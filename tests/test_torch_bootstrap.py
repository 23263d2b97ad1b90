"""The port's multi-chain dataset bootstrap (``MDSimulation.bootstrap_data``
and ``SimulationData.from_sim``) against the JAX package's on the CPU."""

import types

import numpy as np
import pytest
import torch

import isokann_tpu as itk
import isokann_tpu.data as jdata

import isokann_tpu_torch as itt
import isokann_tpu_torch.data as tdata

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)


def _jax_defaults(nx, chains=None, burnin=None):
    """(chains, burnin) as the JAX ``bootstrap_data`` resolves them: its
    staged branch is forced and records its arguments."""
    stub = types.SimpleNamespace(
        steps=1, _BOOTSTRAP_FUSED_MAX=-1, featurizer=lambda x: x,
        _bootstrap_staged=lambda nx, nk, feat, key, c, b: (c, b))
    return itk.MDSimulation.bootstrap_data(stub, nx, 1, key=0, chains=chains,
                                           burnin=burnin)


@pytest.fixture(scope="module")
def sim():
    return itt.MDSimulation(steps=3, device="cpu")


def test_default_chains_and_burnin_match_jax():
    for nx in range(1, 201):
        assert itt.MDSimulation.bootstrap_chains(nx) == _jax_defaults(nx), nx
    assert itt.MDSimulation.bootstrap_chains(100) == (5, 40)
    assert itt.MDSimulation.bootstrap_chains(8) == (2, 2)
    assert itt.MDSimulation.bootstrap_chains(5) == (1, 0)
    assert itt.MDSimulation.bootstrap_chains(12, chains=3, burnin=1) \
        == _jax_defaults(12, chains=3, burnin=1) == (3, 1)


def test_chains_must_divide_nx(sim):
    with pytest.raises(ValueError, match="must divide"):
        _jax_defaults(8, chains=3)
    with pytest.raises(ValueError, match="must divide"):
        sim.bootstrap_data(8, 2, gen=0, chains=3)


def test_non_finite_frame_raises():
    s = itt.MDSimulation(steps=2, device="cpu")
    x = s.coords.clone()
    x[:3] = float("nan")
    s.setcoords(x)
    with pytest.raises(FloatingPointError, match="dataset bootstrap "
                                                 "diverged"):
        s.bootstrap_data(4, 2, gen=0)


def test_one_chain_is_the_lagged_trajectory(sim):
    """chains=1, burnin=0 is ``laggedtrajectory`` from the same generator,
    bit for bit (the reference's single-trajectory semantics)."""
    xs = sim.bootstrap_data(5, 2, gen=3)[0]
    assert sim.bootstrap_chains(5) == (1, 0)
    assert torch.equal(xs, sim.laggedtrajectory(5, gen=3))
    xs = sim.bootstrap_data(8, 2, gen=4, chains=1, burnin=0)[0]
    assert torch.equal(xs, sim.laggedtrajectory(8, gen=4))


def test_noiseless_bootstrap_matches_jax():
    """At T = 0 (no velocities, no noise) both packages run the same
    deterministic chains and bursts: 2 chains of 4 lags after a 2-lag
    burn-in, 3 steps a lag."""
    tsim = itt.MDSimulation(steps=3, temp=0.0, device="cpu")
    jsim = itk.MDSimulation(steps=3, temp=0.0)
    got = tsim.bootstrap_data(8, 2, gen=0)
    ref = jsim.bootstrap_data(8, 2, key=0)
    for name, a, b in zip(("xs", "ys", "fxs", "fys"), got, ref):
        assert tuple(a.shape) == tuple(np.shape(b)), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5, err_msg=name)
    # the chains moved from the start state
    assert float((got[0] - tsim.coords).abs().max()) > 1e-3


def test_frames_are_chain_major(sim, monkeypatch):
    """Each lag adds (walker + 1) to every coordinate, so chain c's lag l
    frame is x0 + (c + 1) l: the frames of one chain are consecutive rows
    of xs after its burn-in (a lag-major stack would interleave them)."""
    x0 = sim.coords

    def integrate(x, v, nsteps, gen):
        step = torch.arange(1, x.shape[0] + 1, dtype=x.dtype)[:, None]
        return x + step, v

    monkeypatch.setattr(sim, "_integrate", integrate)
    nx, (chains, burnin) = 12, sim.bootstrap_chains(12)
    assert (chains, burnin) == (3, 4)
    xs = sim.bootstrap_data(nx, 1, gen=0)[0]
    nlag = nx // chains
    want = torch.stack([x0 + (c + 1) * (burnin + j + 1)
                        for c in range(chains) for j in range(nlag)])
    # the sums are rounded lag by lag; a misplaced frame is >= 1 off
    assert float((xs - want).abs().max()) < 1e-4


def test_every_chain_frame_is_checked_for_cell_overflow(sim, monkeypatch):
    """The neighbor route's overflow check sees every frame of every chain
    (burn-in included), as it sees every frame of ``trajectory``; the
    bursts' own check samples only their first rows, which come from
    chain 0."""
    seen = []

    def check(ys, sample=8):
        seen.append(ys.reshape(-1, sim.dim)[:sample].clone())

    monkeypatch.setattr(sim, "_check_cell_overflow", check)
    xs = sim.bootstrap_data(8, 2, gen=0)[0]
    chains, burnin = sim.bootstrap_chains(8)
    assert seen[0].shape == ((8 // chains + burnin) * chains, sim.dim)
    for row in xs:
        assert any(torch.equal(row, r) for r in seen[0])


class _StubSim:
    """Records which data path ``from_sim`` takes; ``arr`` makes the
    package's arrays."""

    def __init__(self, arr, bias=None, bootstrap=True):
        self.arr, self.bias, self.calls = arr, bias, []
        if bootstrap:
            self.bootstrap_data = self._bootstrap_data

    def featurizer(self, x):
        return x

    def _bootstrap_data(self, nx, nk, featurizer=None, **kw):
        self.calls.append("bootstrap_data")
        return (self.arr(np.zeros((nx, 3))), self.arr(np.zeros((nx, nk, 3))),
                self.arr(np.zeros((nx, 3))), self.arr(np.zeros((nx, nk, 3))))

    def randx0(self, nx, **kw):
        self.calls.append("randx0")
        return self.arr(np.zeros((nx, 3)))

    def propagate(self, xs, nk, **kw):
        self.calls.append("propagate")
        return self.arr(np.zeros((len(xs), nk, 3)))


@pytest.mark.parametrize("case", ["unbiased", "biased", "xs", "no_method"])
def test_from_sim_takes_the_bootstrap_when_jax_does(case):
    calls = []
    for arr, SD in ((np.asarray, jdata.SimulationData),
                    (lambda a: torch.as_tensor(a, dtype=torch.float32),
                     tdata.SimulationData)):
        s = _StubSim(arr, bias=(lambda *a: 0) if case == "biased" else None,
                     bootstrap=case != "no_method")
        kw = dict(xs=arr(np.zeros((4, 3)))) if case == "xs" else dict(nx=4)
        d = SD.from_sim(s, nk=2, **kw)
        assert len(d) == 4 and d.nk == 2
        calls.append(s.calls)
    assert calls[0] == calls[1]
    assert ("bootstrap_data" in calls[1]) == (case == "unbiased")


def test_from_sim_is_the_bootstrap(sim):
    d = itt.SimulationData.from_sim(sim, nx=8, nk=2, gen=5)
    xs, ys, fxs, fys = sim.bootstrap_data(8, 2, gen=5)
    assert torch.equal(d.coords, xs) and torch.equal(d.propcoords, ys)
    assert torch.equal(d.features, fxs) and torch.equal(d.propfeatures, fys)
    assert d.featurizer is sim.featurizer


def test_data_bootstrap_is_randx0_then_propagate(sim):
    xs, ys = tdata.bootstrap(sim, 3, 2, gen=6)
    gen = itt.make_generator(6)
    x2 = sim.randx0(3, gen=gen)
    assert torch.equal(xs, x2)
    assert torch.equal(ys, sim.propagate(x2, 2, gen=gen))
    jxs, jys = jdata.bootstrap(itk.MDSimulation(steps=3), 3, 2, key=0)
    assert tuple(xs.shape) == np.shape(jxs)
    assert tuple(ys.shape) == np.shape(jys)


def test_potential_and_minimize_match_jax(sim):
    jsim = itk.MDSimulation(steps=3)
    rng = np.random.default_rng(0)
    x = (sim.coords.numpy()[None, :]
         + rng.normal(scale=0.01, size=(4, sim.dim))).astype(np.float32)
    e = sim.potential(torch.as_tensor(x)).numpy()
    ej = np.asarray(jsim.potential(x))
    np.testing.assert_allclose(e, ej, rtol=1e-5, atol=1e-3)
    xm = sim.minimize(maxiter=20)
    xj = np.asarray(jsim.minimize(maxiter=20))
    assert xm.shape == (sim.dim,)
    assert float(sim.potential(xm[None])) < float(sim.potential(
        sim.coords[None]))
    np.testing.assert_allclose(xm.numpy(), xj, rtol=0, atol=1e-4)
