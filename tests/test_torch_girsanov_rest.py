"""The rest of Girsanov in the port, against the JAX package on the CPU:
naive underdamped Euler-Maruyama (``langevin_em``), the constrained ABOBA
recursion on the solvated fixture, the dispatch of any bias on the fused
route, the biased ``trajectory`` / ``laggedtrajectory`` / ``randx0`` and
``SimulationData.from_sim`` on a biased simulation, Brownian propagation
with its retry, the direct integrators and the constructor's
``integrator=`` / ``minimize=``.

Noisy recursions are held by feeding both packages the same normals: the
test draws them from the keys that the JAX scan splits, and the port's
recursion takes them through ``md.integrators._normals``."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md import integrators as JI
from isokann_tpu.md import neighbor as JN
from isokann_tpu.md.integrators import KB

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import integrators as I
from isokann_tpu_torch.md import langevin_kernel as LK
from isokann_tpu_torch.md import neighbor_kernel as NK
from isokann_tpu_torch.simulators import mdsim as MD

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

SOLV = dict(addwater=True, padding=0.7, steps=3, dense_pairs=False)
K_BIAS = 20.0         # the harmonic test bias, kJ/mol/nm^2 (in sigma units)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _biases(x_ref):
    """A harmonic pull toward ``x_ref`` in both packages: the same
    deterministic, non-zero bias."""
    jref, tref = jnp.asarray(x_ref), torch.as_tensor(x_ref)

    def jbias(q, t, sigma, F):
        return -K_BIAS * (q - jref)

    def tbias(q, t, sigma, F):
        return -K_BIAS * (q - tref.to(q.device, q.dtype))

    return jbias, tbias


def _feed(monkeypatch, normals):
    """The port's recursion takes ``normals`` (numpy, one per draw) in
    turn through ``I._normals``."""
    it = iter(normals)

    def take(gen, x):
        return torch.as_tensor(np.array(next(it)), dtype=x.dtype,
                               device=x.device).reshape(x.shape)

    monkeypatch.setattr(I, "_normals", take)


def _jax_normals(key, n, shape, dtype=jnp.float32):
    return [np.asarray(jax.random.normal(k, shape, dtype))
            for k in jax.random.split(key, n)]


@pytest.fixture(scope="module")
def jsim():
    return itk.MDSimulation(steps=10)


@pytest.fixture(scope="module")
def sim():
    return itt.MDSimulation(steps=10, device="cpu")


@pytest.fixture(scope="module")
def walkers(sim):
    x0 = sim.coords.numpy()
    rng = np.random.default_rng(0)
    return (x0[None] + rng.normal(scale=0.005, size=(3, x0.size))
            ).astype(np.float32)


# ---- langevin_em ----------------------------------------------------------

@pytest.mark.parametrize("perturbed", [False, True])
def test_langevin_em_matches_jax(jsim, sim, walkers, perturbed):
    """20 noiseless (T = 0) naive Euler-Maruyama steps from the same
    walkers and velocities, with and without a force perturbation: x to
    1e-5 and v to 1e-4 of the largest value."""
    v0 = np.random.default_rng(1).normal(scale=0.3, size=walkers.shape
                                         ).astype(np.float32)
    c = np.random.default_rng(2).normal(scale=50.0, size=walkers.shape[1]
                                        ).astype(np.float32)
    jp = (lambda x: x * 0 + jnp.asarray(c)) if perturbed else None
    tp = (lambda x: x * 0 + torch.as_tensor(c)) if perturbed else None
    xj, vj = JI.langevin_em(jsim._force_fn(), jnp.asarray(walkers),
                            jnp.asarray(v0), jsim.masses3, 0.0, 1.0, 0.002,
                            20, jax.random.PRNGKey(0), perturbation=jp)
    xt, vt = I.langevin_em(sim.force, torch.as_tensor(walkers),
                           torch.as_tensor(v0), sim.masses3, 0.0, 1.0, 0.002,
                           20, None, perturbation=tp)
    assert _rel(xt.numpy(), xj) < 1e-5
    assert _rel(vt.numpy(), vj) < 1e-4


# ---- constrained ABOBA ----------------------------------------------------

@pytest.fixture(scope="module")
def solvated():
    jsim = itk.MDSimulation(**SOLV)
    sim = itt.MDSimulation(device="cpu", **SOLV)
    jp = JN.NeighborPlan(jsim.system,
                         x0=np.asarray(jsim.coords).reshape(-1, 3))

    def jf(z):
        return jax.vmap(lambda xi: JN.force_neighbor(
            jsim.system, xi.reshape(-1, 3), jp).reshape(-1))(z)

    return jsim, sim, jf


@pytest.mark.parametrize("temp", [0.0, 310.0])
def test_constrained_aboba_matches_jax_float64(solvated, monkeypatch,
                                               temp):
    """10 constrained ABOBA steps under a harmonic bias on the solvated
    fixture (rigid waters), against the JAX recursion in float64.

    At T = 0 (``sigmascaled=False``: the noise amplitude vanishes, the
    bias still acts, projected onto the constraint tangent space) q to
    1e-5 and p to 1e-4 of the largest value.  At 310 K both take the same
    normals: q and p as at T = 0 and logw to 1e-4 of the largest."""
    jsim, sim, jf = solvated
    x0 = sim.coords.numpy()[None].repeat(2, 0)
    x0[1] += 0.01                 # a rigid shift: the waters stay rigid
    p0 = (np.random.default_rng(4).normal(scale=0.3, size=x0.shape)
          * sim.masses3.numpy()).astype(np.float32)
    x_ref = x0[0] + np.random.default_rng(5).normal(
        scale=0.02, size=x0.shape[1]).astype(np.float32)
    jbias, tbias = _biases(x_ref)
    key = jax.random.PRNGKey(3)
    with jax.enable_x64():
        run = jax.jit(lambda x, p: JI.aboba_girsanov(
            jf, jbias, x, p, jsim.masses3.astype(jnp.float64), temp, 1.0,
            0.002, 10, key, sigmascaled=False,
            constraints=jsim.constraint_set))
        qj, pj, lj = (np.asarray(a) for a in run(
            jnp.asarray(x0, jnp.float64), jnp.asarray(p0, jnp.float64)))
        normals = _jax_normals(key, 10, x0.shape, jnp.float64)
    assert qj.dtype == np.float64
    if temp:
        _feed(monkeypatch, normals)
    n0 = NK.neighbor_sweep.launches
    qt, pt, lt = I.aboba_girsanov(
        sim.force, tbias, torch.as_tensor(x0), torch.as_tensor(p0),
        sim.masses3, temp, 1.0, 0.002, 10, itt.make_generator(0) if temp
        else None, sigmascaled=False, constraints=sim.constraint_set)
    assert NK.neighbor_sweep.launches == n0
    assert _rel(qt.numpy(), qj) < 1e-5
    assert _rel(pt.numpy(), pj) < 1e-4
    assert sim.constraint_set.max_violation(qt) < 1e-5
    if temp:
        assert np.all(np.isfinite(lt.numpy()))
        assert _rel(lt.numpy(), lj) < 1e-4


def test_biased_constrained_propagate_and_trajectory(solvated):
    """The entry points of a biased constrained system (raising until
    this slice): weighted bursts and frames, rigid waters held."""
    _, sim, _ = solvated
    sim.bias = _biases(sim.coords.numpy())[1]
    try:
        ws = sim.propagate(sim.coords[None], 2, gen=0)
        tr = sim.trajectory(steps=4, saveevery=2, gen=1)
    finally:
        sim.bias = None
    for w in (ws, tr):
        assert isinstance(w, itt.WeightedSamples)
        assert bool(torch.isfinite(w.values).all())
        assert bool(torch.isfinite(w.weights).all())
        assert sim.constraint_set.max_violation(w.values) < 1e-5
    assert ws.values.shape == (1, 2, sim.dim)
    assert tr.values.shape == (2, sim.dim)


# ---- any bias on the fused route ------------------------------------------

def test_any_bias_fused_route_dispatch(sim):
    """On the card the Girsanov kernel takes an optcontrol bias over a
    chi model it computes; any other bias runs the plain ABOBA recursion
    over ``force`` (kernel A's forces entry), one call a step.  On the
    CPU every bias runs the recursion."""
    npairs = sim.natoms * (sim.natoms - 1) // 2
    feat = sim.featurizer
    taken = I.optcontrol_bias(itt.pairnet(npairs, gen=0), feat, 0.5, 0.4,
                              -2.0, sim.lagtime)
    rejected = I.optcontrol_bias(
        itt.densenet([npairs, 8, 1], lastactivation="sigmoid", gen=0), feat,
        0.5, 0.4, -2.0, sim.lagtime)
    route = {}
    for name, bias in (("taken", taken), ("rejected", rejected),
                       ("callable", _biases(sim.coords.numpy())[1])):
        sim.bias = bias
        route[name] = (sim.biased_route("cuda"), sim.biased_route("cpu"))
    sim.bias = None
    assert route == {"taken": ("kernel", "recursion"),
                     "rejected": ("recursion", "recursion"),
                     "callable": ("recursion", "recursion")}
    calls = []
    s = itt.MDSimulation(steps=7, device="cpu")
    s.force = lambda x: calls.append(x.shape) or LK.forces(s.plan, x)
    s.bias = rejected
    n0 = LK.forces.launches
    ws = s.propagate(s.coords[None], 3, gen=0)
    assert calls == [(8, s.dim)] * 7 and LK.forces.launches == n0
    assert isinstance(ws, itt.WeightedSamples)
    assert bool(torch.isfinite(ws.weights).all())


# ---- biased trajectory, randx0, from_sim ----------------------------------

def test_biased_trajectory_matches_jax(jsim, sim, monkeypatch):
    """A biased 20-step trajectory saving every 5 steps at 310 K, both
    packages fed the same momenta and normals: the frames to 1e-5 and the
    running Girsanov weights to 1e-4 of the largest."""
    jbias, tbias = _biases(sim.coords.numpy())
    key = jax.random.PRNGKey(9)
    jsim.bias = jbias
    try:
        wj = jsim.trajectory(steps=20, saveevery=5, key=key)
    finally:
        jsim.bias = None
    kv, ki = jax.random.split(key)
    m3 = sim.masses3.numpy()
    p0 = np.asarray(jax.random.normal(kv, (1, sim.dim))) * np.sqrt(
        m3 * KB * sim.temp)
    _feed(monkeypatch, _jax_normals(ki, 20, (1, sim.dim)))
    monkeypatch.setattr(sim, "random_velocities",
                        lambda gen, shape: torch.as_tensor(p0 / m3))
    sim.bias = tbias
    try:
        wt = sim.trajectory(steps=20, saveevery=5, gen=0)
    finally:
        sim.bias = None
    assert isinstance(wt, itt.WeightedSamples)
    assert wt.values.shape == (4, sim.dim) and wt.weights.shape == (4,)
    assert _rel(wt.values.numpy(), wj.values) < 1e-5
    assert _rel(wt.weights.numpy(), wj.weights) < 1e-4


def test_biased_lagged_trajectory_and_randx0(sim):
    """``laggedtrajectory(n)`` is one recursion of n lags saving every
    lag; ``randx0`` returns its values (the weights are dropped)."""
    sim.bias = _biases(sim.coords.numpy())[1]
    try:
        lt = sim.laggedtrajectory(3, gen=4)
        tr = sim.trajectory(steps=3 * sim.steps, saveevery=sim.steps, gen=4)
        x0 = sim.randx0(3, gen=4)
    finally:
        sim.bias = None
    assert isinstance(lt, itt.WeightedSamples)
    assert torch.equal(lt.values, tr.values)
    assert torch.equal(lt.weights, tr.weights)
    assert not isinstance(x0, itt.WeightedSamples)
    assert torch.equal(x0, lt.values)
    assert bool((lt.weights > 0).all())


def test_from_sim_on_a_biased_simulation(monkeypatch):
    """A biased simulation's dataset takes ``randx0`` + ``propagate``
    (weighted bursts), not the unbiased bootstrap, as the JAX
    ``data.py:270-278`` does."""
    s = itt.MDSimulation(steps=5, device="cpu")
    s.bias = _biases(s.coords.numpy())[1]

    def no_bootstrap(*a, **k):
        raise AssertionError("bootstrap_data on a biased simulation")

    monkeypatch.setattr(s, "bootstrap_data", no_bootstrap)
    data = itt.SimulationData.from_sim(s, nx=2, nk=3, gen=0)
    assert isinstance(data.propfeatures, itt.WeightedSamples)
    assert data.propfeatures.values.shape == (2, 3, 231)
    assert torch.equal(data.coords, s.randx0(2, gen=itt.make_generator(0)))
    assert bool(torch.isfinite(data.propfeatures.weights).all())


# ---- Brownian propagation -------------------------------------------------

def test_brownian_propagate_matches_jax(walkers):
    """Noiseless (T = 0) Brownian bursts at a friction where 2 fs is
    stable (1000/ps) against JAX at 1e-5; the port's chains stay
    LangevinMiddle (a Brownian simulation's trajectory is the Langevin
    one's, bit for bit)."""
    kw = dict(steps=20, temp=0.0, friction=1000.0, integrator="brownian")
    jb = itk.MDSimulation(**kw)
    tb = itt.MDSimulation(device="cpu", **kw)
    yj = np.asarray(jb.propagate(walkers, 2, key=jax.random.PRNGKey(0)))
    yt = tb.propagate(walkers, 2, gen=0).numpy()
    assert _rel(yt, yj) < 1e-5
    assert np.abs(yt - walkers[:, None]).max() > 1e-3
    kw = dict(steps=20, friction=1000.0, device="cpu")
    bt = itt.MDSimulation(integrator="brownian", **kw)
    assert torch.equal(bt.trajectory(steps=10, saveevery=5, gen=1),
                       itt.MDSimulation(**kw).trajectory(steps=10,
                                                         saveevery=5, gen=1))


def test_brownian_propagate_retries_then_falls_back(walkers):
    """At the default friction (1/ps) 2 fs of overdamped dynamics
    diverges: three retries of the batch, a warning, and the start states
    back, in both packages."""
    jb = itk.MDSimulation(steps=30, integrator="brownian")
    tb = itt.MDSimulation(steps=30, integrator="brownian", device="cpu")
    with pytest.warns(UserWarning, match="diverged"):
        yj = np.asarray(jb.propagate(walkers[:1], 2,
                                     key=jax.random.PRNGKey(1)))
    with pytest.warns(UserWarning, match="diverged"):
        yt = tb.propagate(walkers[:1], 2, gen=1).numpy()
    assert tb.retries == 3
    np.testing.assert_array_equal(yt, np.repeat(walkers[:1, None], 2, 1))
    np.testing.assert_array_equal(yj, yt)


# ---- direct integrators ---------------------------------------------------

def test_integrate_langevin_matches_jax(walkers):
    """``integrate_langevin`` at T = 0 (velocities and noise vanish) from
    the walkers, with and without a perturbation: 1e-5."""
    jz = itk.MDSimulation(steps=15, temp=0.0)
    tz = itt.MDSimulation(steps=15, temp=0.0, device="cpu")
    c = np.random.default_rng(2).normal(scale=50.0, size=tz.dim
                                        ).astype(np.float32)
    for jp, tp in ((None, None), (lambda x: x * 0 + jnp.asarray(c),
                                  lambda x: x * 0 + torch.as_tensor(c))):
        xj = np.asarray(jz.integrate_langevin(walkers, perturbation=jp,
                                              key=jax.random.PRNGKey(0)))
        xt = tz.integrate_langevin(walkers, perturbation=tp, gen=0)
        assert xt.shape == walkers.shape
        assert _rel(xt.numpy(), xj) < 1e-5
    assert tz.integrate_langevin(gen=0).shape == (1, tz.dim)


def test_integrate_girsanov_matches_jax(walkers, monkeypatch):
    """Overdamped Girsanov at T = 0 and 1000/ps, both packages fed the
    same normals: the drift alone moves x (1e-5); logw, -(|u|^2 dt / 2 +
    u . dB) with the bias u, to 1e-5 of the largest."""
    kw = dict(steps=15, temp=0.0, friction=1000.0)
    jz, tz = itk.MDSimulation(**kw), itt.MDSimulation(device="cpu", **kw)
    jbias, tbias = _biases(walkers[0])
    key = jax.random.PRNGKey(0)
    xj, lj = jz.integrate_girsanov(walkers, bias=jbias, key=key)
    _feed(monkeypatch, _jax_normals(key, 15, walkers.shape))
    xt, lt = tz.integrate_girsanov(walkers, bias=tbias, gen=0)
    assert _rel(xt.numpy(), xj) < 1e-5
    assert _rel(lt.numpy(), lj) < 1e-5
    with pytest.raises(ValueError, match="needs a bias"):
        tz.integrate_girsanov(walkers)


@pytest.mark.parametrize("sigmascaled", [True, False])
def test_langevin_girsanov_matches_jax(jsim, sim, monkeypatch, sigmascaled):
    """``langevin_girsanov`` at 310 K with the same momenta and normals:
    frames to 1e-5 and weights to 1e-4 of the largest; with no bias the
    zero bias (weights 1)."""
    jbias, tbias = _biases(sim.coords.numpy())
    key = jax.random.PRNGKey(5)
    wj = jsim.langevin_girsanov(steps=12, bias=jbias, saveevery=4,
                                sigmascaled=sigmascaled, key=key)
    kv, ki = jax.random.split(key)
    m3 = sim.masses3.numpy()
    p0 = np.asarray(jax.random.normal(kv, (1, sim.dim))) * np.sqrt(
        m3 * KB * sim.temp)
    _feed(monkeypatch, _jax_normals(ki, 12, (1, sim.dim)))
    monkeypatch.setattr(sim, "random_velocities",
                        lambda gen, shape: torch.as_tensor(p0 / m3))
    wt = sim.langevin_girsanov(steps=12, bias=tbias, saveevery=4,
                               sigmascaled=sigmascaled, gen=0)
    assert wt.values.shape == (3, sim.dim)
    assert _rel(wt.values.numpy(), wj.values) < 1e-5
    assert _rel(wt.weights.numpy(), wj.weights) < 1e-4
    monkeypatch.undo()
    w0 = sim.langevin_girsanov(steps=4, saveevery=2, gen=0)
    assert torch.equal(w0.weights, torch.ones(2))


# ---- constructor ----------------------------------------------------------

def test_constructor_integrator_and_minimize():
    """``integrator`` and ``minimize`` are constructor arguments recorded
    in ``constructor``; ``minimize=True`` starts from the FIRE-minimized
    structure (500 steps), as the JAX package's: the two FIRE runs agree
    to 1e-6 nm over their first 100 steps (``tests/test_torch_bootstrap
    .py`` holds 20 at 1e-4) and then part on the flat end of the
    landscape, to 8e-4 nm and 0.05 kJ/mol after 500; held to 1e-3 nm and
    0.1 kJ/mol.  An unknown integrator raises; rigid water under the
    Brownian integrator stays flexible with a warning, as in the JAX
    package."""
    tm = itt.MDSimulation(minimize=True, device="cpu")
    jm = itk.MDSimulation(minimize=True)
    assert tm.constructor["minimize"] is True
    assert tm.constructor["integrator"] == "langevin"
    np.testing.assert_allclose(tm.coords.numpy(), np.asarray(jm.coords),
                               rtol=0, atol=1e-3)
    assert abs(float(tm.potential(tm.coords[None])[0]) - float(
        np.asarray(jm.potential(np.asarray(jm.coords)[None]))[0])) < 0.1
    plain = itt.MDSimulation(device="cpu")
    assert float(tm.potential(tm.coords[None])) < float(
        plain.potential(plain.coords[None]))
    assert torch.equal(tm.coords, plain.minimize(plain.coords))
    with pytest.raises(ValueError, match="unknown integrator"):
        itt.MDSimulation(integrator="verlet", device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        b = itt.MDSimulation(device="cpu", integrator="brownian", **SOLV)
    assert any("rigid water" in str(x.message) for x in w)
    assert b.constraint_set is None
    assert b.constructor["integrator"] == "brownian"
    assert MD.force_route(b.system, False) == b.route == "neighbor"
