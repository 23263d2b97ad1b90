"""The villin slice on the CPU: HP35 (``out/villin.pdb``, 588 atoms, OBC2
implicit solvent, the hybrid force route) with all-pairs features
(172,578 distances, the fused route of kernels C and C′) under an
``optcontrol`` bias, against the JAX package on the same numpy inputs
and the same chi weights (carried across by ``weights.py``).

The chi model is narrow, ``densenet([172578, 8, 1])``: the default
``autonet`` at this width has 535 M parameters.  Both packages' ``iso``
is a stub whose ``chis()`` / ``koopman()`` give Kchi = 0.1 + 0.8 chi, so
that ``optcontrol`` fits lambda = 0.8 without training.  The JAX package
featurizes through its fused route in Pallas interpret mode (its TPU
dispatch rule, patched in with ``monkeypatch``; nothing in the JAX package
changes).  Tolerance 1e-5 relative: the fused routes of both packages are
float32 direct differences, 1.5e-6 nm from float64 distances."""

import functools
import math
import os
from types import SimpleNamespace

import jax
import jax.experimental.pallas as jax_pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu import features as JF
from isokann_tpu.md import integrators as JI
from isokann_tpu.md.forces import force_flat as jax_force_flat
from isokann_tpu.models import densenet as jax_densenet
from isokann_tpu.ops import pairdists as JP

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import integrators as I
from isokann_tpu_torch.models import densenet
from isokann_tpu_torch.ops import pairdists_kernel as PK
from isokann_tpu_torch.weights import load_jax_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

VILLIN = os.path.join(os.path.dirname(__file__), "..", "out", "villin.pdb")
NFEAT = 588 * 587 // 2
FS, T_EVAL = 0.5, 0.004


@pytest.fixture(scope="module")
def sim():
    return itt.MDSimulation(pdb=VILLIN, steps=3, implicit="obc2",
                            features=itt.FeaturesAll(), device="cpu")


@pytest.fixture(scope="module")
def jsim():
    return itk.MDSimulation(pdb=VILLIN, steps=3, implicit="obc2",
                            features=JF.FeaturesAll())


@pytest.fixture(scope="module")
def models(sim):
    """The JAX model and the port's with its weights, the output bias
    shifted so that chi = 0.5 at the start structure: psi = lam_t (chi -
    b) + b stays above its floor near it, where log psi has a gradient."""
    jm = jax_densenet([NFEAT, 8, 1], key=jax.random.PRNGKey(5))
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = load_jax_params(densenet([NFEAT, 8, 1]), params)
    with torch.no_grad():
        chi0 = float(tm(sim.featurizer(sim.coords[None]))[0, 0])
    params["layers"][-1]["b"] = (params["layers"][-1]["b"]
                                 + np.float32(0.5 - chi0))
    return jm.with_params(params), load_jax_params(tm, params)


def _stubs(sim, models):
    chi = np.linspace(0.0, 1.0, 12, dtype=np.float32)[:, None]
    kchi = (0.1 + 0.8 * chi).astype(np.float32)
    jm, tm = models
    jiso = SimpleNamespace(
        data=SimpleNamespace(sim=SimpleNamespace(lagtime=sim.lagtime),
                             featurizer=JF.FeaturesAll()),
        model=jm, chis=lambda: chi, koopman=lambda: kchi)
    tiso = SimpleNamespace(
        data=SimpleNamespace(sim=sim, featurizer=sim.featurizer),
        model=tm, chis=lambda: torch.as_tensor(chi),
        koopman=lambda: torch.as_tensor(kchi))
    return jiso, tiso


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX package's fused route on the CPU: its TPU dispatch rule and
    ``pallas_call`` in interpret mode; JAX's caches are cleared so that no
    program traced on another route is reused."""
    monkeypatch.setattr(jax_pallas, "pallas_call", functools.partial(
        jax_pallas.pallas_call, interpret=True))
    monkeypatch.setattr(JP, "_should_use_pallas",
                        lambda b: b.shape[1] >= 512)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _walkers(sim, n, seed):
    rng = np.random.default_rng(seed)
    x0 = sim.coords.numpy()
    return (x0[None] + rng.normal(scale=0.01, size=(n, x0.size))
            ).astype(np.float32)


def test_villin_route_and_features(sim):
    assert sim.natoms == 588 and sim.route == "hybrid"
    assert isinstance(sim.featurizer, itt.FeaturesAll)
    assert sim.featurizer(sim.coords[None]).shape == (1, NFEAT)


def test_optcontrol_bias_matches_jax(sim, models, jax_fused):
    """The bias force of both packages on the same weights and walkers,
    fused featurization on both: (b, qrate, Tmax) to 1e-6, the force to
    1e-5 of its largest entry."""
    jiso, tiso = _stubs(sim, models)
    jb = JI.optcontrol(jiso, forcescale=FS)
    tb = itt.optcontrol(tiso, forcescale=FS)
    for k in ("b", "qrate", "Tmax"):
        assert tb.optcontrol_spec[k] == pytest.approx(
            jb.optcontrol_spec[k], rel=1e-6), k
    assert math.exp(tb.optcontrol_spec["qrate"] * sim.lagtime) == \
        pytest.approx(0.8, rel=1e-6)
    x = _walkers(sim, 4, seed=1)
    sig = I.constants(sim.masses3, sim.temp, sim.friction, overdamped=False)
    fj = np.asarray(jb(jnp.asarray(x), T_EVAL, jnp.asarray(sig.numpy()),
                       None))
    ft = tb(torch.as_tensor(x), T_EVAL, sig, None).numpy()
    assert np.abs(fj).max() > 0
    assert np.abs(ft - fj).max() / np.abs(fj).max() < 1e-5


def test_noiseless_biased_aboba_matches_jax_oracle(sim, jsim, models,
                                                   jax_fused):
    """Three noiseless (eta = 0) biased ABOBA steps at B = 4: the port's
    recursion over its hybrid force route and its bias against an oracle
    written here from the JAX package's ``force_flat`` and its bias: q to
    1e-5 relative, logw to 1e-4 of its largest value."""
    jiso, tiso = _stubs(sim, models)
    jb = JI.optcontrol(jiso, forcescale=FS)
    tb = itt.optcontrol(tiso, forcescale=FS)
    x0 = _walkers(sim, 4, seed=2)
    m3 = sim.masses3.numpy().astype(np.float64)
    p0 = (np.random.default_rng(3).normal(size=x0.shape)
          * np.sqrt(m3 * I.KB * sim.temp)).astype(np.float32)
    nsteps, dt, gamma, T = 3, sim.step, sim.friction, sim.temp

    q_t, p_t, lw_t = I.aboba_girsanov(
        sim.force, tb, torch.as_tensor(x0), torch.as_tensor(p0),
        sim.masses3, T, gamma, dt, nsteps)

    # the oracle: the ABOBA splitting of ``md.integrators.aboba_girsanov``
    # in the JAX package, eta = 0
    m = jnp.asarray(sim.masses3.numpy())
    sig = jnp.sqrt(2 * JI.KB * T * gamma * m)
    d = math.exp(-gamma * dt)
    famp = jnp.sqrt(JI.KB * T * m * (1.0 - d * d))
    q, p = jnp.asarray(x0), jnp.asarray(p0)
    logw = jnp.zeros(4)
    for k in range(nsteps):
        q = q + dt / 2 * p / m
        F = jax_force_flat(jsim.system, q)
        B = jb(q, k * dt, sig, F) * sig
        deta = (d + 1.0) / famp * dt / 2 * B
        logw = logw - jnp.sum(deta * deta, axis=-1) / 2
        b = dt / 2 * (F + B)
        p = d * (p + b) + b
        q = q + dt / 2 * p / m
    q, logw = np.asarray(q), np.asarray(logw)
    assert np.abs(logw).max() > 0            # the bias acted
    assert np.abs(q_t.numpy() - q).max() / np.abs(q).max() < 1e-5
    assert np.abs(lw_t.numpy() - logw).max() / np.abs(logw).max() < 1e-4


def test_biased_propagate_gives_weighted_samples(sim, models):
    """``MDSimulation.propagate`` under the bias on the hybrid route:
    finite Girsanov-weighted samples; the CPU counts no kernel launch."""
    _, tiso = _stubs(sim, models)
    launches = (PK.sqpairdist_fwd.launches, PK.sqpairdist_bwd.launches)
    sim.bias = itt.optcontrol(tiso, forcescale=FS)
    try:
        x0 = torch.as_tensor(_walkers(sim, 2, seed=4))
        ws = sim.propagate(x0, 4, gen=5, steps=3)
    finally:
        sim.bias = None
    assert isinstance(ws, itt.WeightedSamples)
    assert ws.values.shape == (2, 4, 3 * 588) and ws.weights.shape == (2, 4)
    assert bool(torch.isfinite(ws.values).all())
    assert bool(torch.isfinite(ws.weights).all())
    assert bool((ws.weights > 0).all())
    assert not torch.equal(ws.weights, torch.ones(2, 4))
    assert (PK.sqpairdist_fwd.launches,
            PK.sqpairdist_bwd.launches) == launches == (0, 0)
