"""Girsanov / optimal-control slice of the port on the CPU, against the
JAX package on the same numpy inputs and parameters: the chi-MLP gradient
and the noiseless trajectory of the Girsanov kernel's plain version,
``optcontrol``, the Girsanov martingale, weighted samples, KDE resampling,
weighted training, the ``run_girsanov`` workflow and the dispatch rules.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``."""

import math
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.data import SimulationData as JaxData
from isokann_tpu.data import WeightedSamples as JaxWeightedSamples
from isokann_tpu.data import lastcat as jax_lastcat
from isokann_tpu.md import integrators as JI
from isokann_tpu.md.pallas_md import (ChiBiasPlan, PallasMDPlan,
                                      aboba_girsanov_fused, make_chi_grad_fn)
from isokann_tpu.models import densenet as jax_densenet
from isokann_tpu.models import pairnet as jax_pairnet
from isokann_tpu.sample import resample_kde_ash as jax_resample_kde_ash
from isokann_tpu.targets import expectation as jax_expectation

import isokann_tpu_torch as itt
from isokann_tpu_torch import _build
from isokann_tpu_torch.data import WeightedSamples, lastcat
from isokann_tpu_torch.md import girsanov_kernel as GK
from isokann_tpu_torch.md import integrators as I
from isokann_tpu_torch.md import langevin_kernel as LK
from isokann_tpu_torch.models import densenet
from isokann_tpu_torch.sample import resample_kde_ash
from isokann_tpu_torch.weights import load_jax_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "golden",
                      "ala2_vacuum_msm.npz")
NPAIRS = 231


def _params_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jsim():
    return itk.MDSimulation(steps=10)


@pytest.fixture(scope="module")
def sim():
    return itt.MDSimulation(steps=10, device="cpu")


@pytest.fixture(scope="module")
def jmodel():
    return jax_pairnet(n=NPAIRS, key=jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def tmodel(jmodel):
    return load_jax_params(itt.pairnet(NPAIRS), _params_np(jmodel.params))


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    return g["xs"][:20], g["ys"][:20, :5]


# ---- kernel module: chi gradient and noiseless trajectory ----------------

@pytest.mark.parametrize("net", ["pairnet_layernorm", "densenet_13"])
def test_chi_grad_plain_matches_jax_kernel_math(jsim, sim, net):
    """chi and dchi/df of the plain version (autograd on the port's MLP)
    against the TPU kernel's hand-written forward/backward: chi to 1e-5,
    dchi/df to 1e-4 relative to its largest entry (the JAX package's own
    tolerances for its kernel against autodiff)."""
    if net == "pairnet_layernorm":
        jm = jax_pairnet(n=NPAIRS, key=jax.random.PRNGKey(3))
        tm = load_jax_params(itt.pairnet(NPAIRS), _params_np(jm.params))
    else:
        jm = jax_densenet([NPAIRS, 13, 1], layernorm=False,
                          key=jax.random.PRNGKey(4))
        tm = load_jax_params(densenet([NPAIRS, 13, 1]),
                             _params_np(jm.params))
    bias_plan = ChiBiasPlan(PallasMDPlan(jsim.system), jm.sizes,
                            jm.layernorm)
    f = np.random.default_rng(0).uniform(0.1, 1.5, size=(16, NPAIRS))
    f = f.astype(np.float32)
    chi_j, g_j = make_chi_grad_fn(bias_plan)(bias_plan.cols(jm.params),
                                             jnp.asarray(f.T))
    plan = GK.GirsanovPlan(sim.plan, tm.sizes, tm.layernorm, 1.0)
    chi, g = GK.chi_grad(plan, tm, torch.as_tensor(f))
    chi_j, g_j = np.asarray(chi_j)[0], np.asarray(g_j).T
    assert np.abs(chi.numpy() - chi_j).max() < 1e-5
    assert np.abs(g.numpy() - g_j).max() / np.abs(g_j).max() < 1e-4


def test_noiseless_trajectory_matches_fused_interpret(jsim, sim, jmodel,
                                                      tmodel):
    """8 walkers x 5 noiseless biased steps of the plain version against
    the TPU kernel's interpret run, at the JAX test's tolerances
    (tests/test_pallas_md.py:345-348): q 2e-5 absolute, p 1e-3 absolute,
    logw 1e-4 relative to its largest value."""
    T, gamma, dt, nsteps = 310.0, 1.0, 0.002, 5
    fs, b, qrate = 0.7, 0.4, -2.0
    Tmax = nsteps * dt
    rng = np.random.default_rng(2)
    x0 = (np.asarray(jsim.coords)[None, :]
          + rng.normal(scale=0.005, size=(8, 66))).astype(np.float32)
    p0 = (rng.normal(size=(8, 66))
          * np.sqrt(np.asarray(jsim.masses3) * JI.KB * T)).astype(np.float32)
    q_j, p_j, lw_j = aboba_girsanov_fused(
        jsim.system, jnp.asarray(x0), jnp.asarray(p0), T, gamma, dt, nsteps,
        jax.random.PRNGKey(0), jmodel, forcescale=fs, b=b, qrate=qrate,
        Tmax=Tmax, block=8, interpret=True)
    plan = GK.GirsanovPlan(sim.plan, tmodel.sizes, tmodel.layernorm, fs)
    q, p, lw = GK.aboba_girsanov(plan, tmodel, torch.as_tensor(x0),
                                 torch.as_tensor(p0), nsteps, b, qrate, Tmax,
                                 itt.make_generator(0), noise=False)
    lw_j = np.asarray(lw_j)
    assert np.abs(q.numpy() - np.asarray(q_j)).max() < 2e-5
    assert np.abs(p.numpy() - np.asarray(p_j)).max() < 1e-3
    assert np.abs(lw.numpy() - lw_j).max() / np.abs(lw_j).max() < 1e-4
    assert np.abs(lw_j).max() > 1e-6      # the bias did act


def test_kernel_plain_matches_optcontrol_recursion(sim, golden):
    """The kernel's formula (pair-row features, fs sigma^2 lam/psi
    back-projection) equals the ABOBA recursion driven by the
    ``optcontrol`` callable (FeaturesAll + autograd), noiseless, at the
    JAX kernel test's tolerances."""
    xs, ys = golden
    data = itt.SimulationData.from_coords(sim, torch.as_tensor(xs),
                                          torch.as_tensor(ys))
    iso = itt.Iso(data=data, model=itt.pairnet(NPAIRS, gen=1),
                  opt=itt.AdamRegularized(), gen=0).run(30)
    bias = itt.optcontrol(iso, forcescale=0.7)
    spec = bias.optcontrol_spec
    x0 = torch.as_tensor(xs[:8])
    p0 = sim.random_velocities(itt.make_generator(2), x0.shape) * sim.masses3
    q_a, p_a, lw_a = I.aboba_girsanov(
        lambda z: LK.forces(sim.plan, z), bias, x0, p0, sim.masses3,
        sim.temp, sim.friction, sim.step, 5)
    plan = GK.GirsanovPlan.for_model(sim.plan, spec["model"], 0.7)
    q_k, p_k, lw_k = GK.aboba_girsanov_plain(
        plan, spec["model"], x0, p0, 5, spec["b"], spec["qrate"],
        spec["Tmax"], noise=False)
    assert (q_k - q_a).abs().max() < 2e-5
    assert (p_k - p_a).abs().max() < 1e-3
    assert float((lw_k - lw_a).abs().max() / lw_a.abs().max()) < 1e-4


def test_step_ops_and_bound(sim, tmodel):
    plan = GK.GirsanovPlan.for_model(sim.plan, tmodel, 0.5)
    macs = 231 * 38 + 38 * 6 + 6 * 1
    ops = GK.step_ops(plan)
    assert ops > LK.step_ops(sim.plan) + 4 * macs
    assert ops == 66917                       # alanine, pairnet 231-38-6-1
    ms, by = GK.bound_ms(plan, 256, 100)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * ops * 256 * 100 / LK.H100_FP32_PEAK)


def test_kernel_ops_and_blocks(sim, tmodel):
    """Kernel B executes ``step_ops`` with kernel A's force routine as A
    executes it and the back-projection from both atoms' sides (9 more a
    pair, 18 more under minimum image: alanine is periodic); one warp a
    walker, four a block."""
    plan = GK.GirsanovPlan.for_model(sim.plan, tmodel, 0.5)
    lp = sim.plan
    assert lp.box is not None
    assert GK.kernel_ops(plan) == (GK.step_ops(plan) + LK.kernel_ops(lp)
                                   - LK.step_ops(lp) + lp.np * (9 + 18))
    assert 1.0 < GK.kernel_ops(plan) / GK.step_ops(plan) < 1.3
    assert [GK.blocks(b) for b in (1, 4, 5, 256, 512, 16384)] == \
        [1, 1, 2, 64, 128, 4096]


@pytest.mark.parametrize("wrapped", [False, True])
def test_backprojection_gather_matches_index_add(sim, golden, wrapped):
    """The kernel's back-projection, each atom gathering c_p (x_a - x_b)
    over its partners in ascending order, equals the plain version's
    ``index_add_`` scatter of c_p d_p at 1e-6 relative to its largest
    entry, on golden alanine frames (CutoffPeriodic) and with atoms moved
    by whole box lengths."""
    lp = sim.plan
    xs = torch.as_tensor(golden[0][:8])
    B, n = xs.shape[0], lp.natoms
    if wrapped:
        shift = np.random.default_rng(5).integers(-1, 2, size=(B, n, 3))
        xs = (xs.reshape(B, n, 3) + torch.as_tensor(
            shift * np.asarray(lp.box), dtype=torch.float32)).reshape(B, -1)
    c = torch.as_tensor(np.random.default_rng(6).normal(size=(B, lp.np)),
                        dtype=torch.float32)
    d, _ = LK.pair_delta(lp, xs.reshape(B, n, 3))
    tb = lp.on("cpu")
    ref = torch.zeros(B, n, 3)
    ref.index_add_(1, tb["pairs"][:, 0], c[..., None] * d)
    ref.index_add_(1, tb["pairs"][:, 1], -c[..., None] * d)
    got = GK.backproject_gather(lp, xs, c)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-6


# ---- optcontrol ---------------------------------------------------------

@pytest.fixture(scope="module")
def trained_pair(golden):
    """A JAX Iso trained on the golden bursts and a port Iso with its
    parameters and its features."""
    xs, ys = golden
    jsim = itk.MDSimulation(steps=10)
    jm = jsim.defaultmodel(n=NPAIRS, key=jax.random.PRNGKey(0))
    jdata = JaxData.from_coords(jsim, xs, ys)
    jiso = itk.Iso(data=jdata, model=jm, opt=itk.AdamRegularized(), key=0,
                   shard=False)
    jiso.run(30)
    sim = itt.MDSimulation(steps=10, device="cpu")
    data = itt.SimulationData.from_coords(
        sim, torch.as_tensor(xs), torch.as_tensor(ys),
        features=(torch.tensor(np.asarray(jdata.features)),
                  torch.tensor(np.asarray(jdata.propfeatures))))
    tm = load_jax_params(sim.defaultmodel(n=NPAIRS),
                         _params_np(jiso.model.params))
    iso = itt.Iso(data=data, model=tm, opt=itt.AdamRegularized(), gen=0)
    return jsim, jiso, sim, iso


def test_optcontrol_matches_jax(trained_pair):
    """Same chis and koopman -> the same (b, qrate, Tmax) to 1e-5, and the
    same bias force at ten perturbed coordinates.

    The force is held to 5e-5 relative to its largest entry, not 1e-5:
    both packages featurize by the f32 Gram trick, whose cancellation on
    the short bonded distances puts each package's force 1.8e-5 from the
    float64 force of exact distances (measured on these inputs), so two
    f32 implementations cannot agree to 1e-5.  The port is also held to
    that float64 reference at 5e-5."""
    jsim, jiso, sim, iso = trained_pair
    jb = JI.optcontrol(jiso, forcescale=0.5)
    tb = itt.optcontrol(iso, forcescale=0.5)
    js, ts = jb.optcontrol_spec, tb.optcontrol_spec
    for k in ("b", "qrate", "Tmax", "forcescale"):
        assert ts[k] == pytest.approx(js[k], rel=1e-5), k
    rng = np.random.default_rng(7)
    x = (np.asarray(jsim.coords)[None, :]
         + rng.normal(scale=0.01, size=(10, 66))).astype(np.float32)
    jsig = JI.constants(jsim.masses3, 310.0, 1.0, overdamped=False)
    tsig = I.constants(sim.masses3, 310.0, 1.0, overdamped=False)
    fj = np.asarray(jb(jnp.asarray(x), 0.004, jsig, None))
    ft = tb(torch.as_tensor(x), 0.004, tsig, None).numpy()
    assert np.abs(ft - fj).max() / np.abs(fj).max() < 5e-5

    m64 = ts["model"].double()
    z = torch.as_tensor(x).double().requires_grad_(True)
    X = z.reshape(10, 22, 3)
    i, j = np.triu_indices(22, 1)
    chi = m64(torch.sqrt(((X[:, i] - X[:, j]) ** 2).sum(-1)))[:, 0]
    lam = math.exp(ts["qrate"] * (ts["Tmax"] - 0.004))
    psi = torch.clamp(lam * (chi - ts["b"]) + ts["b"], min=I.PSI_FLOOR)
    (g,) = torch.autograd.grad(torch.log(psi).sum(), z)
    f64 = (0.5 * tsig.double() * g).numpy()
    assert np.abs(ft - f64).max() / np.abs(f64).max() < 5e-5


def test_optcontrol_raises_domain_error_on_non_contracting_fit(sim):
    """Kchi = 0.1 - 0.5 chi (lambda < 0): both packages raise."""
    chi = np.linspace(0.0, 1.0, 12)[:, None].astype(np.float32)
    kchi = (0.1 - 0.5 * chi).astype(np.float32)
    fake_j = SimpleNamespace(data=SimpleNamespace(sim=SimpleNamespace(
        lagtime=0.2)), chis=lambda: chi, koopman=lambda: kchi)
    fake_t = SimpleNamespace(data=SimpleNamespace(sim=sim),
                             chis=lambda: torch.as_tensor(chi),
                             koopman=lambda: torch.as_tensor(kchi))
    with pytest.raises(itk.DomainError):
        JI.optcontrol(fake_j)
    with pytest.raises(itt.DomainError):
        itt.optcontrol(fake_t)


# ---- Girsanov martingale -------------------------------------------------

@pytest.mark.parametrize("path", ["integrator", "kernel_plain"])
def test_girsanov_weights_are_a_martingale(sim, tmodel, path):
    """E[w] = 1 within 4 standard errors with noise, for ABOBA under a
    smooth bias (as tests/test_girsanov_stats.py checks the JAX
    integrator) and for the kernel's plain version under a pairnet chi
    bias.  The band is a valid test only while the log-weights' variance
    stays near 1 or below: this untrained chi is steep, and at forcescale
    0.5 its 20 steps give var(logw) ~ 42, where 512 samples cannot
    estimate E[w] at all; forcescale 0.05 gives ~ 0.3."""
    n, nsteps = 512, 20
    x0 = sim.coords[None, :].repeat(n, 1)
    gen = itt.make_generator(3)
    p0 = sim.random_velocities(gen, x0.shape) * sim.masses3
    if path == "integrator":
        _, _, logw = I.aboba_girsanov(
            lambda z: LK.forces(sim.plan, z),
            lambda q, t, sigma, F: 0.05 * torch.tanh(q), x0, p0,
            sim.masses3, sim.temp, sim.friction, sim.step, nsteps, gen)
    else:
        plan = GK.GirsanovPlan.for_model(sim.plan, tmodel, 0.05)
        _, _, logw = GK.aboba_girsanov(plan, tmodel, x0, p0, nsteps, 0.4,
                                       -2.0, nsteps * sim.step, gen)
    w = np.exp(logw.double().numpy())
    assert np.all(np.isfinite(w))
    assert 1e-3 < float(logw.var()) < 1.0     # the bias acts, weights live
    z = (w.mean() - 1.0) / (w.std(ddof=1) / np.sqrt(w.size))
    assert abs(z) < 4.0, f"E[w]={w.mean():.4f}, z={z:.2f}"


# ---- weighted samples, KDE resampling, weighted training -----------------

def test_weighted_samples_match_jax():
    """ESS, the weighted Koopman expectation and the mixed lastcat (plain
    rows get weight 1) against the JAX package, to 1e-6."""
    rng = np.random.default_rng(9)
    vals = rng.normal(size=(6, 4, 5)).astype(np.float32)
    w = rng.uniform(0.1, 3.0, size=(6, 4)).astype(np.float32)
    plain = rng.normal(size=(3, 4, 5)).astype(np.float32)
    jws = JaxWeightedSamples(jnp.asarray(vals), jnp.asarray(w))
    tws = WeightedSamples(torch.as_tensor(vals), torch.as_tensor(w))
    np.testing.assert_allclose(tws.ess(), jws.ess(), rtol=1e-12)

    jm = jax_pairnet(n=5, key=jax.random.PRNGKey(1))
    tm = load_jax_params(itt.pairnet(5), _params_np(jm.params))
    ref = np.asarray(jax_expectation(jm, jws))
    with torch.no_grad():
        got = itt.expectation(tm, tws).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)

    for a, b in ((jws, plain), (plain, jws)):
        ref = jax_lastcat(a, b)
        ta = tws if a is jws else torch.as_tensor(a)
        tb = tws if b is jws else torch.as_tensor(b)
        got = lastcat(ta, tb)
        assert isinstance(got, WeightedSamples)
        np.testing.assert_array_equal(got.values.numpy(), ref.values)
        np.testing.assert_array_equal(got.weights.numpy(), ref.weights)


@pytest.mark.parametrize("spread", ["clustered", "uniform"])
def test_resample_kde_ash_matches_jax(spread):
    """The same chi values give the same picks as the JAX package (whose
    greedy loop may run in its native host library)."""
    rng = np.random.default_rng(11)
    if spread == "clustered":
        chix = np.concatenate([rng.normal(0.1, 0.03, 60),
                               rng.normal(0.9, 0.03, 40)]).clip(0, 1)
        chiy = rng.uniform(0.0, 1.0, 300)
    else:
        chix = rng.uniform(0.0, 1.0, 100)
        chiy = rng.uniform(-0.05, 1.05, 500)
    for n in (1, 10, 50):
        ref = jax_resample_kde_ash(chix, chiy, n)
        got = resample_kde_ash(chix, chiy, n)
        np.testing.assert_array_equal(got, ref)


def test_weighted_training_matches_jax(golden):
    """Five Koopman iterations on Girsanov-weighted bursts, shared
    features, weights and initial parameters: losses, chis and the
    weighted koopman agree to 1e-5."""
    xs, ys = golden
    w = np.random.default_rng(12).uniform(0.2, 2.0, size=ys.shape[:2])
    w = w.astype(np.float32)
    jsim = itk.MDSimulation(steps=10)
    jm = jsim.defaultmodel(n=NPAIRS, key=jax.random.PRNGKey(0))
    params0 = _params_np(jm.params)
    base = JaxData.from_coords(jsim, xs, ys)
    jfeat = (base.features, JaxWeightedSamples(base.propfeatures, w))
    jdata = JaxData.from_coords(jsim, xs, JaxWeightedSamples(ys, w),
                                features=jfeat)
    jiso = itk.Iso(data=jdata, model=jm, opt=itk.AdamRegularized(), key=0,
                   shard=False)
    jiso.run(5)

    sim = itt.MDSimulation(steps=10, device="cpu")
    tw = torch.as_tensor(w)
    data = itt.SimulationData.from_coords(
        sim, torch.as_tensor(xs), WeightedSamples(torch.as_tensor(ys), tw),
        features=(torch.tensor(np.asarray(base.features)),
                  WeightedSamples(torch.tensor(np.asarray(
                      base.propfeatures)), tw)))
    tm = load_jax_params(sim.defaultmodel(n=NPAIRS), params0)
    iso = itt.Iso(data=data, model=tm, opt=itt.AdamRegularized(), gen=0)
    iso.run(5)
    np.testing.assert_allclose(iso.losses, jiso.losses, rtol=1e-5, atol=0)
    np.testing.assert_allclose(iso.chis().numpy(), np.asarray(jiso.chis()),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(iso.koopman().numpy(),
                               np.asarray(jiso.koopman()), rtol=1e-5, atol=0)


def test_simulation_data_slicing_and_merge_keep_weights(sim, golden):
    xs, ys = golden
    w = torch.rand(ys.shape[:2], generator=itt.make_generator(0))
    d1 = itt.SimulationData.from_coords(sim, torch.as_tensor(xs[:4]),
                                        torch.as_tensor(ys[:4]))
    d2 = itt.SimulationData.from_coords(
        sim, torch.as_tensor(xs[4:10]),
        WeightedSamples(torch.as_tensor(ys[4:10]), w[4:10]))
    assert isinstance(d2.propfeatures, WeightedSamples)
    assert d2.propfeatures.values.shape == (6, 5, NPAIRS)
    m = itt.data.mergedata(d1, d2)
    assert len(m) == 10 and m.nk == 5
    assert isinstance(m.propfeatures, WeightedSamples)
    assert torch.equal(m.propfeatures.weights[:4], torch.ones(4, 5))
    assert torch.equal(m.propfeatures.weights[4:], w[4:10])
    tail = m[7:]
    assert len(tail) == 3
    assert torch.equal(tail.propcoords.weights, w[7:10])
    assert torch.equal(m[0].coords, m.coords[:1])


# ---- MDSimulation with a bias, the workflow, dispatch --------------------

@pytest.fixture(scope="module")
def trained_md():
    sim = itt.MDSimulation(steps=10, device="cpu")
    iso = itt.Iso(sim=sim, nx=8, nk=2, opt=itt.AdamRegularized(), gen=0)
    iso.run(20)
    return sim, iso


def test_biased_propagate_returns_weighted_samples(trained_md):
    sim, iso = trained_md
    bias = itt.optcontrol(iso, forcescale=0.5)
    assert sim.bias is None
    sim.bias = bias
    try:
        assert sim.kernel_takes_bias()
        ys = sim.propagate(iso.data.coords[:3], 2, gen=4)
    finally:
        sim.bias = None
    assert isinstance(ys, WeightedSamples)
    assert ys.values.shape == (3, 2, 66) and ys.weights.shape == (3, 2)
    assert bool(torch.isfinite(ys.values).all())
    assert bool(torch.isfinite(ys.weights).all())
    assert bool((ys.weights > 0).all())
    assert not torch.equal(ys.weights, torch.ones(3, 2))
    # a biased trajectory: the frames and their running Girsanov weights
    sim.bias = bias
    try:
        tr = sim.trajectory(steps=2, gen=5)
    finally:
        sim.bias = None
    assert isinstance(tr, WeightedSamples)
    assert tr.values.shape == (2, 66) and tr.weights.shape == (2,)
    assert bool(torch.isfinite(tr.values).all())
    assert bool((tr.weights > 0).all())


def test_run_girsanov_workflow_trains(trained_md):
    """Two generations of 4 KDE-picked start points under the refreshed
    bias: telemetry rows, weighted propfeatures with finite weights, a
    grown dataset, the bias restored afterwards."""
    _, iso0 = trained_md
    sim = itt.MDSimulation(steps=10, device="cpu")
    data = itt.SimulationData(sim, iso0.data.features, iso0.data.propfeatures,
                              iso0.data.coords, iso0.data.propcoords,
                              iso0.data.featurizer)
    model = itt.pairnet(NPAIRS)
    model.load_state_dict(iso0.model.state_dict())
    iso = itt.Iso(data=data, model=model, opt=itt.AdamRegularized(), gen=5)
    extra = []
    itt.run_girsanov(iso, generations=2, iter=3, kde=4, forcescale=0.5,
                     telemetry=extra)
    assert sim.bias is None
    assert len(iso.data) == 16 and len(iso.losses) == 6
    assert np.all(np.isfinite(iso.losses))
    rows = iso.girsanov_telemetry
    assert rows == extra and [r["gen"] for r in rows] == [0, 1]
    assert rows[0]["biased"] and rows[0]["n_new"] == 4
    assert 0 < rows[0]["ess"] <= 2
    pf = iso.data.propfeatures
    assert isinstance(pf, WeightedSamples)
    assert bool(torch.isfinite(pf.weights).all())
    assert torch.equal(pf.weights[:8], torch.ones(8, 2))


def test_run_kde_grows_the_data(trained_md):
    _, iso0 = trained_md
    sim = iso0.data.sim
    iso = itt.Iso(data=iso0.data, model=itt.pairnet(NPAIRS, gen=2),
                  opt=itt.AdamRegularized(), gen=6)
    iso.run_kde(generations=2, iter=2, kde=2)
    assert len(iso.data) == 12 and len(iso.losses) == 4
    assert sim.bias is None
    assert isinstance(iso.data.propfeatures, torch.Tensor)


def test_biased_dispatch_raises_off_the_cpu(trained_md, monkeypatch):
    """Off the CPU a bias gets no plain fallback in place of a kernel: a
    non-optcontrol bias runs the ABOBA recursion, whose force wrapper
    (kernel A's forces entry) raises for a tensor that is not on a CUDA
    card, and an optcontrol bias reaches the Girsanov kernel wrapper,
    which raises the same way; no launch counts."""
    sim, iso = trained_md
    x = torch.zeros(8, 66, device="meta")
    n0 = (GK.aboba_girsanov.launches, GK.chi_grad.launches,
          LK.forces.launches)
    sim.bias = lambda q, t, sigma, F: torch.zeros_like(q)
    try:
        assert sim.biased_route(x.device) == "recursion"
        # the simulation's masses where the walkers are, as on a card
        monkeypatch.setattr(sim, "masses3", sim.masses3.to(x.device))
        with pytest.raises(NotImplementedError, match="no forces kernel"):
            sim._girsanov(x, x, 2, None)
        monkeypatch.undo()
        sim.bias = itt.optcontrol(iso, forcescale=0.5)
        assert sim.biased_route(x.device) == "kernel"
        with pytest.raises(NotImplementedError):
            sim._girsanov(x, x, 2, itt.make_generator(0))
    finally:
        sim.bias = None
    plan = GK.GirsanovPlan.for_model(sim.plan, iso.model, 0.5)
    with pytest.raises(NotImplementedError):
        GK.chi_grad(plan, iso.model, torch.zeros(4, NPAIRS, device="meta"))
    with pytest.raises(NotImplementedError):
        GK.aboba_girsanov(plan, iso.model, x, x, 1, 0.5, 0.0, 0.2,
                          itt.make_generator(0))
    assert (GK.aboba_girsanov.launches, GK.chi_grad.launches,
            LK.forces.launches) == n0


def test_girsanov_plan_rejects_models_the_kernel_does_not_take(sim):
    assert not GK.takes_model(itt.pairnet(NPAIRS, nout=2), NPAIRS)
    assert not GK.takes_model(itt.pairnet(100), NPAIRS)
    assert not GK.takes_model(
        densenet([NPAIRS, 4, 1], lastactivation="sigmoid"), NPAIRS)
    with pytest.raises(ValueError):
        GK.GirsanovPlan.for_model(sim.plan, itt.pairnet(100), 1.0)


# ---- build ---------------------------------------------------------------

def test_build_hash_covers_included_headers(tmp_path):
    """An edit of a header that a source includes changes the library's
    name, so it forces a rebuild; kernels A and B both include the shared
    warp force routine."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint f();\n')
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// one\n")
    src = str(tmp_path / "k.cu")
    assert [os.path.basename(p) for p in _build._sources(src)] == \
        ["k.cu", "h.cuh", "g.cuh"]
    before = _build.digest(src)
    (tmp_path / "g.cuh").write_text("// two\n")
    assert _build.digest(src) != before
    for name in ("langevin_middle.cu", "aboba_girsanov.cu"):
        real = os.path.join(_build._PKG, "csrc", name)
        assert "warp_forces.cuh" in [os.path.basename(p)
                                     for p in _build._sources(real)], name
