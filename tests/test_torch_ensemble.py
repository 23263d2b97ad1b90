"""The port's chi ensemble (``isokann_tpu_torch.ensemble``) against the
JAX package's (``isokann_tpu.ensemble``) on the CPU, on the JAX test's
Doublewell (sigma 1, nx 64, nk 4, 5 members): the capacity bucket (64)
fits one minibatch (100), so training is full batch and deterministic.
From the JAX ensemble's initial stacked parameters, carried across, the
losses and the members' chi agree to 1e-4 after 120 iterations, on plain
and on Girsanov-weighted bursts; the alignment flips the same members and
``resample_uncertainty`` picks the same start points."""

import copy

import jax
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.data import SimulationData as JaxData
from isokann_tpu.data import WeightedSamples as JaxWeightedSamples
from isokann_tpu.ensemble import ChiEnsemble as JaxChiEnsemble
from isokann_tpu.ensemble import \
    resample_uncertainty as jax_resample_uncertainty

import isokann_tpu_torch as itt
from isokann_tpu_torch.data import WeightedSamples, bucket_capacity
from isokann_tpu_torch.ensemble import (ChiEnsemble, StackedMLP,
                                        resample_uncertainty)
from isokann_tpu_torch.targets import DomainError
from isokann_tpu_torch.weights import load_jax_ensemble_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

E, ITERS = 5, 120
XS = np.linspace(-1.3, 1.3, 101, dtype=np.float32)[:, None]


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _pair(weighted, nx=64, minibatch=100):
    """A JAX Iso and its twin in the port on the same data (with the same
    random Girsanov weights when ``weighted``)."""
    jsim = itk.Doublewell(sigma=1.0)
    base = itk.Iso(sim=jsim, nx=nx, nk=4, key=0, opt=itk.AdamRegularized(),
                   minibatch=minibatch)
    xs = np.asarray(base.data.coords)
    ys = np.asarray(base.data.propcoords)
    w = None
    if weighted:
        w = np.random.default_rng(5).uniform(0.3, 1.7, size=ys.shape[:2])
        w = w.astype(np.float32)
        jdata = JaxData.from_coords(jsim, xs, JaxWeightedSamples(ys, w),
                                    features=(xs, JaxWeightedSamples(ys, w)))
        jiso = itk.Iso(data=jdata, opt=itk.AdamRegularized(), key=0,
                       minibatch=minibatch)
    else:
        jiso = base
    tsim = itt.Doublewell(device="cpu")
    tys = torch.tensor(ys)
    if weighted:
        tys = WeightedSamples(tys, torch.tensor(w))
    tdata = itt.SimulationData.from_coords(tsim, torch.tensor(xs), tys)
    tiso = itt.Iso(data=tdata, opt=itt.AdamRegularized(), gen=0,
                   minibatch=minibatch)
    return jiso, tiso


def _jax_permutations(jens, n, cap):
    """The bucket permutations JAX's next ``jens.run(n)`` draws, one (E,
    cap) array an iteration: the run splits a key a member from
    the ensemble's key, each member's fused run a key an iteration, and
    each iteration's epoch permutes the bucket with it
    (``isokann_tpu/iso.py:101``)."""
    _, sub = jax.random.split(jens.key)
    keys = [jax.random.split(k, n)
            for k in jax.random.split(sub, jens.n_members)]
    return [torch.as_tensor(np.stack([np.asarray(jax.random.permutation(
        jax.random.split(k[i], 1)[0], cap)) for k in keys]))
        for i in range(n)]


def _load_member(ens, e, model):
    """Make member ``e`` of ``ens`` a copy of ``model``'s parameters."""
    with torch.no_grad():
        for i, layer in enumerate(model.layers):
            ens.model.weights[i][e].copy_(layer.weight.T)
            ens.model.biases[i][e, 0].copy_(layer.bias)
        if ens.model.layernorm:
            ens.model.gamma[e, 0].copy_(model.ln.weight)
            ens.model.beta[e, 0].copy_(model.ln.bias)


def _minibatch_pair(jiso, tiso, n_members, n):
    """Both ensembles after ``n`` iterations from the same initial stacked
    parameters, the port's members fed the permutations JAX draws."""
    jens = JaxChiEnsemble(jiso, n_members=n_members, key=7)
    tens = ChiEnsemble(tiso, n_members=n_members, gen=0)
    load_jax_ensemble_params(tens, _np_tree(jens.params))
    cap = bucket_capacity(len(tiso.data))
    perms = iter(_jax_permutations(jens, n, cap))

    def permutations(c):
        assert c == cap
        return next(perms)

    tens._permutations = permutations
    jens.run(n)
    tens.run(n)
    return jens, tens


@pytest.fixture(scope="module", params=["plain", "weighted"])
def trained(request):
    """Both ensembles after ``ITERS`` iterations from the same initial
    stacked parameters."""
    jiso, tiso = _pair(request.param == "weighted")
    jens = JaxChiEnsemble(jiso, n_members=E, key=7)
    params0 = _np_tree(jens.params)
    jens.run(ITERS)
    tens = ChiEnsemble(tiso, n_members=E, gen=0)
    load_jax_ensemble_params(tens, params0)
    tens.run(ITERS)
    return jiso, jens, tiso, tens


def test_losses_and_members_match_jax(trained):
    """Losses (120, 5) and every member's chi at the start points and on
    a grid agree to 1e-4 (float32, 120 Adam steps; chi ends ~3e-6 apart).

    On the weighted bursts one iteration (48, member 2) is ill
    conditioned: the shift-scale target's range shrinks, that member's
    loss jumps from 0.33 to 0.49 and the two packages' float32 roundings
    part by 1.5e-4 for that iteration (2e-6 before and after).  The
    losses there are held to 1e-4 plus 1e-3 of the loss."""
    _, jens, tiso, tens = trained
    lj, lt = np.asarray(jens.losses), np.asarray(tens.losses)
    assert lt.shape == lj.shape == (ITERS, E)
    assert np.all(np.isfinite(lt)) and tens.finite_members.all()
    weighted = isinstance(tiso.data.propfeatures, WeightedSamples)
    np.testing.assert_allclose(lt, lj, rtol=1e-3 if weighted else 0,
                               atol=1e-4)
    for xs in (None, XS):
        cj = jens.chi_members(None if xs is None else jax.numpy.asarray(xs))
        ct = tens.chi_members(xs).numpy()
        assert ct.shape == cj.shape
        np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tens.chi_mean(XS).numpy(),
                               np.asarray(jens.chi_mean(XS)), atol=1e-4)
    np.testing.assert_allclose(tens.chi_std(XS).numpy(),
                               np.asarray(jens.chi_std(XS)), atol=1e-4)
    # every member learns: late losses below early ones (the JAX test's
    # bar, tests/test_ensemble.py:28-34)
    assert np.all(lt[-10:].mean(axis=0) < lt[:10].mean(axis=0))


def test_alignment_flips_the_members_jax_flips(trained):
    _, jens, _, tens = trained

    def flips(raw, aligned):
        return [not np.allclose(a, r, atol=1e-7)
                for a, r in zip(aligned[:, :, 0], raw[:, :, 0])]

    fj = flips(jens.chi_members(aligned=False), jens.chi_members())
    ft = flips(tens.chi_members(aligned=False).numpy(),
               tens.chi_members().numpy())
    assert ft == fj
    raw = tens.chi_members(aligned=False).numpy()[:, :, 0]
    aligned = tens.chi_members().numpy()[:, :, 0]
    for e in range(E):
        assert (np.allclose(aligned[e], raw[e], atol=1e-7)
                or np.allclose(aligned[e], 1.0 - raw[e], atol=1e-7))
    assert np.all(np.corrcoef(aligned) > 0.9)


def test_resample_uncertainty_picks_match_jax(trained):
    """``explore=0``: the same top start points by chi_std; with
    ``explore`` the count holds and the top picks stay."""
    jiso, jens, tiso, tens = trained
    j2, t2 = copy.copy(jiso), copy.copy(tiso)
    n0 = len(t2.data)
    jax_resample_uncertainty(j2, jens, ny=6, key=3)
    resample_uncertainty(t2, tens, ny=6, gen=3)
    assert len(t2.data) == len(j2.data) == n0 + 6
    pj = np.sort(np.asarray(j2.data.coords)[n0:, 0])
    pt = np.sort(t2.data.coords[n0:, 0].numpy())
    np.testing.assert_array_equal(pt, pj)
    assert len(tiso.data) == n0
    t3 = copy.copy(tiso)
    resample_uncertainty(t3, tens, ny=6, explore=0.5, gen=4)
    assert len(t3.data) == n0 + 6
    top = np.argsort(-tens.chi_std().numpy()[:, 0])[:3]
    assert set(tiso.data.coords[top, 0].tolist()) <= set(
        t3.data.coords[n0:, 0].tolist())


@pytest.mark.parametrize("opt", ["adam", "nesterov"])
def test_stacked_optimizer_equals_per_member(opt):
    """One optimiser over stacked (E, ...) tensors steps each member
    exactly as its own optimiser does, bit for bit, given the same
    gradients (Adam and SGD with coupled weight decay act element by
    element)."""
    recipe = (itt.AdamRegularized() if opt == "adam"
              else itt.NesterovRegularized())
    g = torch.Generator().manual_seed(0)
    stacked = torch.nn.Parameter(torch.randn(3, 4, 5, generator=g))
    single = [torch.nn.Parameter(stacked.detach()[e].clone())
              for e in range(3)]
    o_st = recipe([stacked])
    o_si = [recipe([p]) for p in single]
    for _ in range(6):
        grad = torch.randn(3, 4, 5, generator=g)
        stacked.grad = grad.clone()
        o_st.step()
        for e in range(3):
            single[e].grad = grad[e].clone()
            o_si[e].step()
    for e in range(3):
        assert torch.equal(stacked.detach()[e], single[e].detach())


def test_member_run_equals_iso_run():
    """A member loaded with an Iso's initial weights reproduces that
    Iso's own run (its own Adam): 1e-12 in float64 over 40 iterations.
    (In float32 the member's batched product and the Iso's ``Linear``
    round differently, and Adam's first steps, g / |g| for the smallest
    gradients, carry that to ~1e-5 in the loss.)"""
    _, tiso = _pair(False)
    d = tiso.data
    data = itt.SimulationData(d.sim, d.features.double(),
                              d.propfeatures.double(), d.coords.double(),
                              d.propcoords.double(), d.featurizer)
    m0 = copy.deepcopy(tiso.model).double()
    iso = itt.Iso(data=data, model=copy.deepcopy(m0),
                  opt=itt.AdamRegularized(), gen=0)
    ens = ChiEnsemble(iso, n_members=3, gen=2)
    assert ens.model.weights[0].dtype == torch.float64
    _load_member(ens, 1, m0)
    ens.run(40)
    iso.run(40)
    np.testing.assert_allclose(np.asarray(ens.losses)[:, 1], iso.losses,
                               rtol=0, atol=1e-12)
    x = torch.tensor(XS, dtype=torch.float64)
    with torch.no_grad():
        np.testing.assert_allclose(ens.model(x)[1].numpy(),
                                   iso.model(x).numpy(), atol=1e-12)


@pytest.mark.parametrize("layernorm", [False, True])
def test_stacked_forward_equals_members(layernorm):
    """The stacked forward pass on shared and on per-member inputs equals
    each member's ``MLP``; the members are drawn as E MLPs in turn."""
    spec = itt.densenet([7, 5, 3, 1], layernorm=layernorm)
    model = StackedMLP(spec, 4, gen=3)
    gen = itt.make_generator(3)
    drawn = [itt.MLP(spec.sizes, layernorm=layernorm, gen=gen)
             for _ in range(4)]
    x = torch.randn(11, 7, generator=torch.Generator().manual_seed(0))
    xe = torch.randn(4, 11, 7, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        if layernorm:
            # distinct per-member LayerNorm affines
            for e in range(4):
                model.gamma[e].add_(0.1 * (e + 1))
                model.beta[e].sub_(0.05 * e)
                drawn[e].ln.weight.copy_(model.gamma[e, 0])
                drawn[e].ln.bias.copy_(model.beta[e, 0])
        shared, per = model(x), model(xe)
        for e in range(4):
            torch.testing.assert_close(shared[e], drawn[e](x), atol=1e-6,
                                       rtol=0)
            torch.testing.assert_close(per[e], drawn[e](xe[e]), atol=1e-6,
                                       rtol=0)


def test_minibatch_permutation_is_per_member():
    """Above one minibatch (nx 100: bucket 128, minibatch 100) each member
    draws its own permutation: two identical members part after the
    first iteration; in full batch they stay equal bit for bit."""
    sim = itt.Doublewell(device="cpu")
    for nx, same in ((100, False), (64, True)):
        iso = itt.Iso(sim=sim, nx=nx, nk=4, gen=0,
                      opt=itt.AdamRegularized())
        ens = ChiEnsemble(iso, n_members=2, gen=1)
        with torch.no_grad():
            for p in ens.model.parameters():
                p[1] = p[0]
        ens.run(3)
        losses = np.asarray(ens.losses)
        assert np.all(np.isfinite(losses))
        assert (losses[:, 0] == losses[:, 1]).all() == same


@pytest.mark.parametrize("nx,minibatch", [(100, 100), (64, 16)])
def test_minibatch_members_match_jax(nx, minibatch):
    """Above one minibatch (nx 100: bucket 128, minibatch 100, as the
    quickstart on the card; nx 64 in 4 minibatches of 16) each member,
    given the permutations the JAX ensemble draws, trains as the JAX
    member does: losses and chi within 1e-4 after 60 iterations."""
    jiso, tiso = _pair(False, nx=nx, minibatch=minibatch)
    jens, tens = _minibatch_pair(jiso, tiso, E, 60)
    lj, lt = np.asarray(jens.losses), np.asarray(tens.losses)
    assert lt.shape == lj.shape == (60, E) and np.all(np.isfinite(lt))
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tens.chi_members(XS).numpy(),
                               jens.chi_members(jax.numpy.asarray(XS)),
                               rtol=0, atol=1e-4)


def test_alanine_members_match_jax():
    """At the quickstart's alanine shape (nx 100, nk 5, 231 pair-distance
    features, 231 -> 38 -> 6 -> 1; bucket 128, minibatch 100) 8 members,
    given the JAX ensemble's initial parameters and permutations, follow
    the JAX members for 100 iterations: losses and chi within 1e-4, and
    the aligned members' correlations within 1e-3.  The data are the
    port's CPU bursts (100 steps), handed to both.  The aligned pairwise
    correlations that both print are the members' agreement at this
    shape."""
    sim = itt.MDSimulation(steps=100, device="cpu")
    data = itt.SimulationData.from_sim(sim, nx=100, nk=5,
                                       gen=itt.make_generator(0))
    fx, fy = data.features.numpy(), data.propfeatures.numpy()
    jdata = JaxData.from_coords(None, data.coords.numpy(),
                                data.propcoords.numpy(), features=(fx, fy))
    jiso = itk.Iso(data=jdata, model=itk.models.autonet(
        fx.shape[1], key=jax.random.PRNGKey(1)), opt=itk.AdamRegularized(),
        key=0)
    tiso = itt.Iso(data=data, model=sim.defaultmodel(n=fx.shape[1], gen=1),
                   opt=itt.AdamRegularized(), gen=0)
    assert tiso.model.sizes == jiso.model.sizes == (231, 38, 6, 1)
    jens, tens = _minibatch_pair(jiso, tiso, 8, 100)
    lj, lt = np.asarray(jens.losses), np.asarray(tens.losses)
    assert lt.shape == (100, 8) and np.all(np.isfinite(lt))
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)
    cj = jens.chi_members()[:, :, 0]
    ct = tens.chi_members().numpy()[:, :, 0]
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-4)
    rj, rt = np.corrcoef(cj), np.corrcoef(ct)
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-3)
    print(f"alanine, 8 members, run(100): aligned pairwise corr min "
          f"JAX {rj.min():.4f}, port {rt.min():.4f}")


def test_collapse_only_when_every_member_collapses():
    """A member whose weights are NaN keeps the others training (their
    losses as in a run without it) and drops out of ``chi_members``;
    ``DomainError`` only when all collapse."""
    _, tiso = _pair(False)
    ens = ChiEnsemble(tiso, n_members=3, gen=4)
    ref = ChiEnsemble(tiso, n_members=3, gen=4)
    with torch.no_grad():
        ens.model.weights[0][1].fill_(float("nan"))
    ens.run(5)
    ref.run(5)
    losses, rl = np.asarray(ens.losses), np.asarray(ref.losses)
    assert np.isnan(losses[:, 1]).all()
    np.testing.assert_allclose(losses[:, [0, 2]], rl[:, [0, 2]], rtol=0,
                               atol=1e-7)
    assert ens.finite_members.tolist() == [True, False, True]
    assert ens.chi_members(XS).shape == (2, 101, 1)
    with torch.no_grad():
        for w in ens.model.weights:
            w.fill_(float("nan"))
    with pytest.raises(DomainError, match="every ensemble member"):
        ens.run(2)


def test_ensemble_requires_fused_target():
    _, tiso = _pair(False)
    iso2 = copy.copy(tiso)
    iso2.target = itt.TransformISA()
    with pytest.raises(ValueError, match="fusable"):
        ChiEnsemble(iso2, n_members=2, gen=0)
