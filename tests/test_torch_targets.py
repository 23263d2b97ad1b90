"""Port parity of the target transforms (``targets.py``) against the JAX
package on the CPU.  Both packages' transforms get the same stub model:
a fixed numpy sigmoid layer, so that chi(xs) and chi(ys) are the same
float32 arrays in both, as ``isotarget`` feeds them.  Tolerance 1e-5
relative to the largest entry; the stateful transforms agree over three
successive calls."""

import numpy as np
import pytest
import torch

from isokann_tpu import targets as JT
from isokann_tpu.data import WeightedSamples as JaxWeightedSamples

from isokann_tpu_torch import targets as PT
from isokann_tpu_torch.data import WeightedSamples

torch.set_num_threads(1)

N, K, F, D = 48, 6, 5, 3


def stub(seed, d=D):
    """A numpy chi model: sigmoid(z W + b), float32 (..., F) -> (..., d)."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(F, d)).astype(np.float32)
    b = rng.normal(size=d).astype(np.float32)

    def model(z):
        z = np.asarray(z, np.float32)
        return (1.0 / (1.0 + np.exp(-(z @ W + b)))).astype(np.float32)

    return model


def data(seed):
    rng = np.random.default_rng(100 + seed)
    xs = rng.normal(size=(N, F)).astype(np.float32)
    ys = (xs[:, None, :] + 0.3 * rng.normal(size=(N, K, F))).astype(np.float32)
    return xs, ys


def close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err <= tol, f"max rel err {err:.3e} > {tol}"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_indexmap_fixperm_equal(seed):
    rng = np.random.default_rng(seed)
    X = rng.random((40, 4)).astype(np.float32)
    np.testing.assert_array_equal(PT.indexmap(X), JT.indexmap(X))
    old = rng.random((40, 4))
    new = old[:, rng.permutation(4)] + 0.01 * rng.random((40, 4))
    np.testing.assert_array_equal(PT.fixperm(new, old), JT.fixperm(new, old))
    for wh in (False, True):
        close(PT.myisa(X, wh), JT.myisa(X, wh), 1e-12)


CASES = [
    ("TransformISA", {}),
    ("TransformISA", {"whitening": True}),
    ("TransformISA", {"permute": False}),
    ("TransformPseudoInv", {}),
    ("TransformPseudoInv", {"direct": False}),
    ("TransformPseudoInv", {"eigenvecs": False, "normalize": False}),
    ("TransformGramSchmidt", {}),
    ("TransformLeftRight", {}),
    ("TransformSVD", {}),
    ("TransformSVDRev", {}),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{'-'.join(k) or 'default'}"
                              for n, k in CASES])
def test_transform_matches_jax(name, kw):
    xs, ys = data(0)
    model = stub(0)
    ref = np.asarray(getattr(JT, name)(**kw)(model, xs, ys))
    got = getattr(PT, name)(**kw)(model, xs, ys)
    assert got.dtype == np.float32 and got.shape == (N, D)
    close(got, ref)


def test_isa_weighted_samples():
    xs, ys = data(1)
    w = np.random.default_rng(7).uniform(0.5, 1.5, (N, K)).astype(np.float32)
    model = stub(1)
    ref = JT.TransformISA()(model, xs, JaxWeightedSamples(ys, w))
    got = PT.TransformISA()(model, xs, WeightedSamples(ys, w))
    close(got, np.asarray(ref))


def test_isa_rejects_one_dimensional_chi():
    xs, ys = data(0)
    with pytest.raises(PT.DomainError):
        PT.TransformISA()(stub(0, d=1), xs, ys)


STATEFUL = [
    ("TransformLeftRightHistory", {"hist": 5}),
    ("TransformPinv", {"d": 3, "hist": 4}),
    ("TransformPinv", {"d": 3, "hist": 4, "fixedone": True}),
    ("TransformCross", {}),
    ("TransformCross", {"maxcols": 4}),
]


@pytest.mark.parametrize("name,kw", STATEFUL,
                         ids=[f"{n}-{'-'.join(k) or 'default'}"
                              for n, k in STATEFUL])
def test_stateful_transform_three_calls(name, kw):
    """The history state carried between iterations: the same sequence of
    inputs gives the same targets in both packages on every call."""
    jt, pt = getattr(JT, name)(**kw), getattr(PT, name)(**kw)
    for call in range(3):
        xs, ys = data(call)
        model = stub(10 + call)
        close(pt(model, xs, ys), np.asarray(jt(model, xs, ys)))


def test_stabilize_three_calls():
    js, ps = JT.Stabilize(JT.TransformISA()), PT.Stabilize(PT.TransformISA())
    j1 = JT.Stabilize(JT.TransformShiftscale())
    p1 = PT.Stabilize(PT.TransformShiftscale())
    for call in range(3):
        xs, ys = data(call)
        model = stub(20 + call)
        close(ps(model, xs, ys), np.asarray(js(model, xs, ys)))
        m1 = stub(30 + call, d=1)
        close(p1(m1, xs, ys), np.asarray(j1(m1, xs, ys)))


def test_residual_subspace_arrays():
    rng = np.random.default_rng(3)
    V = rng.random((N, D))
    KV = 0.9 * V + 0.05 * rng.random((N, D))
    for vn in (False, True):
        got = PT.residual_subspace(V, KV, V_norms=vn)
        ref = JT.residual_subspace(V, KV, V_norms=vn)
        close(got["res"], ref["res"], 1e-10)
        close(got["relres"], ref["relres"], 1e-10)


def test_rr_family():
    rng = np.random.default_rng(4)
    X = rng.random((N, D))
    Y = 0.8 * X + 0.1 * rng.random((N, D))
    for f in ("rr_svd", "rr_svd_i", "rr_svd_si", "rr_gev"):
        gv, gw = getattr(PT, f)(X, Y)
        rv, rw = getattr(JT, f)(X, Y)
        close(gv, rv, 1e-10)
        close(np.abs(gw), np.abs(rw), 1e-8)
    got, ref = PT.rr_cross(X, Y), JT.rr_cross(X, Y)
    for k in ("vals", "relres", "weights", "s"):
        close(got[k], ref[k], 1e-10)


def test_shiftscale_call_matches_jax():
    xs, ys = data(2)
    model = stub(5, d=1)
    ref = JT.TransformShiftscale()(model, xs, ys)
    got = PT.TransformShiftscale()(model, xs, ys)
    close(got.numpy(), np.asarray(ref), 1e-6)


@pytest.mark.parametrize("d", [1, 3])
def test_numpy_expectation_is_the_mean_over_k(d):
    """The host expectation sums the k rows in order (``einsum``): the
    bits of ``np.mean`` for d > 1, within float32 rounding for d = 1
    (where ``np.mean`` sums pairwise), and the JAX package's mean within
    1e-6 relative."""
    model = stub(7, d)
    ys = np.random.default_rng(8).normal(size=(N, 64, F)).astype(np.float32)
    got = PT.expectation(model, ys)
    want = np.mean(model(ys), axis=-2)
    assert got.dtype == want.dtype == np.float32
    if d > 1:
        assert np.array_equal(got, want)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    ref = np.asarray(JT.expectation(model, ys))
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_host_to_keeps_the_permutation():
    """``iso.host_to`` puts a host permutation on the device unchanged
    (on the CPU a plain copy; on the card through pinned memory)."""
    from isokann_tpu_torch.iso import host_to
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(0))
    out = host_to(perm.reshape(4, 16), torch.device("cpu"))
    assert torch.equal(out, perm.reshape(4, 16))
