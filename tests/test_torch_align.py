"""The port's ``ops/align.py`` against the JAX package's on the CPU, in
float32, mirroring ``tests/test_ops.py``'s alignment tests; every
comparison at 1e-5 nm unless stated."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from isokann_tpu_torch.ops import align as TA

JA = importlib.import_module("isokann_tpu.ops.align")

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

TOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _structs(seed, n=20, natoms=9, scale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(natoms, 3)).astype(np.float32)
    ys = (x[None] + scale * rng.normal(size=(n, natoms, 3))).astype(
        np.float32)
    w = rng.uniform(0.5, 2.0, size=natoms).astype(np.float32)
    return x, ys, w


@pytest.mark.parametrize("weighted", [False, True])
def test_centered_kabsch_align_match_jax(weighted):
    x, ys, w = _structs(0)
    wj, wt = (jnp.asarray(w), _t(w)) if weighted else (None, None)
    np.testing.assert_allclose(TA.centered(_t(ys), wt).numpy(),
                               np.asarray(JA.centered(jnp.asarray(ys), wj)),
                               atol=TOL)
    xc, yc = JA.centered(jnp.asarray(x), wj), JA.centered(jnp.asarray(ys), wj)
    r_t = TA.kabsch_rotation(_t(np.asarray(xc)), _t(np.asarray(yc)), wt)
    np.testing.assert_allclose(r_t.numpy(),
                               np.asarray(JA.kabsch_rotation(xc, yc, wj)),
                               atol=TOL)
    for flat in (True, False):
        xa = x.ravel() if flat else x
        ya = ys.reshape(len(ys), -1) if flat else ys
        got = TA.align(_t(xa), _t(ya), weights=wt, flat=flat).numpy()
        ref = np.asarray(JA.align(jnp.asarray(xa), jnp.asarray(ya),
                                  weights=wj, flat=flat))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_aligned_rmsd_and_qcp_match_jax(weighted):
    x, ys, w = _structs(1, n=50)
    wj, wt = (jnp.asarray(w), _t(w)) if weighted else (None, None)
    got = TA.aligned_rmsd(_t(x), _t(ys), weights=wt, flat=False).numpy()
    ref = np.asarray(JA.aligned_rmsd(jnp.asarray(x), jnp.asarray(ys),
                                     weights=wj, flat=False))
    np.testing.assert_allclose(got, ref, atol=TOL)
    one = TA.aligned_rmsd_one_to_many(_t(x.ravel()),
                                      _t(ys.reshape(len(ys), -1)), wt)
    np.testing.assert_allclose(one.numpy(), ref, atol=TOL)
    # the QCP pieces themselves, on the same correlation matrices
    h = np.einsum("ni,bnj->bij", x - x.mean(0), ys - ys.mean(1,
                                                         keepdims=True))
    ga = np.full(len(ys), float(((x - x.mean(0)) ** 2).sum()), np.float32)
    gb = ((ys - ys.mean(1, keepdims=True)) ** 2).sum(axis=(1, 2))
    args_j = [jnp.asarray(a, jnp.float32) for a in (h, ga, gb)]
    args_t = [_t(a) for a in (h, ga, gb)]
    lam_j = np.asarray(JA._qcp_lambda_max(*args_j))
    np.testing.assert_allclose(TA._qcp_lambda_max(*args_t).numpy(), lam_j,
                               rtol=1e-5)
    np.testing.assert_allclose(TA._qcp_rotation(*args_t).numpy(),
                               np.asarray(JA._qcp_rotation(*args_j)),
                               atol=TOL)


def test_aligned_rmsd_zero_for_rotated_copy():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(6, 3))
    R = Rotation.random(random_state=6).as_matrix()
    y = (x - x.mean(0)) @ R.T + 3.0
    d = TA.aligned_rmsd(_t(x.ravel()), _t(y.ravel()[None, :]))
    ref = JA.aligned_rmsd(jnp.asarray(x.ravel(), jnp.float32),
                          jnp.asarray(y.ravel()[None, :], jnp.float32))
    assert float(d[0]) < 1e-4
    assert abs(float(d[0]) - float(ref[0])) < TOL
    # and align puts the copy back onto x
    a = TA.align(_t(x.ravel()), _t(y.ravel()[None, :])).numpy()
    np.testing.assert_allclose(a.reshape(6, 3), x, atol=1e-4)


def test_no_reflection():
    """A mirror image is not a rotation: its RMSD stays large, as in the
    JAX package (both take the maximum over proper rotations)."""
    rng = np.random.default_rng(23)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    x -= x.mean(0)
    y = x.copy()
    y[:, 2] *= -1.0
    d = float(TA.aligned_rmsd(_t(x), _t(y[None]), flat=False)[0])
    ref = float(JA.aligned_rmsd(jnp.asarray(x), jnp.asarray(y[None]),
                                flat=False)[0])
    assert d > 0.1
    assert abs(d - ref) < TOL
    r = TA.kabsch_rotation(_t(x), _t(y))
    assert abs(float(torch.linalg.det(r)) - 1.0) < 1e-5


@pytest.mark.parametrize("masked", [False, True])
def test_pairwise_aligned_rmsd_matches_jax(masked):
    rng = np.random.default_rng(8)
    xs = rng.normal(size=(7, 15)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((7, 7), bool)
        mask[0, 2] = mask[3, 5] = mask[6, 1] = True
    # memsize: a few pairs per batch, so that the batching runs
    got = TA.pairwise_aligned_rmsd(_t(xs), mask=mask, memsize=400)
    ref = JA.pairwise_aligned_rmsd(jnp.asarray(xs), mask=mask)
    assert got.shape == (7, 7) and got.dtype == np.float64
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, atol=TOL, equal_nan=True)
    if masked:
        assert np.isfinite(got[0, 2]) and np.isfinite(got[2, 0])
        assert np.isnan(got[0, 1])
    else:
        assert np.allclose(np.diag(got), 0.0)
        np.testing.assert_allclose(got, got.T, atol=1e-6)


def _trajectory(seed, T, natoms=22):
    """A drifting structure, each frame under a random rotation and
    shift (alanine's size: 22 atoms, ~0.6 nm across)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.2, size=(natoms, 3))
    frames = []
    for t in range(T):
        x = x + rng.normal(scale=0.005, size=x.shape)
        R = Rotation.random(random_state=seed * 10_000 + t).as_matrix()
        frames.append((x @ R.T + rng.normal(size=3)).ravel())
    return np.asarray(frames, np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_aligntrajectory_matches_jax_scan(weighted):
    """T = 600: the batched Kabsch and log-depth running product against
    JAX's sequential scan at 1e-5 nm, and against a float64 sequential
    scan of the port's own ``align`` at 1e-6 nm, closer to it than the
    JAX scan's float32 rotations come."""
    T = 600
    traj = _trajectory(3, T)
    w = np.random.default_rng(4).uniform(0.5, 2.0, 22).astype(np.float32)
    wj, wt = (jnp.asarray(w), _t(w)) if weighted else (None, None)
    got = TA.aligntrajectory(_t(traj), wt).numpy()
    ref = np.asarray(JA.aligntrajectory(jnp.asarray(traj), wj))
    assert got.shape == (T, 66) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=TOL)
    w64 = None if wt is None else wt.double()
    prev = TA.centered(torch.as_tensor(traj[0], dtype=torch.float64)
                       .reshape(-1, 3), w64).reshape(-1)
    seq = [prev]
    for t in range(1, T):
        prev = TA.align(prev, torch.as_tensor(traj[t], dtype=torch.float64),
                        weights=w64)
        seq.append(prev)
    seq = torch.stack(seq).numpy()
    np.testing.assert_allclose(got, seq, atol=1e-6)
    assert np.abs(got - seq).max() < np.abs(ref - seq).max()


def test_aligntrajectory_short():
    traj = _trajectory(5, 3)
    for t in (traj[:1], traj[:2], traj):
        np.testing.assert_allclose(
            TA.aligntrajectory(_t(t)).numpy(),
            np.asarray(JA.aligntrajectory(jnp.asarray(t))), atol=TOL)
