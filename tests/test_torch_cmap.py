"""Port parity of CMAP torsion-torsion maps (``md/cmap.py``) and of
``system_from_tables``: the bicubic patches equal the JAX package's, the
surface is exact at the grid points, and the energy and the analytic
forces (dense and sparse paths) match autograd and the JAX package on the
JAX test's toy chain (CPU)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isokann_tpu.md import cmap as JC
from isokann_tpu.md.forces import force_flat as jax_force_flat
from isokann_tpu.md.system import system_from_tables as jax_tables

from isokann_tpu_torch.md import cmap as C
from isokann_tpu_torch.md import forces as F
from isokann_tpu_torch.md import neighbor as NB
from isokann_tpu_torch.md.system import system_from_tables

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

R = 24


def _grid(fn):
    ang = -np.pi + 2 * np.pi * np.arange(R) / R
    P, S = np.meshgrid(ang, ang, indexing="ij")
    return fn(P, S)


def _tables(grids):
    """The JAX test's 5-atom chain with CMAP terms over (0123, 1234)."""
    return dict(
        masses=[12.0] * 5, charges=[0.0] * 5, rmin_half=[0.0] * 5,
        eps=[0.0] * 5, bond_idx=[(i, i + 1) for i in range(4)],
        bond_k=[1e4] * 4, bond_r0=[0.15] * 4,
        excl_idx=[(i, j) for i in range(5) for j in range(i + 1, 5)],
        excl_qq=[0.0] * 10, excl_lj=[0.0] * 10,
        cmap_idx=[[0, 1, 2, 3, 1, 2, 3, 4]] * len(grids),
        cmap_type=list(range(len(grids))), cmap_grids=grids,
        method="NoCutoff")


def _both(grids):
    t = _tables(grids)
    return jax_tables(**t), system_from_tables(device="cpu", **t)


def _chain(phi, psi):
    """5 atoms with torsion(0123) = phi and torsion(1234) = psi (NeRF,
    bonds 0.15 nm, angles 109.5 degrees), float32 (5, 3)."""
    b, theta = 0.15, math.radians(109.5)
    pts = [np.array([0.0, 0.0, 0.0]), np.array([b, 0.0, 0.0]),
           np.array([b + b * math.cos(math.pi - theta),
                     b * math.sin(math.pi - theta), 0.0])]
    for tor in (phi, psi):
        p1, p2, p3 = pts[-3], pts[-2], pts[-1]
        e1 = (p3 - p2) / np.linalg.norm(p3 - p2)
        nrm = np.cross(p2 - p1, e1)
        nrm /= np.linalg.norm(nrm)
        m = np.cross(nrm, e1)
        pts.append(p3 - b * math.cos(theta) * e1
                   + b * math.sin(theta) * (math.cos(tor) * m
                                            - math.sin(tor) * nrm))
    return np.stack(pts).astype(np.float32)


SMOOTH = [lambda p, s: 3.0 * np.cos(p) + 2.0 * np.sin(s)
          + 1.5 * np.cos(p + s),
          lambda p, s: 2.0 * np.cos(p) * np.sin(s),
          lambda p, s: 1.7 * np.cos(2 * p) * np.cos(s)]


@pytest.mark.parametrize("fn", SMOOTH)
def test_patches_and_tables_match_jax(fn):
    """The float64 patches equal the JAX package's to rounding, and every
    table of system_from_tables equals its counterpart."""
    g = _grid(fn)
    np.testing.assert_allclose(C.bicubic_coefs(g), JC.bicubic_coefs(g),
                               rtol=1e-13, atol=1e-13)
    js, ts = _both([g])
    for name in ("bond_idx", "excl_idx", "cmap_idx", "cmap_type"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    for name in ("bond_k", "bond_r0", "excl_qq", "masses", "qq_scale",
                 "cmap_coefs"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), rtol=1e-7)
    assert ts.method == js.method and ts.dense_pairs == js.dense_pairs


def test_chain_coords_hit_requested_torsions():
    x = torch.as_tensor(_chain(0.7, -1.9))[None]
    phi, _ = F.torsions(x, *torch.tensor([0, 1, 2, 3])[:, None])
    psi, _ = F.torsions(x, *torch.tensor([1, 2, 3, 4])[:, None])
    assert abs(float(phi) - 0.7) < 1e-5 and abs(float(psi) + 1.9) < 1e-5


def test_bicubic_exact_at_grid_points_and_accurate_between():
    """Exact (1e-4 kJ/mol) at the grid points, within 0.02 between them on
    a smooth surface (the JAX test's bounds), and equal to the JAX
    package's energy to 1e-5."""
    grid = _grid(SMOOTH[0])
    js, ts = _both([grid])
    ang = -np.pi + 2 * np.pi * np.arange(R) / R
    for (i, j) in [(0, 0), (5, 17), (23, 23), (12, 1)]:
        x = _chain(ang[i], ang[j])
        e = float(C.cmap_energy(ts, torch.as_tensor(x)[None])[0])
        assert abs(e - grid[i, j]) < 1e-4, (i, j)
    rng = np.random.default_rng(0)
    for _ in range(10):
        phi, psi = rng.uniform(-np.pi, np.pi, 2)
        x = _chain(phi, psi)
        e = float(C.cmap_energy(ts, torch.as_tensor(x)[None])[0])
        assert abs(e - SMOOTH[0](phi, psi)) < 0.02
        assert abs(e - float(JC.cmap_energy(js, jnp.asarray(x)))) < 1e-5


@pytest.mark.parametrize("fn", SMOOTH[1:])
def test_cmap_force_matches_autograd_and_jax(fn):
    """The analytic forces equal autograd of the energy and the JAX
    package's cmap_force, each within 1e-5 of the largest component (the
    JAX test's 1e-5 relative; float32 leaves ~1e-6 kJ/mol/nm on the
    components that vanish); net force zero."""
    js, ts = _both([_grid(fn)])
    for phi, psi in ((0.43, 2.11), (-2.9, 0.05), (1.1, -0.4)):
        x = _chain(phi, psi)
        f = C.cmap_force(ts, torch.as_tensor(x)[None])[0].numpy()
        xg = torch.as_tensor(x)[None].requires_grad_(True)
        (g,) = torch.autograd.grad(C.cmap_energy(ts, xg).sum(), xg)
        assert np.abs(f + g[0].numpy()).max() <= 1e-5 * np.abs(f).max()
        fj = np.asarray(JC.cmap_force(js, jnp.asarray(x)))
        assert np.abs(f - fj).max() <= 1e-5 * np.abs(fj).max()
        np.testing.assert_allclose(f.sum(0), 0.0, atol=1e-4)


def test_cmap_in_full_energy_terms_and_forces():
    """energy_terms carries the term; force_flat (autograd) and the
    sparse analytic bonded forces both include its gradient and match the
    JAX package's force_flat (1e-4, the JAX test's bound)."""
    js, ts = _both([_grid(lambda p, s: np.cos(p) + np.cos(s)),
                    _grid(lambda p, s: 0.3 * np.sin(p - s))])
    x = _chain(0.3, 0.9)
    terms = F.energy_terms(ts, torch.as_tensor(x))
    assert abs(float(terms["cmap"]) - float(JC.cmap_energy(
        js, jnp.asarray(x)))) < 1e-5
    fj = np.asarray(jax_force_flat(js, jnp.asarray(x.reshape(-1))))
    f = F.force_flat(ts, torch.as_tensor(x.reshape(1, -1)))[0].numpy()
    np.testing.assert_allclose(f, fj, rtol=1e-4, atol=1e-4)
    fs = NB.bonded_force_sparse(ts, torch.as_tensor(x)[None])[0].numpy()
    np.testing.assert_allclose(fs.reshape(-1), fj, rtol=1e-4, atol=1e-4)
    e = float(F.bonded_energy(ts, torch.as_tensor(x)[None])[0])
    e0 = float(F.bonded_energy(_both([np.zeros((R, R))] * 2)[1],
                               torch.as_tensor(x)[None])[0])
    assert abs((e - e0) - float(terms["cmap"])) < 1e-4
