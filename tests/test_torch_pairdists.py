"""Pair-distance featurisation of the port against the JAX package on the
CPU: the plain versions of kernels C and C′ (``ops.pairdists_kernel``)
against the TPU kernels ``_sqpairdist_fwd_impl`` / ``_sqpairdist_bwd_impl``
run in Pallas interpret mode, C′'s tiled mirror (the CUDA kernel's order
in tensor ops) against both, ``flatpairdists`` and its gradient on both
routes, the featurizers and pair selections, the route dispatch, the
device rule of the wrappers and the bounds.  The CUDA kernels themselves
are held against the plain versions and the mirror on the card by
``chip_smoke.py``.

The JAX package runs its fused route on the CPU only when asked
(``use_pallas=True``), and its ``pallas_call`` only in interpret mode:
the tests wrap ``jax.experimental.pallas.pallas_call`` in
``functools.partial(..., interpret=True)`` with ``monkeypatch``; nothing
in the JAX package changes.  Inputs are villin HP35 (``out/villin.pdb``,
588 atoms, |x| <= 5.05 nm) with 0.01 nm of noise and random coordinates
of 130 and 520 atoms.

Tolerances: both fused routes take direct differences in float32, 1.5e-6
nm from float64 distances on villin; the Gram trick (the JAX package's
default off the TPU, and the route of both packages below 512 atoms)
cancels at |x| ~ 5 nm and is 6.4e-5 nm off, so the Gram comparisons hold
1e-4 nm."""

import functools
import os

import jax
import jax.experimental.pallas as jax_pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isokann_tpu import features as JF
from isokann_tpu.ops import dihedrals as JD
from isokann_tpu.ops import pairdists as JP

import isokann_tpu_torch as itt
from isokann_tpu_torch import features as F
from isokann_tpu_torch.md import langevin_kernel as LK
from isokann_tpu_torch.md.pdbio import read_pdb
from isokann_tpu_torch.ops import dihedrals as D
from isokann_tpu_torch.ops import pairdists as P
from isokann_tpu_torch.ops import pairdists_kernel as PK

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

VILLIN = os.path.join(os.path.dirname(__file__), "..", "out", "villin.pdb")


@pytest.fixture
def interpret(monkeypatch):
    """JAX's ``pallas_call`` in interpret mode for one test."""
    monkeypatch.setattr(jax_pallas, "pallas_call", functools.partial(
        jax_pallas.pallas_call, interpret=True))


def _coords(case, nwalkers=4):
    """(nwalkers, N, 3) float32: villin + 0.01 nm noise, or uniform random
    atoms in a 6 nm cube."""
    rng = np.random.default_rng(0)
    if case == "villin":
        x0 = read_pdb(VILLIN).coords
        x = x0[None] + rng.normal(scale=0.01, size=(nwalkers,) + x0.shape)
    else:
        x = rng.uniform(-3.0, 3.0, size=(nwalkers, int(case), 3))
    return x.astype(np.float32)


CASES = ["villin", "130", "520"]


@pytest.mark.parametrize("case", CASES)
def test_forward_plain_matches_tpu_kernel(interpret, case):
    """C's plain version against the TPU kernel: 1e-6 of the largest
    squared distance (both round per operation in float32; XLA's CPU code
    contracts some of them)."""
    x = _coords(case)
    ref = np.asarray(JP._sqpairdist_fwd_impl(jnp.asarray(x)))
    got = PK.sqpairdist_fwd(torch.as_tensor(x)).numpy()
    assert got.shape == ref.shape == (x.shape[0], x.shape[1], x.shape[1])
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6


@pytest.mark.parametrize("dense", [False, True], ids=["upper", "dense"])
@pytest.mark.parametrize("case", CASES)
def test_backward_plain_matches_tpu_kernel(interpret, case, dense):
    """C′'s plain version against the TPU kernel, with the upper-triangular
    dp that the backward of the i < j gather gives and with a dense one:
    1e-6 of the largest |dx|."""
    x = _coords(case)
    rng = np.random.default_rng(1)
    dp = rng.normal(size=(x.shape[0], x.shape[1], x.shape[1]))
    if not dense:
        dp = np.triu(dp, k=1)
    dp = dp.astype(np.float32)
    ref = np.asarray(JP._sqpairdist_bwd_impl(jnp.asarray(x),
                                             jnp.asarray(dp)))
    got = PK.sqpairdist_bwd(torch.as_tensor(x), torch.as_tensor(dp)).numpy()
    assert got.shape == x.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6


def _dp(x, dense, seed=1):
    """(B, N, N) float32 from a seed: normal, or its strict upper triangle
    (the backward of the i < j gather)."""
    rng = np.random.default_rng(seed)
    dp = rng.normal(size=(x.shape[0], x.shape[1], x.shape[1]))
    return (dp if dense else np.triu(dp, k=1)).astype(np.float32)


@pytest.mark.parametrize("nwalkers", [1, 3])
@pytest.mark.parametrize("dense", [False, True], ids=["upper", "dense"])
@pytest.mark.parametrize("case", CASES)
def test_backward_tiled_matches_plain(case, dense, nwalkers):
    """C′'s tiled mirror against its plain version: 1e-6 of the largest
    |dx| (both sum in float64 and round once)."""
    x = _coords(case, nwalkers)
    dp = _dp(x, dense)
    got = PK.sqpairdist_bwd_tiled(torch.as_tensor(x), torch.as_tensor(dp))
    ref = PK.sqpairdist_bwd_plain(torch.as_tensor(x), torch.as_tensor(dp))
    assert got.shape == ref.shape == x.shape and got.dtype == torch.float32
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-6


@pytest.mark.parametrize("nwalkers", [1, 3])
@pytest.mark.parametrize("dense", [False, True], ids=["upper", "dense"])
@pytest.mark.parametrize("case", CASES)
def test_backward_tiled_matches_tpu_kernel(interpret, case, dense, nwalkers):
    """C′'s tiled mirror against the TPU kernel in interpret mode: 1e-6 of
    the largest |dx|."""
    x = _coords(case, nwalkers)
    dp = _dp(x, dense)
    ref = np.asarray(JP._sqpairdist_bwd_impl(jnp.asarray(x),
                                             jnp.asarray(dp)))
    got = PK.sqpairdist_bwd_tiled(torch.as_tensor(x),
                                  torch.as_tensor(dp)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6


@pytest.mark.parametrize("dense", [False, True], ids=["upper", "dense"])
@pytest.mark.parametrize("case", CASES)
def test_backward_tiled_walker_independent_of_batch(case, dense):
    """A walker's dx in the kernel's order is the same bits alone and in a
    batch of 3, and the same bits on a repeat (the kernel's sums follow the
    tile indices only)."""
    x = torch.as_tensor(_coords(case, 3))
    dp = torch.as_tensor(_dp(x, dense))
    batch = PK.sqpairdist_bwd_tiled(x, dp)
    for w in range(3):
        alone = PK.sqpairdist_bwd_tiled(x[w:w + 1], dp[w:w + 1])
        assert torch.equal(alone[0], batch[w])
    assert torch.equal(PK.sqpairdist_bwd_tiled(x, dp), batch)


def test_backward_launch_shape_and_kernel_bytes():
    """C′'s grid at villin's width: 190 tile pairs, 48 blocks of 4 warps (a
    tile pair a warp) at B=1, one wave of two blocks an SM at B=8, 8 blocks
    (six tile pairs a warp) from B=32 up; its bytes are
    ``step_bytes`` plus the partial sums written and read once (1,536 bytes
    a tile pair, 768 on the diagonal), 1.397x at N=588, within 1.45x; C's
    are ``step_bytes``."""
    n = 588
    assert (PK.tiles(n), PK.tile_pairs(n)) == (19, 190)
    assert PK.launch_shape(n, 1) == (48, 4)
    assert PK.launch_shape(n, 8) == (33, 4)
    assert PK.launch_shape(n, 32) == PK.launch_shape(n, 1024) == (8, 4)
    assert PK.launch_shape(2, 1) == (1, 4)
    part = 171 * 1536 + 19 * 768
    for b in (1, 32, 1024):
        assert PK.kernel_bytes("bwd", b, n) == \
            PK.step_bytes("bwd", b, n) + 2 * b * part
        assert PK.kernel_bytes("fwd", b, n) == PK.step_bytes("fwd", b, n)
    ratio = PK.kernel_bytes("bwd", 32, n) / PK.step_bytes("bwd", 32, n)
    assert ratio == pytest.approx(1.3969, abs=1e-4) and ratio <= 1.45


def _jax_scalar(z):
    return jnp.sum(jnp.sin(JP.flatpairdists(z, use_pallas=True)))


@pytest.mark.parametrize("case", ["villin", "520"])
def test_flatpairdists_and_gradient_match_jax_fused(interpret, case):
    """The port's fused route (>= 512 atoms) against the JAX package's
    fused route: distances to 2e-6 nm; the gradient of sum(sin(d)) (C′
    through the i < j gather) to 1e-5 of its largest entry."""
    x = _coords(case).reshape(4, -1)
    ref = np.asarray(JP.flatpairdists(jnp.asarray(x), use_pallas=True))
    gref = np.asarray(jax.grad(_jax_scalar)(jnp.asarray(x)))
    z = torch.as_tensor(x).requires_grad_(True)
    d = P.flatpairdists(z)
    torch.sin(d).sum().backward()
    assert d.shape == ref.shape
    assert np.abs(d.detach().numpy() - ref).max() < 2e-6
    g = z.grad.numpy()
    assert np.abs(g - gref).max() / np.abs(gref).max() < 1e-5


def test_fused_route_against_jax_gram_default():
    """Against the JAX package's default off the TPU (the Gram trick): the
    documented 1e-4 nm gap; the port's fused route is the nearer to
    float64 distances."""
    x = _coords("villin")
    flat = x.reshape(4, -1)
    gram = np.asarray(JP.flatpairdists(jnp.asarray(flat)))
    got = P.flatpairdists(torch.as_tensor(flat)).numpy()
    assert np.abs(got - gram).max() < 1e-4
    i, j = np.triu_indices(x.shape[1], k=1)
    x64 = x.astype(np.float64)
    d64 = np.sqrt(((x64[:, i] - x64[:, j]) ** 2).sum(-1))
    assert np.abs(got - d64).max() < 2e-6 < np.abs(gram - d64).max()


@pytest.mark.parametrize("n", [511, 512])
def test_route_dispatch_by_atom_count(monkeypatch, n):
    """The fused route from 512 atoms up (counted after the ``atoms``
    gather), on any device; the Gram route below; ``use_kernel``
    overrides.  The two routes agree within the Gram gap."""
    calls = []

    def counting(b):
        calls.append(tuple(b.shape))
        return PK.sqpairdist_fused(b)

    monkeypatch.setattr(P, "sqpairdist_fused", counting)
    x = torch.as_tensor(_coords("520", nwalkers=2).reshape(2, -1))
    d = P.flatpairdists(x[:, :3 * n])
    P.flatpairdists(x, atoms=np.arange(n))
    assert calls == ([(2, n, 3)] * 2 if n >= 512 else [])
    assert d.shape == (2, n * (n - 1) // 2)
    calls.clear()
    P.flatpairdists(x[:, :30], use_kernel=True)
    assert calls == [(2, 10, 3)]
    calls.clear()
    g = P.flatpairdists(x[:, :3 * n], use_kernel=not n >= 512)
    assert calls == ([(2, n, 3)] if n < 512 else [])
    assert float((g - d).abs().max()) < 1e-4


def test_wrappers_raise_off_cpu_and_cuda_without_a_launch():
    fwd0, bwd0 = PK.sqpairdist_fwd.launches, PK.sqpairdist_bwd.launches
    x = torch.empty(2, 520, 3, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        PK.sqpairdist_fwd(x)
    with pytest.raises(NotImplementedError, match="meta"):
        PK.sqpairdist_bwd(x, torch.empty(2, 520, 520, device="meta"))
    with pytest.raises(NotImplementedError, match="meta"):
        P.flatpairdists(x.reshape(2, -1))
    with pytest.raises(ValueError, match="float32"):
        PK.sqpairdist_fwd(torch.zeros(2, 5, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="dp"):
        PK.sqpairdist_bwd(torch.zeros(2, 5, 3), torch.zeros(2, 5, 4))
    # the CPU takes the plain versions and counts no launch
    xc = torch.as_tensor(_coords("130", nwalkers=2))
    PK.sqpairdist_bwd(xc, PK.sqpairdist_fwd(xc))
    assert (PK.sqpairdist_fwd.launches, PK.sqpairdist_bwd.launches) == (
        fwd0, bwd0) == (0, 0)


def test_kernel_route_same_bits_and_plain_autograd_function():
    """The forward's plain version equals a float32 direct-difference
    evaluation bit for bit; the autograd function over the plain versions
    gives the wrappers' gradient on the CPU; repeat calls give the same
    bits."""
    x = torch.as_tensor(_coords("520", nwalkers=3))
    p = PK.sqpairdist_fwd(x)
    d = x[:, :, None, :] - x[:, None, :, :]
    sq = d * d
    assert torch.equal(p, (sq[..., 0] + sq[..., 1]) + sq[..., 2])
    w = torch.as_tensor(np.random.default_rng(2).normal(
        size=p.shape).astype(np.float32))
    grads = []
    for fn in (PK.sqpairdist_fused, PK.sqpairdist_fused_plain,
               PK.sqpairdist_fused):
        z = x.clone().requires_grad_(True)
        (fn(z) * w).sum().backward()
        grads.append(z.grad)
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0],
                                                           grads[2])
    # the float64 autograd reference of sum(w * |x_i - x_j|^2)
    z = x.double().requires_grad_(True)
    dz = z[:, :, None, :] - z[:, None, :, :]
    ((dz * dz).sum(-1) * w.double()).sum().backward()
    rel = (grads[0].double() - z.grad).abs().max() / z.grad.abs().max()
    assert float(rel) < 1e-6


def test_step_ops_bytes_and_bound():
    """The bound at villin's width: bytes dominate, 13.3 us at B = 32 and
    0.425-0.427 ms at B = 1024 for each kernel (4 B N^2 bytes of p or
    dp, and the coordinates)."""
    n = 588
    for kind in ("fwd", "bwd"):
        ms32, by = PK.bound_ms(kind, 32, n)
        assert by == "bytes"
        assert ms32 == pytest.approx(1e3 * PK.step_bytes(kind, 32, n)
                                     / LK.H100_HBM_BYTES_PER_S)
        assert 0.0132 < ms32 < 0.0134
        assert 0.424 < PK.bound_ms(kind, 1024, n)[0] < 0.428
    assert PK.step_ops("fwd", 2, n) == 8 * 2 * n * n
    assert PK.step_ops("bwd", 2, n) == 10 * 2 * n * n + 3 * 2 * n
    assert PK.step_bytes("fwd", 1, n) == 4 * (3 * n + n * n)
    assert PK.step_bytes("bwd", 1, n) == 4 * (6 * n + n * n)


# ---- featurizers and pair selections ---------------------------------------

def test_halfinds_and_localpdistinds_match_jax():
    for n in (2, 7, 130):
        for a, b in zip(P.halfinds(n), JP.halfinds(n)):
            np.testing.assert_array_equal(a, b)
    x = _coords("villin").reshape(4, -1)
    for r in (0.3, 0.5):
        got = P.localpdistinds(x, r)
        np.testing.assert_array_equal(got, JP.localpdistinds(x, r))
        assert len(got) > 1000
    np.testing.assert_array_equal(P.localpdistinds(x[0], 0.5),
                                  JP.localpdistinds(x[0], 0.5))
    atoms = np.arange(0, 588, 3)
    np.testing.assert_array_equal(
        P.restricted_localpdistinds(x, 0.6, atoms),
        JP.restricted_localpdistinds(x, 0.6, atoms))
    d, inds = P.localpdists(x, 0.4)
    dj, indsj = JP.localpdists(x, 0.4)
    np.testing.assert_array_equal(inds, indsj)
    assert np.abs(d.numpy() - np.asarray(dj)).max() < 1e-5


@pytest.mark.parametrize("natoms, tol", [(520, 2e-6), (300, 1e-4)],
                         ids=["fused", "gram"])
def test_features_atoms_match_jax(interpret, monkeypatch, natoms, tol):
    """``FeaturesAtoms`` over an atom list, the JAX package with its TPU
    dispatch rule (fused from 512 atoms): from 512 atoms the fused route
    of both packages (2e-6 nm); below it the Gram route of both (1e-4 nm,
    the Gram trick's gap at villin's coordinates)."""
    monkeypatch.setattr(JP, "_should_use_pallas",
                        lambda b: b.shape[1] >= 512)
    atoms = np.sort(np.random.default_rng(3).choice(588, natoms,
                                                    replace=False))
    x = _coords("villin").reshape(4, -1)
    ref = np.asarray(JF.FeaturesAtoms(tuple(atoms)).compute(jnp.asarray(x)))
    tf = F.FeaturesAtoms(tuple(atoms))
    got = tf(torch.as_tensor(x)).numpy()
    assert got.shape == ref.shape == (4, natoms * (natoms - 1) // 2)
    assert np.abs(got - ref).max() < tol
    assert F.default_featurizer(VILLIN, 588, list(atoms)) == tf


def test_features_angles_match_jax():
    """Backbone phi / psi quadruplets of villin exactly, the dihedrals to
    1e-5 rad, and ``dihedral`` on random points."""
    jf = JF.FeaturesAngles.from_pdb(VILLIN)
    tf = F.FeaturesAngles.from_pdb(VILLIN)
    assert tf.quads == jf.quads and len(tf.quads) == 2 * 35
    x = _coords("villin").reshape(4, -1)
    ref = np.asarray(jf.compute(jnp.asarray(x)))
    got = tf(torch.as_tensor(x)).numpy()
    assert got.shape == ref.shape == (4, 70)
    assert np.abs(got - ref).max() < 1e-5
    p = np.random.default_rng(4).normal(size=(50, 4, 3)).astype(np.float32)
    assert np.abs(D.dihedral(torch.as_tensor(p)).numpy()
                  - np.asarray(JD.dihedral(jnp.asarray(p)))).max() < 1e-5


@pytest.mark.parametrize("spec", [
    dict(selector="calpha"),
    dict(selector="heavy", maxfeatures=200, seed=3),
    dict(selector="backbone", maxdist=0.6),
    dict(selector="all", maxdist=0.3, maxfeatures=500),
], ids=["calpha", "heavy_max", "backbone_dist", "all_dist_max"])
def test_features_pairs_from_pdb_match_jax(spec):
    jf = JF.FeaturesPairs.from_pdb(VILLIN, **spec)
    tf = F.FeaturesPairs.from_pdb(VILLIN, **spec)
    assert tf.pairs == jf.pairs and len(tf.pairs) > 0
    x = _coords("villin").reshape(4, -1)
    ref = np.asarray(jf.compute(jnp.asarray(x)))
    assert np.abs(tf(torch.as_tensor(x)).numpy() - ref).max() < 1e-5


def test_default_featurizer_specs_match_jax():
    """The radius spec (C-alpha pairs + local heavy-atom pairs), pair
    lists, callables and the atom-count rule, as the JAX package."""
    for radius in (0.4, 0.5):
        jf = JF.default_featurizer(VILLIN, 588, radius)
        tf = F.default_featurizer(VILLIN, 588, radius)
        assert isinstance(tf, F.FeaturesPairs) and tf.pairs == jf.pairs
    s = read_pdb(VILLIN)
    assert F.calpha_pairs(s) == [tuple(p) for p in JF.calpha_pairs(s)]
    np.testing.assert_array_equal(F.calpha_inds(s), JF.calpha_inds(s))
    assert F.local_atom_pairs(s, 0.35) == JF.local_atom_pairs(s, 0.35)
    assert F.default_featurizer(VILLIN, 588, [(0, 5), (3, 9)]).pairs == \
        ((0, 5), (3, 9))
    assert isinstance(F.default_featurizer(VILLIN, 588), F.FeaturesRandomPairs)
    assert isinstance(F.default_featurizer(None, 22), F.FeaturesAll)
    fa = F.FeaturesAll()
    assert F.default_featurizer(VILLIN, 588, fa) is fa
    with pytest.raises(ValueError, match="PDB"):
        F.default_featurizer(None, 588, 0.5)
    x = torch.as_tensor(_coords("villin", nwalkers=2).reshape(2, -1))
    assert torch.equal(F.FeaturesCoords()(x), x)


def test_mdsimulation_feature_specs():
    """``MDSimulation(features=...)`` takes every spec of the rule."""
    sim = itt.MDSimulation(pdb=VILLIN, steps=2, implicit="obc2",
                           features=0.4, device="cpu")
    assert sim.featurizer == F.default_featurizer(VILLIN, 588, 0.4)
    sim = itt.MDSimulation(pdb=VILLIN, steps=2, implicit="obc2",
                           features=list(range(0, 588, 2)), device="cpu")
    assert isinstance(sim.featurizer, F.FeaturesAtoms)
    assert sim.featurizer(sim.coords[None]).shape == (1, 294 * 293 // 2)
