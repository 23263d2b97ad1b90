"""Port parity of kernel D's module: the OBC2 system build, GBSA energies,
the plain nonbonded + GBSA force (``gb_kernel.gb_force_plain``) against the
JAX TPU kernel run in interpret mode, the kernel's tile order
(``gb_kernel.gb_force_tiled``) against the plain version and the JAX
package's upper-triangle tiling, and ``force_flat_hybrid`` / ``force_flat``
against JAX ``force_flat`` on trp-cage (CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isokann_tpu.md.forces import energy_terms as jax_energy_terms
from isokann_tpu.md.forces import force_flat as jax_force_flat
from isokann_tpu.md.pallas_gb import GBPlan as JaxGBPlan
from isokann_tpu.md.pallas_gb import gb_force_pallas
from isokann_tpu.md.system import build_system as jax_build_system

from isokann_tpu_torch.md import gb_kernel as GB
from isokann_tpu_torch.md.fixtures import alanine_dipeptide_pdb
from isokann_tpu_torch.md.forces import energy_terms, force_flat
from isokann_tpu_torch.md.pdbio import read_pdb
from isokann_tpu_torch.md.system import build_system

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

TRPCAGE = os.path.join(os.path.dirname(__file__), "..", "out",
                       "trpcage.pdb")

FLOAT_FIELDS = ("bond_k", "bond_r0", "angle_k", "angle_t0", "dih_pk",
                "dih_phase", "dih_n", "charges", "rmin_half", "eps",
                "qq_scale", "lj_scale", "masses", "gb_radii", "gb_scales")
INT_FIELDS = ("bond_idx", "angle_idx", "dih_idx")


def _walkers(pdb, n, scale, seed=0):
    """``n`` copies of the PDB's coordinates plus N(0, scale nm) noise."""
    x0 = read_pdb(pdb).coords.reshape(-1)
    rng = np.random.default_rng(seed)
    return (x0[None] + rng.normal(scale=scale, size=(n, x0.size))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def trpcage():
    """JAX and port systems of trp-cage in OBC2, 2 walkers at 0.005 nm
    noise, and one compiled JAX ``force_flat`` for them."""
    js = jax_build_system(TRPCAGE, implicit="obc2")
    ts = build_system(TRPCAGE, implicit="obc2", device="cpu")
    xs = _walkers(TRPCAGE, 2, 0.005)
    f_ref = np.asarray(jax.jit(lambda x: jax_force_flat(js, x))(
        jnp.asarray(xs)))
    return js, ts, xs, f_ref


def test_obc2_system_fields_match_jax(trpcage):
    js, ts, _, _ = trpcage
    assert ts.natoms == js.natoms == 313
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert (ts.method, ts.implicit, ts.box) == ("NoCutoff", "obc2", None)
    assert (js.method, js.implicit, js.box) == ("NoCutoff", "obc2", None)


def test_plan_tables_match_jax(trpcage):
    """The per-atom tables and the Coulomb scale grid are the reference
    plan's, without its padding."""
    js, ts, _, _ = trpcage
    jp, tp = JaxGBPlan(js), GB.GBPlan(ts)
    A = tp.A
    cols = (jp.q_col, jp.rmh_col, jp.eps_col, jp.radii_col, jp.orad_col,
            jp.sr_col)
    for k, c in enumerate(cols):
        np.testing.assert_array_equal(tp.tab[k], c[:A, 0])
    np.testing.assert_array_equal(tp.qq_scale, jp.qq_scale[:A, :A])
    assert (tp.use_gb, tp.use_rf, tp.box) == (True, False, None)


@pytest.mark.parametrize("kw", [dict(implicit="obc2"), dict(),
                                dict(method="NoCutoff"),
                                dict(method="CutoffNonPeriodic")],
                         ids=["obc2", "rf_periodic", "nocutoff",
                              "rf_nonperiodic"])
def test_plain_matches_tpu_kernel_on_alanine(kw):
    """The cases of the JAX package's own GB kernel tests (OBC2, the
    default reaction field with minimum image, NoCutoff) plus the
    non-periodic reaction field: 4 walkers, 1e-5 relative to the largest
    force."""
    pdb = alanine_dipeptide_pdb()
    js, ts = jax_build_system(pdb, **kw), build_system(pdb, **kw,
                                                        device="cpu")
    xs = _walkers(pdb, 4, 0.005)
    ref = np.asarray(gb_force_pallas(js, jnp.asarray(xs), interpret=True))
    got = GB.gb_force(GB.GBPlan(ts), torch.as_tensor(xs)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_plain_minimum_image_matches_tpu_kernel_on_wrapped_atoms():
    """Alanine with the periodic reaction field, each atom moved by a
    whole number of box lengths (-1, 0 or 1 per axis), so that the
    minimum image changes every pair across a wrap: 4 walkers, 1e-5
    relative to the largest force against the JAX kernel on the same
    input."""
    pdb = alanine_dipeptide_pdb()
    js, ts = jax_build_system(pdb), build_system(pdb, device="cpu")
    plan = GB.GBPlan(ts)
    assert plan.box is not None
    xs = _walkers(pdb, 4, 0.005).reshape(4, -1, 3)
    shift = np.random.default_rng(1).integers(-1, 2, size=xs.shape)
    xw = (xs + shift * np.asarray(plan.box, np.float32)).astype(
        np.float32).reshape(4, -1)
    ref = np.asarray(gb_force_pallas(js, jnp.asarray(xw), interpret=True))
    got = GB.gb_force(plan, torch.as_tensor(xw)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_plain_matches_tpu_kernel_on_trpcage(trpcage):
    js, ts, xs, _ = trpcage
    ref = np.asarray(gb_force_pallas(js, jnp.asarray(xs), interpret=True))
    got = GB.gb_force_plain(GB.GBPlan(ts), torch.as_tensor(xs)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_hybrid_and_autograd_forces_match_jax(trpcage):
    """``force_flat_hybrid`` (plain kernel D + analytic bonded terms) and
    autograd ``force_flat`` against JAX ``force_flat``, 1e-5 relative to
    the largest force."""
    _, ts, xs, f_ref = trpcage
    x = torch.as_tensor(xs)
    scale = np.abs(f_ref).max()
    hyb = GB.force_flat_hybrid(GB.GBPlan(ts), x).numpy()
    auto = force_flat(ts, x).numpy()
    assert np.abs(hyb - f_ref).max() / scale < 1e-5
    assert np.abs(auto - f_ref).max() / scale < 1e-5


def test_energy_terms_with_gbsa_match_jax(trpcage):
    js, ts, xs, _ = trpcage
    got = energy_terms(ts, torch.as_tensor(xs[0].reshape(-1, 3)))
    ref = jax_energy_terms(js, jnp.asarray(xs[0].reshape(-1, 3)))
    assert set(got) == set(ref) == {"bond", "angle", "dihedral",
                                    "nonbonded", "gbsa"}
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=2e-3,
                                   err_msg=k)


def test_step_ops_and_bound(trpcage):
    """The operation counts per unordered pair, each with its derivation,
    and the function is operation-bound at the path's batch sizes."""
    _, ts, _, _ = trpcage
    plan = GB.GBPlan(ts)
    pairs = 313 * 312 // 2
    ops = GB.step_ops(plan)
    # once a pair: geometry 10, LJ + Coulomb 23, accumulation 9, the GB
    # pair term's shared part 16, dE/dr^2 11; each direction: descreening
    # 30, df/dB factor 2, dI/dr 47; per atom 40
    assert ops == (10 + 23 + 9 + 16 + 11 + 2 * (30 + 2 + 47)) * pairs \
        + 40 * 313
    assert ops == 227 * pairs + 40 * 313
    # the kernel recomputes r^2 (8) in pass 2 and d (3) in pass 3
    assert GB.kernel_ops(plan) == ops + (8 + 3) * pairs
    assert 1.0 <= GB.kernel_ops(plan) / ops <= 1.10
    # PR 7-10's count: each ordered pair, symmetric terms twice
    assert GB.step_ops(plan, ordered=True) == 153 * 313 * 312 + 40 * 313
    vac = GB.GBPlan(build_system(TRPCAGE, method="CutoffNonPeriodic",
                                 device="cpu"))
    # vacuum with the reaction field: geometry 10, LJ + Coulomb + RF 33,
    # accumulation 9, one pass
    assert GB.step_ops(vac) == (10 + 33 + 9) * pairs
    assert GB.kernel_ops(vac) == GB.step_ops(vac)
    assert GB.step_ops(vac) < ops / 2
    for b in (1, 1024):
        ms, by = GB.bound_ms(plan, b)
        assert by == "operations"
        assert ms == pytest.approx(1e3 * ops * b / 67e12)
        ms_ord, _ = GB.bound_ms(plan, b, ordered=True)
        assert ms_ord == pytest.approx(ms * GB.step_ops(plan, ordered=True)
                                       / ops)


def test_blocks_and_tiles(trpcage):
    """One cluster a walker, of 8 blocks of 8 warps where a block's shared
    memory fits and of 16 where it does not, so B=1 spreads over at least
    8 SMs; trp-cage is 10 tiles and 55 tile pairs, villin-sized 588 atoms
    19 and 190, the 640-atom limit 20 and 210."""
    _, ts, _, _ = trpcage
    plan = GB.GBPlan(ts)
    assert GB.launch_shape(plan) == (8, 8)
    assert GB.blocks(plan, 1) == (8, 1)
    assert GB.blocks(plan, 1024) == (8192, 1024)
    assert GB.tiles(plan) == 10 and len(GB.tile_pairs(plan)) == 55
    # 13 per-atom rows of 320, 7 tile pairs of partials and pair caches
    assert GB.smem_bytes(plan, 8) == 4 * (13 * 320 + 7 * (192 + 3072))
    vac = GB.GBPlan(build_system(TRPCAGE, method="CutoffNonPeriodic",
                                 device="cpu"))
    assert GB.smem_bytes(vac, 8) == 4 * (13 * 320 + 7 * 192)
    for A, nt in ((588, 19), (640, 20)):
        stub = type("P", (), {"A": A, "use_gb": True})()
        assert GB.tiles(stub) == nt
        assert len(GB.tile_pairs(stub)) == nt * (nt + 1) // 2
        assert GB.smem_bytes(stub, 8) > GB.SMEM_LIMIT
        assert GB.smem_bytes(stub, 16) <= GB.SMEM_LIMIT
        assert GB.launch_shape(stub) == (16, 8)
        assert GB.blocks(stub, 3) == (48, 3)


@pytest.mark.parametrize("A", [22, 313, 588])
def test_tile_order_visits_each_unordered_pair_once(A):
    """The kernel's visiting rule (tile pairs J >= I, lane l meets column
    (l + k) mod 32 at step k, i < j on the diagonal, atoms < A) takes every
    unordered pair exactly once."""
    nt = -(-A // 32)
    lane = np.arange(32)
    seen = np.zeros((A, A), np.int64)
    for I in range(nt):
        for J in range(I, nt):
            for k in range(32):
                c = (lane + k) % 32
                i, j = I * 32 + lane, J * 32 + c
                ok = (i < A) & (j < A) & ((I != J) | (c > lane))
                np.add.at(seen, (i[ok], j[ok]), 1)
    assert np.array_equal(seen, np.triu(np.ones((A, A), np.int64), 1))


def _wrapped_alanine():
    pdb = alanine_dipeptide_pdb()
    ts = build_system(pdb, device="cpu")
    plan = GB.GBPlan(ts)
    xs = _walkers(pdb, 4, 0.005).reshape(4, -1, 3)
    shift = np.random.default_rng(1).integers(-1, 2, size=xs.shape)
    xw = (xs + shift * np.asarray(plan.box, np.float32)).astype(
        np.float32).reshape(4, -1)
    return plan, xw


@pytest.mark.parametrize("case", ["alanine_vacuum_rf",
                                  "alanine_periodic_rf_wrapped",
                                  "trpcage_obc2"])
def test_tiled_order_matches_plain(case, trpcage):
    """The kernel's order in tensor ops (``gb_force_tiled``) against the
    plain version, 1e-5 relative to the largest force."""
    if case == "alanine_vacuum_rf":
        pdb = alanine_dipeptide_pdb()
        plan = GB.GBPlan(build_system(pdb, method="CutoffNonPeriodic",
                                      device="cpu"))
        xs = _walkers(pdb, 4, 0.005)
    elif case == "alanine_periodic_rf_wrapped":
        plan, xs = _wrapped_alanine()
        assert plan.box is not None
    else:
        _, ts, xs, _ = trpcage
        plan = GB.GBPlan(ts)
        assert plan.use_gb
    x = torch.as_tensor(xs)
    ref = GB.gb_force_plain(plan, x).numpy()
    got = GB.gb_force_tiled(plan, x).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_tiled_order_matches_tpu_tri_kernel_on_trpcage(trpcage):
    """``gb_force_tiled`` against the JAX package's upper-triangle tiling
    (``_force_one_walker_tri``) in interpret mode, at the full-grid test's
    1e-5 relative to the largest force."""
    js, ts, xs, _ = trpcage
    ref = np.asarray(gb_force_pallas(js, jnp.asarray(xs), interpret=True,
                                     tri=True))
    got = GB.gb_force_tiled(GB.GBPlan(ts), torch.as_tensor(xs)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_wrapper_takes_plain_on_cpu_and_raises_elsewhere(trpcage):
    _, ts, xs, _ = trpcage
    plan = GB.GBPlan(ts)
    n0 = GB.gb_force.launches
    x = torch.as_tensor(xs)
    np.testing.assert_array_equal(GB.gb_force(plan, x).numpy(),
                                  GB.gb_force_plain(plan, x).numpy())
    with pytest.raises(NotImplementedError):
        GB.gb_force(plan, x.to("meta"))
    with pytest.raises(ValueError):
        GB.gb_force(plan, x.double())
    assert GB.gb_force.launches == n0
