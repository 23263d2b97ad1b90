"""The LangevinMiddle kernel module of the port on the CPU: its plain
version against the TPU kernel's noiseless interpret run, thermal
statistics with noise, determinism, and the wrapper's dispatch.  The CUDA
kernel itself is held against the plain version on the card by
``chip_smoke.py``."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md.forces import force_flat as jax_force_flat
from isokann_tpu.md.pallas_md import PallasMDPlan, langevin_middle_fused
from isokann_tpu.md.system import build_system as jax_build_system
from isokann_tpu.utils.flops import fused_md_flops

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import integrators as I
from isokann_tpu_torch.md import langevin_kernel as LK
from isokann_tpu_torch.md.fixtures import alanine_dipeptide_pdb
from isokann_tpu_torch.md.forces import force_flat
from isokann_tpu_torch.md.system import build_system

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "golden",
                      "ala2_vacuum_msm.npz")


@pytest.fixture(scope="module")
def jsim():
    return itk.MDSimulation(steps=10)


@pytest.fixture(scope="module")
def sim():
    return itt.MDSimulation(steps=10, device="cpu")


def test_noiseless_plain_matches_fused_interpret(jsim, sim):
    """5 noiseless steps of 8 walkers from rest, as the JAX package's own
    interpret-mode kernel test runs them: x to 1e-5, v to 1e-4."""
    x0 = jnp.tile(jsim.coords[None, :], (8, 1))
    v0 = jnp.zeros_like(x0)
    xo, vo = langevin_middle_fused(jsim.system, x0, v0, 310.0, 1.0, 0.002,
                                   5, jax.random.PRNGKey(0), block=8,
                                   interpret=True)
    x = torch.tensor(np.asarray(x0))
    v = torch.zeros_like(x)
    xt, vt = LK.langevin_middle_plain(sim.plan, x, v, 5, noise=False)
    assert np.abs(xt.numpy() - np.asarray(xo)).max() < 1e-5
    assert np.abs(vt.numpy() - np.asarray(vo)).max() < 1e-4


def test_plain_matches_autograd_recursion(sim):
    """The kernel module's recursion equals the integrator module's
    LangevinMiddle over autograd forces (noiseless)."""
    rng = np.random.default_rng(3)
    x = sim.coords[None, :] + torch.as_tensor(
        rng.normal(scale=0.01, size=(4, 66)), dtype=torch.float32)
    v = sim.random_velocities(itt.make_generator(0), x.shape)
    xa, va = LK.langevin_middle_plain(sim.plan, x, v, 5, noise=False)
    xb, vb = I.langevin_middle(lambda z: force_flat(sim.system, z), x, v,
                               sim.masses3, 310.0, 1.0, 0.002, 5)
    assert (xa - xb).abs().max() < 1e-5
    assert (va - vb).abs().max() < 1e-3


def test_kinetic_temperature_with_noise(sim):
    """Noisy LangevinMiddle from Maxwell-Boltzmann velocities holds 310 K
    within sampling error (4 sigma of the kinetic-temperature estimate).
    Friction 20/ps relaxes the start in ~25 steps; the stationary
    distribution does not depend on the friction."""
    B, n = 256, 200
    plan = LK.LangevinPlan(sim.system, 310.0, 20.0, 0.002)
    x = sim.coords[None, :].repeat(B, 1)
    gen = itt.make_generator(11)
    v = sim.random_velocities(gen, x.shape)
    xo, vo = LK.langevin_middle(plan, x, v, n, gen)
    assert bool(torch.isfinite(xo).all())
    temp = float((sim.masses3 * vo ** 2).sum(1).mean() / (66 * I.KB))
    sigma = 310.0 * math.sqrt(2.0 / (B * 66))
    assert abs(temp - 310.0) < 4 * sigma


def test_same_generator_seed_same_result(sim):
    x = sim.coords[None, :].repeat(4, 1)
    v = torch.zeros_like(x)
    a = LK.langevin_middle(sim.plan, x, v, 3, itt.make_generator(5))
    b = LK.langevin_middle(sim.plan, x, v, 3, itt.make_generator(5))
    c = LK.langevin_middle(sim.plan, x, v, 3, itt.make_generator(6))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_cpu_tensors_take_the_plain_version(sim):
    """On a CPU tensor the wrappers run the plain version and count no
    kernel launch."""
    x = sim.coords[None, :].repeat(2, 1)
    n0, f0 = LK.langevin_middle.launches, LK.forces.launches
    out = LK.forces(sim.plan, x)
    torch.testing.assert_close(out, LK.forces_plain(sim.plan, x))
    LK.langevin_middle(sim.plan, x, torch.zeros_like(x), 1,
                       itt.make_generator(0))
    assert (LK.langevin_middle.launches, LK.forces.launches) == (n0, f0)


def test_wrappers_raise_off_the_cpu_without_a_kernel(sim):
    """A tensor that is neither on the CPU nor on a CUDA card gets no
    plain fallback: the wrappers raise and count no launch."""
    x = torch.zeros(2, sim.dim, device="meta")
    n0, f0 = LK.langevin_middle.launches, LK.forces.launches
    with pytest.raises(NotImplementedError):
        LK.forces(sim.plan, x)
    with pytest.raises(NotImplementedError):
        LK.langevin_middle(sim.plan, x, x, 1, itt.make_generator(0))
    assert (LK.langevin_middle.launches, LK.forces.launches) == (n0, f0)


def test_wrapper_rejects_bad_shapes(sim):
    with pytest.raises(ValueError):
        LK.forces(sim.plan, torch.zeros(2, 65))
    with pytest.raises(ValueError):
        LK.forces(sim.plan, torch.zeros(2, 66, dtype=torch.float64))


def test_step_ops_is_the_vector_part_of_fused_md_flops(jsim, sim):
    ref = fused_md_flops(PallasMDPlan(jsim.system))["vector_flops"]
    assert LK.step_ops(sim.plan) == ref
    ms, by = LK.bound_ms(sim.plan, 512, 100)
    assert by == "operations" and ms > 0


@pytest.mark.parametrize("method", ["NoCutoff", "CutoffPeriodic"])
def test_gather_order_matches_plain_and_jax(method):
    """Kernel A's force routine in its own order (the nonbonded force of
    each atom gathered over its partners through the dense pair table, then
    its bonded slots through its list) on frames of the golden alanine
    run, in vacuum and with the periodic reaction field: 1e-6 of max |F|
    from the plain version, 1e-5 from the JAX package's ``force_flat``."""
    pdb = alanine_dipeptide_pdb()
    jsys = jax_build_system(pdb, method=method)
    tsys = build_system(pdb, method=method, device="cpu")
    plan = LK.LangevinPlan(tsys, 310.0, 1.0, 0.002)
    assert (plan.box is not None) == (method == "CutoffPeriodic")
    xs = np.load(GOLDEN)["xs"][::256][:6]
    x = torch.as_tensor(xs)
    f_gather = LK.forces_gather(plan, x).numpy()
    f_plain = LK.forces_plain(plan, x).numpy()
    f_jax = np.asarray(jax_force_flat(jsys, jnp.asarray(xs)))
    scale = np.abs(f_jax).max()
    assert np.abs(f_gather - f_plain).max() / np.abs(f_plain).max() < 1e-6
    assert np.abs(f_gather - f_jax).max() / scale < 1e-5


def test_kernel_tables(sim):
    """The dense pair table holds each pair's (qq, eps, rmin, full) at [j, i]
    and [i, j] and zeros on the diagonal; every bonded slot is in exactly
    one atom's list, the atom it acts on, in ascending order."""
    plan = sim.plan
    n = plan.natoms
    iu, ju = plan.pairs[:, 0], plan.pairs[:, 1]
    want = np.stack([plan.nb_qq, plan.nb_eps, plan.nb_rmin, plan.nb_full],
                    axis=-1).astype(np.float32)
    np.testing.assert_array_equal(plan.dense[ju, iu], want)
    np.testing.assert_array_equal(plan.dense[iu, ju], want)
    assert not plan.dense[np.arange(n), np.arange(n)].any()
    assert plan.nslot == 2 * plan.nb + 3 * plan.na + 4 * plan.nd
    listed = plan.atom_slots[plan.atom_slots < plan.nslot]
    np.testing.assert_array_equal(np.sort(listed), np.arange(plan.nslot))
    for a, row in enumerate(plan.atom_slots):
        row = row[row < plan.nslot]
        assert np.all(np.diff(row) > 0) and np.all(plan.slot_atom[row] == a)


def test_kernel_ops_and_blocks(sim):
    """Kernel A executes each pair twice (the gather) and sums the slots:
    between 1x and 2x the function's operations; a warp per walker, four
    walkers a block."""
    plan = sim.plan
    ratio = LK.kernel_ops(plan) / LK.step_ops(plan)
    assert 1.0 < ratio < 2.0
    assert LK.kernel_ops(plan) - LK.step_ops(plan) == \
        plan.np * 45 + 3 * plan.nslot
    assert [LK.blocks(b) for b in (1, 4, 5, 512)] == [1, 1, 2, 128]
