"""Port parity of the generic bond constraints (``md/constraints.py``):
the reference's selection (HBonds, HAngles, AllBonds, explicit pairs,
scattered waters, a stride-4 water block), its colored Gauss-Seidel
classes, SHAKE and RATTLE, and constrained LangevinMiddle steps on the
plain (alanine) and hybrid (trp-cage in OBC2) routes, against the JAX
package on the same numpy inputs (CPU)."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md import integrators as JI
from isokann_tpu.md.constraints import ConstraintSet as JaxConstraintSet
from isokann_tpu.md.forces import force_flat as jax_force_flat

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import gb_kernel as GB
from isokann_tpu_torch.md.constraints import ConstraintSet
from isokann_tpu_torch.md.integrators import KB
from isokann_tpu_torch.md.solvate import ANG_HOH, water_triplets

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

TRPCAGE = os.path.join(os.path.dirname(__file__), "..", "out",
                       "trpcage.pdb")
# an explicit (i, j, d) list: two heavy-atom distances of alanine
PAIRS = [(4, 6, 0.1449), (6, 8, 0.1522)]
WHICH = [("HBonds", None), ("HAngles", None), ("AllBonds", None),
         (None, PAIRS), ("HBonds", PAIRS)]


@pytest.fixture(scope="module")
def jsim():
    return itk.MDSimulation(steps=20, constraints="HBonds")


@pytest.fixture(scope="module")
def sim():
    return itt.MDSimulation(steps=20, constraints="HBonds", device="cpu")


@pytest.fixture(scope="module")
def frames(jsim):
    """The JAX test's perturbed frames (``tests/test_md.py``): 4 copies
    of the start state moved by 3e-3 nm normals."""
    x0 = np.tile(np.asarray(jsim.coords)[None], (4, 1))
    x = x0 + np.random.default_rng(0).normal(scale=3e-3, size=x0.shape)
    return x0.astype(np.float32), x.astype(np.float32)


def _classes(cs):
    """The generic classes as lists of (i, j) pairs, port or JAX."""
    if hasattr(cs, "_classes"):
        return [list(zip(np.asarray(c[0]).tolist(),
                         np.asarray(c[1]).tolist())) for c in cs._classes]
    return [list(zip(cs.idx_i[k].tolist(), cs.idx_j[k].tolist()))
            for k in cs.classes]


def _both(jsys, tsys, which, pairs, **kw):
    return (JaxConstraintSet(jsys, which, pairs=pairs, **kw),
            ConstraintSet(tsys, which, pairs=pairs, **kw))


@pytest.mark.parametrize("which,pairs", WHICH)
def test_selection_and_classes_match_jax(jsim, sim, which, pairs):
    """The same constraints, lengths, sweep counts and Gauss-Seidel
    classes as the reference."""
    jc, tc = _both(jsim.system, sim.system, which, pairs)
    assert (tc.ncons, tc.ngeneric, tc.iters) == (jc.ncons, jc.ngeneric,
                                                 jc.iters)
    np.testing.assert_array_equal(tc.idx_i, np.asarray(jc.idx_i))
    np.testing.assert_array_equal(tc.idx_j, np.asarray(jc.idx_j))
    np.testing.assert_array_equal(tc.r0, np.asarray(jc.r0))
    assert _classes(tc) == _classes(jc)
    for cls in _classes(tc):
        atoms = [a for p in cls for a in p]
        assert len(atoms) == len(set(atoms))      # no atom twice in a class


@pytest.mark.parametrize("which,pairs", WHICH)
def test_shake_and_rattle_match_jax(jsim, sim, frames, which, pairs):
    """SHAKE of the JAX test's perturbed frames: within 1e-6 nm of JAX and
    onto the constraints.  RATTLE of random velocities on those frames:
    within 1e-5 of the largest JAX value; what velocity is left along the
    constraints is what JAX leaves (1e-4 for the HBond stars, the JAX
    test's bound; the HAngles triangles keep more after their 25 sweeps,
    in both)."""
    jc, tc = _both(jsim.system, sim.system, which, pairs)
    x0, x = frames
    xs_j = np.asarray(jc.shake(jnp.asarray(x0), jnp.asarray(x)))
    xs_t = tc.shake(torch.as_tensor(x0), torch.as_tensor(x)).numpy()
    assert np.abs(xs_t - xs_j).max() < 1e-6
    assert tc.max_violation(xs_t) < 1e-5
    assert abs(tc.max_violation(x) - float(jc.max_violation(x))) < 1e-7

    v = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    vr_j = np.asarray(jc.rattle(jnp.asarray(xs_j), jnp.asarray(v)))
    vr_t = tc.rattle(torch.tensor(xs_j), torch.as_tensor(v)).numpy()
    assert np.abs(vr_t - vr_j).max() / np.abs(vr_j).max() < 1e-5
    xr = xs_j.reshape(4, -1, 3)
    d = xr[:, tc.idx_i] - xr[:, tc.idx_j]

    def along(vel):
        vr = vel.reshape(4, -1, 3)
        return np.abs(np.sum((vr[:, tc.idx_i] - vr[:, tc.idx_j]) * d,
                             axis=-1)).max()

    assert along(vr_t) < max(1e-4, 1.01 * along(vr_j))


def test_hangles_triangulated_distances(sim):
    """HAngles: the H-X-H distances by the law of cosines from the bond
    lengths and the angle, held by SHAKE within 1e-5 nm (the JAX test's
    check, ``tests/test_md.py``)."""
    cs = ConstraintSet(sim.system, "HAngles")
    assert cs.ncons > ConstraintSet(sim.system, "HBonds").ncons
    assert cs.iters == 50
    x0 = sim.coords[None]
    x = x0 + 0.004 * torch.as_tensor(np.random.default_rng(0).normal(
        size=x0.shape), dtype=torch.float32)
    xr = cs.shake(x0, x).numpy().reshape(-1, 3)
    masses = sim.system.masses.numpy()
    bond_r0 = {tuple(sorted(map(int, b))): float(l) for b, l in zip(
        sim.system.bond_idx.numpy(), sim.system.bond_r0.numpy())}
    checked = 0
    for (a, b, c), t0 in zip(sim.system.angle_idx.numpy(),
                             sim.system.angle_t0.numpy()):
        if masses[a] < 3.5 and masses[c] < 3.5:
            rab = bond_r0[tuple(sorted((int(a), int(b))))]
            rbc = bond_r0[tuple(sorted((int(b), int(c))))]
            target = np.sqrt(rab ** 2 + rbc ** 2
                             - 2 * rab * rbc * np.cos(float(t0)))
            assert abs(np.linalg.norm(xr[a] - xr[c]) - target) < 1e-5
            checked += 1
    assert checked >= 3


@pytest.fixture(scope="module")
def water_pair():
    """Solvated alanine (the JAX package's and the port's, 640 atoms) and
    every other of its waters: no contiguous block."""
    kw = dict(addwater=True, padding=0.7, steps=3, dense_pairs=False)
    js = itk.MDSimulation(**kw)
    ts = itt.MDSimulation(device="cpu", **kw)
    return js, ts, water_triplets(ts.structure)[::2]


def test_scattered_waters_take_the_generic_path(water_pair):
    """Waters outside one contiguous block go into the generic path with
    their three distances, as in the reference: the same classes, SHAKE
    within 1e-6 nm, RATTLE within 1e-5."""
    js, ts, trip = water_pair
    jc = JaxConstraintSet(js.system, "HBonds", water=trip)
    tc = ConstraintSet(ts.system, "HBonds", water=trip)
    assert tc.nwater == jc.nwater == 0
    assert tc.ngeneric == jc.ngeneric >= 3 * len(trip)
    assert _classes(tc) == _classes(jc)
    x0 = ts.coords.numpy()[None].repeat(2, 0)
    x = (x0 + np.random.default_rng(3).normal(scale=2e-3, size=x0.shape)
         ).astype(np.float32)
    xs_j = np.asarray(jc.shake(jnp.asarray(x0), jnp.asarray(x)))
    xs_t = tc.shake(torch.as_tensor(x0), torch.as_tensor(x)).numpy()
    assert np.abs(xs_t - xs_j).max() < 1e-6
    assert tc.max_violation(xs_t) < 1e-5
    v = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    vr_j = np.asarray(jc.rattle(jnp.asarray(xs_j), jnp.asarray(v)))
    vr_t = tc.rattle(torch.tensor(xs_j), torch.as_tensor(v)).numpy()
    assert np.abs(vr_t - vr_j).max() / np.abs(vr_j).max() < 1e-5


def _stride4_system(lib):
    """Two solute atoms (C, H) then 3 four-site waters (O, H1, H2, M), M
    massless with a zero-length frame bond to O, as arrays of ``lib``."""
    masses = [12.011, 1.008] + [15.999, 1.008, 1.008, 0.0] * 3
    bonds = [(0, 1)] + [(o, o + d) for o in (2, 6, 10) for d in (1, 2, 3)]
    r0 = [0.109] + [0.09572, 0.09572, 0.015] * 3
    if lib is torch:
        def arr(a, dt):
            return torch.as_tensor(np.asarray(a), dtype=dt)
        f, i = torch.float32, torch.int64
    else:
        def arr(a, dt):
            return jnp.asarray(np.asarray(a), dt)
        f, i = jnp.float32, jnp.int32
    return SimpleNamespace(
        masses=arr(masses, f), bond_idx=arr(bonds, i), bond_r0=arr(r0, f),
        angle_idx=arr(np.zeros((0, 3)), i), angle_t0=arr(np.zeros(0), f))


def test_stride4_water_block_matches_jax():
    """A 4-site water block (the reference's molecule stride 4): the
    massless site stays where it is, and SHAKE (1e-6 nm) and RATTLE (1e-5)
    match JAX."""
    trip = np.asarray([[2, 3, 4], [6, 7, 8], [10, 11, 12]])
    jc = JaxConstraintSet(_stride4_system(jnp), "HBonds", water=trip)
    tc = ConstraintSet(_stride4_system(torch), "HBonds", water=trip)
    assert (tc.wstart, tc.wstride, tc.nwater) == (jc.wstart, jc.wstride,
                                                  jc.nwater) == (2, 4, 3)
    assert tc.ngeneric == jc.ngeneric == 1 and tc.ncons == jc.ncons == 10
    rng = np.random.default_rng(5)
    o = np.array([0.0, 0.0, 0.0])
    h1 = np.array([0.09572, 0.0, 0.0])
    h2 = 0.09572 * np.array([np.cos(ANG_HOH), np.sin(ANG_HOH), 0.0])
    m = 0.015 * (h1 + h2) / np.linalg.norm(h1 + h2)
    water = np.stack([o, h1, h2, m])
    x0 = np.concatenate([[[0.5, 0.5, 0.5], [0.5, 0.5, 0.609]]]
                        + [water + [0.4 * k, 0.0, 0.0] for k in range(3)])
    x0 = np.tile(x0.reshape(1, -1), (2, 1)).astype(np.float32)
    x = (x0 + rng.normal(scale=3e-3, size=x0.shape)).astype(np.float32)
    xs_j = np.asarray(jc.shake(jnp.asarray(x0), jnp.asarray(x)))
    xs_t = tc.shake(torch.as_tensor(x0), torch.as_tensor(x)).numpy()
    assert np.abs(xs_t - xs_j).max() < 1e-6
    # the water block's 25 Jacobi sweeps leave ~1e-5 nm at this kick, in
    # both packages (ROADMAP Queue 3 (j))
    assert abs(tc.max_violation(xs_t) - float(jc.max_violation(xs_j))) < 1e-6
    msite = [3 * a + k for a in (5, 9, 13) for k in range(3)]
    np.testing.assert_array_equal(xs_t[:, msite], x[:, msite])
    v = rng.normal(size=x.shape).astype(np.float32)
    vr_j = np.asarray(jc.rattle(jnp.asarray(xs_j), jnp.asarray(v)))
    vr_t = tc.rattle(torch.tensor(xs_j), torch.as_tensor(v)).numpy()
    assert np.abs(vr_t - vr_j).max() / np.abs(vr_j).max() < 1e-5


def test_unsupported_options_raise(sim):
    with pytest.raises(ValueError, match="Everything"):
        ConstraintSet(sim.system, "Everything")
    with pytest.raises(ValueError, match="langevin"):
        itt.MDSimulation(steps=5, constraints="HBonds",
                         integrator="brownian", device="cpu")


def test_constructor_records_constraints(sim):
    assert sim.constructor["constraints"] == "HBonds"
    assert sim.route == "plain"
    assert sim.constraint_set.ncons == int(
        (sim.system.masses < 3.5).sum())


def _noiseless_parity(jsim, sim, xs, v0):
    """10 noiseless constrained LangevinMiddle steps: JAX in float64 over
    its ``force_flat`` against the port's route in float32."""
    with jax.enable_x64():
        run = jax.jit(lambda x, v: JI.langevin_middle(
            lambda z: jax_force_flat(jsim.system, z), x, v, jsim.masses3,
            0.0, 1.0, 0.002, 10, jax.random.PRNGKey(0),
            constraints=jsim.constraint_set))
        x, v = run(jnp.asarray(xs, jnp.float64), jnp.asarray(v0, jnp.float64))
        x, v = np.asarray(x), np.asarray(v)
    assert x.dtype == np.float64
    xt, vt = sim._integrate(torch.as_tensor(xs), torch.as_tensor(v0), 10,
                            None)
    assert np.abs(xt.numpy() - x).max() / np.abs(x).max() < 1e-5
    assert np.abs(vt.numpy() - v).max() / np.abs(v).max() < 1e-4
    assert sim.constraint_set.max_violation(xt) < 1e-5


def test_noiseless_constrained_steps_plain_route_match_jax(jsim, sim):
    """Alanine with HBonds (the plain route)."""
    assert sim.route == "plain"
    xs = np.tile(sim.coords.numpy()[None], (2, 1))
    v0 = sim.constraint_set.rattle(
        torch.as_tensor(xs), torch.as_tensor(np.random.default_rng(6).normal(
            scale=0.3, size=xs.shape), dtype=torch.float32)).numpy()
    _noiseless_parity(jsim, sim, xs, v0)


def test_noiseless_constrained_steps_hybrid_route_match_jax():
    """Trp-cage in OBC2 with HBonds (the hybrid route: kernel D's plain
    version on the CPU, no launch)."""
    jsim = itk.MDSimulation(pdb=TRPCAGE, steps=10, implicit="obc2",
                            constraints="HBonds")
    sim = itt.MDSimulation(pdb=TRPCAGE, steps=10, implicit="obc2",
                           constraints="HBonds", device="cpu")
    assert sim.route == "hybrid"
    xs = np.tile(sim.coords.numpy()[None], (2, 1))
    v0 = sim.constraint_set.rattle(
        torch.as_tensor(xs), torch.as_tensor(np.random.default_rng(7).normal(
            scale=0.3, size=xs.shape), dtype=torch.float32)).numpy()
    n0 = GB.gb_force.launches
    _noiseless_parity(jsim, sim, xs, v0)
    assert GB.gb_force.launches == n0


def test_constrained_propagate_on_every_entry_point(sim):
    """propagate, randx0 and bootstrap_data keep HBonds within 1e-4 nm
    with finite frames (the JAX test's bounds), energies below E0 + 4.5
    kB T N."""
    ys = sim.propagate(sim.coords[None].repeat(6, 1), 1, gen=0)[:, 0]
    assert bool(torch.isfinite(ys).all())
    assert sim.constraint_set.max_violation(ys) < 1e-4
    e = sim.potential(ys)
    e0 = float(sim.potential(sim.coords[None])[0])
    assert bool((e < e0 + 4.5 * KB * 310 * sim.natoms).all())
    xs = sim.randx0(2, gen=1)
    assert sim.constraint_set.max_violation(xs) < 1e-4
    bx, by, *_ = sim.bootstrap_data(4, 1, gen=2, chains=1)
    assert sim.constraint_set.max_violation(by) < 1e-4
