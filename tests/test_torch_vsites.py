"""Port parity of virtual sites (``md/vsites.py``) and TIP4P-Ew water:
placement and the redistributed forces of average and out-of-plane sites
against autograd of the placed energy and against the JAX package, the
TIP4P-Ew box's tables, noiseless constrained steps against float64 JAX,
placed output frames, and the force route of a site system (CPU)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md import integrators as JI
from isokann_tpu.md import vsites as JV
from isokann_tpu.md.forces import force_flat as jax_force_flat
from isokann_tpu.md.system import system_from_tables as jax_tables

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import forces as F
from isokann_tpu_torch.md import vsites as V
from isokann_tpu_torch.md.solvate import M_WEIGHTS, R_OH, water_triplets
from isokann_tpu_torch.md.system import system_from_tables
from isokann_tpu_torch.simulators.mdsim import force_route

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

TIP4P = dict(addwater=True, padding=0.5, water_model="tip4pew", steps=3,
             features=[(0, 4)])


def _tables(oop=False):
    """The JAX test's 4-atom systems: the last atom an average3 site of
    the first three (a TIP4P-like M), or a TIP5P-like out-of-plane site."""
    if oop:
        return dict(masses=[16.0, 1.0, 1.0, 0.0],
                    charges=[0.2, 0.2, 0.2, -0.6],
                    rmin_half=[0.17, 0.0, 0.0, 0.0],
                    eps=[0.6, 0.0, 0.0, 0.0],
                    bond_idx=[(0, 1), (0, 2)],
                    bond_k=[20000.0, 20000.0], bond_r0=[0.1, 0.1],
                    excl_idx=[(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
                    excl_qq=[0.0] * 6, excl_lj=[0.0] * 6, method="NoCutoff")
    return dict(masses=[16.0, 1.0, 1.0, 0.0],
                charges=[0.0, 0.5, 0.5, -1.0],
                rmin_half=[0.17, 0.0, 0.0, 0.0],
                eps=[0.6, 0.0, 0.0, 0.0],
                bond_idx=[(0, 1), (0, 2), (0, 3)],
                bond_k=[20000.0, 20000.0, 0.0],
                bond_r0=[0.1, 0.1, 0.0125],
                excl_idx=[(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
                excl_qq=[0.0] * 6, excl_lj=[0.0] * 6, method="NoCutoff")


OOP = (0.4, 0.3, 5.0)          # w12, w13, wc


def _both(oop=False):
    """The toy system in both packages, sites attached."""
    t = _tables(oop)
    w12, w13, wc = OOP
    args = (([3], [(0, 1, 2)], [(1.0 - w12 - w13, w12, w13)])
            if oop else ([3], [(0, 1, 2)], [M_WEIGHTS]))
    kw = dict(vs_cross=[wc]) if oop else {}
    return (JV.attach_vsites(jax_tables(**t), *args, **kw),
            V.attach_vsites(system_from_tables(device="cpu", **t), *args,
                            **kw))


@pytest.mark.parametrize("oop", [False, True])
def test_placement(oop):
    """Site rows at the average (and cross term) of their parents within
    1e-7 nm, equal to the JAX package's; real rows untouched."""
    js, ts = _both(oop)
    assert V.has_vsites(ts) and (V._has_oop(ts) == oop)
    x = np.array([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.1, 0.0],
                  [9.0, 9.0, 9.0]], np.float32)
    xp = V.place_vsites(ts, torch.as_tensor(x)).numpy()
    if oop:
        w12, w13, wc = OOP
        d12, d13 = x[1] - x[0], x[2] - x[0]
        want = x[0] + w12 * d12 + w13 * d13 + wc * np.cross(d12, d13)
    else:
        want = M_WEIGHTS[0] * x[0] + M_WEIGHTS[1] * x[1] + M_WEIGHTS[2] * x[2]
    np.testing.assert_allclose(xp[3], want, atol=1e-7)
    np.testing.assert_array_equal(xp[:3], x[:3])
    np.testing.assert_allclose(
        xp, np.asarray(JV.place_vsites(js, jnp.asarray(x))), atol=1e-7)
    xf = torch.as_tensor(np.tile(x.reshape(-1), (5, 1)))
    np.testing.assert_allclose(V.place_vsites_flat(ts, xf).numpy(),
                               np.tile(xp.reshape(-1), (5, 1)), atol=1e-7)


@pytest.mark.parametrize("oop", [False, True])
def test_redistributed_force_is_the_chain_rule(oop):
    """force_flat (gradient at the placed frame handed to the parents)
    equals autograd of E(place(x)) within 1e-4 relative (2e-4 with the
    cross term, the JAX test's bounds), and the JAX package's force_flat
    within 1e-5 of its largest value; the site row carries no force."""
    js, ts = _both(oop)
    rng = np.random.default_rng(3 if oop else 0)
    x = (rng.normal(size=(4, 3)) * (0.06 if oop else 0.05)).astype(
        np.float32)
    f = F.force(ts, torch.as_tensor(x))
    assert torch.equal(f, F.force_flat(ts, torch.as_tensor(
        x.reshape(1, -1)))[0].reshape(4, 3))
    xg = torch.as_tensor(x).requires_grad_(True)
    (g,) = torch.autograd.grad(
        F._potential_raw(ts, V.place_vsites(ts, xg)[None])[0], xg)
    tol = 2e-4 if oop else 1e-4
    np.testing.assert_allclose(f[:3].numpy(), -g[:3].numpy(), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(f[3].numpy(), 0.0, atol=1e-7)
    fj = np.asarray(jax_force_flat(js, jnp.asarray(x.reshape(-1))))
    assert np.abs(f.numpy().reshape(-1) - fj).max() < 1e-5 * np.abs(fj).max()
    # the transpose alone, at the same site forces, equals JAX's
    fs = torch.as_tensor(rng.normal(size=(2, 4, 3)), dtype=torch.float32)
    got = V.redistribute_forces(ts, fs, torch.as_tensor(x))
    want = np.asarray(JV.redistribute_forces(js, jnp.asarray(fs.numpy()),
                                             jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_attach_vsites_refuses_what_the_reference_refuses():
    ts = system_from_tables(device="cpu", **_tables())
    with pytest.raises(ValueError, match="parenting"):
        V.attach_vsites(ts, [3, 2], [(0, 1, 2), (0, 1, 3)],
                        [M_WEIGHTS, M_WEIGHTS])
    with pytest.raises(ValueError, match="at most 3"):
        V.attach_vsites(ts, [3], [(0, 1, 2, 1)], [(0.4, 0.2, 0.2, 0.2)])
    with pytest.raises(ValueError, match="3 parents"):
        V.attach_vsites(ts, [3], [(0, 1)], [(0.5, 0.5)], vs_cross=[1.0])
    with pytest.raises(ValueError, match="sum to 1"):
        V.attach_vsites(ts, [3], [(0, 1, 2)], [(0.5, 0.2, 0.2)])


def test_site_system_refuses_the_fused_route():
    """A 4-atom vacuum system takes kernel A's route; with a site it
    does not (kernel A integrates every atom), as in the reference."""
    ts = system_from_tables(device="cpu", **_tables())
    assert force_route(ts) == "fused"
    assert force_route(V.attach_vsites(ts, [3], [(0, 1, 2)],
                                       [M_WEIGHTS])) == "plain"


@pytest.fixture(scope="module")
def tip4p():
    """The JAX test's TIP4P-Ew box (alanine, padding 0.5) in both
    packages."""
    return itk.MDSimulation(**TIP4P), itt.MDSimulation(device="cpu", **TIP4P)


def test_tip4p_box_tables_match_jax(tip4p):
    """The same atoms and coordinates, the site and constraint tables,
    charges, masses and exceptions as the JAX package's; each M carries the
    TIP4P-Ew charge and its O none; M massless in the system, 1e30 amu to
    the integrators; a stride-4 water block in the constraint solver."""
    js, ts = tip4p
    sj, st = js.system, ts.system
    assert ts.natoms == js.natoms and ts.route == "dense"
    np.testing.assert_allclose(ts.coords.numpy(), np.asarray(js.coords),
                               atol=1e-6)
    for name in ("vs_idx", "vs_gather", "vs_rev", "excl_idx", "bond_idx",
                 "angle_idx"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)), name)
    for name in ("vs_w", "vs_rev_w", "charges", "masses", "rmin_half",
                 "eps", "excl_qq", "excl_lj"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    vs = st.vs_idx.numpy()
    q = st.charges.numpy()
    np.testing.assert_allclose(q[vs], -1.04844, atol=1e-6)
    np.testing.assert_allclose(q[st.vs_gather.numpy()[vs, 0]], 0.0,
                               atol=1e-6)
    assert abs(q.sum() - round(q.sum())) < 1e-4
    np.testing.assert_allclose(st.masses.numpy()[vs], 0.0)
    assert float(ts.masses3.max()) > 1e20
    np.testing.assert_allclose(ts.masses3.numpy(), np.asarray(js.masses3),
                               rtol=1e-6)
    cs = ts.constraint_set
    assert cs.nwater == len(vs) and cs.wstride == 4 and cs.ngeneric == 0


def test_tip4p_energy_uses_the_m_charge(tip4p):
    """Moving a site row leaves the energy (it is placed again); moving its
    O changes it; each energy term (at the placed frame) equals the JAX
    package's within 1e-5 of its size, for the nonbonded term the size of
    its summands (the energy with every charge made positive, ~1e3 times
    the cancelled sum), + 1e-3 kJ/mol."""
    js, ts = tip4p
    x = ts.coords.numpy().reshape(-1, 3).astype(np.float64)
    vs = ts.system.vs_idx.numpy()

    def energy(xx):
        return float(ts.potential(torch.as_tensor(
            xx.reshape(1, -1), dtype=torch.float32))[0])

    e1 = energy(x)
    x2 = x.copy()
    x2[vs[0]] += 1.0
    assert math.isclose(e1, energy(x2), rel_tol=1e-6, abs_tol=1e-3)
    x3 = x.copy()
    x3[ts.system.vs_gather.numpy()[vs[0], 0]] += 0.05
    assert abs(energy(x3) - e1) > 1.0
    from isokann_tpu.md.forces import energy_terms as jax_terms
    tt = F.energy_terms(ts.system, torch.as_tensor(x2, dtype=torch.float32))
    tj = jax_terms(js.system, jnp.asarray(x2, jnp.float32))
    assert set(tt) == set(tj)
    size = {k: abs(float(v)) for k, v in tj.items()}
    pos = ts.system.replace(charges=ts.system.charges.abs())
    size["nonbonded"] = abs(float(F.nonbonded_energy(
        pos, torch.as_tensor(x2, dtype=torch.float32)[None])[0]))
    for k in tj:
        assert abs(float(tt[k]) - float(tj[k])) < 1e-5 * size[k] + 1e-3, k


def test_tip4p_noiseless_constrained_steps_match_jax(tip4p):
    """10 noiseless constrained LangevinMiddle steps of the TIP4P-Ew box
    (dense route, autograd forces through the placement): JAX in float64
    over its force_flat against the port in float32, x within 1e-5 and v
    within 1e-4 of their largest values (the constrained steps' bounds of
    ``tests/test_torch_constraints.py``); the site rows stay where they
    were (1e-6 nm), the waters rigid within 1e-5 nm."""
    js, ts = tip4p
    xs = np.tile(ts.coords.numpy()[None], (2, 1))
    v0 = ts.constraint_set.rattle(
        torch.as_tensor(xs), ts.random_velocities(itt.make_generator(8),
                                                  xs.shape)).numpy()
    with jax.enable_x64():
        run = jax.jit(lambda x, v: JI.langevin_middle(
            lambda z: jax_force_flat(js.system, z), x, v, js.masses3, 0.0,
            1.0, 0.002, 10, jax.random.PRNGKey(0),
            constraints=js.constraint_set))
        x, v = run(jnp.asarray(xs, jnp.float64), jnp.asarray(v0, jnp.float64))
        x, v = np.asarray(x), np.asarray(v)
    xt, vt = ts._integrate(torch.as_tensor(xs), torch.as_tensor(v0), 10,
                           None)
    assert np.abs(xt.numpy() - x).max() / np.abs(x).max() < 1e-5
    assert np.abs(vt.numpy() - v).max() / np.abs(v).max() < 1e-4
    assert ts.constraint_set.max_violation(xt) < 1e-5
    vs = ts.system.vs_idx.numpy()
    np.testing.assert_allclose(xt.numpy().reshape(2, -1, 3)[:, vs],
                               xs.reshape(2, -1, 3)[:, vs], atol=1e-6)


def test_tip4p_outputs_are_placed(tip4p):
    """propagate, trajectory and minimize return frames with every M on
    its average3 position within 2e-6 nm and rigid waters within 2e-3 nm
    of R_OH (the JAX test's bounds)."""
    _, ts = tip4p
    st = ts.system
    vs, par = st.vs_idx.numpy(), st.vs_gather.numpy()[st.vs_idx.numpy()]
    trip = water_triplets(ts.structure)
    w = M_WEIGHTS
    ys = ts.propagate(ts.coords[None], 2, gen=0).reshape(2, -1)
    tr = ts.trajectory(steps=2, saveevery=1, gen=1)
    mn = ts.minimize(maxiter=3)[None]
    for frames in (ys, tr, mn):
        f3 = frames.numpy().reshape(frames.shape[0], -1, 3)
        assert np.isfinite(f3).all()
        want = (w[0] * f3[:, par[:, 0]] + w[1] * f3[:, par[:, 1]]
                + w[2] * f3[:, par[:, 2]])
        np.testing.assert_allclose(f3[:, vs], want, atol=2e-6)
    d = np.linalg.norm(ys.numpy().reshape(2, -1, 3)[:, trip[:, 0]]
                       - ys.numpy().reshape(2, -1, 3)[:, trip[:, 1]], axis=-1)
    np.testing.assert_allclose(d, R_OH, atol=2e-3)
