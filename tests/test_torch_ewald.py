"""Port parity of Ewald / PME (``md/ewald.py``, the Ewald branch of
``forces.nonbonded_energy``, the neighbor engine under Ewald) and of the
dense route: the NaCl Madelung constant, alpha invariance, the erfc
approximation and the reciprocal force against autograd (as the JAX
package's ``tests/test_ewald.py``), the k-vector tables, the PME box's
energy and forces against the JAX package, the neighbor route against
the dense one within the JAX test's bounds, and a dense periodic box's
forces against JAX's ``force_flat`` (CPU)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md import ewald as JE
from isokann_tpu.md import forces as JF
from isokann_tpu.md import neighbor as JN

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import ewald as E
from isokann_tpu_torch.md import forces as F
from isokann_tpu_torch.md import neighbor as NB
from isokann_tpu_torch.md import neighbor_kernel as NK
from isokann_tpu_torch.md.system import COULOMB, build_system

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

A_NACL = 0.564          # nm, NaCl conventional-cell lattice constant
MADELUNG = 1.7475646
PME = dict(addwater=True, padding=0.9, steps=3, method="PME")


def _nacl():
    fcc = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    pos = np.concatenate([fcc, fcc + [0.5, 0, 0]]) % 1.0 * A_NACL
    q = np.array([1.0] * 4 + [-1.0] * 4)
    return (torch.as_tensor(pos, dtype=torch.float64),
            torch.as_tensor(q, dtype=torch.float64), np.array([A_NACL] * 3))


def _ewald_total(x, q, box, rc, tol):
    """Real + reciprocal + self energy of one float64 configuration."""
    al = E.ewald_alpha(rc, tol)
    kv, cf = (torch.as_tensor(v) for v in E.ewald_kvectors(box, al, tol))
    n = x.shape[0]
    bx = torch.as_tensor(box)
    d = x[:, None, :] - x[None, :, :]
    d = d - bx * torch.round(d / bx)
    eye = torch.eye(n, dtype=x.dtype)
    r = torch.sqrt((d ** 2).sum(-1) + eye)
    qq = COULOMB * q[:, None] * q[None, :]
    mask = (1 - eye) * (r < rc)
    e_real = 0.5 * torch.sum(qq * torch.special.erfc(al * r) / r * mask)
    return float(e_real + E.ewald_recip_energy(kv, cf, q, x)
                 + E.ewald_self_energy(al, q))


def test_madelung():
    """The rocksalt lattice energy is -M C q^2 / d per ion pair (4 pairs
    in the conventional cell), to 1e-6."""
    x, q, box = _nacl()
    target = -MADELUNG * COULOMB / (A_NACL / 2) * 4
    e = _ewald_total(x, q, box, rc=0.25, tol=1e-6)
    assert abs(e / target - 1) < 1e-6, (e, target)


def test_alpha_invariance():
    """The split between real and reciprocal space leaves the total."""
    x, q, box = _nacl()
    e1 = _ewald_total(x, q, box, rc=0.27, tol=1e-7)
    e2 = _ewald_total(x, q, box, rc=0.22, tol=1e-7)
    assert abs(e1 / e2 - 1) < 1e-6


def test_erfc_approx_accuracy():
    """A&S 7.1.26 in float32 within 1e-6 of erfc, and equal to the JAX
    package's to float32 rounding."""
    xs = torch.linspace(0.0, 6.0, 2000)
    assert float((E.erfc_approx(xs) - torch.special.erfc(xs)).abs().max()) \
        < 1e-6
    np.testing.assert_allclose(E.erfc_approx(xs).numpy(),
                               np.asarray(JE.erfc_approx(jnp.asarray(
                                   xs.numpy()))), rtol=1e-6, atol=1e-7)


def test_recip_force_matches_autograd():
    x, q, box = _nacl()
    x = (x + 0.02 * torch.as_tensor(np.random.default_rng(0).normal(
        size=x.shape))).float()
    q = q.float()
    al = E.ewald_alpha(0.25, 1e-5)
    kv, cf = (torch.as_tensor(v, dtype=torch.float32)
              for v in E.ewald_kvectors(box, al, 1e-5))
    fa = E.ewald_recip_force(kv, cf, q, x)
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(E.ewald_recip_energy(kv, cf, q, xg), xg)
    assert float((fa + g).abs().max()) < 1e-3 * (float(g.abs().max()) + 1)


@pytest.mark.parametrize("rc,tol", [(0.25, 1e-6), (1.0, 5e-4),
                                    (0.9, 5e-5)])
def test_kvectors_match_jax(rc, tol):
    """The k-vector tables in float64 equal the JAX package's."""
    box = np.array([3.1, 2.7, 2.9])
    al = E.ewald_alpha(rc, tol)
    assert al == JE.ewald_alpha(rc, tol)
    kv, cf = E.ewald_kvectors(box, al, tol)
    jkv, jcf = JE.ewald_kvectors(box, al, tol)
    assert kv.dtype == cf.dtype == np.float64
    np.testing.assert_array_equal(kv, np.asarray(jkv))
    np.testing.assert_array_equal(cf, np.asarray(jcf))


def test_exception_force_matches_autograd(pme):
    _, ts, _, x = pme
    s = ts.system
    xb = torch.as_tensor(x)[None]
    fa = E.ewald_exception_force(s, xb, s.ewald_alpha)
    xg = xb.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(
        E.ewald_exception_energy(s, xg, s.ewald_alpha).sum(), xg)
    assert float((fa + g).abs().max()) < 1e-4 * float(g.abs().max())


@pytest.fixture(scope="module")
def pme():
    """The JAX test's PME box (1,012 atoms) in both packages, the port's
    also with ``dense_pairs=False``, and its perturbed frame."""
    js = itk.MDSimulation(**PME)
    ts = itt.MDSimulation(device="cpu", **PME)
    tn = itt.MDSimulation(device="cpu", dense_pairs=False, **PME)
    rng = np.random.default_rng(0)
    x = (np.asarray(js.coords).reshape(-1, 3)
         + rng.normal(scale=0.003, size=(ts.natoms, 3))).astype(np.float32)
    return js, ts, tn, x


def test_pme_system_matches_jax(pme):
    js, ts, tn, _ = pme
    assert ts.natoms == tn.natoms == 1012
    for s in (ts.system, tn.system):
        assert s.method == "PME" and s.ewald_alpha == js.system.ewald_alpha
        assert s.cutoff == js.system.cutoff
        assert s.use_dispersion == js.system.use_dispersion is True
        assert s.ewald_kvecs.shape[0] > 100
        np.testing.assert_array_equal(s.ewald_kvecs.numpy(),
                                      np.asarray(js.system.ewald_kvecs))
        np.testing.assert_array_equal(s.ewald_coefs.numpy(),
                                      np.asarray(js.system.ewald_coefs))
    assert (ts.route, tn.route) == ("dense", "neighbor")
    ew = build_system(ts.structure, method="Ewald", device="cpu")
    np.testing.assert_array_equal(ew.ewald_kvecs.numpy(),
                                  ts.system.ewald_kvecs.numpy())


def test_pme_dense_energy_matches_jax(pme):
    """The dense nonbonded energy (erfc real space, cut and 1-4 LJ,
    reciprocal, self and exception terms) within 1e-5 relative."""
    js, ts, _, x = pme
    e_j = float(JF.nonbonded_energy(js.system, jnp.asarray(x)))
    e_t = float(F.nonbonded_energy(ts.system, torch.as_tensor(x)[None])[0])
    assert abs(e_t - e_j) < 1e-5 * abs(e_j)


@pytest.mark.slow
def test_pme_neighbor_energy_matches_dense(pme):
    _, ts, tn, x = pme
    plan = NB.NeighborPlan(tn.system, x0=x)
    e_n = float(NB.neighbor_nonbonded_energy(tn.system, torch.as_tensor(x),
                                             plan))
    e_d = float(F.nonbonded_energy(ts.system, torch.as_tensor(x)[None])[0])
    assert abs(e_n - e_d) < 2e-4 * abs(e_d) + 0.5, (e_n, e_d)


def _dense_nonbonded_force(sys, x):
    xg = torch.as_tensor(x)[None].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(F.nonbonded_energy(sys, xg).sum(), xg)
    return -g[0].numpy()


def test_pme_neighbor_force_matches_dense(pme):
    """The neighbor engine's analytic PME forces (the erfc sweep through
    kernel E's plain version, exceptions, reciprocal) against autograd of
    the dense energy: the JAX test's bound, 2e-4 max|f| + 0.5."""
    _, ts, tn, x = pme
    plan = NB.NeighborPlan(tn.system, x0=x)
    f_n = NB.neighbor_nonbonded_force(tn.system, torch.as_tensor(x),
                                      plan).numpy()
    f_d = _dense_nonbonded_force(ts.system, x)
    assert np.abs(f_n - f_d).max() < 2e-4 * np.abs(f_d).max() + 0.5
    # the same through the sweep wrapper, walker-batched
    xb = torch.as_tensor(x.reshape(1, -1))
    f_w = NB.force_flat_neighbor(tn.system, xb, plan).numpy().reshape(-1, 3)
    f_b = NB.bonded_force_sparse(tn.system, torch.as_tensor(x)[None])[0]
    assert np.abs(f_w - f_b.numpy() - f_d).max() < \
        2e-4 * np.abs(f_d).max() + 0.5


def test_pme_neighbor_force_matches_own_energy_grad(pme):
    """Analytic neighbor forces against autograd of the neighbor energy:
    every correction term's derivative."""
    _, _, tn, x = pme
    plan = NB.NeighborPlan(tn.system, x0=x)
    f_a = NB.neighbor_nonbonded_force(tn.system, torch.as_tensor(x),
                                      plan).numpy()
    xg = torch.as_tensor(x).clone().requires_grad_(True)
    (g,) = torch.autograd.grad(
        NB.neighbor_nonbonded_energy(tn.system, xg, plan), xg)
    f_g = -g.numpy()
    assert np.abs(f_a - f_g).max() < 2e-4 * np.abs(f_g).max() + 0.5


def test_pme_neighbor_route_matches_jax(pme):
    """The neighbor route's whole PME forces (``MDSimulation.force``:
    sweep with alpha, exceptions, reciprocal, bonded) against the JAX
    package's XLA ``force_flat_neighbor`` within 1e-4 relative."""
    _, _, tn, x = pme
    jn = itk.MDSimulation(dense_pairs=False, **PME)
    jp = JN.NeighborPlan(jn.system, x0=x)
    xb = x.reshape(1, -1)
    f_j = np.asarray(jax.jit(lambda z: JN.force_flat_neighbor(
        jn.system, z, jp))(jnp.asarray(xb)))
    n0 = NK.neighbor_sweep.launches
    f_t = tn.force(torch.as_tensor(xb)).numpy()
    assert NK.neighbor_sweep.launches == n0
    assert np.abs(f_t - f_j).max() < 1e-4 * np.abs(f_j).max()


def test_dense_route_forces_match_jax():
    """A dense periodic box (alanine with 0.55 nm of water, reaction
    field): route "dense", forces against JAX's ``force_flat`` within
    1e-5 relative."""
    kw = dict(addwater=True, padding=0.55, steps=3)
    js = itk.MDSimulation(**kw)
    ts = itt.MDSimulation(device="cpu", **kw)
    assert ts.route == "dense" and ts.system.method == "CutoffPeriodic"
    assert 64 < ts.natoms <= 4000 and ts.system.dense_pairs
    rng = np.random.default_rng(1)
    xb = (np.asarray(js.coords)[None] + rng.normal(
        scale=0.003, size=(2, ts.dim))).astype(np.float32)
    f_j = np.asarray(jax.jit(lambda z: JF.force_flat(js.system, z))(
        jnp.asarray(xb)))
    f_t = ts.force(torch.as_tensor(xb)).numpy()
    assert np.abs(f_t - f_j).max() < 1e-5 * np.abs(f_j).max()


def test_pme_simulation_propagates(pme):
    """Both routes of the PME box run 2 lags (``randx0(2)``) with finite
    frames and energies and the rigid waters held (the JAX test's
    end-to-end check)."""
    _, ts, tn, _ = pme
    for sim in (ts, tn):
        y = sim.randx0(2, gen=0)
        assert bool(torch.isfinite(y).all())
        assert bool(torch.isfinite(sim.potential(y)).all())
        assert sim.constraint_set.max_violation(y) < 1e-5
    assert tn.overflows == 0


def test_pme_vs_rf_physics(pme):
    """PME and reaction field describe the same neutral box: the forces
    correlate (the JAX test's bounds, corr > 0.97, rel < 0.3)."""
    _, ts, _, _ = pme
    rf = build_system(ts.structure, method="CutoffPeriodic", device="cpu")
    x = ts.coords.numpy().reshape(-1, 3)
    f_pme = _dense_nonbonded_force(ts.system, x)
    f_rf = _dense_nonbonded_force(rf, x)
    corr = np.corrcoef(f_pme.ravel(), f_rf.ravel())[0, 1]
    rel = np.linalg.norm(f_pme - f_rf) / np.linalg.norm(f_rf)
    assert corr > 0.97 and rel < 0.3, (corr, rel)
    assert math.isclose(ts.system.cutoff, rf.cutoff)
