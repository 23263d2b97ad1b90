"""Port parity of the analytic nonbonded and OBC2 forces
(``md/gbsa_force.py``) on the JAX test's system (``tests/test_pallas_md.py``:
alanine in OBC2, 8 walkers moved by 0.01 nm normals): against autograd of
the port's energies and against the JAX package's ``gbsa_force`` (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md import gbsa_force as JG

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import forces as F
from isokann_tpu_torch.md import gbsa_force as G

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def systems():
    js = itk.MDSimulation(steps=5, implicit="obc2")
    ts = itt.MDSimulation(steps=5, implicit="obc2", device="cpu")
    rng = np.random.default_rng(0)
    xs = (np.asarray(js.coords)[None, :]
          + rng.normal(scale=0.01, size=(8, 66))).astype(np.float32)
    return js.system, ts.system, xs


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _minus_grad(energy, x):
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(energy(xg).sum(), xg)
    return -g


def test_nonbonded_direct_matches_autograd_and_jax(systems):
    js, ts, xs = systems
    x3 = torch.as_tensor(xs).reshape(8, 22, 3)
    f = G.nonbonded_force_direct(ts, x3)
    assert _rel(f, _minus_grad(lambda z: F.nonbonded_energy(ts, z), x3)) \
        < 1e-5
    ref = jax.vmap(lambda z: JG.nonbonded_force_direct(js, z))(
        jnp.asarray(xs).reshape(8, 22, 3))
    assert _rel(f, ref) < 1e-5
    # one walker (n, 3) as the reference takes it
    assert _rel(G.nonbonded_force_direct(ts, x3[0]), ref[0]) < 1e-5


@pytest.mark.parametrize("method", ["CutoffNonPeriodic", "CutoffPeriodic"])
def test_reaction_field_direct_matches_autograd(method):
    """The reaction field (minimum image when periodic) on the vacuum
    alanine system."""
    from isokann_tpu_torch.md.system import build_system
    from isokann_tpu_torch.md.fixtures import alanine_dipeptide_pdb
    ts = build_system(alanine_dipeptide_pdb(), method=method, cutoff=0.6,
                      device="cpu")
    rng = np.random.default_rng(2)
    x3 = torch.as_tensor(np.asarray(
        itt.MDSimulation(steps=2, device="cpu").coords).reshape(1, 22, 3)
        + rng.normal(scale=0.01, size=(4, 22, 3)), dtype=torch.float32)
    f = G.nonbonded_force_direct(ts, x3)
    assert _rel(f, _minus_grad(lambda z: F.nonbonded_energy(ts, z), x3)) \
        < 1e-5


def test_obc2_force_matches_autograd_and_jax(systems):
    js, ts, xs = systems
    x3 = torch.as_tensor(xs).reshape(8, 22, 3)
    f = G.obc2_force(ts, x3)
    assert _rel(f, _minus_grad(lambda z: F.gbsa_obc2_energy(ts, z), x3)) \
        < 1e-4
    ref = jax.vmap(lambda z: JG.obc2_force(js, z))(
        jnp.asarray(xs).reshape(8, 22, 3))
    assert _rel(f, ref) < 1e-5


def test_total_force_matches_force_flat_and_jax(systems):
    js, ts, xs = systems
    x = torch.as_tensor(xs)
    f = G.force_flat_analytic(ts, x)
    assert f.shape == x.shape
    assert _rel(f, F.force_flat(ts, x)) < 1e-4
    assert _rel(f, JG.force_flat_analytic(js, jnp.asarray(xs))) < 1e-5


def test_ewald_raises(systems):
    _, ts, xs = systems
    with pytest.raises(ValueError, match="Ewald"):
        G.nonbonded_force_direct(ts.replace(method="PME"),
                                 torch.as_tensor(xs).reshape(8, 22, 3))


def test_bonded_force_flat_matches_autograd_and_jax(systems):
    """``forces.bonded_force_flat`` (analytic, the hybrid route's bonded
    part) against autograd of ``bonded_energy`` and the JAX package's
    autograd of its own, 1e-5 relative to the largest force."""
    from isokann_tpu.md import forces as JF
    js, ts, xs = systems
    x = torch.as_tensor(xs)
    f = F.bonded_force_flat(ts, x)
    assert f.shape == x.shape
    assert _rel(f, _minus_grad(lambda z: F.bonded_energy(
        ts, z.reshape(8, 22, 3)), x)) < 1e-5

    def jax_bonded(z):
        z = z.reshape(22, 3)
        return (JF.bond_energy(js, z) + JF.angle_energy(js, z)
                + JF.dihedral_energy(js, z))
    ref = -jax.vmap(jax.grad(jax_bonded))(jnp.asarray(xs))
    assert _rel(f, ref) < 1e-5


@pytest.mark.parametrize("kw", [dict(constraints="HBonds"),
                                dict(implicit="obc2", constraints="HBonds"),
                                dict(addwater=True, padding=0.9)],
                         ids=["plain_rf", "plain_obc2", "dense_rf"])
def test_plain_and_dense_routes_take_the_analytic_forces(kw):
    """The "plain" and "dense" routes of ``MDSimulation`` under the
    reaction field or OBC2 are the analytic forces, equal to autograd
    ``force_flat`` within 1e-5 relative to the largest force."""
    sim = itt.MDSimulation(device="cpu", **kw)
    assert sim.route in ("plain", "dense")
    rng = np.random.default_rng(3)
    x = sim.coords[None] + torch.as_tensor(
        rng.normal(scale=0.002, size=(2, sim.dim)), dtype=torch.float32)
    f = sim.force(x)
    assert _rel(f, G.force_flat_analytic(sim.system, x)) == 0.0
    assert _rel(f, F.force_flat(sim.system, x)) < 1e-5
