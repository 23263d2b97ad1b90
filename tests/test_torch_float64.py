"""``MDSimulation(dtype=torch.float64)``: every route's plain version in
float64, held against the JAX package's ``MDSimulation(dtype=jnp.float64)``
under ``jax.enable_x64()`` on the same coordinates (numpy, from a seed).

Energy terms and forces at 1e-9 relative to the largest force (or term),
noiseless 10-step LangevinMiddle trajectories at 1e-9 nm; float32 keeps
every kernel route, any other dtype raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
import isokann_tpu_torch as itt
from isokann_tpu.md import integrators as JI
from isokann_tpu.md.forces import energy_terms as jax_energy_terms
from isokann_tpu_torch.md import forces as F
from isokann_tpu_torch.md import gb_kernel as GB
from isokann_tpu_torch.md import langevin_kernel as LK
from isokann_tpu_torch.md import neighbor_kernel as NBK

# small tensor ops: one intra-op thread each; several test workers share
# the machine and oversubscribed threads slow them down
torch.set_num_threads(1)

TRPCAGE = os.path.join(os.path.dirname(__file__), "..", "out",
                       "trpcage.pdb")
PME = dict(addwater=True, padding=0.9, steps=3, method="PME")
CASES = {
    "vacuum": (dict(), "fused"),
    "obc2": (dict(implicit="obc2"), "plain"),
    "hbonds": (dict(constraints="HBonds"), "plain"),
    "pme_dense": (dict(PME), "dense"),
    "pme_sparse": (dict(PME, dense_pairs=False), "neighbor"),
    "trpcage_obc2": (dict(pdb=TRPCAGE, implicit="obc2"), "hybrid"),
}


def _launches():
    return (LK.langevin_middle.launches, LK.forces.launches,
            GB.gb_force.launches, NBK.neighbor_sweep.launches)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """(name, the JAX float64 simulation, the port's float64 one, a walker
    (1, 3N) near the start state)."""
    kw, route = CASES[request.param]
    with jax.enable_x64():
        jsim = itk.MDSimulation(dtype=jnp.float64, **kw)
    sim = itt.MDSimulation(dtype=torch.float64, device="cpu", **kw)
    assert sim.route == route and sim.plain_versions
    assert sim.coords.dtype == torch.float64
    rng = np.random.default_rng(11)
    x = (sim.coords.numpy()[None]
         + rng.normal(scale=0.002, size=(1, sim.dim)))
    return request.param, jsim, sim, x


def test_energy_terms_match_jax(pair):
    """Every energy term of the float64 system (the total of the neighbor
    route's) at 1e-9 relative to the largest term."""
    name, jsim, sim, x = pair
    n = sim.natoms
    with jax.enable_x64():
        if sim.system.dense_pairs:
            jt = {k: np.asarray(v) for k, v in jax.jit(
                lambda z: jax_energy_terms(jsim.system, z))(
                jnp.asarray(x[0].reshape(n, 3))).items()}
        else:
            # the JAX package's term breakdown is dense-only: the total
            jt = dict(total=np.asarray(jax.jit(jsim.potential)(
                jnp.asarray(x[0]))))
    if sim.system.dense_pairs:
        pt = {k: np.asarray(torch.as_tensor(v).detach()) for k, v in
              F.energy_terms(sim.system,
                             torch.as_tensor(x[0].reshape(n, 3))).items()}
    else:
        pt = dict(total=sim.potential(torch.as_tensor(x[0])).numpy())
    assert set(jt) == set(pt), (set(jt), set(pt))
    scale = max(abs(float(v)) for v in jt.values())
    for k in jt:
        assert abs(float(pt[k]) - float(jt[k])) <= 1e-9 * scale, (
            name, k, float(pt[k]), float(jt[k]))


def test_forces_match_jax(pair):
    """The route's forces (its kernel's plain version) at 1e-9 relative to
    the largest force; no kernel launches."""
    name, jsim, sim, x = pair
    with jax.enable_x64():
        fj = np.asarray(jax.jit(jsim.force)(jnp.asarray(x)))
    n0 = _launches()
    fp = sim.force(torch.as_tensor(x))
    assert fp.dtype == torch.float64 and _launches() == n0
    err = np.abs(fp.numpy() - fj).max() / np.abs(fj).max()
    assert err < 1e-9, (name, err)


def test_noiseless_trajectory_matches_jax(pair):
    """10 noiseless LangevinMiddle steps through the route (with its
    constraints) at 1e-9 nm against JAX's float64 recursion (at 0 K, its
    noiseless form)."""
    name, jsim, sim, x = pair
    v0 = np.random.default_rng(5).normal(scale=0.3, size=x.shape)
    if sim.constraint_set is not None:
        v0 = sim.constraint_set.rattle(torch.as_tensor(x),
                                       torch.as_tensor(v0)).numpy()
    with jax.enable_x64():
        xj, _ = jax.jit(lambda x, v: JI.langevin_middle(
            jsim._force_fn(), x, v, jsim.masses3, 0.0, jsim.friction,
            jsim.step, 10, jax.random.PRNGKey(0),
            constraints=jsim.constraint_set))(jnp.asarray(x),
                                              jnp.asarray(v0))
        xj = np.asarray(xj)
    assert xj.dtype == np.float64
    xt, _ = sim._integrate(torch.as_tensor(x), torch.as_tensor(v0), 10,
                           None)
    assert xt.dtype == torch.float64
    err = np.abs(xt.numpy() - xj).max()
    assert err < 1e-9, (name, err)


def test_float64_entry_points_run_plain():
    """propagate, trajectory and randx0 of a float64 simulation return
    float64 frames from the plain versions (no kernel launch), and the
    bootstrap's features are float32, as the JAX package's."""
    sim = itt.MDSimulation(steps=5, dtype=np.float64, device="cpu")
    n0 = _launches()
    ys = sim.propagate(sim.coords[None].repeat(2, 1), 2, gen=0)
    tr = sim.trajectory(steps=10, saveevery=5, gen=1)
    x0 = sim.randx0(2, gen=2)
    assert _launches() == n0
    for t in (ys, tr, x0):
        assert t.dtype == torch.float64 and bool(torch.isfinite(t).all())
    assert ys.shape == (2, 2, 66) and tr.shape == (2, 66)
    data = itt.SimulationData.from_sim(sim, nx=4, nk=2, gen=3)
    assert data.features.dtype == torch.float32
    assert data.coords.dtype == torch.float64


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   np.float16, "float64"])
def test_other_dtypes_raise(dtype):
    with pytest.raises(ValueError, match="float32"):
        itt.MDSimulation(dtype=dtype, device="cpu")


@pytest.mark.parametrize("kw,route", [
    (dict(), "fused"), (dict(implicit="obc2"), "plain"),
    (dict(pdb=TRPCAGE, implicit="obc2"), "hybrid"),
    (dict(PME, dense_pairs=False), "neighbor")])
def test_float32_keeps_kernel_routes(kw, route):
    """float32 (the default, torch's or numpy's) takes the kernel route it
    took, with float32 plans."""
    for dtype in (torch.float32, np.float32):
        sim = itt.MDSimulation(dtype=dtype, device="cpu", **kw)
        assert sim.route == route and not sim.plain_versions
        assert sim.coords.dtype == torch.float32
        assert sim.system.charges.dtype == torch.float32
        if route == "fused":
            assert sim.plan.ftab.dtype == np.float32


@pytest.mark.parametrize("dense", [True, False])
def test_float64_barostat_runs_plain(dense):
    """``npt_langevin`` on a float64 simulation (the JAX NPT test's
    flexible water box, dense and neighbor routes): float64 frames, the
    volume moves attempted, no kernel launch; the box state is float32,
    as the JAX package keeps it."""
    from isokann_tpu_torch.md import barostat as B
    sim = itt.MDSimulation(addwater=True, padding=0.62, steps=5,
                           rigidwater=False, step=0.001,
                           dense_pairs=dense, dtype=torch.float64,
                           device="cpu")
    assert sim.route == ("dense" if dense else "neighbor")
    n0 = _launches()
    xf, box_f, info = B.npt_langevin(sim, gen=2, steps=8, interval=4)
    assert _launches() == n0
    assert xf.dtype == torch.float64 and bool(torch.isfinite(xf).all())
    assert box_f.dtype == torch.float32 and info["attempted"] == 2
