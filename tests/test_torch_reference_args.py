"""The reference arguments the port lacked, each called as the JAX package
calls it: ``MDSimulation(dispersion_correction=, dtype=)``,
``Iso(transform=)``, ``Iso.run(showprogress=)`` and the module-level
``run(**kw)``, ``pairnet(data=)``, ``langevin_middle(save_every=)``,
``minimize_energy(tol=)``, ``minimize_levelset(retract_every=)`` and
``alanine_dipeptide_pdb(minimized=)``; held against JAX where the
argument changes a result."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.analysis.minimumpath import \
    minimize_levelset as jax_minimize_levelset
from isokann_tpu.md import integrators as JI
from isokann_tpu.md.fixtures import \
    alanine_dipeptide_pdb as jax_alanine_dipeptide_pdb
from isokann_tpu.md.forces import dispersion_correction_energy as jax_disp
from isokann_tpu.models import pairnet as jax_pairnet

import isokann_tpu_torch as itt
from isokann_tpu_torch import workflows as W
from isokann_tpu_torch.analysis.minimumpath import minimize_levelset
from isokann_tpu_torch.md import forces as F
from isokann_tpu_torch.md import integrators as I
from isokann_tpu_torch.md.minimize import minimize_energy

torch.set_num_threads(1)


# ---- MDSimulation(dispersion_correction=, dtype=) -----------------------------

@pytest.mark.parametrize("dc", [True, False])
def test_dispersion_correction_energy_matches_jax(dc):
    """Solvated alanine (a periodic box, 355 atoms at padding 0.5): the
    potential at the start state with and without the long-range LJ tail
    equals JAX's within 1e-3 kJ/mol (float32 sums over ~63,000 pairs;
    the energies are -53 and 4.4 kJ/mol), the tail itself within 1e-6
    relative, and the argument is recorded in ``constructor``."""
    j = itk.MDSimulation(addwater=True, padding=0.5, steps=2,
                         dispersion_correction=dc)
    t = itt.MDSimulation(addwater=True, padding=0.5, steps=2,
                         dispersion_correction=dc, device="cpu")
    assert t.natoms == j.natoms == 355
    assert t.system.use_dispersion is dc
    assert t.constructor["dispersion_correction"] is dc
    assert abs(float(t.potential(t.coords))
               - float(j.potential(j.coords))) < 1e-3
    tail_t = float(F.dispersion_correction_energy(t.system))
    tail_j = float(jax_disp(j.system))
    if dc:
        assert tail_t < 0 and abs(tail_t - tail_j) <= 1e-6 * abs(tail_j)
    else:
        assert tail_t == tail_j == 0.0


def test_escalate_lag_keeps_dispersion_correction():
    sim = itt.MDSimulation(steps=2, dispersion_correction=False,
                           device="cpu")
    iso = itt.Iso(sim=sim, nx=4, nk=1, gen=0, opt=itt.AdamRegularized())
    W.escalate_lag(iso, 4, nx_max=4, gen=1)
    assert iso.data.sim.constructor["dispersion_correction"] is False
    assert iso.data.sim.constructor["steps"] == 4


@pytest.mark.parametrize("dtype", [torch.float32, np.float32])
def test_dtype_float32_accepted(dtype):
    sim = itt.MDSimulation(steps=2, dtype=dtype, device="cpu")
    assert sim.coords.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float64, np.float64, torch.float16])
def test_dtype_other_raises(dtype):
    """float64 (torch's or numpy's) builds the float64 plain routes since
    they were ported (``tests/test_torch_float64.py`` holds them to the
    JAX package); any other dtype still raises."""
    if dtype in (torch.float64, np.float64):
        sim = itt.MDSimulation(steps=2, dtype=dtype, device="cpu")
        assert sim.coords.dtype == torch.float64 and sim.plain_versions
        return
    with pytest.raises(ValueError, match="float32 .* or float64"):
        itt.MDSimulation(steps=2, dtype=dtype, device="cpu")


# ---- Iso(transform=), run(showprogress=) -------------------------------------

def test_iso_transform_is_target():
    """``transform`` sets the target when ``target`` is not given, as in
    JAX; ``target`` wins when both are."""
    sim = itt.Doublewell(device="cpu")
    tr = itt.TransformPseudoInv()
    iso = itt.Iso(sim=sim, nx=8, nk=2, gen=0, transform=tr)
    jiso = itk.Iso(sim=itk.Doublewell(), nx=8, nk=2, key=0,
                   transform=itk.TransformPseudoInv())
    assert iso.target is tr
    assert type(iso.target).__name__ == type(jiso.target).__name__
    ss = itt.TransformShiftscale()
    assert itt.Iso(sim=sim, nx=8, nk=2, gen=0, target=ss,
                   transform=tr).target is ss


@pytest.mark.parametrize("fused", [True, False])
def test_run_showprogress(capsys, fused):
    """One progress line per host sync: at the end of a fused run, after
    every iteration of a host target; the same losses as without it."""
    # a host target: the ISA transform of a 3-output chi
    sim = itt.Doublewell(device="cpu") if fused else itt.Triplewell(
        device="cpu")
    nout = 1 if fused else 3
    a = itt.Iso(sim=sim, nx=16, nk=2, gen=0, nout=nout,
                opt=itt.AdamRegularized())
    b = itt.Iso(data=a.data, model=copy.deepcopy(a.model), gen=0,
                nout=nout, opt=itt.AdamRegularized())
    assert getattr(a.target, "fused", False) is fused
    a.run(3, showprogress=True)
    out = capsys.readouterr().out
    b.run(3)
    assert a.losses == b.losses
    assert out.count("[run]") == (1 if fused else 3)
    assert "[run] 3/3 loss=" in out and out.endswith("\n")
    itt.run(a, 2, 1, showprogress=True)
    assert "[run] 2/2" in capsys.readouterr().out and len(a.losses) == 5


# ---- pairnet(data=) -------------------------------------------------------------

def test_pairnet_data_gives_n():
    """``n`` defaults to ``data.featuredim``: the JAX package's sizes."""
    sim = itt.MDSimulation(steps=2, device="cpu")
    data = itt.SimulationData.from_sim(sim, nx=3, nk=1, gen=0)
    m = itt.pairnet(data=data)
    jd = type("D", (), {"featuredim": data.featuredim})()
    jm = jax_pairnet(data=jd, key=jax.random.PRNGKey(0))
    assert tuple(m.sizes) == tuple(jm.sizes) == (231, 38, 6, 1)
    with pytest.raises(ValueError, match="n or data"):
        itt.pairnet()


# ---- langevin_middle(save_every=) -------------------------------------------------

@pytest.mark.parametrize("save_every", [1, 3, 4])
def test_langevin_middle_save_every_matches_jax(save_every):
    """Noiseless (JAX at T = 0): the frames saved at the end of each block
    of ``save_every`` steps and the final state over nsteps // save_every
    blocks, against JAX at 1e-5 (x) and 1e-4 (v) relative; without
    ``save_every`` the port returns (x, v) as before."""
    jsim = itk.MDSimulation(steps=2)
    sim = itt.MDSimulation(steps=2, device="cpu")
    rng = np.random.default_rng(4)
    x0 = (sim.coords.numpy()[None] + rng.normal(scale=0.005, size=(2, 66))
          ).astype(np.float32)
    v0 = rng.normal(scale=0.3, size=(2, 66)).astype(np.float32)
    saves, (x, v) = I.langevin_middle(
        sim.force, torch.tensor(x0), torch.tensor(v0), sim.masses3, 0.0,
        1.0, 0.002, 10, None, save_every=save_every)
    js, (jx, jv) = JI.langevin_middle(
        jsim.force, jnp.asarray(x0), jnp.asarray(v0), jsim.masses3, 0.0,
        1.0, 0.002, 10, jax.random.PRNGKey(0), save_every=save_every)
    js = np.asarray(js)
    assert saves.shape == js.shape == (10 // save_every, 2, 66)
    np.testing.assert_allclose(saves.numpy(), js, rtol=0,
                               atol=1e-5 * np.abs(js).max())
    assert np.abs(x.numpy() - np.asarray(jx)).max() \
        <= 1e-5 * np.abs(np.asarray(jx)).max()
    assert np.abs(v.numpy() - np.asarray(jv)).max() \
        <= 1e-4 * np.abs(np.asarray(jv)).max()
    assert torch.equal(saves[-1], x)
    xp, vp = I.langevin_middle(sim.force, torch.tensor(x0),
                               torch.tensor(v0), sim.masses3, 0.0, 1.0,
                               0.002, 10 // save_every * save_every, None)
    assert torch.equal(xp, x) and torch.equal(vp, v)


# ---- accepted, unused ---------------------------------------------------------------

def test_minimize_energy_tol_accepted_unused():
    sim = itt.MDSimulation(steps=2, device="cpu")

    def e(z):
        return F.potential_energy_flat(sim.system, z)

    a = minimize_energy(e, sim.coords, maxiter=5)
    b = minimize_energy(e, sim.coords, maxiter=5, tol=1.0)
    assert torch.equal(a, b)


def test_minimize_levelset_retract_every_accepted_unused():
    """Both packages accept it and ignore it: the same result with 1 and
    5, the port's equal to JAX's on the Doublewell at 1e-5."""
    def chi(x):
        return torch.tanh(x[..., 0])

    def energy(x):
        return (x[..., 0] ** 2 - 1.0) ** 2 + x[..., 1] ** 2

    x0 = torch.tensor([0.3, 0.4])
    a = minimize_levelset(x0, chi, energy, iterations=5, lr=1e-2)
    b = minimize_levelset(x0, chi, energy, iterations=5, lr=1e-2,
                          retract_every=5)
    assert torch.equal(a, b)
    j = jax_minimize_levelset(
        jnp.asarray(x0.numpy()), lambda x: jnp.tanh(x[..., 0]),
        lambda x: (x[..., 0] ** 2 - 1.0) ** 2 + x[..., 1] ** 2,
        iterations=5, lr=1e-2, retract_every=5)
    np.testing.assert_allclose(a.numpy(), np.asarray(j), atol=1e-5)


def test_alanine_dipeptide_pdb_minimized_either_way():
    """JAX returns the bundled file whenever it exists; so does the port,
    for either value."""
    p = itt.alanine_dipeptide_pdb()
    assert itt.alanine_dipeptide_pdb(minimized=True) == p
    assert itt.alanine_dipeptide_pdb(minimized=False) == p
    assert jax_alanine_dipeptide_pdb(minimized=False) == p
