"""Port parity of the trp-cage path: the peptide builder, the residue
tables and lookups, FIRE minimization, random-pair features, stratified
subsampling, noiseless OBC2 dynamics through ``MDSimulation``'s hybrid
route, training with ``resample_strat``, and the force-route dispatch,
against the JAX package on the same numpy inputs (CPU)."""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.data import SimulationData as JaxData
from isokann_tpu.features import FeaturesRandomPairs as JaxRandomPairs
from isokann_tpu.md import amber as jax_amber
from isokann_tpu.md import integrators as JI
from isokann_tpu.md.fixtures import build_peptide as jax_build_peptide
from isokann_tpu.md.forces import force_flat as jax_force_flat
from isokann_tpu.md.forces import potential_energy_flat as jax_energy
from isokann_tpu.md.minimize import minimize_energy as jax_minimize
from isokann_tpu.md.pdbio import write_pdb as jax_write_pdb
from isokann_tpu.md.system import build_system as jax_build_system
from isokann_tpu.sample import pickclosest as jax_pickclosest
from isokann_tpu.sample import subsample_uniformgrid as jax_subsample

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import amber
from isokann_tpu_torch.md import gb_kernel as GB
from isokann_tpu_torch.md import langevin_kernel as LK
from isokann_tpu_torch.md.fixtures import (alanine_dipeptide_pdb,
                                           build_peptide, peptide_pdb)
from isokann_tpu_torch.md.forces import potential_energy_flat
from isokann_tpu_torch.md.minimize import minimize_energy
from isokann_tpu_torch.md.pdbio import read_pdb, write_pdb
from isokann_tpu_torch.md.system import build_system
from isokann_tpu_torch.sample import pickclosest, subsample_uniformgrid
from isokann_tpu_torch.weights import load_jax_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

TC5B = "NLYIQWLKDGGPSSGRPPPS"
TRPCAGE = os.path.join(os.path.dirname(__file__), "..", "out",
                       "trpcage.pdb")


def _walkers(n, scale, seed=0):
    x0 = read_pdb(TRPCAGE).coords.reshape(-1)
    rng = np.random.default_rng(seed)
    return (x0[None] + rng.normal(scale=scale, size=(n, x0.size))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def jsim():
    return itk.MDSimulation(pdb=TRPCAGE, steps=2, implicit="obc2")


@pytest.fixture(scope="module")
def sim():
    return itt.MDSimulation(pdb=TRPCAGE, steps=2, implicit="obc2",
                            device="cpu")


def test_protein_tables_match_jax():
    for name in ("ATOM_TYPES", "BONDS", "ANGLES", "DIHEDRALS", "IMPROPERS"):
        assert getattr(amber, name) == getattr(jax_amber, name), name
    for res, tmpl in amber.RESIDUES.items():
        assert tmpl == jax_amber.RESIDUES[res], res
    assert {"NASN", "CSER", "HID", "HIP", "CYX", "NPRO", "CTRP"} <= set(
        amber.RESIDUES)


def test_missing_bond_and_angle_take_the_fallback_with_a_warning():
    with pytest.warns(UserWarning, match="fallback"):
        assert amber.lookup_bond("ZZ", "YY") == jax_amber.lookup_bond(
            "ZZ", "YY")
    with pytest.warns(UserWarning, match="fallback"):
        assert amber.lookup_angle("ZZ", "CA", "YY") == \
            jax_amber.lookup_angle("ZZ", "CA", "YY")
    with pytest.warns(UserWarning, match="109.5 deg fallback"):
        assert amber.lookup_angle("ZZ", "CT", "YY") == (50.0, 109.5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # warned once per message
        assert amber.lookup_angle("ZZ", "CT", "YY") == (50.0, 109.5)


def test_build_peptide_matches_jax(tmp_path):
    """TC5B with ACE/NME caps: the same 313 atoms, names, residues and
    elements, coordinates to 1e-6 nm, and the same PDB text."""
    got, ref = build_peptide(TC5B), jax_build_peptide(TC5B)
    assert got.natoms == ref.natoms == 313
    for f in ("atom_names", "res_names", "res_ids", "chain_ids",
              "elements"):
        assert getattr(got, f) == getattr(ref, f), f
    np.testing.assert_allclose(got.coords, ref.coords, rtol=0, atol=1e-6)
    write_pdb(str(tmp_path / "port.pdb"), got)
    jax_write_pdb(str(tmp_path / "jax.pdb"), ref)
    assert (tmp_path / "port.pdb").read_text() == \
        (tmp_path / "jax.pdb").read_text()
    # the topology resolves the terminal residues' templates from sequence
    s = build_system(str(tmp_path / "port.pdb"), implicit="obc2",
                     device="cpu")
    js = jax_build_system(str(tmp_path / "jax.pdb"), implicit="obc2")
    np.testing.assert_array_equal(s.dih_idx.numpy(), np.asarray(js.dih_idx))
    np.testing.assert_allclose(s.charges.numpy(), np.asarray(js.charges),
                               rtol=1e-6, atol=1e-6)


def test_peptide_pdb_without_minimization_writes_the_built_structure(
        tmp_path):
    path = peptide_pdb("AQG", str(tmp_path / "p.pdb"), minimize=False)
    got = read_pdb(path)
    np.testing.assert_allclose(got.coords, build_peptide("AQG").coords,
                               rtol=0, atol=1e-4)


def test_fire_matches_jax_on_alanine_obc2():
    """20 FIRE steps from a perturbed alanine dipeptide in OBC2, 1e-5 nm."""
    pdb = alanine_dipeptide_pdb()
    x0 = read_pdb(pdb).coords.reshape(-1)
    x0 = (x0 + np.random.default_rng(3).normal(scale=0.01, size=x0.size)
          ).astype(np.float32)
    js = jax_build_system(pdb, implicit="obc2")
    ts = build_system(pdb, implicit="obc2", device="cpu")
    ref = np.asarray(jax_minimize(lambda z: jax_energy(js, z),
                                  jnp.asarray(x0), maxiter=20))
    got = minimize_energy(lambda z: potential_energy_flat(ts, z),
                          torch.as_tensor(x0), maxiter=20).numpy()
    assert np.abs(ref - x0).max() > 1e-3       # it moved
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_random_pairs_match_jax():
    xs = _walkers(3, 0.01)
    ref = JaxRandomPairs(313, maxfeatures=100)
    got = itt.FeaturesRandomPairs(313, maxfeatures=100)
    np.testing.assert_array_equal(got.pairs, ref._pairs)
    np.testing.assert_allclose(got(torch.as_tensor(xs)).numpy(),
                               np.asarray(ref(jnp.asarray(xs))), rtol=0,
                               atol=1e-6)
    assert itt.FeaturesRandomPairs(313) == got


def test_stratified_picks_match_jax():
    ys = np.random.default_rng(5).uniform(size=200)
    for n, edges in ((7, True), (12, False), (2, True)):
        got = subsample_uniformgrid(ys, n, keepedges=edges,
                                    rng=np.random.default_rng(9))
        ref = jax_subsample(ys, n, keepedges=edges,
                            rng=np.random.default_rng(9))
        np.testing.assert_array_equal(got, ref)
    needles = np.random.default_rng(6).uniform(size=40)
    hay = np.round(ys, 2)                      # ties exercise the sweep
    np.testing.assert_array_equal(pickclosest(hay, needles),
                                  jax_pickclosest(hay, needles))


def test_noiseless_obc2_steps_match_jax(jsim, sim):
    """5 noiseless LangevinMiddle steps of trp-cage in OBC2 (the hybrid
    route, with kernel D's plain version on the CPU) against the JAX
    package's step over its ``force_flat`` (T = 0 drops the noise), from
    the same v0: x to 1e-5 relative to the largest coordinate."""
    assert sim.route == "hybrid"
    xs = _walkers(2, 0.005)
    v0 = np.random.default_rng(1).normal(scale=0.3, size=xs.shape
                                         ).astype(np.float32)
    jf = jax.jit(lambda z: jax_force_flat(jsim.system, z))
    x, v = jnp.asarray(xs), jnp.asarray(v0)
    key = jax.random.PRNGKey(0)
    for _ in range(5):
        x, v = JI.langevin_middle_step(jf, x, v, jsim.masses3, 0.0, 1.0,
                                       0.002, key)
    n0 = GB.gb_force.launches
    xt, vt = sim._integrate(torch.as_tensor(xs), torch.as_tensor(v0), 5,
                            None)
    assert GB.gb_force.launches == n0
    x, v = np.asarray(x), np.asarray(v)
    assert np.abs(xt.numpy() - x).max() / np.abs(x).max() < 1e-5
    assert np.abs(vt.numpy() - v).max() / np.abs(v).max() < 1e-4


def test_training_and_resample_strat_match_jax(jsim, sim):
    """Shared trp-cage features and parameters: 5 Koopman iterations
    (losses 1e-5), the same chi-stratified picks from the same seed, then
    ``resample_strat`` in the port (its MD on the CPU) and the same new
    rows given to the JAX learner: 3 more iterations, losses 1e-5.

    The start points span the folded structure to 40% of the way to the
    extended chain, and the chi model's first layer is scaled by 10, so
    chi spans ~0.05 over them as a trained chi does.  The untrained
    autonet's chi spans ~0.01, and the shift-scale target divides by that
    spread: it magnifies the packages' 1e-7 float32 differences in chi to
    ~1e-5 in the losses."""
    ext = build_peptide(TC5B).coords.reshape(-1)
    a = np.arange(6)[:, None] / 10.0
    xs = ((1.0 - a) * read_pdb(TRPCAGE).coords.reshape(1, -1) + a * ext
          + np.random.default_rng(2).normal(scale=0.02, size=(6, ext.size))
          ).astype(np.float32)
    ys = (xs[:, None] + np.random.default_rng(3).normal(
        scale=0.02, size=(6, 2, xs.shape[1]))).astype(np.float32)
    jdata = JaxData.from_coords(jsim, xs, ys)
    jm = jsim.defaultmodel(n=100, key=jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    params["layers"][0]["w"] = params["layers"][0]["w"] * 10.0
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    jiso = itk.Iso(data=jdata, model=jm, opt=itk.AdamRegularized(), key=0,
                   shard=False)
    shared = (torch.tensor(np.asarray(jdata.features)),
              torch.tensor(np.asarray(jdata.propfeatures)))
    data = itt.SimulationData.from_coords(sim, torch.as_tensor(xs),
                                          torch.as_tensor(ys),
                                          features=shared)
    tm = load_jax_params(sim.defaultmodel(n=100), params)
    iso = itt.Iso(data=data, model=tm, opt=itt.AdamRegularized(), gen=0)
    jiso.run(5)
    iso.run(5)
    np.testing.assert_allclose(iso.losses, jiso.losses, rtol=1e-5, atol=0)

    picks = iso.data.chistratcoords(iso.model, 3, seed=11).numpy()
    ref = np.asarray(jiso.data.chistratcoords(
        jiso.chifun, 3, key=jax.random.PRNGKey(11)))
    np.testing.assert_array_equal(picks, ref)

    iso.resample_strat(3)
    assert len(iso.data) == 9
    new = iso.data[6:]
    assert bool(torch.isfinite(new.propcoords).all())
    jiso.data = jiso.data.merge(JaxData.from_coords(
        jsim, new.coords.numpy(), new.propcoords.numpy()))
    jiso.run(3)
    iso.run(3)
    np.testing.assert_allclose(iso.losses, jiso.losses, rtol=1e-5, atol=0)


def test_force_routes_and_cpu_dispatch(sim):
    """The routes mirror the reference's TPU dispatch; on the CPU every
    route runs its plain version and no kernel launches."""
    ala = itt.MDSimulation(steps=2, device="cpu")
    ala_gb = itt.MDSimulation(steps=2, implicit="obc2", device="cpu")
    vac = itt.MDSimulation(pdb=TRPCAGE, steps=2,
                           method="CutoffNonPeriodic", device="cpu")
    per = itt.MDSimulation(pdb=TRPCAGE, steps=2, method="CutoffPeriodic",
                           device="cpu")
    assert [s.route for s in (ala, ala_gb, sim, vac, per)] == \
        ["fused", "plain", "hybrid", "hybrid", "unported"]
    assert isinstance(sim.featurizer, itt.FeaturesRandomPairs)
    counts = (GB.gb_force.launches, LK.langevin_middle.launches,
              LK.forces.launches)
    for s in (ala_gb, sim, per):
        ys = s.propagate(s.coords[None], 2, gen=0)
        assert ys.shape == (1, 2, s.dim) and bool(torch.isfinite(ys).all())
    assert (GB.gb_force.launches, LK.langevin_middle.launches,
            LK.forces.launches) == counts
    with pytest.raises(NotImplementedError, match="neighbor_sweep_pallas"):
        per.force(per.coords[None].to("meta"))
    with pytest.raises(NotImplementedError):
        sim.force(sim.coords[None].to("meta"))
