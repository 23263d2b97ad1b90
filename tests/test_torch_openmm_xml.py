"""Port parity of the serialized OpenMM System / State XML importer
(``md/openmm_xml.py``): every case of the JAX package's
``tests/test_amberio.py`` XML part, ``test_cmap.py``'s XML round trip and
``test_vsites.py``'s virtual-site XML cases through the port at the JAX
test's bounds; the XML text the port writes equals the JAX package's on
equal systems, and the tables both packages read from one file are equal
(indices exactly, values 1e-6).  A PME box read back with
``dense_pairs=False`` and its <Constraints> takes the neighbor route
through ``MDSimulation.from_system`` (CPU)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isokann_tpu.md import build_system as jax_build_system
from isokann_tpu.md import openmm_xml as JX
from isokann_tpu.md.system import system_from_tables as jax_tables
from isokann_tpu.md.vsites import attach_vsites as jax_attach

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import neighbor_kernel as NK
from isokann_tpu_torch.md import openmm_xml as X
from isokann_tpu_torch.md.cmap import has_cmap
from isokann_tpu_torch.md.fixtures import alanine_dipeptide_pdb
from isokann_tpu_torch.md.forces import force_flat, potential_energy_flat
from isokann_tpu_torch.md.pdbio import read_pdb
from isokann_tpu_torch.md.solvate import M_WEIGHTS, water_constraint_pairs
from isokann_tpu_torch.md.system import build_system, system_from_tables
from isokann_tpu_torch.md.vsites import attach_vsites, has_vsites

from test_torch_amberio import (_chain_coords, _cmap_chain, _cmap_grid,
                                assert_tables_match, compare_terms)

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ala():
    pdb = alanine_dipeptide_pdb()
    x = read_pdb(pdb).coords.astype(np.float32)
    return (build_system(pdb, method="NoCutoff", device="cpu"),
            jax_build_system(pdb, method="NoCutoff"), x)


def _both_load(text, **kw):
    """The port's and the JAX package's read of one XML text."""
    tsys, tcons, tmeta = X.load_system_xml(text, device="cpu", **kw)
    jsys, jcons, jmeta = JX.load_system_xml(text)
    assert tcons == jcons and tmeta == jmeta
    assert_tables_match(jsys, tsys)
    return tsys, tcons, tmeta


def test_system_xml_roundtrip_vacuum(ala, tmp_path):
    tsys, jsys, x = ala
    path = tmp_path / "ala_system.xml"
    text = X.save_system_xml(tsys, str(path))
    assert text == JX.save_system_xml(jsys)
    assert path.read_text() == text
    sys2, cons, meta = _both_load(str(path))
    assert cons == []
    assert meta["skipped_forces"] == []
    assert sys2.method == tsys.method
    np.testing.assert_array_equal(tsys.excl_idx.numpy(),
                                  sys2.excl_idx.numpy())
    compare_terms(tsys, sys2, x)


def test_system_xml_roundtrip_gb():
    pdb = alanine_dipeptide_pdb()
    tsys = build_system(pdb, implicit="obc2", device="cpu")
    x = read_pdb(pdb).coords.astype(np.float32)
    text = X.save_system_xml(tsys)
    assert text == JX.save_system_xml(jax_build_system(pdb, implicit="obc2"))
    sys2, _, _ = _both_load(text)
    assert sys2.implicit == "obc2"
    np.testing.assert_allclose(sys2.gb_radii.numpy(), tsys.gb_radii.numpy(),
                               atol=1e-7)
    compare_terms(tsys, sys2, x)


def test_system_xml_constraints_roundtrip(ala):
    tsys, jsys, _ = ala
    cons = [(0, 1, 0.109), (4, 5, 0.101)]
    text = X.save_system_xml(tsys, constraints=cons)
    assert text == JX.save_system_xml(jsys, constraints=cons)
    _, cons2, _ = _both_load(text)
    assert [(i, j) for i, j, _ in cons2] == [(0, 1), (4, 5)]
    np.testing.assert_allclose([d for _, _, d in cons2],
                               [d for _, _, d in cons], atol=1e-9)


STATE = """<?xml version="1.0" ?>
<State openmmVersion="8.1" time="12.5" type="State" version="1">
 <PeriodicBoxVectors>
  <A x="2.5" y="0" z="0"/><B x="0" y="2.6" z="0"/><C x="0" y="0" z="2.7"/>
 </PeriodicBoxVectors>
 <Positions>
  <Position x="0.1" y="0.2" z="0.3"/>
  <Position x="0.4" y="0.5" z="0.6"/>
 </Positions>
 <Velocities>
  <Velocity x="1.0" y="-1.0" z="0.5"/>
  <Velocity x="0.0" y="0.25" z="0.0"/>
 </Velocities>
</State>"""


def test_state_xml_load():
    coords, vel, box = X.load_state_xml(STATE)
    np.testing.assert_allclose(coords, [[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]])
    np.testing.assert_allclose(vel, [[1.0, -1.0, 0.5], [0.0, 0.25, 0.0]])
    np.testing.assert_allclose(box, [2.5, 2.6, 2.7])
    for got, want in zip((coords, vel, box), JX.load_state_xml(STATE)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="not a serialized State"):
        X.load_state_xml("<System/>")


@pytest.fixture(scope="module")
def pme():
    return itt.MDSimulation(addwater=True, padding=0.55, steps=2,
                            method="PME", features=[(0, 4)], device="cpu")


def test_system_xml_roundtrip_pme(pme):
    """The JAX test's solvated PME box: method, box, the dispersion
    correction and alpha survive; energies at rtol 5e-4, atol 5e-3."""
    sys = pme.system
    x = pme.coords.numpy()
    text = X.save_system_xml(sys)
    sys2, cons, meta = _both_load(text)
    assert sys2.method == "PME"
    assert sys2.box == pytest.approx(sys.box)
    assert sys2.use_dispersion == sys.use_dispersion
    np.testing.assert_allclose(sys2.ewald_alpha, sys.ewald_alpha, rtol=1e-6)
    compare_terms(sys, sys2, x, rtol=5e-4, atol=5e-3)


def test_load_system_xml_dense_pairs_values_agree(pme):
    """``dense_pairs`` (an option the JAX reader lacks) changes only the
    layout of the pair tables: the dense and the cell-list reads of one
    PME box give the same energy (rtol 5e-4, atol 5e-3) and forces
    (5e-4 of max(1, max|f|))."""
    text = X.save_system_xml(pme.system)
    dense = X.load_system_xml(text, dense_pairs=True, device="cpu")[0]
    cells = X.load_system_xml(text, dense_pairs=False, device="cpu")[0]
    assert dense.dense_pairs and not cells.dense_pairs
    x = pme.coords.reshape(-1)
    np.testing.assert_allclose(float(potential_energy_flat(cells, x)),
                               float(potential_energy_flat(dense, x)),
                               rtol=5e-4, atol=5e-3)
    fd = force_flat(dense, x).numpy()
    fc = force_flat(cells, x).numpy()
    scale = max(1.0, float(np.abs(fd).max()))
    np.testing.assert_allclose(fc / scale, fd / scale, atol=5e-4)


def test_pme_box_from_xml_takes_the_neighbor_route(pme):
    """The same box with its rigid waters in <Constraints>, read back with
    ``dense_pairs=False``: ``from_system(constraint_pairs=...)`` takes the
    neighbor route (kernel E's plain version on the CPU, no launch), and a
    propagation keeps the waters to 1e-5 nm with no cell overflow."""
    cons = water_constraint_pairs(pme.structure)
    text = X.save_system_xml(pme.system, constraints=cons)
    sys2, cons2, _ = X.load_system_xml(text, dense_pairs=False,
                                       device="cpu")
    assert not sys2.dense_pairs and len(cons2) == len(cons)
    sim = itt.MDSimulation.from_system(sys2, pme.coords, steps=3,
                                       constraint_pairs=cons2, device="cpu")
    assert sim.route == "neighbor" and sim.nbplan is not None
    n0 = NK.neighbor_sweep.launches
    ys = sim.propagate(sim.coords[None].repeat(2, 1), 1, gen=0)[:, 0]
    assert NK.neighbor_sweep.launches == n0
    assert bool(torch.isfinite(ys).all())
    assert sim.constraint_set.max_violation(ys) < 1e-5
    assert sim.overflows == 0


def test_system_xml_geometry_errors():
    """Both packages refuse an oblique box and a PME method without a
    box; an unsupported force is skipped with a warning."""
    oblique = """<System openmmVersion="8.1" type="System" version="1">
 <PeriodicBoxVectors><A x="2" y="0" z="0"/><B x="0.5" y="2" z="0"/>
  <C x="0" y="0" z="2"/></PeriodicBoxVectors>
 <Particles><Particle mass="1"/></Particles><Forces/></System>"""
    for load in (X.load_system_xml, JX.load_system_xml):
        with pytest.raises(ValueError, match="rectangular"):
            load(oblique)
    nobox = """<System openmmVersion="8.1" type="System" version="1">
 <Particles><Particle mass="1"/></Particles>
 <Forces><Force type="NonbondedForce" method="4">
  <Particles><Particle q="0" sig="0.3" eps="0.1"/></Particles>
 </Force><Force type="CustomBondForce"/></Forces></System>"""
    for load in (X.load_system_xml, JX.load_system_xml):
        with pytest.raises(ValueError, match="no periodic box"), \
                pytest.warns(UserWarning, match="CustomBondForce"):
            load(nobox)


def test_cmap_xml_roundtrip():
    """A CMAP map through CMAPTorsionForce (0-origin grids rolled onto the
    engine's -pi origin): energy at 1e-5, the text equal to JAX's."""
    tab = _cmap_chain([_cmap_grid(lambda p, s: np.cos(p)
                                  + 0.5 * np.sin(2 * s))])
    sys = system_from_tables(device="cpu", **tab)
    text = X.save_system_xml(sys)
    assert text == JX.save_system_xml(jax_tables(**tab))
    assert "CMAPTorsionForce" in text
    sys2, _, _ = _both_load(text)
    assert has_cmap(sys2)
    x = torch.as_tensor(_chain_coords(0.8, -0.6).reshape(-1))
    np.testing.assert_allclose(float(potential_energy_flat(sys2, x)),
                               float(potential_energy_flat(sys, x)),
                               rtol=1e-5, atol=1e-5)


def _toy_tables(charges, bonds, k, r0):
    return dict(masses=[16.0, 1.0, 1.0, 0.0], charges=charges,
                rmin_half=[0.17, 0.0, 0.0, 0.0], eps=[0.6, 0.0, 0.0, 0.0],
                bond_idx=bonds, bond_k=k, bond_r0=r0,
                excl_idx=[(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
                excl_qq=[0.0] * 6, excl_lj=[0.0] * 6, method="NoCutoff")


def _toy_site():
    """The JAX test's 4 atoms, the last a massless average3 site."""
    tab = _toy_tables([0.0, 0.5, 0.5, -1.0], [(0, 1), (0, 2), (0, 3)],
                      [20000.0, 20000.0, 0.0], [0.1, 0.1, 0.0125])
    return (attach_vsites(system_from_tables(device="cpu", **tab), [3],
                          [(0, 1, 2)], [M_WEIGHTS]),
            jax_attach(jax_tables(**tab), [3], [(0, 1, 2)], [M_WEIGHTS]))


def _oop_site():
    """The JAX test's TIP5P-style out-of-plane site."""
    w12, w13, wc = 0.4, 0.3, 5.0
    tab = _toy_tables([0.2, 0.2, 0.2, -0.6], [(0, 1), (0, 2)],
                      [20000.0, 20000.0], [0.1, 0.1])
    w = [(1.0 - w12 - w13, w12, w13)]
    return (attach_vsites(system_from_tables(device="cpu", **tab), [3],
                          [(0, 1, 2)], w, vs_cross=[wc]),
            jax_attach(jax_tables(**tab), [3], [(0, 1, 2)], w,
                       vs_cross=[wc]))


def test_system_xml_vsite_roundtrip():
    sys, jsys = _toy_site()
    text = X.save_system_xml(sys)
    assert text == JX.save_system_xml(jsys)
    assert "VirtualSite" in text
    sys2, _, _ = X.load_system_xml(text, device="cpu")
    assert has_vsites(sys2)
    np.testing.assert_array_equal(sys2.vs_idx.numpy(), sys.vs_idx.numpy())
    np.testing.assert_allclose(sys2.vs_w.numpy(), sys.vs_w.numpy(),
                               atol=1e-9)
    np.testing.assert_array_equal(
        sys2.vs_gather.numpy(), np.asarray(JX.load_system_xml(text)[0]
                                           .vs_gather))
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(12,)) * 0.05,
                        dtype=torch.float32)
    np.testing.assert_allclose(float(potential_energy_flat(sys2, x)),
                               float(potential_energy_flat(sys, x)),
                               rtol=1e-5, atol=1e-4)


def test_unsupported_vsite_type_raises():
    xml = """<?xml version="1.0" ?>
<System openmmVersion="8.1" type="System" version="1">
 <PeriodicBoxVectors><A x="2" y="0" z="0"/><B x="0" y="2" z="0"/>
  <C x="0" y="0" z="2"/></PeriodicBoxVectors>
 <Particles>
  <Particle mass="16"/><Particle mass="1"/><Particle mass="1"/>
  <Particle mass="0">
   <VirtualSite type="localCoords" particle1="0" particle2="1"
    particle3="2"/>
  </Particle>
 </Particles>
 <Constraints/>
 <Forces/>
</System>"""
    with pytest.raises(ValueError, match="localCoords"):
        X.load_system_xml(xml, device="cpu")


def test_outofplane_xml_roundtrip():
    sys, jsys = _oop_site()
    text = X.save_system_xml(sys)
    assert text == JX.save_system_xml(jsys)
    assert 'type="outOfPlane"' in text
    sys2, _, _ = X.load_system_xml(text, device="cpu")
    np.testing.assert_allclose(sys2.vs_wc.numpy(), sys.vs_wc.numpy())
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(12,)) * 0.05,
                        dtype=torch.float32)
    np.testing.assert_allclose(float(potential_energy_flat(sys2, x)),
                               float(potential_energy_flat(sys, x)),
                               rtol=1e-5, atol=1e-5)


def test_tip4p_box_roundtrip():
    """A TIP4P-Ew box (M points as average3 sites): the sites, their
    weights and the energy survive the XML, equal to the JAX package's
    read of the same text."""
    sim = itt.MDSimulation(addwater=True, padding=0.5,
                           water_model="tip4pew", steps=2, device="cpu")
    text = X.save_system_xml(sim.system)
    sys2, _, _ = _both_load(text)
    np.testing.assert_array_equal(sys2.vs_idx.numpy(),
                                  sim.system.vs_idx.numpy())
    np.testing.assert_allclose(sys2.vs_w.numpy(), sim.system.vs_w.numpy(),
                               atol=1e-7)
    x = sim.coords[None]
    e0, e1 = (float(potential_energy_flat(s, x)[0])
              for s in (sim.system, sys2))
    assert abs(e1 - e0) <= 5e-4 * abs(e0) + 5e-3
