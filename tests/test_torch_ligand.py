"""Port parity of ligand perception and parameterization
(``md/ligand.py``): every case of the JAX package's ``tests/test_ligand.py``
perception part (the 6O0K case waits for its input file, as there) and of
``tests/test_ligand_fidelity.py`` through the port at the JAX test's
bounds; perceived bonds, rings, orders, hybridization, formal charges,
types and added hydrogens equal the JAX package's, Gasteiger charges
within 1e-6, and ``parameterize_ligand`` registers the same template.
A fixture restores both packages' amber tables after every test (CPU)."""

import copy
import math
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import isokann_tpu.md.amber as JAM
from isokann_tpu.md import ligand as JL
from isokann_tpu.md.pdbio import PDBStructure as JaxStructure

from isokann_tpu_torch.md import amber
from isokann_tpu_torch.md import ligand as L
from isokann_tpu_torch.md.forces import potential_energy_flat
from isokann_tpu_torch.md.minimize import minimize_energy
from isokann_tpu_torch.md.pdbio import PDBStructure, read_pdb, write_pdb
from isokann_tpu_torch.md.system import build_system

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "tools"))
from ligand_charge_fidelity import (MOH_AM1BCC, MOH_XYZ_A,   # noqa: E402
                                    coulomb_intra, methanol_anchor)

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

TABLES = ("ATOM_TYPES", "BONDS", "ANGLES", "DIHEDRALS", "IMPROPERS",
          "RESIDUES")


@pytest.fixture(autouse=True)
def restore_amber():
    snaps = [(mod, {k: copy.deepcopy(getattr(mod, k)) for k in TABLES})
             for mod in (amber, JAM)]
    yield
    for mod, snap in snaps:
        for k, v in snap.items():
            getattr(mod, k).clear()
            getattr(mod, k).update(v)


def _benzene():
    r = 1.39
    coords = np.array([[r * math.cos(k * math.pi / 3),
                        r * math.sin(k * math.pi / 3), 0.0]
                       for k in range(6)]) / 10.0
    return ["C"] * 6, coords


def _acetone():
    coords = np.array([
        [0.000, 0.000, 0.000],     # C (carbonyl)
        [0.000, 1.220, 0.000],     # O  (C=O 1.22)
        [1.310, -0.750, 0.000],    # C methyl
        [-1.310, -0.750, 0.000],   # C methyl
    ]) / 10.0
    return ["C", "O", "C", "C"], coords


def _nitro_acid():
    """Nitromethane next to an acetate and a pyridine-like ring: the
    nitro, carboxylate and aromatic-N branches of perception (heavy
    atoms, Angstrom -> nm)."""
    ring = [[1.39 * math.cos(k * math.pi / 3) + 6.0,
             1.39 * math.sin(k * math.pi / 3), 0.0] for k in range(6)]
    coords = np.array([
        [0.0, 0.0, 0.0], [1.48, 0.0, 0.0],              # C, N (nitro)
        [2.10, 1.06, 0.0], [2.10, -1.06, 0.0],          # O, O
        [0.0, 4.0, 0.0], [1.52, 4.0, 0.0],              # CH3-C (acetate)
        [2.15, 5.08, 0.0], [2.15, 2.92, 0.0],           # O, O (1.25 A)
    ] + ring) / 10.0
    return ["C", "N", "O", "O", "C", "C", "O", "O",
            "N", "C", "C", "C", "C", "C"], coords


MOLECULES = {"benzene": _benzene, "acetone": _acetone,
             "mixed": _nitro_acid}


def _same_perception(p, j):
    assert p.elements == j.elements
    assert [tuple(b) for b in p.bonds] == [tuple(b) for b in j.bonds]
    assert p.order == j.order
    assert p.aromatic == j.aromatic
    assert sorted(map(sorted, p.rings)) == sorted(map(sorted, j.rings))
    assert p.hybrid == j.hybrid
    np.testing.assert_array_equal(p.formal, j.formal)
    assert p.implicit_h == j.implicit_h


@pytest.mark.parametrize("name", sorted(MOLECULES))
def test_perception_matches_jax(name):
    els, xyz = MOLECULES[name]()
    assert L.perceive_bonds(els, xyz) == JL.perceive_bonds(els, xyz)
    p, j = L.perceive(els, xyz), JL.perceive(els, xyz)
    _same_perception(p, j)
    hp, hx = L.add_hydrogens(p, xyz)
    jp, jx = JL.add_hydrogens(j, xyz)
    np.testing.assert_array_equal(hp, jp)
    np.testing.assert_allclose(hx, jx, rtol=0, atol=1e-12)
    adj = {i: [] for i in range(len(els))}
    for a, b in p.bonds:
        adj[a].append(b)
        adj[b].append(a)
    assert ([L._atom_type(p, i, adj) for i in range(len(els))]
            == [JL._atom_type(j, i, adj) for i in range(len(els))])
    q = L.gasteiger_charges(p.elements, p.bonds, p.hybrid, p.formal)
    np.testing.assert_allclose(
        q, JL.gasteiger_charges(j.elements, j.bonds, j.hybrid, j.formal),
        rtol=0, atol=1e-6)


def test_rings_match_jax():
    """The smallest ring through each bond, on a fused bicycle (a
    naphthalene-like graph) and a 7-ring cut at max_size."""
    adj = {i: [] for i in range(10)}
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (4, 6),
             (6, 7), (7, 8), (8, 9), (9, 3)]
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    got, want = L._rings(adj, 10), JL._rings(adj, 10)
    assert sorted(got) == sorted(want) and len(got) == 2
    assert sorted(L._rings(adj, 10, max_size=5)) == sorted(
        JL._rings(adj, 10, max_size=5))


def test_bond_perception_benzene():
    els, xyz = _benzene()
    assert len(L.perceive_bonds(els, xyz)) == 6


def test_aromatic_perception():
    els, xyz = _benzene()
    p = L.perceive(els, xyz)
    assert all(p.aromatic)
    assert all(h == 2 for h in p.hybrid)
    assert all(o == 1.5 for o in p.order.values())
    assert p.implicit_h == [1] * 6


def test_carbonyl_perception():
    els, xyz = _acetone()
    p = L.perceive(els, xyz)
    assert p.order[(0, 1)] == 2.0
    assert p.hybrid[0] == 2
    assert p.implicit_h[0] == 0
    assert p.implicit_h[1] == 0
    assert p.implicit_h[2] == 3
    assert p.implicit_h[3] == 3


def test_hydrogen_placement_geometry():
    els, xyz = _benzene()
    p = L.perceive(els, xyz)
    parents, hxyz = L.add_hydrogens(p, xyz)
    assert len(parents) == 6
    for par, h in zip(parents, hxyz):
        assert abs(h[2]) < 1e-6
        d = np.linalg.norm(h - xyz[par]) * 10.0
        assert 1.0 < d < 1.2
        assert np.linalg.norm(h) > np.linalg.norm(xyz[par])


def test_gasteiger_charges_ordering():
    els, xyz = _acetone()
    p = L.perceive(els, xyz)
    parents, hxyz = L.add_hydrogens(p, xyz)
    els_all = p.elements + ["H"] * len(parents)
    bonds_all = list(p.bonds) + [(int(a), len(p.elements) + k)
                                 for k, a in enumerate(parents)]
    hyb = p.hybrid + [0] * len(parents)
    formal = np.concatenate([p.formal, np.zeros(len(parents))])
    q = L.gasteiger_charges(els_all, bonds_all, hyb, formal)
    assert abs(q.sum()) < 1e-9
    assert q[1] < -0.2
    assert q[0] > 0.1
    assert q[0] == max(q[:4])


def _acetone_struct(cls=PDBStructure):
    els, xyz = _acetone()
    return cls(atom_names=["C1", "O1", "C2", "C3"], res_names=["ACT"] * 4,
               res_ids=[1] * 4, chain_ids=["A"] * 4, elements=els,
               coords=xyz)


def test_parameterize_ligand_matches_jax():
    """The registered template (types, charges, bonds) and every table
    entry it adds equal the JAX package's; the structure with its added
    hydrogens too."""
    with pytest.warns(UserWarning, match="Gasteiger"):
        tmpl, full = L.parameterize_ligand("ACT", _acetone_struct())
    with pytest.warns(UserWarning, match="Gasteiger"):
        jtmpl, jfull = JL.parameterize_ligand(
            "ACT", _acetone_struct(JaxStructure))
    assert set(tmpl["atoms"]) == set(jtmpl["atoms"])
    for a, (t, q) in jtmpl["atoms"].items():
        assert tmpl["atoms"][a][0] == t
        assert abs(tmpl["atoms"][a][1] - q) < 1e-6, a
    assert tmpl["bonds"] == jtmpl["bonds"]
    assert tmpl["formal_charge"] == jtmpl["formal_charge"]
    assert full.atom_names == jfull.atom_names
    assert full.elements == jfull.elements
    np.testing.assert_allclose(full.coords, jfull.coords, rtol=0,
                               atol=1e-12)
    types = {t for t, _ in tmpl["atoms"].values()}
    for t in types:
        assert amber.ATOM_TYPES[t] == JAM.ATOM_TYPES[t]

    def added(mod, table):
        """The entries of ``table`` over the ligand's types (wildcards
        allowed, one type at least)."""
        return {k: v for k, v in getattr(mod, table).items()
                if all(s == "X" or s in types for s in k)
                and any(s in types for s in k)}
    for table in ("BONDS", "ANGLES", "DIHEDRALS", "IMPROPERS"):
        mine, theirs = added(amber, table), added(JAM, table)
        assert mine.keys() == theirs.keys() and mine, table
        for k in mine:
            np.testing.assert_allclose(np.asarray(mine[k], float),
                                       np.asarray(theirs[k], float),
                                       rtol=1e-12, err_msg=str(k))


def test_parameterize_and_build_small_molecule(tmp_path):
    """A perceived acetone registers, builds (10 atoms after H addition)
    and minimizes downhill."""
    tmpl, full = L.parameterize_ligand("ACT", _acetone_struct())
    assert full.natoms == 10
    path = str(tmp_path / "act.pdb")
    write_pdb(path, full)
    sys_ = build_system(path, device="cpu")
    x0 = torch.as_tensor(full.coords.reshape(-1), dtype=torch.float32)
    e0 = float(potential_energy_flat(sys_, x0))
    x1 = minimize_energy(lambda z: potential_energy_flat(sys_, z), x0,
                         maxiter=200)
    e1 = float(potential_energy_flat(sys_, x1))
    assert np.isfinite(e1) and e1 < e0


def test_parameterize_from_pdb_with_conect(tmp_path):
    """CONECT records give the ligand's bonds (read into ``.conect`` by
    the port's reader as by the JAX package's); ``residue_filter``
    selects the ligand and ``net_charge`` shifts the charges."""
    els, xyz = _acetone()
    lines = []
    for k, (e, p) in enumerate(zip(els, xyz * 10.0), 1):
        lines.append("HETATM%5d %-4s ACT A   1    %8.3f%8.3f%8.3f"
                     "  1.00  0.00          %2s" % (k, f"{e}{k}", *p, e))
    lines += ["CONECT    1    2    3    4", "END"]
    path = tmp_path / "act.pdb"
    path.write_text("\n".join(lines) + "\n")
    s = read_pdb(str(path))
    from isokann_tpu.md.pdbio import read_pdb as jax_read_pdb
    assert s.conect == jax_read_pdb(str(path)).conect == [(0, 1), (0, 2),
                                                          (0, 3)]
    with pytest.warns(UserWarning, match="Gasteiger"):
        tmpl, full = L.parameterize_ligand("ACT", str(path),
                                           residue_filter="ACT",
                                           net_charge=-1, register=False)
    assert tmpl is None and full.natoms == 10
    with pytest.raises(ValueError, match="no atoms"):
        L.parameterize_ligand("ACT", str(path), residue_filter="XYZ")


# ---- charge fidelity -----------------------------------------------------------

def test_methanol_anchor_bounds():
    """Gasteiger against the published AM1-BCC methanol charges, through
    the port's perception and PEOE: the JAX test's bounds, and the
    charges equal to the JAX package's (1e-6)."""
    names = list(MOH_AM1BCC)
    els = ["C", "O", "H", "H", "H", "H"]
    xyz = np.array([MOH_XYZ_A[n] for n in names]) / 10.0
    perc = L.perceive(els, xyz)
    qg = L.gasteiger_charges(perc.elements, perc.bonds, perc.hybrid,
                             perc.formal)
    qa = np.array([MOH_AM1BCC[n] for n in names])
    ref = methanol_anchor()
    np.testing.assert_allclose(np.round(qg, 4), ref["q_gasteiger"],
                               atol=1e-6)
    dq = np.abs(qg - qa)
    assert 0.04 < dq.mean() < 0.12
    assert 0.12 < dq.max() < 0.25
    e_diff = abs(coulomb_intra(qg, xyz, perc.bonds)
                 - coulomb_intra(qa, xyz, perc.bonds))
    assert e_diff < 10.0
    assert e_diff == pytest.approx(ref["e_coul_intra_diff_kj"], abs=1e-6)

    def mu(q):
        return float(np.linalg.norm((q[:, None] * xyz).sum(0))) * 48.0329
    assert 1.0 < mu(qg) < mu(qa) < 2.5


def test_gasteiger_warning_fires():
    names = list(MOH_AM1BCC)
    xyz = np.array([MOH_XYZ_A[n] for n in names]) / 10.0
    struct = PDBStructure(
        atom_names=names, res_names=["MOH"] * 6, res_ids=[1] * 6,
        chain_ids=["A"] * 6, elements=["C", "O", "H", "H", "H", "H"],
        coords=xyz)
    with pytest.warns(UserWarning, match="Gasteiger"):
        L.parameterize_ligand("MOH", struct, add_h=False, register=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        L.parameterize_ligand("MOH", struct, add_h=False, register=False,
                              charges=[MOH_AM1BCC[n] for n in names])
