"""Port parity of the parameter-file importers (``md/importers.py``) and
of ``amber.register_residue``: every case of the JAX package's
``tests/test_ffxml_forcefield.py``, the importer cases of
``tests/test_ligand.py`` and ``test_forcefield_ext.py``'s
``register_residue`` cases through the port at the JAX test's bounds;
the parsed tables equal the JAX package's, and a system built after the
same registration in both packages has the same tables (indices exactly,
values 1e-6).  A fixture restores both packages' amber tables after every
test, so no registration leaks into another test of the worker (CPU)."""

import copy
import math
import os
import textwrap
import warnings

import numpy as np
import pytest
import torch

import isokann_tpu.md.amber as JAM
from isokann_tpu.md import importers as JI
from isokann_tpu.md.pdbio import PDBStructure as JaxStructure
from isokann_tpu.md.system import build_system as jax_build_system

from isokann_tpu_torch.md import amber
from isokann_tpu_torch.md import importers as I
from isokann_tpu_torch.md.fixtures import alanine_dipeptide_pdb
from isokann_tpu_torch.md.forces import energy_terms, potential_energy_flat
from isokann_tpu_torch.md.pdbio import PDBStructure, read_pdb, write_pdb
from isokann_tpu_torch.md.system import build_system

from test_torch_amberio import assert_tables_match

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

KCAL = 4.184
SIG = 2.0 ** (1.0 / 6.0)
TABLES = ("ATOM_TYPES", "BONDS", "ANGLES", "DIHEDRALS", "IMPROPERS",
          "RESIDUES")
FRAGMENT = os.path.join(os.path.dirname(__file__), "data",
                        "amber14_style_fragment.xml")


@pytest.fixture(autouse=True)
def restore_amber():
    """Both packages' registries as they were before the test."""
    snaps = [(mod, {k: copy.deepcopy(getattr(mod, k)) for k in TABLES})
             for mod in (amber, JAM)]
    yield
    for mod, snap in snaps:
        for k, v in snap.items():
            getattr(mod, k).clear()
            getattr(mod, k).update(v)


def _ffxml_from_builtin(resnames, charge_move=0.0, dihe_scale=None):
    """The JAX test's renderer: the embedded tables for ``resnames`` as an
    OpenMM ffxml (``charge_move`` shifts ALA CB by +d and HB1 by -d;
    ``dihe_scale`` {key: factor} scales torsion barriers)."""
    classes = {}
    lines = ['<ForceField>', ' <AtomTypes>']
    for rn in resnames:
        for n, (t, q) in amber.RESIDUES[rn]["atoms"].items():
            classes[t] = amber.ATOM_TYPES[t]
    for t, (m, rh, eps) in sorted(classes.items()):
        lines.append(f'  <Type name="{t}" class="{t}" mass="{m}"/>')
    lines.append(' </AtomTypes>')
    lines.append(' <Residues>')
    for rn in resnames:
        tmpl = amber.RESIDUES[rn]
        lines.append(f'  <Residue name="{rn}">')
        for n, (t, q) in tmpl["atoms"].items():
            if rn == "ALA" and n == "CB":
                q = q + charge_move
            if rn == "ALA" and n == "HB1":
                q = q - charge_move
            lines.append(f'   <Atom name="{n}" type="{t}" charge="{q}"/>')
        for a, b in tmpl["bonds"]:
            lines.append(f'   <Bond atomName1="{a}" atomName2="{b}"/>')
        lines.append('  </Residue>')
    lines.append(' </Residues>')

    def in_classes(key):
        return all(t == "X" or t in classes for t in key)

    lines.append(' <HarmonicBondForce>')
    for (t1, t2), (k, r0) in amber.BONDS.items():
        if not isinstance(k, (int, float)) or not in_classes((t1, t2)):
            continue
        lines.append(f'  <Bond class1="{t1}" class2="{t2}" '
                     f'length="{r0 / 10.0}" k="{k * 2 * KCAL * 100}"/>')
    lines.append(' </HarmonicBondForce>')
    lines.append(' <HarmonicAngleForce>')
    for (t1, t2, t3), (k, t0) in amber.ANGLES.items():
        if not in_classes((t1, t2, t3)):
            continue
        lines.append(f'  <Angle class1="{t1}" class2="{t2}" class3="{t3}" '
                     f'angle="{math.radians(t0)}" k="{k * 2 * KCAL}"/>')
    lines.append(' </HarmonicAngleForce>')
    lines.append(' <PeriodicTorsionForce>')
    for key, terms in amber.DIHEDRALS.items():
        if not in_classes(key):
            continue
        scale = (dihe_scale or {}).get(key, 1.0)
        attrs = "".join(f' class{i + 1}="{"" if t == "X" else t}"'
                        for i, t in enumerate(key))
        tattrs = "".join(
            f' periodicity{j + 1}="{int(n)}" phase{j + 1}='
            f'"{math.radians(ph)}" k{j + 1}="{pk * scale * KCAL}"'
            for j, (pk, ph, n) in enumerate(terms))
        lines.append(f'  <Proper{attrs}{tattrs}/>')
    for (i, j, c, l), (pk, ph, n) in amber.IMPROPERS.items():
        if not in_classes((i, j, c, l)):
            continue
        attrs = (f' class1="{"" if c == "X" else c}"'
                 f' class2="{"" if i == "X" else i}"'
                 f' class3="{"" if j == "X" else j}"'
                 f' class4="{"" if l == "X" else l}"')
        lines.append(f'  <Improper{attrs} periodicity1="{int(n)}" '
                     f'phase1="{math.radians(ph)}" k1="{pk * KCAL}"/>')
    lines.append(' </PeriodicTorsionForce>')
    lines.append(' <NonbondedForce coulomb14scale="0.8333333" '
                 'lj14scale="0.5">')
    for t, (m, rh, eps) in sorted(classes.items()):
        sigma = (2.0 * rh) / SIG / 10.0
        lines.append(f'  <Atom type="{t}" sigma="{sigma}" '
                     f'epsilon="{eps * KCAL}"/>')
    lines.append(' </NonbondedForce>')
    lines.append('</ForceField>')
    return "\n".join(lines)


RES = ("ACE", "ALA", "NME")


def _ala():
    pdb = alanine_dipeptide_pdb()
    struct = read_pdb(pdb)
    return pdb, struct, torch.as_tensor(struct.coords, dtype=torch.float32)


def _terms(sys, x):
    return {k: float(v) for k, v in energy_terms(sys, x).items()}


def _register_both(path, **kw):
    """Register one ffxml in both packages; the alanine systems built
    afterwards have equal tables."""
    done = I.register_forcefield_ffxml(path, **kw)
    assert JI.register_forcefield_ffxml(path, **kw) == done
    pdb = alanine_dipeptide_pdb()
    sys = build_system(pdb, method="NoCutoff", device="cpu")
    assert_tables_match(jax_build_system(pdb, method="NoCutoff"), sys)
    return done, sys


# ---- whole force-field ffxml ------------------------------------------------

def test_load_ffxml_matches_jax(tmp_path):
    """The parse of the committed amber14-style fragment and of a rendered
    file equals the JAX package's."""
    assert I.load_ffxml(FRAGMENT) == JI.load_ffxml(FRAGMENT)
    path = tmp_path / "ff.xml"
    path.write_text(_ffxml_from_builtin(RES, charge_move=0.05))
    assert I.load_ffxml(str(path)) == JI.load_ffxml(str(path))


def test_roundtrip_identity(tmp_path):
    """Registering an ffxml rendered from the embedded tables reproduces
    the embedded energies (2e-3) with no fallback."""
    pdb, _, x = _ala()
    t0 = _terms(build_system(pdb, method="NoCutoff", device="cpu"), x)
    path = tmp_path / "ff.xml"
    path.write_text(_ffxml_from_builtin(RES))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        done, sys2 = _register_both(str(path))
    assert set(done) == set(RES)
    t1 = _terms(sys2, x)
    for k in t0:
        assert abs(t1[k] - t0[k]) < 2e-3, k


def test_xml_values_win(tmp_path):
    """Perturbed charges and a doubled backbone torsion barrier land in
    the built system as the file gives them."""
    pdb, struct, x = _ala()
    base = _terms(build_system(pdb, method="NoCutoff", device="cpu"), x)
    key = next(k for k in amber.DIHEDRALS
               if k in (("C", "N", "CT", "C"), ("C", "CT", "N", "C")))
    path = tmp_path / "ff.xml"
    path.write_text(_ffxml_from_builtin(RES, charge_move=0.05,
                                        dihe_scale={key: 2.0}))
    _, sys2 = _register_both(str(path))
    ala_cb = [i for i, (rn, an) in
              enumerate(zip(struct.res_names, struct.atom_names))
              if rn == "ALA" and an == "CB"][0]
    got = float(sys2.charges[ala_cb])
    want = amber.RESIDUES["ALA"]["atoms"]["CB"][1]
    assert abs(got - want) < 1e-6 and abs(got - (0.0337 - 1.0)) > 1e-3
    t1 = _terms(sys2, x)
    assert abs(t1["dihedral"] - base["dihedral"]) > 0.05
    assert abs(t1["nonbonded"] - base["nonbonded"]) > 1e-4
    assert abs(t1["bond"] - base["bond"]) < 2e-4


def test_terminal_fallback_generated(tmp_path):
    path = tmp_path / "ff.xml"
    path.write_text(_ffxml_from_builtin(RES))
    _register_both(str(path))
    assert "NALA" in amber.RESIDUES and "CALA" in amber.RESIDUES
    assert amber.RESIDUES["NALA"] == JAM.RESIDUES["NALA"]


def test_strict_lj_conflict(tmp_path):
    xml = """<ForceField>
 <AtomTypes>
  <Type name="t1" class="cc" mass="12.0"/>
  <Type name="t2" class="cc" mass="12.0"/>
 </AtomTypes>
 <Residues/>
 <NonbondedForce>
  <Atom type="t1" sigma="0.3" epsilon="0.5"/>
  <Atom type="t2" sigma="0.35" epsilon="0.5"/>
 </NonbondedForce>
</ForceField>"""
    path = tmp_path / "bad.xml"
    path.write_text(xml)
    with pytest.raises(ValueError, match="different LJ"):
        I.register_forcefield_ffxml(str(path))
    with pytest.warns(UserWarning, match="keeping the first"):
        assert I.register_forcefield_ffxml(str(path), strict=False) == []


def test_amber14_style_static_fixture():
    """The committed amber14-structured fragment: type-name != class
    indirection, charges in NonbondedForce, multi-term Propers; alanine
    builds with no fallback and carries the file's values."""
    pdb, struct, x = _ala()
    base = _terms(build_system(pdb, method="NoCutoff", device="cpu"), x)
    cb_q_builtin = amber.RESIDUES["ALA"]["atoms"]["CB"][1]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        done, sys2 = _register_both(FRAGMENT)
    assert set(done) == {"ACE", "ALA", "NME"}
    ala_cb = [i for i, (rn, an) in
              enumerate(zip(struct.res_names, struct.atom_names))
              if rn == "ALA" and an == "CB"][0]
    assert float(sys2.charges[ala_cb]) == pytest.approx(
        cb_q_builtin - 0.09, abs=1e-5)
    q = float(sys2.charges.double().sum())
    assert abs(q - round(q)) < 1e-4
    t1 = _terms(sys2, x)
    assert abs(t1["angle"] - base["angle"]) > 0.05
    assert abs(t1["bond"] - base["bond"]) < 2e-4
    assert abs(t1["dihedral"] - base["dihedral"]) < 2e-3


def test_no_override_keeps_embedded_tables(tmp_path):
    """``override=False`` adds only what the embedded tables lack: the
    perturbed file then changes nothing, in both packages."""
    pdb, _, x = _ala()
    base = _terms(build_system(pdb, method="NoCutoff", device="cpu"), x)
    path = tmp_path / "ff.xml"
    path.write_text(_ffxml_from_builtin(RES, charge_move=0.05))
    done, sys2 = _register_both(str(path), override=False)
    assert done == []
    t1 = _terms(sys2, x)
    for k in base:
        assert t1[k] == base[k], k


# ---- register_residue --------------------------------------------------------

def _bnz():
    return dict(
        atoms={f"C{i}": ("CA", -0.115) for i in range(1, 7)}
        | {f"H{i}": ("HA", 0.115) for i in range(1, 7)},
        bonds=[(f"C{i}", f"C{i % 6 + 1}") for i in range(1, 7)]
        + [(f"C{i}", f"H{i}") for i in range(1, 7)])


def test_register_residue_ligand(tmp_path):
    """A benzene 'ligand' with given parameters registers, builds with a
    zero net charge and a finite energy, the same tables as the JAX
    package's; an unknown type raises."""
    tmpl = amber.register_residue("BNZ", **_bnz())
    assert tmpl == JAM.register_residue("BNZ", **_bnz())
    names, elements, coords = [], [], []
    for i in range(6):
        a = 2 * math.pi * i / 6
        names.append(f"C{i+1}")
        elements.append("C")
        coords.append([0.139 * math.cos(a), 0.139 * math.sin(a), 0.0])
        names.append(f"H{i+1}")
        elements.append("H")
        coords.append([0.248 * math.cos(a), 0.248 * math.sin(a), 0.0])
    s = PDBStructure(names, ["BNZ"] * 12, [1] * 12, ["L"] * 12, elements,
                     np.asarray(coords), None)
    p = str(tmp_path / "bnz.pdb")
    write_pdb(p, s)
    sys = build_system(p, device="cpu")
    assert_tables_match(jax_build_system(p), sys)
    assert abs(float(sys.charges.sum())) < 1e-6
    e = float(potential_energy_flat(sys, torch.as_tensor(
        np.asarray(coords).reshape(-1), dtype=torch.float32)))
    assert np.isfinite(e)
    with pytest.raises(ValueError, match="unknown atom types"):
        amber.register_residue("BAD", atoms={"X1": ("ZZ", 0.0)}, bonds=[])


def test_register_residue_validates_before_mutating():
    """A failed registration leaves every shared table as it was: an
    unknown type, or a bond naming an unknown atom."""
    before = {k: copy.deepcopy(getattr(amber, k)) for k in TABLES}
    with pytest.raises(ValueError):
        amber.register_residue(
            "BAD2", atoms={"X1": ("ZZ9", 0.0)}, bonds=[],
            bond_params={("CT", "N"): (999.0, 0.5)})
    with pytest.raises(ValueError, match="unknown atoms"):
        amber.register_residue(
            "BAD3", atoms={"X1": ("CT", 0.0)}, bonds=[("X1", "X2")],
            bond_params={("CT", "N"): (999.0, 0.5)})
    for k in TABLES:
        assert getattr(amber, k) == before[k], k


def test_register_residue_backbone_variants():
    """A residue with backbone N/H/CA/C/O gets N- and C-terminal variants
    (normalised to formal charge +1 / -1), equal to the JAX package's."""
    atoms = dict(amber.RESIDUES["ALA"]["atoms"])
    bonds = list(amber.RESIDUES["ALA"]["bonds"])
    amber.register_residue("XAL", atoms, bonds)
    JAM.register_residue("XAL", dict(atoms), list(bonds))
    for name in ("XAL", "NXAL", "CXAL"):
        assert amber.RESIDUES[name] == JAM.RESIDUES[name], name
    for name, formal in (("NXAL", 1), ("CXAL", -1)):
        s = sum(q for _, q in amber.RESIDUES[name]["atoms"].values())
        assert abs(s - formal) < 1e-9


# ---- ligand importers ----------------------------------------------------------

_FRCMOD = textwrap.dedent("""\
    generic methanol-like fragment
    MASS
    c3 12.010   0.878
    oh 16.000   0.465
    ho 1.008    0.135
    h1 1.008    0.135

    BOND
    c3-oh  316.70  1.423
    c3-h1  330.60  1.097
    oh-ho  371.40  0.973

    ANGLE
    h1-c3-h1  39.24  108.46
    h1-c3-oh  50.97  110.26
    c3-oh-ho  47.09  107.26

    DIHE
    h1-c3-oh-ho  3  0.50  0.0  3.

    IMPROPER

    NONBON
      c3  1.9080  0.1094
      oh  1.7210  0.2104
      ho  0.0000  0.0000
      h1  1.3870  0.0157
    """)

_MOL2 = textwrap.dedent("""\
    @<TRIPOS>MOLECULE
    MOH
     6 5 1 0 0
    SMALL
    USER_CHARGES
    @<TRIPOS>ATOM
      1 C1   0.000  0.000  0.000 c3 1 MOH  0.0900
      2 O1   1.410  0.000  0.000 oh 1 MOH -0.5988
      3 H1  -0.360  1.030  0.000 h1 1 MOH  0.0372
      4 H2  -0.360 -0.520  0.890 h1 1 MOH  0.0372
      5 H3  -0.360 -0.520 -0.890 h1 1 MOH  0.0372
      6 H4   1.730  0.890  0.000 ho 1 MOH  0.3972
    @<TRIPOS>BOND
      1 1 2 1
      2 1 3 1
      3 1 4 1
      4 1 5 1
      5 2 6 1
    """)


def test_frcmod_mol2_import(tmp_path):
    fp = tmp_path / "moh.frcmod"
    fp.write_text(_FRCMOD)
    mp = tmp_path / "moh.mol2"
    mp.write_text(_MOL2)

    prm = I.load_frcmod(str(fp))
    assert prm == JI.load_frcmod(str(fp))
    assert prm["bonds"][("c3", "oh")] == (316.70, 1.423)
    assert prm["angles"][("c3", "oh", "ho")] == (47.09, 107.26)
    assert prm["dihedrals"][("h1", "c3", "oh", "ho")] == [
        (0.50 / 3, 0.0, 3.0)]
    assert prm["types"]["oh"] == (16.0, 1.7210, 0.2104)

    mol2 = I.load_mol2(str(mp))
    jmol2 = JI.load_mol2(str(mp))
    for k in ("names", "types", "charges", "bonds", "elements"):
        assert mol2[k] == jmol2[k], k
    np.testing.assert_array_equal(mol2["coords_nm"], jmol2["coords_nm"])
    assert mol2["names"][0] == "C1"
    assert mol2["bonds"][0] == (0, 1)
    assert abs(sum(mol2["charges"])) < 1e-9

    tmpl, mol2b = I.register_ligand_frcmod("MOH", str(mp), str(fp))
    assert tmpl == JI.register_ligand_frcmod("MOH", str(mp), str(fp))[0]
    assert tmpl["atoms"]["O1"] == ("oh", -0.5988)
    struct = PDBStructure(
        atom_names=mol2b["names"], res_names=["MOH"] * 6,
        res_ids=[1] * 6, chain_ids=["A"] * 6,
        elements=mol2b["elements"], coords=mol2b["coords_nm"])
    path = str(tmp_path / "moh.pdb")
    write_pdb(path, struct)
    sys_ = build_system(path, device="cpu")
    assert_tables_match(jax_build_system(path), sys_)
    e = float(potential_energy_flat(sys_, torch.as_tensor(
        struct.coords.reshape(-1), dtype=torch.float32)))
    assert np.isfinite(e)
    assert np.allclose(sorted(sys_.charges.numpy()),
                       sorted(mol2["charges"]), atol=1e-6)


_LIG_XML = textwrap.dedent("""\
    <ForceField>
     <AtomTypes>
      <Type name="gaff-c3" class="c3" element="C" mass="12.01"/>
      <Type name="gaff-hc" class="hc" element="H" mass="1.008"/>
     </AtomTypes>
     <Residues>
      <Residue name="LIG">
       <Atom name="C1" type="gaff-c3" charge="-0.4"/>
       <Atom name="H1" type="gaff-hc" charge="0.1"/>
       <Bond atomName1="C1" atomName2="H1"/>
      </Residue>
     </Residues>
     <HarmonicBondForce>
      <Bond class1="c3" class2="hc" length="0.1092" k="282252.8"/>
     </HarmonicBondForce>
     <HarmonicAngleForce>
      <Angle class1="hc" class2="c3" class3="hc" angle="1.8919"
             k="329.95"/>
     </HarmonicAngleForce>
     <PeriodicTorsionForce>
      <Proper class1="" class2="c3" class3="c3" class4=""
              periodicity1="3" phase1="0.0" k1="0.6508"/>
     </PeriodicTorsionForce>
     <NonbondedForce coulomb14scale="0.8333" lj14scale="0.5">
      <Atom type="gaff-c3" charge="-0.4" sigma="0.3398" epsilon="0.4577"/>
      <Atom type="gaff-hc" charge="0.1" sigma="0.2600" epsilon="0.0870"/>
     </NonbondedForce>
    </ForceField>
    """)


def test_ffxml_import(tmp_path):
    p = tmp_path / "lig.xml"
    p.write_text(_LIG_XML)
    ff = I.load_ffxml(str(p))
    assert ff == JI.load_ffxml(str(p))
    K, r0 = ff["bonds"][("c3", "hc")]
    assert abs(r0 - 1.092) < 1e-9
    assert abs(K - 282252.8 / (2 * 4.184 * 100)) < 1e-6
    Ka, t0 = ff["angles"][("hc", "c3", "hc")]
    assert abs(t0 - math.degrees(1.8919)) < 1e-9
    assert ff["dihedrals"][("X", "c3", "c3", "X")] == [
        (0.6508 / 4.184, 0.0, 3)]
    m, rmin_half, eps = ff["types"]["gaff-c3"]
    assert abs(rmin_half - 0.3398 * 10 * 2 ** (1 / 6) / 2) < 1e-6
    assert abs(eps - 0.4577 / 4.184) < 1e-6
    assert ff["residues"]["LIG"]["atoms"]["C1"] == ("gaff-c3", -0.4)


def test_register_ligand_ffxml(tmp_path):
    """A ligand residue from an ffxml registers with class-keyed types and
    its charges, as in the JAX package; its system builds with finite
    energy and the file's charges."""
    p = tmp_path / "lig.xml"
    p.write_text(_LIG_XML)
    tmpl = I.register_ligand_ffxml("LIG", str(p))
    assert tmpl == JI.register_ligand_ffxml("LIG", str(p))
    assert tmpl["atoms"]["C1"] == ("c3", -0.4)
    assert amber.ATOM_TYPES["c3"] == JAM.ATOM_TYPES["c3"]
    with pytest.raises(ValueError, match="not in"):
        I.register_ligand_ffxml("LIG", str(p), residue="XYZ")
    s = PDBStructure(["C1", "H1"], ["LIG"] * 2, [1, 1], ["A"] * 2,
                     ["C", "H"], np.array([[0.0, 0.0, 0.0],
                                           [0.109, 0.0, 0.0]]))
    path = str(tmp_path / "lig.pdb")
    write_pdb(path, s)
    sys = build_system(path, device="cpu")
    assert_tables_match(jax_build_system(path), sys)
    np.testing.assert_allclose(sys.charges.numpy(), [-0.4, 0.1], atol=1e-7)
    assert np.isfinite(float(potential_energy_flat(
        sys, torch.as_tensor(s.coords.reshape(-1), dtype=torch.float32))))
