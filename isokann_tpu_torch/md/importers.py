"""Parameter-file importers: Amber frcmod + Tripos mol2 and OpenMM ffxml.

Counterpart of ``isokann_tpu/md/importers.py``.  When real GAFF /
antechamber output exists for a ligand (a frcmod with the parameters and
a mol2 with types, charges and bonds, or an OpenMM ffxml), these parsers
feed it into ``amber.register_residue``, so a built system uses those
values instead of the generic perception of ``md/ligand.py``;
``register_forcefield_ffxml`` registers every residue template and
parameter table of a whole OpenMM force-field XML.

Unit conventions on output match the embedded tables (kcal/mol, Angstrom,
degrees); ffxml input units (kJ, nm, radians, OpenMM half-k harmonic
convention) are converted.
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from typing import Dict, Tuple

from . import amber

KCAL = 4.184


# --------------------------------------------------------------------------
# Amber frcmod
# --------------------------------------------------------------------------

def _split_types(field: str, n: int):
    """'c3-c3-oh' -> ('c3', 'c3', 'oh') (fields are dash-separated,
    2 chars, space-padded)."""
    parts = [p.strip() for p in field.split("-")]
    if len(parts) != n:
        raise ValueError(f"bad type field {field!r}")
    return tuple(parts)


def load_frcmod(path: str):
    """Parse an Amber frcmod/parm-style file.

    Returns dict with keys ``masses`` {type: (mass, rmin_half, eps)} (LJ
    merged from NONBON), ``bonds`` {(t1,t2): (K, r0)}, ``angles``
    {(t1,t2,t3): (K, theta0)}, ``dihedrals`` {(t1..t4): [(pk, phase, n)]}
    (PK already divided by IDIVF), ``impropers`` {(t1,t2,t3c,t4): (pk,
    phase, n)}."""
    section = None
    masses: Dict[str, float] = {}
    nonbon: Dict[str, Tuple[float, float]] = {}
    bonds, angles = {}, {}
    dihedrals: Dict[tuple, list] = {}
    impropers = {}
    headers = {"MASS": "MASS", "BOND": "BOND", "ANGL": "ANGLE",
               "DIHE": "DIHE", "IMPR": "IMPROPER", "NONB": "NONBON",
               "HBON": "HBOND"}
    with open(path) as f:
        lines = f.readlines()
    for raw in lines[1:]:                      # first line is a title
        line = raw.rstrip("\n")
        token = line.strip()[:4].upper()
        if token in headers and len(line.strip().split()) <= 2:
            section = headers[token]
            continue
        if not line.strip():
            section = None
            continue
        if section == "MASS":
            m = re.match(r"\s*(\S{1,2})\s+([\d.+-]+)", line)
            if m:
                masses[m.group(1)] = float(m.group(2))
        elif section == "BOND":
            m = re.match(r"\s*(..-..)\s+([\d.+-]+)\s+([\d.+-]+)", line)
            if m:
                bonds[_split_types(m.group(1), 2)] = (
                    float(m.group(2)), float(m.group(3)))
        elif section == "ANGLE":
            m = re.match(r"\s*(..-..-..)\s+([\d.+-]+)\s+([\d.+-]+)", line)
            if m:
                angles[_split_types(m.group(1), 3)] = (
                    float(m.group(2)), float(m.group(3)))
        elif section == "DIHE":
            m = re.match(r"\s*(..-..-..-..)\s+(\d+)\s+([\d.+-]+)\s+"
                         r"([\d.+-]+)\s+([\d.+-]+)", line)
            if m:
                key = _split_types(m.group(1), 4)
                key = tuple("X" if t in ("X", "x") else t for t in key)
                idivf = int(m.group(2))
                pk = float(m.group(3)) / max(idivf, 1)
                phase = float(m.group(4))
                pn = float(m.group(5))
                dihedrals.setdefault(key, []).append(
                    (pk, phase, abs(pn)))
                # negative periodicity: additional terms follow (already
                # handled by appending per-line)
        elif section == "IMPROPER":
            m = re.match(r"\s*(..-..-..-..)\s+([\d.+-]+)\s+([\d.+-]+)\s+"
                         r"([\d.+-]+)", line)
            if m:
                key = _split_types(m.group(1), 4)
                key = tuple("X" if t in ("X", "x") else t for t in key)
                impropers[key] = (float(m.group(2)), float(m.group(3)),
                                  int(float(m.group(4))))
        elif section == "NONBON":
            m = re.match(r"\s*(\S{1,2})\s+([\d.+-]+)\s+([\d.+-]+)", line)
            if m:
                nonbon[m.group(1)] = (float(m.group(2)), float(m.group(3)))
    types = {}
    for t in set(masses) | set(nonbon):
        mass = masses.get(t, 12.01)
        rmin, eps = nonbon.get(t, (1.9080, 0.0860))
        types[t] = (mass, rmin, eps)
    return dict(types=types, bonds=bonds, angles=angles,
                dihedrals=dihedrals, impropers=impropers)


# --------------------------------------------------------------------------
# Tripos mol2
# --------------------------------------------------------------------------

def load_mol2(path: str):
    """Parse a Tripos mol2 file.

    Returns dict(names, types, charges, bonds (0-based index pairs),
    coords_nm, elements)."""
    names, types, charges, coords, elements = [], [], [], [], []
    bonds = []
    section = None
    with open(path) as f:
        for line in f:
            if line.startswith("@<TRIPOS>"):
                section = line.strip()[9:]
                continue
            if not line.strip():
                continue
            if section == "ATOM":
                p = line.split()
                names.append(p[1])
                coords.append([float(p[2]), float(p[3]), float(p[4])])
                sybyl = p[5]
                types.append(sybyl)
                charges.append(float(p[8]) if len(p) > 8 else 0.0)
                elements.append(sybyl.split(".")[0].capitalize())
            elif section == "BOND":
                p = line.split()
                bonds.append((int(p[1]) - 1, int(p[2]) - 1))
    import numpy as np
    return dict(names=names, types=types, charges=charges, bonds=bonds,
                coords_nm=np.asarray(coords) / 10.0, elements=elements)


def register_ligand_frcmod(name: str, mol2_path: str, frcmod_path: str,
                           type_map=None):
    """Authoritative ligand registration from antechamber output: mol2
    supplies atoms/types/charges/bonds, frcmod the parameters.

    ``type_map``: optional {mol2_type: frcmod_type} when the mol2 carries
    SYBYL types instead of GAFF types (antechamber ``-at gaff`` writes
    GAFF types directly, which need no map)."""
    mol2 = load_mol2(mol2_path)
    prm = load_frcmod(frcmod_path)
    tmap = type_map or {}
    types = [tmap.get(t, t) for t in mol2["types"]]
    missing = set(types) - set(prm["types"])
    if missing:
        raise ValueError(f"frcmod lacks LJ/mass entries for {sorted(missing)}")
    atoms = {n: (t, q) for n, t, q in
             zip(mol2["names"], types, mol2["charges"])}
    bonds_named = [(mol2["names"][a], mol2["names"][b])
                   for (a, b) in mol2["bonds"]]
    tmpl = amber.register_residue(
        name, atoms, bonds_named,
        formal_charge=int(round(sum(mol2["charges"]))),
        atom_types=prm["types"],
        bond_params=prm["bonds"],
        angle_params=prm["angles"],
        dihedral_params=prm["dihedrals"],
        normalize=False)
    amber.IMPROPERS.update(prm["impropers"])
    return tmpl, mol2


# --------------------------------------------------------------------------
# OpenMM ffxml
# --------------------------------------------------------------------------

def load_ffxml(path: str):
    """Parse an OpenMM force-field XML into amber-convention tables.

    Handles AtomTypes, Residues, HarmonicBondForce, HarmonicAngleForce,
    PeriodicTorsionForce and NonbondedForce.  OpenMM harmonic k values
    (E = k/2 dx^2, kJ, nm, radians) are converted to the Amber convention
    (E = K dx^2, kcal, Angstrom, degrees)."""
    root = ET.parse(path).getroot()
    type_class: Dict[str, str] = {}
    type_mass: Dict[str, float] = {}
    for t in root.iter("Type"):
        type_class[t.get("name")] = t.get("class", t.get("name"))
        type_mass[t.get("name")] = float(t.get("mass", 0.0))

    lj: Dict[str, Tuple[float, float]] = {}
    charges_by_type: Dict[str, float] = {}
    for nb in root.iter("NonbondedForce"):
        for a in nb.iter("Atom"):
            t = a.get("type")
            if t is None:
                continue
            sigma = float(a.get("sigma", 0.0)) * 10.0        # nm -> A
            eps = float(a.get("epsilon", 0.0)) / KCAL
            rmin_half = sigma * (2.0 ** (1.0 / 6.0)) / 2.0
            lj[t] = (rmin_half, eps)
            if a.get("charge") is not None:
                charges_by_type[t] = float(a.get("charge"))

    types = {}
    for t, cls in type_class.items():
        rmin_half, eps = lj.get(t, (1.908, 0.086))
        types[t] = (type_mass.get(t, 12.01), rmin_half, eps)

    def cls(tp):
        return type_class.get(tp, tp)

    bonds = {}
    for bf in root.iter("HarmonicBondForce"):
        for b in bf.iter("Bond"):
            k = float(b.get("k")) / (2.0 * KCAL * 100.0)     # kJ/nm^2
            r0 = float(b.get("length")) * 10.0
            key = (b.get("class1", b.get("type1")),
                   b.get("class2", b.get("type2")))
            bonds[key] = (k, r0)
    angles = {}
    for af in root.iter("HarmonicAngleForce"):
        for a in af.iter("Angle"):
            k = float(a.get("k")) / (2.0 * KCAL)
            t0 = math.degrees(float(a.get("angle")))
            key = (a.get("class1", a.get("type1")),
                   a.get("class2", a.get("type2")),
                   a.get("class3", a.get("type3")))
            angles[key] = (k, t0)
    dihedrals: Dict[tuple, list] = {}
    impropers = {}
    for tf in root.iter("PeriodicTorsionForce"):
        for p in tf.iter("Proper"):
            key = tuple((p.get(f"class{i}") or p.get(f"type{i}") or "X")
                        or "X" for i in (1, 2, 3, 4))
            key = tuple("X" if v in ("", "X") else v for v in key)
            terms = []
            i = 1
            while p.get(f"periodicity{i}") is not None:
                terms.append((float(p.get(f"k{i}")) / KCAL,
                              math.degrees(float(p.get(f"phase{i}"))),
                              int(p.get(f"periodicity{i}"))))
                i += 1
            dihedrals[key] = terms
        for p in tf.iter("Improper"):
            key = tuple((p.get(f"class{i}") or p.get(f"type{i}") or "X")
                        or "X" for i in (1, 2, 3, 4))
            key = tuple("X" if v in ("", "X") else v for v in key)
            if p.get("periodicity1") is not None:
                # OpenMM improper convention: central atom FIRST; the
                # embedded tables use central-third — rotate
                c, a1, a2, a3 = key
                impropers[(a1, a2, c, a3)] = (
                    float(p.get("k1")) / KCAL,
                    math.degrees(float(p.get("phase1"))),
                    int(p.get("periodicity1")))

    residues = {}
    for res in root.iter("Residue"):
        ratoms = {}
        for a in res.iter("Atom"):
            t = a.get("type")
            q = (float(a.get("charge")) if a.get("charge") is not None
                 else charges_by_type.get(t, 0.0))
            ratoms[a.get("name")] = (t, q)
        rbonds = []
        alist = [a.get("name") for a in res.iter("Atom")]
        for b in res.iter("Bond"):
            if b.get("atomName1"):
                rbonds.append((b.get("atomName1"), b.get("atomName2")))
            else:
                rbonds.append((alist[int(b.get("from"))],
                               alist[int(b.get("to"))]))
        residues[res.get("name")] = dict(
            atoms=ratoms, bonds=rbonds,
            has_vsites=res.find("VirtualSite") is not None)

    return dict(types=types, type_class=type_class, bonds=bonds,
                angles=angles, dihedrals=dihedrals, impropers=impropers,
                residues=residues)


def register_forcefield_ffxml(path: str, residues=None,
                              override: bool = True, strict: bool = True):
    """Register EVERY residue template and parameter table from an OpenMM
    force-field XML — the reference's exact input format
    (``ForceField(*forcefields)``, ``src/simulators/mopenmm.py:54``,
    default ``amber14-all.xml`` per ``src/simulators/openmm.jl:130``).

    After this call, ``build_system``/``MDSimulation`` resolve matching
    residues with the XML's exact charges and parameters instead of the
    embedded ff99SB-class tables — the no-OpenMM path to ff14SB/ff19SB
    exactness when the user has the (public, Apache-licensed) XML file.

    - ``residues``: optional subset of residue names to register
      (default: all in the file)
    - ``override=True``: XML values replace colliding embedded
      types/parameters (amber14-class files use their own class names,
      so collisions are rare outside water/ions)
    - ``strict``: raise on within-class LJ conflicts (two types of one
      class with different LJ cannot be represented by class-keyed
      tables); False warns and keeps the first

    Terminal templates (``NALA``/``CALA``...) present in the file are
    registered as-is and override any auto-generated variants.  Residues
    containing virtual sites (4/5-site waters) are skipped with a warning
    — use ``MDSimulation(water_model=...)`` or the serialized-System
    importer for those.  Returns the list of registered residue names.
    """
    import warnings

    ff = load_ffxml(path)
    cls = ff["type_class"]

    class_types: Dict[str, tuple] = {}
    for t, v in ff["types"].items():
        c = cls.get(t, t)
        if c in class_types:
            prev = class_types[c]
            if (abs(prev[1] - v[1]) > 1e-6 or abs(prev[2] - v[2]) > 1e-6):
                msg = (f"types of class {c!r} carry different LJ "
                       f"({prev[1:]} vs {v[1:]}); class-keyed tables "
                       f"cannot represent this")
                if strict:
                    raise ValueError(msg)
                warnings.warn(msg + "; keeping the first")
        else:
            class_types[c] = v

    def merged(table, new):
        if override:
            return new
        return {k: v for k, v in new.items() if k not in table}

    amber.ATOM_TYPES.update(merged(amber.ATOM_TYPES, class_types))
    amber.BONDS.update(merged(amber.BONDS, ff["bonds"]))
    amber.ANGLES.update(merged(amber.ANGLES, ff["angles"]))
    amber.DIHEDRALS.update(merged(amber.DIHEDRALS, ff["dihedrals"]))
    amber.IMPROPERS.update(merged(amber.IMPROPERS, ff["impropers"]))

    wanted = list(ff["residues"]) if residues is None else list(residues)

    def is_terminal_variant(r):
        return len(r) > 3 and r[0] in "NC" and r[1:] in ff["residues"]

    ordered = ([r for r in wanted if not is_terminal_variant(r)]
               + [r for r in wanted if is_terminal_variant(r)])
    done = []
    for rname in ordered:
        res = ff["residues"].get(rname)
        if res is None:
            raise ValueError(f"residue {rname} not in {path}")
        if res.get("has_vsites"):
            warnings.warn(f"residue {rname} contains virtual sites; "
                          f"skipped (use water_model=... or the "
                          f"serialized-System importer)")
            continue
        if not override and rname in amber.RESIDUES:
            continue
        atoms = {n: (cls.get(t, t), q) for n, (t, q) in res["atoms"].items()}
        q_total = sum(q for _, q in atoms.values())
        if abs(q_total - round(q_total)) > 5e-3:
            warnings.warn(f"residue {rname} charge sum {q_total:+.4f} is "
                          f"not integral")
        amber.register_residue(
            rname, atoms, res["bonds"],
            formal_charge=int(round(q_total)),
            normalize=False,
            # XML-provided N*/C* templates are authoritative: never let a
            # base residue auto-generate variants that would mask them
            terminal_variants=False)
        done.append(rname)
    # fallback terminal variants only where the file supplied none
    for rname in done:
        if is_terminal_variant(rname):
            continue
        names = set(amber.RESIDUES[rname]["atoms"])
        if not {"N", "H", "CA", "C", "O"} <= names:
            continue
        try:
            if "N" + rname not in amber.RESIDUES:
                amber.make_nterminal(rname)
            if "C" + rname not in amber.RESIDUES:
                amber.make_cterminal(rname)
        except (ValueError, KeyError):
            pass
    return done


def register_ligand_ffxml(name: str, ffxml_path: str, residue=None):
    """Register a ligand residue from an OpenMM ffxml (e.g. one generated
    by openmmforcefields' GAFFTemplateGenerator)."""
    ff = load_ffxml(ffxml_path)
    resname = residue or (name if name in ff["residues"] else
                          next(iter(ff["residues"])))
    if resname not in ff["residues"]:
        raise ValueError(f"residue {resname} not in {ffxml_path}")
    res = ff["residues"][resname]
    # bonded tables are keyed by CLASS; map atom types to classes
    cls = ff["type_class"]
    atoms = {n: (cls.get(t, t), q) for n, (t, q) in res["atoms"].items()}
    # class-level LJ/mass (first type of each class wins)
    class_types = {}
    for t, v in ff["types"].items():
        class_types.setdefault(cls.get(t, t), v)
    q_total = sum(q for _, q in atoms.values())
    tmpl = amber.register_residue(
        name, atoms, res["bonds"],
        formal_charge=int(round(q_total)),
        atom_types=class_types,
        bond_params=ff["bonds"],
        angle_params=ff["angles"],
        dihedral_params=ff["dihedrals"],
        normalize=False)
    amber.IMPROPERS.update(ff["impropers"])
    return tmpl
