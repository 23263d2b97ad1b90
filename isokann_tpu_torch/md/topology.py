"""Topology construction: PDB structure + residue templates -> bond graph,
atom types, charges and the derived angle/dihedral/improper lists.

Counterpart of ``isokann_tpu/md/topology.py``: the same residue-name and
atom-name aliases, the candidate search over histidine tautomers,
cysteine / cystine, N- / C-terminal protein variants and the nucleic
5'-OH / 3'-OH / nucleoside variants (the interior template as the
fallback), peptide, O3'-P and disulfide bonds by geometry, and the
improper rules.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from . import amber
from .pdbio import PDBStructure


@dataclass
class Residue:
    name: str
    resid: int
    atom_indices: List[int]


@dataclass
class Topology:
    atom_names: List[str]
    atom_types: List[str]
    charges: np.ndarray           # (n,) elementary charges
    masses: np.ndarray            # (n,) amu
    residues: List[Residue]
    bonds: List[Tuple[int, int]]
    angles: List[Tuple[int, int, int]] = field(default_factory=list)
    propers: List[Tuple[int, int, int, int]] = field(default_factory=list)
    impropers: List[Tuple[int, int, int, int]] = field(default_factory=list)

    @property
    def natoms(self):
        return len(self.atom_names)

    def neighbors(self):
        adj: Dict[int, set] = {i: set() for i in range(self.natoms)}
        for a, b in self.bonds:
            adj[a].add(b)
            adj[b].add(a)
        return adj


# residue-name aliases (Maestro / tautomer / GROMACS conventions; RNA
# single-letter PDB v3 names map onto the R-prefixed Amber templates)
_RES_ALIASES = {"NMA": "NME", "NMET": "NME", "HSD": "HID", "HSE": "HIS",
                "WAT": "HOH", "TIP3": "HOH", "SOL": "HOH", "SPC": "HOH",
                "NA+": "NA", "SOD": "NA", "Na+": "NA", "Na": "NA",
                "CL-": "CL", "CLA": "CL", "Cl-": "CL", "Cl": "CL",
                "A": "RA", "C": "RC", "G": "RG", "U": "RU",
                "ADE": "DA", "CYT": "DC", "GUA": "DG", "THY": "DT",
                "URA": "RU"}

# Alternate atom names seen in PDB files -> template names
_ALIASES = {
    ("NME", "C"): "CH3",
    ("NME", "CA"): "CH3",
    ("ACE", "CA"): "CH3",
    ("ACE", "H1"): "HH31", ("ACE", "H2"): "HH32", ("ACE", "H3"): "HH33",
    ("NME", "H1"): "HH31", ("NME", "H2"): "HH32", ("NME", "H3"): "HH33",
    ("NME", "HA1"): "HH31", ("NME", "HA2"): "HH32", ("NME", "HA3"): "HH33",
    ("HOH", "OW"): "O", ("HOH", "HW1"): "H1", ("HOH", "HW2"): "H2",
    ("HOH4", "OW"): "O", ("HOH4", "HW1"): "H1", ("HOH4", "HW2"): "H2",
    ("HOH4", "EPW"): "M", ("HOH4", "MW"): "M", ("HOH4", "EP"): "M",
    ("NA", "Na"): "NA", ("NA", "SOD"): "NA", ("NA", "Na+"): "NA",
    ("CL", "Cl"): "CL", ("CL", "CLA"): "CL", ("CL", "Cl-"): "CL",
}

_EQUIV = {"HB1": "HB3", "HA1": "HA3", "HG1": "HG3", "HD1": "HD3",
          "HE1": "HE3", "HG11": "HG13",
          # Maestro-style backbone amide H naming (mid-chain residues whose
          # single amide H is written H1/H2/H3; template membership is
          # checked first, so true N-terminal H1..H3 are unaffected)
          "HN": "H", "H1": "H", "H2": "H", "H3": "H",
          # GROMACS/CHARMM-style C-terminal carboxylate naming
          "OC1": "O", "OC2": "OXT", "OT1": "O", "OT2": "OXT",
          # PDB v2 nucleic naming -> v3 template names (template membership
          # is checked first, so v3 inputs are unaffected)
          "O1P": "OP1", "O2P": "OP2",
          "H5'1": "H5'", "H5'2": "H5''", "H2'1": "H2'", "H2'2": "H2''",
          "HO'2": "HO2'", "H5T": "HO5'", "H3T": "HO3'",
          "C5M": "C7", "H51": "H71", "H52": "H72", "H53": "H73"}


def _template_atom_name(resname: str, atom: str, template_atoms):
    """Resolve a PDB atom name against a template, following aliases,
    old-style digit-prefix rotations and terminal-H equivalences.
    Returns None if unresolvable."""
    seen = set()
    cand = [atom]
    while cand:
        a = cand.pop(0)
        if a in seen:
            continue
        seen.add(a)
        if a in template_atoms:
            return a
        if (resname, a) in _ALIASES:
            cand.append(_ALIASES[(resname, a)])
        if a and a[0].isdigit():                  # 1HB -> HB1, 1H -> H1
            cand.append(a[1:] + a[0])
        if "*" in a:                              # old nucleic C5* -> C5'
            cand.append(a.replace("*", "'"))
        if a in _EQUIV:
            cand.append(_EQUIV[a])
        if a == "H" and "H1" in template_atoms:   # N-terminal H -> H1
            cand.append("H1")
    return None


def _try_match(resname_tmpl: str, atom_names, indices):
    """Try to map residue atoms onto a template; returns (name_to_idx,
    missing) or None on unresolvable atoms/duplicates."""
    tmpl = amber.RESIDUES.get(resname_tmpl)
    if tmpl is None:
        return None
    name_to_idx = {}
    for idx, pdbname in zip(indices, atom_names):
        t = _template_atom_name(resname_tmpl, pdbname, tmpl["atoms"])
        if t is None or t in name_to_idx:
            return None
        name_to_idx[t] = idx
    missing = set(tmpl["atoms"]) - set(name_to_idx)
    if missing:
        return None
    return name_to_idx


def _resolve_residue(res, struct, is_first: bool, is_last: bool):
    """Pick the matching template (base / HIS tautomers / terminal
    variants).  Returns (template_name, name_to_idx)."""
    name = _RES_ALIASES.get(res.name, res.name)
    atom_names = [struct.atom_names[i] for i in res.atom_indices]

    candidates = [name]
    if name == "HOH":
        # 4-site (TIP4P-class) waters carry an extra M/EPW point
        candidates = ["HOH", "HOH4"]
    if name == "HIS":
        candidates = ["HIS", "HID", "HIP" if "HIP" in amber.RESIDUES else "HID"]
    if name == "CYS":
        candidates = ["CYS", "CYX"]   # no HG -> disulfide-bonded cysteine
    if name in amber.NUCLEIC_RESIDUES:
        # 5'/3'-terminal and nucleoside variants (Amber <res>5/<res>3/<res>N
        # naming); most specific first, interior template as fallback
        candidates = []
        if is_first and is_last:
            candidates.append(name + "N")
        if is_first:
            candidates.append(name + "5")
        if is_last:
            candidates.append(name + "3")
        candidates.append(name)
    else:
        if is_first and name not in ("ACE", "NME"):
            candidates = ["N" + c for c in candidates] + candidates
        if is_last and name not in ("ACE", "NME", "NHE"):
            candidates = ["C" + c for c in candidates] + candidates

    for cand in candidates:
        m = _try_match(cand, atom_names, res.atom_indices)
        if m is not None:
            return cand, m
    # build a helpful error
    tried = ", ".join(candidates)
    tmpl = amber.RESIDUES.get(name)
    if tmpl is None:
        raise KeyError(f"no residue template for {res.name}; add it to "
                       f"isokann_tpu_torch.md.amber.RESIDUES")
    raise KeyError(
        f"could not match residue {res.name}{res.resid} (atoms {atom_names}) "
        f"against templates [{tried}]")


def build_topology(struct: PDBStructure) -> Topology:
    """Match each residue against the Amber templates and derive the full
    bonded topology (bonds, angles, propers, impropers)."""
    # group atoms into residues by (chain, resid)
    residues: List[Residue] = []
    current = None
    for i in range(struct.natoms):
        tag = (struct.chain_ids[i], struct.res_ids[i], struct.res_names[i])
        if current is None or tag != current:
            residues.append(Residue(struct.res_names[i], struct.res_ids[i], []))
            current = tag
        residues[-1].atom_indices.append(i)

    n = struct.natoms
    atom_types = [""] * n
    charges = np.zeros(n)
    masses = np.zeros(n)
    bonds: List[Tuple[int, int]] = []

    # non-polymer residues (solvent, ions) break peptide chains even when
    # they share a chain id with the protein (common in solvated PDBs)
    nonpoly = {"HOH", "WAT", "TIP3", "SOL", "SPC",
               "NA", "CL", "NA+", "CL-", "SOD", "CLA", "Na", "Cl",
               "Na+", "Cl-"}

    def _chain(ri):
        return struct.chain_ids[residues[ri].atom_indices[0]]

    prev_map = None
    for ri, res in enumerate(residues):
        is_first = (ri == 0 or _chain(ri) != _chain(ri - 1)
                    or residues[ri - 1].name in nonpoly
                    or res.name in nonpoly)
        is_last = (ri == len(residues) - 1 or _chain(ri) != _chain(ri + 1)
                   or residues[ri + 1].name in nonpoly
                   or res.name in nonpoly)
        tname, name_to_idx = _resolve_residue(res, struct, is_first, is_last)
        tmpl = amber.RESIDUES[tname]
        res.name = tname
        for t_atom, idx in name_to_idx.items():
            t, q = tmpl["atoms"][t_atom]
            atom_types[idx] = t
            charges[idx] = q
            masses[idx] = amber.mass(t)
        for a, b in tmpl["bonds"]:
            bonds.append((name_to_idx[a], name_to_idx[b]))
        # inter-residue linkage: peptide bond prev C -- this N, or nucleic
        # phosphodiester prev O3' -- this P (geometry-guarded: a heterogen
        # with an atom named N after a TER, or a genuine chain break
        # sharing a chain id, must not be linked)
        if prev_map is not None:
            for pa, ca in (("C", "N"), ("O3'", "P")):
                if pa in prev_map and ca in name_to_idx:
                    d = float(np.linalg.norm(struct.coords[prev_map[pa]]
                                             - struct.coords[name_to_idx[ca]]))
                    if d < 0.25:
                        bonds.append((prev_map[pa], name_to_idx[ca]))
                    break
        prev_map = name_to_idx

    # disulfide bridges: pair CYX sulfurs by proximity (< 2.5 A), the same
    # geometric criterion OpenMM's PDB loader uses for SSBOND inference
    sgs = [res.atom_indices[[struct.atom_names[i] for i in
                             res.atom_indices].index("SG")]
           for res in residues if res.name.endswith("CYX")]
    used = set()
    for a in sgs:
        if a in used:
            continue
        best, bestd = None, 0.25
        for b in sgs:
            if b == a or b in used:
                continue
            d = float(np.linalg.norm(struct.coords[a] - struct.coords[b]))
            if d < bestd:
                best, bestd = b, d
        if best is None:
            warnings.warn(f"CYX sulfur atom {a} has no disulfide partner "
                          f"within 2.5 A; leaving it unbonded")
        else:
            bonds.append((a, best))
            used.update((a, best))

    top = Topology(
        atom_names=list(struct.atom_names),
        atom_types=atom_types,
        charges=charges,
        masses=masses,
        residues=residues,
        bonds=bonds,
    )
    _derive_bonded_terms(top)
    return top


def _derive_bonded_terms(top: Topology):
    """Enumerate angles, proper dihedrals, impropers from the bond graph."""
    adj = top.neighbors()

    angles = []
    for j in range(top.natoms):
        nb = sorted(adj[j])
        for ai in range(len(nb)):
            for ci in range(ai + 1, len(nb)):
                angles.append((nb[ai], j, nb[ci]))
    top.angles = angles

    propers = []
    for (j, k) in top.bonds:
        for i in sorted(adj[j]):
            if i == k:
                continue
            for l in sorted(adj[k]):
                if l == j or l == i:
                    continue
                propers.append((i, j, k, l))
    top.propers = propers

    # impropers at trigonal sp2 centers: carbonyl/carboxylate C, amide and
    # aromatic N-H, tertiary amide N (proline), aromatic C-H ring planarity,
    # ring-substituent attachment (PHE/TYR/TRP/HIS CG), guanidinium CZ
    impropers = []
    types = top.atom_types
    sp2_CH = ("CA", "CW", "CR", "CV", "CK", "CQ", "CM")
    ring_subst = ("CA", "CC", "C*", "CM")
    for c in range(top.natoms):
        nb = sorted(adj[c])
        if len(nb) != 3:
            continue
        tc = types[c]
        if tc == "C":
            os_ = [a for a in nb if types[a] in ("O", "O2")]
            rest = [a for a in nb if types[a] not in ("O", "O2")]
            if len(os_) == 1:
                impropers.append((rest[0], rest[1], c, os_[0]))
            elif len(os_) == 2:  # carboxylate X-O2-C-O2
                impropers.append((rest[0], os_[0], c, os_[1]))
        elif tc in ("N", "N2", "NA"):
            hs = [a for a in nb if types[a].startswith("H")]
            rest = [a for a in nb if not types[a].startswith("H")]
            if len(hs) == 1 and len(rest) == 2:
                impropers.append((rest[0], rest[1], c, hs[0]))
            elif tc == "N" and len(hs) == 0:
                # tertiary amide (PRO backbone N: C, CA, CD); the carbonyl
                # C goes in a peripheral slot so parm94 X-CT-N-CT matches
                cts = [a for a in rest if types[a] == "CT"]
                other = [a for a in rest if types[a] != "CT"]
                if len(cts) == 2 and len(other) == 1:
                    impropers.append((other[0], cts[0], c, cts[1]))
        elif tc == "N*":
            # glycosidic nitrogen (nucleobase N9/N1): ring planarity with
            # the sugar C1' in the peripheral 4th slot (parm94
            # CB-CK-N*-CT / C-CM-N*-CT)
            sub = [a for a in nb if types[a] == "CT"]
            ring = [a for a in nb if types[a] != "CT"]
            if len(sub) == 1:
                impropers.append((ring[0], ring[1], c, sub[0]))
        elif tc in sp2_CH or tc in ring_subst:
            hs = [a for a in nb if types[a].startswith("H")]
            rest = [a for a in nb if not types[a].startswith("H")]
            if tc in sp2_CH and len(hs) == 1 and len(rest) == 2:
                impropers.append((rest[0], rest[1], c, hs[0]))
            elif tc == "CA" and all(types[a] == "N2" for a in nb):
                impropers.append((nb[0], nb[1], c, nb[2]))  # guanidinium
            elif tc == "CA" and len(hs) == 0 and sum(
                    types[a] == "N2" for a in nb) == 1:
                # nucleobase exocyclic amine attachment (adenine C6,
                # guanine C2, cytosine C4): N2 in the peripheral 4th slot
                n2 = [a for a in nb if types[a] == "N2"]
                ring = [a for a in nb if types[a] != "N2"]
                impropers.append((ring[0], ring[1], c, n2[0]))
            elif tc in ring_subst and len(hs) == 0:
                # ring carbon with a heavy substituent (CG of PHE/TYR/HIS/
                # TRP, thymine C5): 4th slot = the exocyclic CT substituent
                sub = [a for a in nb if types[a] == "CT"]
                ring = [a for a in nb if types[a] != "CT"]
                if len(sub) == 1:
                    impropers.append((ring[0], ring[1], c, sub[0]))
    top.impropers = impropers
