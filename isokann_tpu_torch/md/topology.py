"""Topology construction for capped peptides: PDB structure + residue
templates -> bond graph, atom types, charges and the derived
angle/dihedral/improper lists.  Counterpart of
``isokann_tpu/md/topology.py``, restricted to the templates of
``amber.RESIDUES`` under their template atom names (no aliases, terminal
variants, nucleic acids or disulfides)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from . import amber
from .pdbio import PDBStructure

@dataclass
class Topology:
    atom_names: List[str]
    atom_types: List[str]
    charges: np.ndarray           # (n,) elementary charges
    masses: np.ndarray            # (n,) amu
    bonds: List[Tuple[int, int]]
    angles: List[Tuple[int, int, int]] = field(default_factory=list)
    propers: List[Tuple[int, int, int, int]] = field(default_factory=list)
    impropers: List[Tuple[int, int, int, int]] = field(default_factory=list)

    @property
    def natoms(self):
        return len(self.atom_names)

    def neighbors(self) -> Dict[int, set]:
        adj: Dict[int, set] = {i: set() for i in range(self.natoms)}
        for a, b in self.bonds:
            adj[a].add(b)
            adj[b].add(a)
        return adj


def build_topology(struct: PDBStructure) -> Topology:
    """Match each residue against its template and derive the bonded
    topology (bonds, angles, propers, impropers)."""
    residues = []
    current = None
    for i in range(struct.natoms):
        tag = (struct.chain_ids[i], struct.res_ids[i], struct.res_names[i])
        if tag != current:
            residues.append((struct.res_names[i], []))
            current = tag
        residues[-1][1].append(i)

    n = struct.natoms
    atom_types = [""] * n
    charges = np.zeros(n)
    masses = np.zeros(n)
    bonds: List[Tuple[int, int]] = []
    prev = None
    for resname, idxs in residues:
        tmpl = amber.RESIDUES.get(resname)
        if tmpl is None:
            raise KeyError(f"no residue template for {resname}")
        name_to_idx = {struct.atom_names[i]: i for i in idxs}
        if set(name_to_idx) != set(tmpl["atoms"]):
            raise KeyError(f"atoms of residue {resname} do not match its "
                           f"template: {sorted(name_to_idx)}")
        for t_atom, i in name_to_idx.items():
            ty, q = tmpl["atoms"][t_atom]
            atom_types[i] = ty
            charges[i] = q
            masses[i] = amber.mass(ty)
        for a, b in tmpl["bonds"]:
            bonds.append((name_to_idx[a], name_to_idx[b]))
        # peptide bond to the previous residue (geometry-guarded)
        if prev is not None and "C" in prev and "N" in name_to_idx:
            d = float(np.linalg.norm(struct.coords[prev["C"]]
                                     - struct.coords[name_to_idx["N"]]))
            if d < 0.25:
                bonds.append((prev["C"], name_to_idx["N"]))
        prev = name_to_idx

    top = Topology(atom_names=list(struct.atom_names), atom_types=atom_types,
                   charges=charges, masses=masses, bonds=bonds)
    _derive_bonded_terms(top)
    return top


def _derive_bonded_terms(top: Topology):
    """Enumerate angles, proper dihedrals and the carbonyl/amide
    impropers from the bond graph, in the reference's order."""
    adj = top.neighbors()
    top.angles = [(nb[a], j, nb[c])
                  for j in range(top.natoms)
                  for nb in [sorted(adj[j])]
                  for a in range(len(nb)) for c in range(a + 1, len(nb))]
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

    impropers = []
    types = top.atom_types
    for c in range(top.natoms):
        nb = sorted(adj[c])
        if len(nb) != 3:
            continue
        if types[c] == "C":
            os_ = [a for a in nb if types[a] == "O"]
            rest = [a for a in nb if types[a] != "O"]
            if len(os_) == 1:
                impropers.append((rest[0], rest[1], c, os_[0]))
        elif types[c] == "N":
            hs = [a for a in nb if types[a].startswith("H")]
            rest = [a for a in nb if not types[a].startswith("H")]
            if len(hs) == 1 and len(rest) == 2:
                impropers.append((rest[0], rest[1], c, hs[0]))
            elif len(hs) == 0:
                cts = [a for a in rest if types[a] == "CT"]
                other = [a for a in rest if types[a] != "CT"]
                if len(cts) == 2 and len(other) == 1:
                    impropers.append((other[0], cts[0], c, cts[1]))
    top.impropers = impropers
