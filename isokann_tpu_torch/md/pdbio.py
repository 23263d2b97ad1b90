"""Minimal PDB reading (host-side I/O); counterpart of
``isokann_tpu/md/pdbio.py``.  Coordinates in nm (PDB files are Angstrom)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class PDBStructure:
    atom_names: List[str]
    res_names: List[str]
    res_ids: List[int]
    chain_ids: List[str]
    coords: np.ndarray                 # (natoms, 3) in nm
    box: Optional[np.ndarray] = None   # (3,) box lengths in nm, if CRYST1

    @property
    def natoms(self):
        return len(self.atom_names)


def read_pdb(path: str) -> PDBStructure:
    """Parse the ATOM/HETATM records of the first model of a PDB file."""
    atom_names, res_names, res_ids, chain_ids, xyz = [], [], [], [], []
    box = None
    with open(path) as f:
        for line in f:
            rec = line[:6]
            if rec == "CRYST1":
                box = np.array([float(line[6:15]), float(line[15:24]),
                                float(line[24:33])]) / 10.0
            elif rec in ("ATOM  ", "HETATM"):
                atom_names.append(line[12:16].strip())
                res_names.append(line[17:21].strip().split()[0])
                chain_ids.append(line[21].strip())
                res_ids.append(int(line[22:26]))
                xyz.append([float(line[30:38]), float(line[38:46]),
                            float(line[46:54])])
            elif rec == "ENDMDL":
                break
    coords = np.asarray(xyz, dtype=np.float64) / 10.0
    return PDBStructure(atom_names, res_names, res_ids, chain_ids, coords,
                        box)
