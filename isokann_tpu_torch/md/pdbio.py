"""Minimal PDB reading and writing (host-side I/O); counterpart of
``isokann_tpu/md/pdbio.py``.  Coordinates in nm (PDB files are Angstrom)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


@dataclass
class PDBStructure:
    atom_names: List[str]
    res_names: List[str]
    res_ids: List[int]
    chain_ids: List[str]
    elements: List[str]
    coords: np.ndarray                 # (natoms, 3) in nm
    box: Optional[np.ndarray] = None   # (3,) box lengths in nm, if CRYST1
    conect: Optional[List] = None      # [(i, j), ...] 0-based CONECT bonds

    @property
    def natoms(self):
        return len(self.atom_names)


def _guess_element(name: str) -> str:
    name = name.strip()
    if not name:
        return ""
    # PDB convention: left-justified names starting with a digit are H
    if name[0].isdigit():
        return "H"
    if name[:2].upper() in ("CL", "NA", "MG", "ZN", "FE", "BR", "CA2"):
        return name[:2].capitalize()
    return name[0].upper()


def read_pdb(path: str) -> PDBStructure:
    """Parse the ATOM/HETATM records of the first model of a PDB file.
    CONECT records (ligand / heterogen connectivity) come back as 0-based
    index pairs in ``.conect``."""
    atom_names, res_names, res_ids, chain_ids, elements, xyz = \
        [], [], [], [], [], []
    box = None
    serial_to_idx = {}
    conect = set()
    ended = False
    with open(path) as f:
        for line in f:
            rec = line[:6]
            if rec == "CRYST1":
                box = np.array([float(line[6:15]), float(line[15:24]),
                                float(line[24:33])]) / 10.0
            elif rec in ("ATOM  ", "HETATM") and not ended:
                try:
                    serial_to_idx[int(line[6:11])] = len(atom_names)
                except ValueError:
                    pass
                atom_names.append(line[12:16].strip())
                res_names.append(line[17:21].strip().split()[0])
                chain_ids.append(line[21].strip())
                res_ids.append(int(line[22:26]))
                xyz.append([float(line[30:38]), float(line[38:46]),
                            float(line[46:54])])
                el = line[76:78].strip() if len(line) > 76 else ""
                elements.append(el if el else _guess_element(line[12:16]))
            elif rec == "CONECT":
                fields = [line[i:i + 5]
                          for i in range(6, min(len(line), 31), 5)]
                serials = [int(s) for s in fields if s.strip()]
                if serials and serials[0] in serial_to_idx:
                    a = serial_to_idx[serials[0]]
                    for s in serials[1:]:
                        if s in serial_to_idx:
                            b = serial_to_idx[s]
                            if a != b:
                                conect.add((min(a, b), max(a, b)))
            elif rec == "ENDMDL":
                ended = True        # keep scanning for trailing CONECTs
    coords = np.asarray(xyz, dtype=np.float64) / 10.0
    return PDBStructure(atom_names, res_names, res_ids, chain_ids, elements,
                        coords, box, conect=sorted(conect) or None)


def read_pdb_traj(path: str) -> np.ndarray:
    """Every MODEL of a PDB file as a (frames, 3N) float64 trajectory in
    nm."""
    frames, cur = [], []
    with open(path) as f:
        for line in f:
            if line[:6] in ("ATOM  ", "HETATM"):
                cur.append([float(line[30:38]), float(line[38:46]),
                            float(line[46:54])])
            elif line[:6] in ("ENDMDL", "END   ") or line.strip() == "END":
                if cur:
                    frames.append(cur)
                    cur = []
    if cur:
        frames.append(cur)
    arr = np.asarray(frames, dtype=np.float64) / 10.0
    return arr.reshape(arr.shape[0], -1)


def _format_atom_line(i, name, resname, chain, resid, x, y, z, element):
    # PDB atom-name column rules: 4-char field; names <4 chars start at col 14
    if len(name) >= 4:
        namef = name[:4]
    else:
        namef = " " + name.ljust(3)
    return (f"ATOM  {i:5d} {namef} {resname[:3].ljust(3)} {(chain or 'A')[:1]}"
            f"{resid:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
            f"          {element:>2s}\n")


def write_pdb(path: str, struct: PDBStructure, coords=None):
    """Write a single-model PDB; ``coords`` (natoms, 3) in nm overrides."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    xyz = np.asarray(coords if coords is not None else struct.coords) * 10.0
    with open(path, "w") as f:
        if struct.box is not None:
            b = struct.box * 10.0
            f.write(f"CRYST1{b[0]:9.3f}{b[1]:9.3f}{b[2]:9.3f}"
                    f"  90.00  90.00  90.00 P 1           1\n")
        for i in range(struct.natoms):
            f.write(_format_atom_line(
                i + 1, struct.atom_names[i], struct.res_names[i],
                struct.chain_ids[i], struct.res_ids[i],
                xyz[i, 0], xyz[i, 1], xyz[i, 2], struct.elements[i]))
        f.write("END\n")


def write_pdb_traj(path: str, template, traj):
    """Write a multi-model PDB trajectory: ``template`` (a
    ``PDBStructure`` or the path of a PDB file) gives the atoms, ``traj``
    (frames, 3N) or (3N,) the coordinates in nm (a tensor is copied to
    the host)."""
    if isinstance(template, str):
        template = read_pdb(template)
    if isinstance(traj, torch.Tensor):
        traj = traj.detach().cpu().numpy()
    traj = np.asarray(traj)
    if traj.ndim == 1:
        traj = traj[None, :]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for m, frame in enumerate(traj):
            f.write(f"MODEL     {m + 1:4d}\n")
            xyz = frame.reshape(-1, 3) * 10.0
            for i in range(template.natoms):
                f.write(_format_atom_line(
                    i + 1, template.atom_names[i], template.res_names[i],
                    template.chain_ids[i], template.res_ids[i],
                    xyz[i, 0], xyz[i, 1], xyz[i, 2], template.elements[i]))
            f.write("ENDMDL\n")
        f.write("END\n")
