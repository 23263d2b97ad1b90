"""Dihedral angles (phi / psi) of batched coordinates; counterpart of
``isokann_tpu/ops/dihedrals.py``: the atan2 form of the dihedral, its
evaluation over index quadruplets, and the backbone quadruplets of a
protein topology (``md.topology.Topology``)."""

from __future__ import annotations

import numpy as np
import torch


def dihedral(p, eps=1e-12):
    """Dihedral angle of 4 points, (..., 4, 3) -> (...,) radians, by
    atan2 (the stable form of the acos one)."""
    b1 = p[..., 1, :] - p[..., 0, :]
    b2 = p[..., 2, :] - p[..., 1, :]
    b3 = p[..., 3, :] - p[..., 2, :]
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    m1 = torch.linalg.cross(
        n1, b2 / (torch.linalg.norm(b2, dim=-1, keepdim=True) + eps))
    x = torch.sum(n1 * n2, dim=-1)
    y = torch.sum(m1 * n2, dim=-1)
    return torch.atan2(y, x)


def dihedrals_from_indices(coords, quads):
    """Dihedrals of index quadruplets: coords (..., 3N) flat, quads (m, 4)
    int -> (..., m)."""
    quads = torch.as_tensor(np.asarray(quads), dtype=torch.long,
                            device=coords.device)
    batch = coords.shape[:-1]
    xyz = coords.reshape(batch + (-1, 3))
    p = xyz[..., quads.reshape(-1), :].reshape(batch + (len(quads), 4, 3))
    return dihedral(p)


def phi_psi_indices(topology):
    """(phi_quads, psi_quads) int arrays of a protein topology:
    phi C(i-1)-N(i)-CA(i)-C(i), psi N(i)-CA(i)-C(i)-N(i+1)."""
    residues = topology.residues
    phis, psis = [], []

    def find(res, name):
        for idx in res.atom_indices:
            if topology.atom_names[idx] == name:
                return idx
        return None

    for i, res in enumerate(residues):
        N, CA, C = find(res, "N"), find(res, "CA"), find(res, "C")
        prevC = find(residues[i - 1], "C") if i > 0 else None
        nextN = find(residues[i + 1], "N") if i + 1 < len(residues) else None
        if None not in (prevC, N, CA, C):
            phis.append((prevC, N, CA, C))
        if None not in (N, CA, C, nextN):
            psis.append((N, CA, C, nextN))
    return np.asarray(phis, dtype=int), np.asarray(psis, dtype=int)
