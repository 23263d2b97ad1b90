"""Molecular utilities: backbone dihedrals, RMSD reaction coordinates and
the standard form; counterpart of ``isokann_tpu/utils/molutils.py``
(reference ``src/utils/molutils.jl``: ``phi``/``psi`` ``:27-35``,
``standardform``, ``ReactionCoordsRMSD``/``ca_rmsd`` ``:248-284``, and
``getpdb``, ``src/utils/plots.jl:325-330``).  Everything runs in torch on
the inputs' device: a tensor stays where it is, other arrays go to the
card unless the caller names another ``device``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .._device import as_tensor
from ..ops.align import align, aligned_rmsd, centered
from ..ops.dihedrals import dihedrals_from_indices, phi_psi_indices


def phi_psi(coords, pdb, device=None):
    """(phi, psi) of frames ``coords`` (..., 3N) [rad], each (..., m) for
    the m backbone dihedrals of the topology of ``pdb`` (in place of the
    reference's fixed dipeptide indices, ``src/utils/molutils.jl:27-35``)."""
    from ..md.pdbio import read_pdb
    from ..md.topology import build_topology

    coords = as_tensor(coords, device=device)
    phis, psis = phi_psi_indices(build_topology(read_pdb(pdb)))
    return (dihedrals_from_indices(coords, phis),
            dihedrals_from_indices(coords, psis))


def standardform(xs, pdb=None, device=None):
    """Every frame of ``xs`` (n, 3N) aligned onto the first, centered: a
    canonical orientation (reference ``standardform``)."""
    xs = as_tensor(xs, device=device)
    xs = xs.reshape(-1, xs.shape[-1])
    ref = centered(xs[0].reshape(-1, 3)).reshape(-1)
    return align(ref, xs)


def aligned_rmsd_to(ref, xs, atoms=None, device=None):
    """Aligned RMSD of each frame of ``xs`` (n, 3N) to ``ref`` (3N,),
    optionally over a subset of ``atoms``; (n,)."""
    xs = as_tensor(xs, device=device)
    ref = as_tensor(ref, device=xs.device).to(xs.device).reshape(-1, 3)
    xs = xs.reshape(-1, ref.shape[0], 3)
    if atoms is not None:
        idx = torch.as_tensor(np.asarray(atoms), dtype=torch.long,
                              device=xs.device)
        ref, xs = ref[idx], xs[:, idx]
    return aligned_rmsd(ref, xs, flat=False)


@dataclass
class ReactionCoordsRMSD:
    """RMSD-to-reference reaction coordinates (reference
    ``ReactionCoordsRMSD``, ``src/utils/molutils.jl:248-264``): called on
    frames (n, 3N), the aligned RMSD to each of ``refs`` (k, 3N), (n, k)."""

    refs: Any                  # (k, 3N) reference structures
    atoms: Any = None          # optional atom subset

    def __call__(self, coords, device=None):
        coords = as_tensor(coords, device=device)
        coords = coords.reshape(-1, coords.shape[-1])
        refs = as_tensor(self.refs, device=coords.device).to(coords.device)
        refs = refs.reshape(-1, refs.shape[-1])
        return torch.stack([aligned_rmsd_to(r, coords, self.atoms)
                            for r in refs], dim=-1)


def _ca_map(s):
    return {s.res_ids[i]: i for i in range(s.natoms)
            if s.atom_names[i] == "CA"}


def ca_rmsd(xs, ref_xs, pdb_x, pdb_ref, residues=None, device=None):
    """Cross-topology C-alpha RMSD (reference ``ca_rmsd``,
    ``src/utils/molutils.jl:266-284``): the CA atoms of residue ids that
    both topologies share (optionally only ``residues``), each frame of
    ``xs`` aligned onto ``ref_xs``; (n,)."""
    from ..md.pdbio import read_pdb

    sx, sr = read_pdb(pdb_x), read_pdb(pdb_ref)
    mx, mr = _ca_map(sx), _ca_map(sr)
    shared = sorted(set(mx) & set(mr))
    if residues is not None:
        shared = [r for r in shared if r in set(residues)]
    ix = torch.as_tensor([mx[r] for r in shared], dtype=torch.long)
    ir = torch.as_tensor([mr[r] for r in shared], dtype=torch.long)
    xs = as_tensor(xs, device=device)
    ref = as_tensor(ref_xs, device=xs.device).to(xs.device)
    xs = xs.reshape(-1, sx.natoms, 3)[:, ix.to(xs.device)]
    ref = ref.reshape(sr.natoms, 3)[ir.to(xs.device)]
    return aligned_rmsd(ref, xs, flat=False)


def getpdb(pdbid: str, path=None):
    """Download a PDB entry from RCSB (reference ``getpdb``,
    ``src/utils/plots.jl:325-330``); needs network access.  Returns the
    path written (default ``<pdbid>.pdb``)."""
    import urllib.request
    path = path or f"{pdbid}.pdb"
    url = f"https://files.rcsb.org/download/{pdbid}.pdb"
    try:
        urllib.request.urlretrieve(url, path)
    except Exception as e:
        raise RuntimeError(
            f"could not download {pdbid} from RCSB ({e}); without network "
            f"access, provide a local PDB instead") from e
    return path
