"""Trajectory files and the chi-sorted saves; counterpart of
``isokann_tpu/utils/save.py`` (reference ``savecoords``/``saveextrema``,
``src/iso.jl:379-399``, and the trajectory I/O of
``src/utils/molutils.jl:75-128``): multi-model PDB, ``.npy`` and DCD
(through the host library, ``native.py``).  A tensor on the card is copied
to the host once per call."""

from __future__ import annotations

import os

import numpy as np
import torch


def _host(x):
    """``x`` as a host numpy array (one copy for a tensor on the card)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_trajectory(path, traj, top=None, box=None, dt_ps=0.002):
    """Save (frames, 3N) coordinates [nm]: .pdb (needs ``top``, a PDB
    file or ``PDBStructure``), .npy, or .dcd (CHARMM/NAMD binary, with an
    optional orthorhombic ``box`` (3,) [nm]).  Returns ``path``."""
    traj = np.atleast_2d(_host(traj))
    ext = os.path.splitext(path)[1].lower()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if ext == ".npy":
        np.save(path, traj)
    elif ext == ".pdb":
        if top is None:
            raise ValueError("PDB output needs a topology (top=pdbfile)")
        from ..md.pdbio import write_pdb_traj
        write_pdb_traj(path, top, traj)
    elif ext == ".dcd":
        from ..native import dcd_write_native
        dcd_write_native(path, traj.reshape(traj.shape[0], -1, 3),
                         box=None if box is None else _host(box),
                         dt_ps=dt_ps)
    else:
        raise ValueError(f"unsupported trajectory format {ext}")
    return path


def load_trajectory(path, stride=1):
    """A trajectory as a host (frames, 3N) array [nm]: .npy, .pdb
    (every MODEL) or .dcd."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path)[::stride]
    if ext == ".pdb":
        from ..md.pdbio import read_pdb_traj
        return read_pdb_traj(path)[::stride]
    if ext == ".dcd":
        from ..native import dcd_read_native
        xyz, _ = dcd_read_native(path)
        return xyz.reshape(xyz.shape[0], -1)[::stride]
    raise ValueError(f"unsupported trajectory format {ext}")


def savecoords(path, iso, coords=None, sorted=True, aligned=True):
    """Save coordinates (default the start points of ``iso``'s data) with
    its molecule as the template, sorted by chi and each aligned onto the
    one before (``aligntrajectory``), on the coordinates' device
    (reference ``savecoords``, ``src/iso.jl:379-391``)."""
    from ..ops.align import aligntrajectory

    if coords is None:
        coords = iso.data.coords
    elif not isinstance(coords, torch.Tensor):
        coords = torch.as_tensor(np.asarray(coords), dtype=torch.float32,
                                 device=iso.data.coords.device)
    if sorted:
        chi = iso.chicoords(coords)[:, 0].to(coords.device)
        coords = coords[torch.argsort(chi, stable=True)]
    if aligned:
        coords = aligntrajectory(coords)
    return save_trajectory(path, coords, top=iso.data.pdbfile)


def saveextrema(path, iso):
    """Save the start points of lowest and highest chi (reference
    ``saveextrema``, ``src/iso.jl:393-399``)."""
    chi = iso.chis()[:, 0]
    coords = iso.data.coords
    sel = torch.stack([torch.argmin(chi), torch.argmax(chi)])
    return save_trajectory(path, coords[sel.to(coords.device)],
                           top=iso.data.pdbfile)
