"""Out-of-core trajectory access; counterpart of
``isokann_tpu/utils/lazytraj.py`` (the reference's ``LazyTrajectory`` /
``LazyMultiTrajectory``, ``src/utils/molutils.jl:191-240``): frame-indexed
views of on-disk trajectories, read a slice at a time.  Numpy only: a
memmap for ``.npy``, a frame index for multi-model ``.pdb``."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


class LazyTrajectory:
    """Lazy (nframes, 3N) view of an on-disk trajectory [nm].

    - ``.npy``: a numpy memmap, sliced out of core
    - ``.pdb``: the MODEL offsets indexed once, a frame parsed on access
    """

    def __init__(self, path: str):
        self.path = path
        ext = os.path.splitext(path)[1].lower()
        if ext == ".npy":
            self._mm = np.load(path, mmap_mode="r")
            if self._mm.ndim != 2:
                raise ValueError("expected (frames, 3N) array")
        elif ext == ".pdb":
            self._mm = None
            self._index_pdb()
        else:
            raise ValueError(f"unsupported trajectory format {ext}")

    def _index_pdb(self):
        offsets = []
        natoms = None
        count = 0
        with open(self.path, "rb") as f:
            off = 0
            in_model = False
            for line in f:
                rec = line[:6]
                if rec == b"MODEL ":
                    offsets.append(off + len(line))
                    in_model = True
                    count = 0
                elif rec in (b"ATOM  ", b"HETATM") and in_model:
                    count += 1
                elif rec == b"ENDMDL":
                    natoms = count
                    in_model = False
                off += len(line)
        if not offsets:
            # a single-model file is one frame
            offsets = [0]
            from ..md.pdbio import read_pdb
            natoms = read_pdb(self.path).natoms
        self._offsets = offsets
        self._natoms = natoms

    @property
    def shape(self):
        if self._mm is not None:
            return self._mm.shape
        return (len(self._offsets), 3 * self._natoms)

    def __len__(self):
        return self.shape[0]

    def _read_pdb_frame(self, i):
        xyz = []
        with open(self.path) as f:
            f.seek(self._offsets[i])
            for line in f:
                rec = line[:6]
                if rec in ("ATOM  ", "HETATM"):
                    xyz.append([float(line[30:38]), float(line[38:46]),
                                float(line[46:54])])
                elif rec in ("ENDMDL", "MODEL "):
                    break
        return np.asarray(xyz).reshape(-1) / 10.0

    def __getitem__(self, i):
        if self._mm is not None:
            return np.asarray(self._mm[i])
        if isinstance(i, (int, np.integer)):
            return self._read_pdb_frame(int(i) % len(self))
        idx = range(*i.indices(len(self))) if isinstance(i, slice) else i
        return np.stack([self._read_pdb_frame(int(j)) for j in idx])

    def __array__(self, dtype=None, copy=None):
        out = self[:] if self._mm is None else np.asarray(self._mm)
        return out.astype(dtype) if dtype is not None else out


class LazyMultiTrajectory:
    """Concatenated view of several ``LazyTrajectory`` (or paths)
    (reference ``LazyMultiTrajectory``, ``src/utils/molutils.jl:217-240``)."""

    def __init__(self, trajs: Sequence):
        self.trajs = [t if isinstance(t, LazyTrajectory) else LazyTrajectory(t)
                      for t in trajs]
        self._lens = np.asarray([len(t) for t in self.trajs])
        self._starts = np.concatenate([[0], np.cumsum(self._lens)])

    @property
    def shape(self):
        return (int(self._starts[-1]), self.trajs[0].shape[1])

    def __len__(self):
        return self.shape[0]

    def _locate(self, i):
        t = int(np.searchsorted(self._starts, i, side="right") - 1)
        return t, i - int(self._starts[t])

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            t, j = self._locate(int(i) % len(self))
            return self.trajs[t][j]
        idx = range(*i.indices(len(self))) if isinstance(i, slice) else i
        return np.stack([self[int(j)] for j in idx])

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate([np.asarray(t) for t in self.trajs])
        return out.astype(dtype) if dtype is not None else out
