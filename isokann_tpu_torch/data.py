"""SimulationData and capacity-bucket padding; counterpart of
``isokann_tpu/data.py`` (``from_sim``/``from_coords``) and of the
``bucket_capacity``/``_pad_rows`` helpers of ``isokann_tpu/iso.py``.

Arrays are batch-leading tensors on the simulation's device:
xs (n, d), ys (n, k, d), features (n, f) and (n, k, f).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ._device import make_generator


def identity(x):
    return x


def bucket_capacity(n: int) -> int:
    """Round a dataset size up to its capacity bucket (two per octave:
    8, 12, 16, 24, 32, 48, ...), as the reference's trainer does."""
    if n <= 8:
        return 8
    p = 1 << (n - 1).bit_length()
    return 3 * p // 4 if 3 * p // 4 >= n else p


def pad_rows(a, cap: int):
    """Pad the leading axis to ``cap`` by repeating rows from the front
    (duplicates keep min/max exact; a mask removes them from losses)."""
    n = a.shape[0]
    if n == cap:
        return a
    if n == 0:
        raise ValueError("cannot pad an empty batch")
    reps = -(-(cap - n) // n)
    return torch.cat([a] + [a] * reps, dim=0)[:cap]


@dataclass
class SimulationData:
    """Simulation + coordinates + features bundle."""

    sim: Any
    features: torch.Tensor       # (n, f)
    propfeatures: torch.Tensor   # (n, k, f)
    coords: torch.Tensor         # (n, d)
    propcoords: torch.Tensor     # (n, k, d)
    featurizer: Callable

    @classmethod
    def from_sim(cls, sim, nx: int = None, nk: int = None, xs=None,
                 featurizer=None, gen=None):
        """nx start points from ``sim.randx0`` (unless ``xs`` is given),
        then nk Koopman bursts from each."""
        gen = make_generator(gen)
        if xs is None:
            xs = sim.randx0(nx, gen=gen)
        ys = sim.propagate(xs, nk, gen=gen)
        return cls.from_coords(sim, xs, ys, featurizer=featurizer)

    @classmethod
    def from_coords(cls, sim, xs, ys, featurizer=None, features=None):
        """From coordinates, with optional precomputed (fxs, fys)."""
        if featurizer is None:
            featurizer = getattr(sim, "featurizer", None) or identity
        if features is None:
            features = (featurizer(xs), featurizer(ys))
        fxs, fys = features
        return cls(sim, fxs.to(torch.float32), fys.to(torch.float32), xs, ys,
                   featurizer)

    @property
    def featuredim(self):
        return self.features.shape[-1]

    @property
    def nk(self):
        return self.propfeatures.shape[1]

    @property
    def dim(self):
        return self.coords.shape[-1]

    def __len__(self):
        return self.features.shape[0]

    def __repr__(self):
        return (f"SimulationData(sim={type(self.sim).__name__}, "
                f"n={len(self)}, nk={self.nk}, dim={self.dim}, "
                f"featuredim={self.featuredim})")
