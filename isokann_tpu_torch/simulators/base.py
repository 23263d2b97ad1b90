"""Simulation interface; counterpart of
``isokann_tpu/simulators/base.py``.  A simulation provides ``dim``,
``coords``, ``lagtime``, ``propagate(xs, nk, gen)``, ``randx0(n, gen)``,
``featurizer`` and ``defaultmodel(...)``.  ``ExternalSimulation`` holds
the metadata of data generated elsewhere."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


class IsoSimulation:
    """Base class: shared convenience defaults."""

    featurizer = None

    @property
    def dim(self) -> int:
        raise NotImplementedError

    @property
    def lagtime(self) -> float:
        raise NotImplementedError

    def propagate(self, xs, nk, gen=None):
        raise NotImplementedError

    def randx0(self, n, gen=None):
        """Default: n propagations of the default start state."""
        return self.propagate(self.coords[None, :], n, gen=gen)[0]

    def defaultmodel(self, n=None, nout=1, gen=None, **kwargs):
        from ..models import autonet
        return autonet(n if n is not None else self.dim, nout=nout, gen=gen,
                       **kwargs)

    def __getstate__(self):
        """Pickled without its bias: a bias closure does not pickle, and
        ``run_girsanov`` makes a new one each generation."""
        d = self.__dict__.copy()
        if "bias" in d:
            d["bias"] = None
        return d

    def __repr__(self):
        return f"{type(self).__name__} with {self.dim} dimensions"


@dataclass
class ExternalSimulation(IsoSimulation):
    """Metadata of externally generated data (reference
    ``src/simulation.jl:41-50``): it has a lag time and may name a PDB
    file, but no dimension and no dynamics."""

    pdbfile: Optional[str] = None
    masses: Any = None
    _lagtime: float = 1.0
    extra: dict = field(default_factory=dict)

    @property
    def lagtime(self):
        return self._lagtime

    @property
    def dim(self):
        raise ValueError("ExternalSimulation has no intrinsic dimension")

    def propagate(self, xs, nk, gen=None):
        raise ValueError("ExternalSimulation cannot propagate new samples")

    def __repr__(self):
        return (f"ExternalSimulation(pdbfile={self.pdbfile}, "
                f"lagtime={self._lagtime})")
