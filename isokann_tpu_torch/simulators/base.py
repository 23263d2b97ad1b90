"""Simulation interface; counterpart of
``isokann_tpu/simulators/base.py``.  A simulation provides ``dim``,
``coords``, ``lagtime``, ``propagate(xs, nk, gen)``, ``randx0(n, gen)``,
``featurizer`` and ``defaultmodel(...)``."""

from __future__ import annotations


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

    def __repr__(self):
        return f"{type(self).__name__} with {self.dim} dimensions"
