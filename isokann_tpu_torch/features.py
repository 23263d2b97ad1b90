"""Featurisers mapping raw coordinates to chi-model inputs; counterpart
of ``isokann_tpu/features.py`` (``FeaturesAll`` only)."""

from __future__ import annotations

from dataclasses import dataclass

from .ops.pairdists import flatpairdists


@dataclass(frozen=True)
class FeaturesAll:
    """Pairwise distances between all atoms: (..., 3N) -> (..., N(N-1)/2)."""

    def __call__(self, coords):
        return flatpairdists(coords)


def default_featurizer(natoms: int, features=None):
    """The reference's selection rule for the ported cases: all pairs
    under 100 atoms, or a caller-given callable."""
    if features is None:
        if natoms < 100:
            return FeaturesAll()
        raise NotImplementedError("random-pair features (>= 100 atoms) are "
                                  "not ported")
    if callable(features):
        return features
    raise NotImplementedError(f"feature spec {features!r} is not ported")
