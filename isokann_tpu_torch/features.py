"""Featurisers mapping raw coordinates to chi-model inputs; counterpart
of ``isokann_tpu/features.py`` (``FeaturesAll``, ``FeaturesPairs``,
``FeaturesRandomPairs`` and the default selection rule)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .ops.pairdists import flatpairdists, pdists


@dataclass(frozen=True)
class FeaturesAll:
    """Pairwise distances between all atoms: (..., 3N) -> (..., N(N-1)/2)."""

    def __call__(self, coords):
        return flatpairdists(coords)


@dataclass(frozen=True)
class FeaturesPairs:
    """Distances for an explicit pair list: (..., 3N) -> (..., len(pairs))."""

    pairs: Tuple[Tuple[int, int], ...]

    def __post_init__(self):
        object.__setattr__(self, "pairs",
                           tuple((int(a), int(b)) for a, b in self.pairs))

    def __call__(self, coords):
        return pdists(coords, np.asarray(self.pairs).reshape(-1, 2))


@dataclass(frozen=True)
class FeaturesRandomPairs:
    """``maxfeatures`` atom pairs drawn without replacement from all
    i < j pairs by ``np.random.default_rng(seed)`` and sorted: the
    reference's fallback for >= 100 atoms, with the JAX package's draw."""

    natoms: int
    maxfeatures: int = 100
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        pairs = [(i, j) for i in range(self.natoms)
                 for j in range(i + 1, self.natoms)]
        sel = rng.choice(len(pairs), size=min(self.maxfeatures, len(pairs)),
                         replace=False)
        object.__setattr__(self, "pairs",
                           np.asarray(sorted(pairs[i] for i in sel)))

    def __call__(self, coords):
        return pdists(coords, self.pairs)


def default_featurizer(natoms: int, features=None):
    """The reference's selection rule for the ported cases: all pairs
    under 100 atoms, else 100 random pairs; a pair list; a callable."""
    if features is None:
        if natoms < 100:
            return FeaturesAll()
        return FeaturesRandomPairs(natoms, maxfeatures=100)
    if callable(features):
        return features
    features = list(features)
    if features and isinstance(features[0], (tuple, list)):
        return FeaturesPairs(tuple(tuple(p) for p in features))
    raise NotImplementedError(f"feature spec {features!r} is not ported")
