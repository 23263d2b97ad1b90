"""Featurisers mapping raw coordinates to chi-model inputs; counterpart
of ``isokann_tpu/features.py``: callable frozen dataclasses (comparable,
for the featurizer check of ``SimulationData.merge``) over any leading
batch dimensions, the pair selections from a PDB and the reference's
default selection rule."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .md.pdbio import read_pdb
from .md.topology import build_topology
from .ops.dihedrals import dihedrals_from_indices, phi_psi_indices
from .ops.pairdists import flatpairdists, pdists, restricted_localpdistinds


@dataclass(frozen=True)
class FeaturesCoords:
    """The coordinates themselves."""

    def __call__(self, coords):
        return coords


@dataclass(frozen=True)
class FeaturesAll:
    """Pairwise distances between all atoms: (..., 3N) -> (..., N(N-1)/2);
    kernels C and C′ from ``ops.pairdists.FUSED_MIN_ATOMS`` atoms up."""

    def __call__(self, coords):
        return flatpairdists(coords)


@dataclass(frozen=True)
class FeaturesAtoms:
    """All-pairs distances among the atoms ``atominds``."""

    atominds: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "atominds",
                           tuple(int(i) for i in self.atominds))

    def __call__(self, coords):
        return flatpairdists(coords, atoms=np.asarray(self.atominds))


@dataclass(frozen=True)
class FeaturesPairs:
    """Distances for an explicit pair list: (..., 3N) -> (..., len(pairs))."""

    pairs: Tuple[Tuple[int, int], ...]

    def __post_init__(self):
        object.__setattr__(self, "pairs",
                           tuple((int(a), int(b)) for a, b in self.pairs))

    def __call__(self, coords):
        return pdists(coords, np.asarray(self.pairs).reshape(-1, 2))

    @classmethod
    def from_pdb(cls, pdb: str, selector: str = "all", maxdist=np.inf,
                 maxfeatures=np.inf, seed: int = 0):
        """The pairs of the atoms ``selector`` picks ('all', 'heavy' /
        'not element H', 'calpha' / 'name CA', 'backbone'), those within
        ``maxdist`` nm in the PDB's structure if given, at most
        ``maxfeatures`` of them drawn by ``default_rng(seed)`` and
        sorted."""
        struct = read_pdb(pdb)
        inds = _select_atoms(struct, selector)
        if maxdist < np.inf:
            pairs = restricted_localpdistinds(
                struct.coords.reshape(1, -1), maxdist, inds)
            pairs = [tuple(p) for p in pairs]
        else:
            pairs = [(inds[i], inds[j]) for i in range(len(inds))
                     for j in range(i + 1, len(inds))]
        if len(pairs) > maxfeatures:
            rng = np.random.default_rng(seed)
            sel = rng.choice(len(pairs), size=int(maxfeatures), replace=False)
            pairs = sorted(pairs[i] for i in sel)
        return cls(tuple(pairs))


@dataclass(frozen=True)
class FeaturesAngles:
    """Dihedral angles of index quadruplets, e.g. the backbone phi / psi
    of ``from_pdb``: (..., 3N) -> (..., len(quads)) radians."""

    quads: Tuple[Tuple[int, int, int, int], ...]

    def __post_init__(self):
        object.__setattr__(self, "quads",
                           tuple(tuple(int(i) for i in q) for q in self.quads))

    def __call__(self, coords):
        return dihedrals_from_indices(coords, np.asarray(self.quads))

    @classmethod
    def from_pdb(cls, pdb: str):
        """The phi quadruplets, then the psi ones, of the PDB's protein."""
        phis, psis = phi_psi_indices(build_topology(read_pdb(pdb)))
        return cls(tuple(tuple(q) for q in phis)
                   + tuple(tuple(q) for q in psis))


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


def _select_atoms(struct, selector: str):
    names = np.asarray(struct.atom_names)
    elements = np.asarray(struct.elements)
    if selector == "all":
        return np.arange(struct.natoms)
    if selector in ("heavy", "not element H"):
        return np.flatnonzero(elements != "H")
    if selector in ("calpha", "name CA"):
        return np.flatnonzero(names == "CA")
    if selector == "backbone":
        return np.flatnonzero(np.isin(names, ["N", "CA", "C", "O"]))
    raise ValueError(f"unsupported selector {selector!r}")


def calpha_inds(struct):
    """Indices of the C-alpha atoms of a ``PDBStructure``."""
    return np.flatnonzero(np.asarray(struct.atom_names) == "CA")


def calpha_pairs(struct):
    """All i < j pairs of C-alpha atoms."""
    ca = calpha_inds(struct)
    return [(int(ca[i]), int(ca[j])) for i in range(len(ca))
            for j in range(i + 1, len(ca))]


def local_atom_pairs(struct, radius, atomfilter=None):
    """Pairs of atoms within ``radius`` nm in the structure: heavy atoms
    outside water and ions, or those ``atomfilter(i)`` keeps."""
    keep = [i for i in range(struct.natoms)
            if (atomfilter(i) if atomfilter else
                (struct.elements[i] != "H" and
                 struct.res_names[i] not in ("HOH", "NA", "CL")))]
    xs = struct.coords
    pairs = []
    for a in range(len(keep)):
        for b in range(a + 1, len(keep)):
            i, j = keep[a], keep[b]
            if np.linalg.norm(xs[i] - xs[j]) <= radius:
                pairs.append((i, j))
    return pairs


def default_featurizer(pdb, natoms: int, features=None):
    """The reference's featurizer selection rule: with no spec all pairs
    under 100 atoms, else 100 random pairs; a callable as is; a radius
    (number): the C-alpha pairs plus the local heavy-atom pairs of the
    PDB's structure; a pair list; an atom list (``FeaturesAtoms``)."""
    if features is None:
        if natoms < 100:
            return FeaturesAll()
        return FeaturesRandomPairs(natoms, maxfeatures=100)
    if callable(features):
        return features
    if isinstance(features, (int, float)) and not isinstance(features, bool):
        if pdb is None:
            raise ValueError("radius feature selection needs a PDB; pass "
                             "an explicit pair list")
        struct = read_pdb(pdb)
        pairs = list(dict.fromkeys(calpha_pairs(struct)
                                   + local_atom_pairs(struct,
                                                      float(features))))
        return FeaturesPairs(tuple(pairs))
    features = list(features)
    if features and isinstance(features[0], (tuple, list)):
        return FeaturesPairs(tuple(tuple(p) for p in features))
    return FeaturesAtoms(tuple(features))
