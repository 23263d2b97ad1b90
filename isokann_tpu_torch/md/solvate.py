"""Explicit-solvent preparation: a TIP3P or TIP4P-Ew water box and
counterions.

Counterpart of ``isokann_tpu/md/solvate.py`` (``_water_coords``,
``solvate``, ``water_msites``, ``water_triplets``), in numpy: with the
same seed it places the same atoms.  Waters sit on a simple cubic lattice
at liquid density with random orientations; lattice sites overlapping the
solute are removed; ions replace the waters farthest from the solute.
The result is meant to be briefly equilibrated under rigid-water
dynamics.  A 4-site water's M point becomes a virtual site
(``water_msites``, ``md/vsites.py``).
"""

from __future__ import annotations

import math

import numpy as np

from .pdbio import PDBStructure

# TIP3P geometry [nm]
R_OH = 0.09572
ANG_HOH = math.radians(104.52)
R_HH = 2.0 * R_OH * math.sin(ANG_HOH / 2.0)
WATER_SPACING = 0.3104          # (1 / 33.43 waters/nm^3)^(1/3)
WATER_NAMES = ("HOH", "WAT", "TIP3", "SOL", "SPC")
WATER4_NAMES = ("HOH", "HOH4", "WAT", "TIP4", "T4E", "SOL")

# TIP4P-Ew M-site average3 weights over (O, H1, H2) (Horn et al. 2004, the
# values of OpenMM's amber14/tip4pew.xml): M sits 0.0125 nm from O along
# the HOH bisector
M_WEIGHTS = (0.786646558, 0.106676721, 0.106676721)


def _water_coords(center, rng, nsite=3):
    """One water at ``center`` with a random orientation -> (nsite, 3)
    rows O, H1, H2 (and M for a 4-site water)."""
    h1 = np.array([R_OH, 0.0, 0.0])
    h2 = np.array([R_OH * math.cos(ANG_HOH), R_OH * math.sin(ANG_HOH), 0.0])
    # random rotation from the QR factorisation of a Gaussian matrix
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    rows = [center, center + h1 @ q.T, center + h2 @ q.T]
    if nsite == 4:
        w = M_WEIGHTS
        rows.append(w[0] * rows[0] + w[1] * rows[1] + w[2] * rows[2])
    return np.stack(rows)


def _min_image_d2(sites, xyz, box):
    """Squared minimum-image distance of each site to its nearest solute
    atom, in blocks of 4096 sites."""
    d2 = np.empty(len(sites))
    for i in range(0, len(sites), 4096):
        d = sites[i:i + 4096, None, :] - xyz[None, :, :]
        d -= box * np.round(d / box)
        d2[i:i + 4096] = (d ** 2).sum(-1).min(axis=1)
    return d2


def solvate(struct: PDBStructure, padding: float = 1.0, box=None,
            neutralize: bool = True, ionic_strength: float = 0.0,
            exclusion: float = 0.24, seed: int = 0,
            model: str = "tip3p") -> PDBStructure:
    """Surround ``struct`` with water and counterions.

    - ``padding``: box = solute extent + 2 x padding [nm] (ignored if
      ``box`` is given)
    - ``neutralize``: add Na+/Cl- to cancel the solute's formal charge
    - ``ionic_strength``: additional NaCl pairs [mol/l]
    - ``exclusion``: water O to solute-atom clearance [nm]
    - ``model``: "tip3p" or "tip4pew" (4-site: the M points become
      virtual sites, ``water_msites``)

    Returns a new PDBStructure with ``box`` set; the solute keeps its
    atom indices, ions follow, then the waters as (O, H1, H2[, M])
    blocks."""
    if model not in ("tip3p", "tip4pew"):
        raise ValueError(f"unknown water model {model!r}")
    nsite = 4 if model == "tip4pew" else 3
    rng = np.random.default_rng(seed)
    xyz = np.asarray(struct.coords, float)
    lo, hi = xyz.min(axis=0), xyz.max(axis=0)
    if box is None:
        box = hi - lo + 2.0 * padding
    box = np.asarray(box, float) * np.ones(3)
    xyz = xyz + (box / 2.0 - (lo + hi) / 2.0)     # solute centred in box

    # cubic lattice of candidate O sites, minus those near the solute
    nsites = np.maximum(np.round(box / WATER_SPACING).astype(int), 1)
    a = box / nsites
    grid = np.stack(np.meshgrid(
        *[(np.arange(n) + 0.5) * ai for n, ai in zip(nsites, a)],
        indexing="ij"), axis=-1).reshape(-1, 3)
    sites = grid[_min_image_d2(grid, xyz, box) > exclusion ** 2]

    # ion counts: neutralization + ionic strength (waters -> ion pairs)
    from .topology import build_topology
    formal = int(round(float(np.sum(build_topology(struct).charges))))
    n_pairs = int(round(ionic_strength * len(sites) / 55.4))
    n_na = n_pairs + max(0, -formal) if neutralize else n_pairs
    n_cl = n_pairs + max(0, formal) if neutralize else n_pairs
    n_ions = n_na + n_cl
    if n_ions > len(sites):
        raise ValueError("box too small for the requested ions")

    # ions take the sites farthest from the solute (stable placement)
    order = np.argsort(-_min_image_d2(sites, xyz, box))
    ion_sites = sites[order[:n_ions]]
    wat_sites = sites[order[n_ions:]]

    names = list(struct.atom_names)
    resn = list(struct.res_names)
    resi = list(struct.res_ids)
    chains = list(struct.chain_ids)
    elements = list(struct.elements)
    coords = [xyz]
    rid = (max(struct.res_ids) if len(struct.res_ids) else 0) + 1
    for k in range(n_ions):
        ion, el = ("NA", "Na") if k < n_na else ("CL", "Cl")
        names.append(ion)
        resn.append(ion)
        resi.append(rid)
        chains.append("I")
        elements.append(el)
        rid += 1
        coords.append(ion_sites[k][None, :])
    for site in wat_sites:
        coords.append(_water_coords(site, rng, nsite))
        names += ["O", "H1", "H2", "M"][:nsite]
        resn += ["HOH"] * nsite
        resi += [rid] * nsite
        chains += ["W"] * nsite
        elements += ["O", "H", "H", "EP"][:nsite]
        rid += 1
    return PDBStructure(names, resn, resi, chains, elements,
                        np.concatenate(coords, axis=0), box)


def water_msites(struct: PDBStructure):
    """(vs_idx, parents (nv, 3), weights (nv, 3)) of every 4-site water's
    M / EPW point, for ``md.vsites.attach_vsites``."""
    idx, par = [], []
    cur, cur_tag = {}, None
    for i in range(struct.natoms):
        if struct.res_names[i] not in WATER4_NAMES:
            continue
        tag = (struct.chain_ids[i], struct.res_ids[i])
        if tag != cur_tag:
            cur, cur_tag = {}, tag
        n = struct.atom_names[i]
        cur[{"OW": "O", "HW1": "H1", "HW2": "H2",
             "EPW": "M", "MW": "M", "EP": "M"}.get(n, n)] = i
        if len(cur) == 4 and "M" in cur:
            idx.append(cur["M"])
            par.append((cur["O"], cur["H1"], cur["H2"]))
    nv = len(idx)
    return (np.asarray(idx, np.int64),
            np.asarray(par, np.int64).reshape(nv, 3),
            np.tile(np.asarray(M_WEIGHTS), (nv, 1)))


def water_triplets(struct: PDBStructure):
    """(nw, 3) int64 (O, H1, H2) indices of every water residue, for the
    rigid-water constraints."""
    trip = []
    cur, cur_tag = {}, None
    for i in range(struct.natoms):
        if struct.res_names[i] not in WATER_NAMES:
            continue
        tag = (struct.chain_ids[i], struct.res_ids[i])
        if tag != cur_tag:
            cur, cur_tag = {}, tag
        n = struct.atom_names[i]
        cur[{"OW": "O", "HW1": "H1", "HW2": "H2"}.get(n, n)] = i
        if len(cur) == 3:
            trip.append((cur["O"], cur["H1"], cur["H2"]))
    return np.asarray(trip, np.int64).reshape(-1, 3)


def water_constraint_pairs(struct: PDBStructure):
    """The rigid-water constraints of ``struct`` as explicit (i, j, d)
    pairs, O-H1, O-H2 and H1-H2 of each water (``water_triplets``): what
    an OpenMM System's <Constraints> block holds for rigid TIP3P."""
    out = []
    for o, h1, h2 in water_triplets(struct):
        out += [(int(o), int(h1), R_OH), (int(o), int(h2), R_OH),
                (int(h1), int(h2), R_HH)]
    return out
