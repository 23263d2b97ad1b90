"""Small-molecule (ligand) perception and parameterization.

Counterpart of ``isokann_tpu/md/ligand.py``, host numpy throughout.  Two
paths give a ligand its parameters:

1. **Import** (``md/importers.py``): Amber frcmod + mol2 or OpenMM ffxml
   files supply exact types / charges / parameters and register the
   residue directly; use this whenever real GAFF output exists.

2. **Generic perception** (this module): from heavy-atom coordinates and
   connectivity (PDB CONECT or covalent-radius perception) it derives
     - bond orders from crystal-geometry distances,
     - rings and aromaticity (geometry planarity + composition),
     - hybridization-based atom types with GAFF-class Lennard-Jones and
       bonded parameters (generic values, the role GAFF's wildcard
       classes play),
     - explicit hydrogens with standard valence rules and local-frame
       placement,
     - Gasteiger PEOE partial charges (Gasteiger & Marsili 1980) seeded
       with perceived formal charges.

The generic path is an approximation by design (as is any automatic
small-molecule force field); every generated parameter can be overridden
through ``register_residue`` or the importers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from . import amber
from .pdbio import PDBStructure

# --------------------------------------------------------------------------
# element data
# --------------------------------------------------------------------------

COVALENT_RADII = {  # Angstrom (Cordero et al. 2008, rounded)
    "H": 0.31, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57,
    "P": 1.07, "S": 1.05, "Cl": 1.02, "Br": 1.20, "I": 1.39,
}

VALENCE = {"H": 1, "C": 4, "N": 3, "O": 2, "F": 1,
           "P": 5, "S": 2, "Cl": 1, "Br": 1, "I": 1}

MASSES = {"H": 1.008, "C": 12.010, "N": 14.010, "O": 16.000, "F": 19.000,
          "P": 30.970, "S": 32.060, "Cl": 35.450, "Br": 79.900,
          "I": 126.900}


def _norm_element(e: str) -> str:
    e = e.strip()
    return e[:1].upper() + e[1:].lower() if len(e) > 1 else e.upper()


# --------------------------------------------------------------------------
# connectivity and perception
# --------------------------------------------------------------------------

def perceive_bonds(elements, coords_nm, tol=1.25):
    """Distance-based bond perception: d < tol * (r_i + r_j)."""
    xyz = np.asarray(coords_nm) * 10.0           # Angstrom
    els = [_norm_element(e) for e in elements]
    n = len(els)
    bonds = []
    for i in range(n):
        ri = COVALENT_RADII.get(els[i], 0.77)
        for j in range(i + 1, n):
            rj = COVALENT_RADII.get(els[j], 0.77)
            d = np.linalg.norm(xyz[i] - xyz[j])
            if d < tol * (ri + rj):
                bonds.append((i, j))
    return bonds


def _rings(adj, n, max_size=7):
    """Smallest ring through each bond (BFS), deduplicated."""
    rings = set()
    for a in range(n):
        for b in adj[a]:
            if b < a:
                continue
            # shortest path a..b avoiding the direct bond
            prev = {a: None}
            queue = [a]
            found = None
            while queue and found is None:
                cur = queue.pop(0)
                for nb in adj[cur]:
                    if cur == a and nb == b:
                        continue
                    if nb not in prev:
                        prev[nb] = cur
                        if nb == b:
                            found = nb
                            break
                        queue.append(nb)
            if found is None:
                continue
            path = [b]
            while path[-1] is not None:
                p = prev[path[-1]]
                path.append(p)
            path.pop()                      # drop the None
            if len(path) <= max_size:
                rings.add(tuple(sorted(path)))
    return [list(r) for r in rings]


def _planarity(xyz, ring):
    """RMS out-of-plane deviation (Angstrom) of a ring."""
    pts = xyz[ring]
    c = pts.mean(axis=0)
    _, _, vt = np.linalg.svd(pts - c)
    return float(np.sqrt(np.mean(((pts - c) @ vt[2]) ** 2)))


@dataclass
class Perception:
    elements: List[str]
    bonds: List[Tuple[int, int]]
    order: Dict[Tuple[int, int], float]     # 1, 1.5 (aromatic), 2, 3
    aromatic: List[bool]
    rings: List[List[int]]
    hybrid: List[int]                       # 3 = sp3, 2 = sp2, 1 = sp
    formal: np.ndarray                      # perceived formal charges
    implicit_h: List[int]


def perceive(elements, coords_nm, bonds=None):
    """Full perception from heavy-atom geometry."""
    els = [_norm_element(e) for e in elements]
    xyz = np.asarray(coords_nm) * 10.0
    n = len(els)
    if bonds is None:
        bonds = perceive_bonds(els, coords_nm)
    adj = {i: [] for i in range(n)}
    for a, b in bonds:
        adj[a].append(b)
        adj[b].append(a)

    def dist(a, b):
        return float(np.linalg.norm(xyz[a] - xyz[b]))

    rings = _rings(adj, n)
    # aromatic rings: size 5/6, planar, all members sp2-capable
    aromatic = [False] * n
    arom_rings = []
    for ring in rings:
        if len(ring) not in (5, 6):
            continue
        ok_elements = all(
            els[i] in ("C", "N", "O", "S") and len(adj[i]) <= 3
            for i in ring)
        if not ok_elements:
            continue
        if _planarity(xyz, ring) < 0.12:
            arom_rings.append(ring)
            for i in ring:
                aromatic[i] = True

    # bond orders from distances (crystal-quality geometry)
    order = {}
    for (a, b) in bonds:
        key = (min(a, b), max(a, b))
        ea, eb = sorted((els[a], els[b]))
        d = dist(a, b)
        o = 1.0
        if aromatic[a] and aromatic[b] and any(
                a in r and b in r for r in arom_rings):
            o = 1.5
        elif (ea, eb) == ("C", "C"):
            o = 3.0 if d < 1.24 else 2.0 if d < 1.40 else 1.0
        elif (ea, eb) == ("C", "N"):
            o = 3.0 if d < 1.20 else 2.0 if d < 1.34 else 1.0
        elif (ea, eb) == ("C", "O"):
            o = 2.0 if d < 1.28 else 1.0
        elif (ea, eb) == ("N", "O"):
            o = 2.0 if d < 1.30 else 1.0       # nitro N-O ~ 1.22
        elif (ea, eb) == ("O", "S"):
            o = 2.0 if d < 1.52 else 1.0       # sulfonyl S=O ~ 1.44
        elif (ea, eb) == ("N", "N"):
            o = 2.0 if d < 1.28 else 1.0
        order[key] = o

    # hybridization
    hybrid = [3] * n
    for i in range(n):
        e = els[i]
        if aromatic[i]:
            hybrid[i] = 2
            continue
        omax = max((order[(min(i, j), max(i, j))] for j in adj[i]),
                   default=1.0)
        if omax >= 3.0:
            hybrid[i] = 1
        elif omax >= 2.0:
            hybrid[i] = 2
        elif e == "C" and len(adj[i]) == 3:
            # planar 3-coordinate carbon without perceived double bond
            # (conjugated): check geometry
            a1, a2, a3 = adj[i][:3]
            normal = np.cross(xyz[a1] - xyz[i], xyz[a2] - xyz[i])
            nn = np.linalg.norm(normal)
            if nn > 1e-6:
                oop = abs(np.dot(xyz[a3] - xyz[i], normal / nn))
                if oop < 0.35:
                    hybrid[i] = 2
        elif e in ("N",) and len(adj[i]) == 3:
            # amide/aniline N: planar if bonded to an sp2 carbon
            if any(els[j] == "C" and (aromatic[j] or any(
                    order[(min(j, k), max(j, k))] >= 1.5 for k in adj[j]))
                   for j in adj[i]):
                hybrid[i] = 2

    # formal charges (common organic groups)
    formal = np.zeros(n)
    for i in range(n):
        e = els[i]
        if e == "N":
            # nitro: N bonded to two short-bond O's
            os_ = [j for j in adj[i] if els[j] == "O" and len(adj[j]) == 1]
            if len(os_) == 2 and all(
                    order[(min(i, j), max(i, j))] >= 1.0 and
                    dist(i, j) < 1.32 for j in os_):
                formal[i] = 1.0
                formal[os_[0]] = formal[os_[1]] = -0.5
                order[(min(i, os_[0]), max(i, os_[0]))] = 1.5
                order[(min(i, os_[1]), max(i, os_[1]))] = 1.5
                hybrid[i] = 2
        if e == "C":
            # carboxylate: C with two terminal O at ~equal 1.25 A
            os_ = [j for j in adj[i] if els[j] == "O" and len(adj[j]) == 1]
            if len(os_) == 2:
                d1, d2 = dist(i, os_[0]), dist(i, os_[1])
                if abs(d1 - d2) < 0.06 and max(d1, d2) < 1.32:
                    formal[os_[0]] = formal[os_[1]] = -0.5
                    order[(min(i, os_[0]), max(i, os_[0]))] = 1.5
                    order[(min(i, os_[1]), max(i, os_[1]))] = 1.5

    # implicit hydrogens: standard valence minus bond-order sum
    implicit = [0] * n
    for i in range(n):
        e = els[i]
        bo = sum(order[(min(i, j), max(i, j))] for j in adj[i])
        val = VALENCE.get(e, 4)
        if e == "S" and len(adj[i]) >= 3:
            val = 6 if len(adj[i]) == 4 else 4    # sulfone/sulfoxide
        if e == "N" and formal[i] > 0.5:
            val = 4
        if e == "O" and formal[i] < -0.25:
            val = 1
        # aromatic bookkeeping: 1.5 * 2 = 3 on a 2-connected aromatic
        # carbon leaves exactly one slot
        implicit[i] = max(0, int(round(val - bo + 1e-6)))
        if e in ("O",) and len(adj[i]) == 2:
            implicit[i] = 0
        if e == "N" and aromatic[i] and len(adj[i]) == 2:
            # pyridine-type (lone pair in plane) vs pyrrole-type (N-H):
            # a 5-ring N with both neighbors aromatic and the ring already
            # having another heteroatom keeps the H only if needed for
            # aromaticity — default to no H (pyridine/imine type), the
            # dominant case in drug-like molecules
            implicit[i] = 0
    return Perception(els, bonds, order, aromatic, rings, hybrid, formal,
                      implicit)


# --------------------------------------------------------------------------
# hydrogen placement
# --------------------------------------------------------------------------

def _local_frame(x0, neighbors):
    """Orthonormal frame anchored at x0 pointing away from neighbors."""
    if len(neighbors) == 0:
        return np.eye(3)
    v = -np.mean([n - x0 for n in neighbors], axis=0)
    nv = np.linalg.norm(v)
    if nv < 1e-8:
        v = np.array([1.0, 0.0, 0.0])
        nv = 1.0
    v = v / nv
    ref = np.array([0.0, 0.0, 1.0]) if abs(v[2]) < 0.9 else \
        np.array([1.0, 0.0, 0.0])
    u = np.cross(v, ref)
    u /= np.linalg.norm(u)
    w = np.cross(v, u)
    return v, u, w


def add_hydrogens(perc: Perception, coords_nm):
    """Generate explicit hydrogens (positions in nm) for the implicit
    counts; returns (h_parent (m,), h_xyz (m, 3))."""
    xyz = np.asarray(coords_nm) * 10.0
    adj = {i: [] for i in range(len(perc.elements))}
    for a, b in perc.bonds:
        adj[a].append(b)
        adj[b].append(a)
    parents, hs = [], []
    for i, nh in enumerate(perc.implicit_h):
        if nh == 0:
            continue
        e = perc.elements[i]
        blen = {"C": 1.09, "N": 1.01, "O": 0.96, "S": 1.34}.get(e, 1.0)
        nbrs = [xyz[j] for j in adj[i]]
        v, u, w = _local_frame(xyz[i], nbrs) if nbrs else (
            np.array([1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0, 0, 1.0]))
        if perc.hybrid[i] == 2 and len(nbrs) == 2:
            pos = [xyz[i] + blen * v]                       # in-plane
        elif perc.hybrid[i] == 2 and len(nbrs) == 1 and nh == 2:
            d = nbrs[0] - xyz[i]
            d /= np.linalg.norm(d)
            perp = np.cross(d, u if abs(np.dot(d, u)) < 0.9 else w)
            perp /= np.linalg.norm(perp)
            c, s = math.cos(math.radians(120)), math.sin(math.radians(120))
            pos = [xyz[i] + blen * (c * d + s * perp),
                   xyz[i] + blen * (c * d - s * perp)]
        else:
            # tetrahedral-ish fan around the away vector
            tilt = math.radians(180.0 - 109.47)
            pos = []
            for k in range(nh):
                phi = 2 * math.pi * k / max(nh, 1)
                d = (math.cos(tilt) * v
                     + math.sin(tilt) * (math.cos(phi) * u
                                         + math.sin(phi) * w))
                if len(nbrs) <= 1 and nh < 3:
                    d = v if nh == 1 else d
                pos.append(xyz[i] + blen * d)
            pos = pos[:nh]
        for p in pos[:nh]:
            parents.append(i)
            hs.append(p)
    return (np.asarray(parents, int),
            np.asarray(hs).reshape(-1, 3) / 10.0)


# --------------------------------------------------------------------------
# Gasteiger (PEOE) charges — Gasteiger & Marsili, Tetrahedron 36, 3219 (1980)
# --------------------------------------------------------------------------

_PEOE = {  # (a, b, c) by (element, hybridization-ish class)
    ("H", 0): (7.17, 6.24, -0.56),
    ("C", 3): (7.98, 9.18, 1.88),
    ("C", 2): (8.79, 9.32, 1.51),
    ("C", 1): (10.39, 9.45, 0.73),
    ("N", 3): (11.54, 10.82, 1.36),
    ("N", 2): (12.87, 11.15, 0.85),
    ("N", 1): (15.68, 11.70, -0.27),
    ("O", 3): (14.18, 12.92, 1.39),
    ("O", 2): (17.07, 13.79, 0.47),
    ("F", 0): (14.66, 13.85, 2.31),
    ("Cl", 0): (11.00, 9.69, 1.35),
    ("Br", 0): (10.08, 8.47, 1.16),
    ("I", 0): (9.90, 7.96, 0.96),
    ("S", 0): (10.14, 9.13, 1.38),
    ("P", 0): (8.90, 8.24, 0.96),
}


def gasteiger_charges(elements, bonds, hybrid, formal, iters=8):
    """PEOE partial charges seeded with formal charges."""
    n = len(elements)

    def abc(i):
        e = elements[i]
        if e in ("H", "F", "Cl", "Br", "I", "S", "P"):
            return _PEOE[(e, 0)]
        h = min(max(hybrid[i], 1), 3)
        return _PEOE.get((e, h), _PEOE.get((e, 3), (9.0, 9.0, 1.0)))

    q = np.asarray(formal, float).copy()
    damp = 1.0
    for it in range(iters):
        damp *= 0.5
        chi = np.array([a + b * q[i] + c * q[i] ** 2
                        for i, (a, b, c) in enumerate(map(abc, range(n)))])
        dq = np.zeros(n)
        for (i, j) in bonds:
            if chi[i] == chi[j]:
                continue
            lo, hi = (i, j) if chi[i] < chi[j] else (j, i)
            a, b, c = abc(lo)
            denom = 20.02 if elements[lo] == "H" else (a + b + c)
            t = (chi[hi] - chi[lo]) / denom * damp
            dq[lo] += t
            dq[hi] -= t
        q = q + dq
    return q


# --------------------------------------------------------------------------
# generic GAFF-class parameter assignment
# --------------------------------------------------------------------------

# atom types: LJ (rmin_half A, eps kcal/mol) + mass, GAFF-class values
LIGAND_TYPES = {
    "c3": (12.010, 1.9080, 0.1094),   # sp3 C
    "c2": (12.010, 1.9080, 0.0860),   # sp2 C
    "ca": (12.010, 1.9080, 0.0860),   # aromatic C
    "c1": (12.010, 1.9080, 0.0860),   # sp C
    "co": (12.010, 1.9080, 0.0860),   # carbonyl C
    "n3": (14.010, 1.8240, 0.1700),   # sp3 N
    "n2": (14.010, 1.8240, 0.1700),   # sp2/amide N
    "nr": (14.010, 1.8240, 0.1700),   # aromatic N
    "no": (14.010, 1.8240, 0.1700),   # nitro N
    "o1": (16.000, 1.6612, 0.2100),   # carbonyl/nitro/sulfonyl O
    "oe": (16.000, 1.6837, 0.1700),   # ether/ester O
    "ol": (16.000, 1.7210, 0.2104),   # hydroxyl O
    "sx": (32.060, 2.0000, 0.2500),   # any S (sulfide/sulfonyl)
    "cl": (35.450, 1.9480, 0.2650),   # Cl
    "br": (79.900, 2.0900, 0.3200),
    "f":  (19.000, 1.7500, 0.0610),
    "hx": (1.008, 1.4870, 0.0157),    # H on sp3 C
    "hr": (1.008, 1.4590, 0.0150),    # H on aromatic/sp2 C
    "hn": (1.008, 0.6000, 0.0157),    # H on N
    "hl": (1.008, 0.0001, 0.0000),    # H on O
}


def _atom_type(perc: Perception, i, adj):
    e = perc.elements[i]
    if e == "C":
        if perc.aromatic[i]:
            return "ca"
        if perc.hybrid[i] == 1:
            return "c1"
        if perc.hybrid[i] == 2:
            if any(perc.elements[j] == "O"
                   and perc.order[(min(i, j), max(i, j))] >= 1.5
                   for j in adj[i]):
                return "co"
            return "c2"
        return "c3"
    if e == "N":
        if abs(perc.formal[i] - 1.0) < 0.25 and not perc.aromatic[i]:
            ox = [j for j in adj[i] if perc.elements[j] == "O"]
            if len(ox) == 2:
                return "no"
        if perc.aromatic[i]:
            return "nr"
        return "n2" if perc.hybrid[i] == 2 else "n3"
    if e == "O":
        deg = len(adj[i])
        if deg >= 2:
            return "oe"
        omax = max((perc.order[(min(i, j), max(i, j))] for j in adj[i]),
                   default=1.0)
        if omax >= 1.5 or perc.formal[i] < -0.25:
            return "o1"
        return "ol"
    if e == "S":
        return "sx"
    if e == "Cl":
        return "cl"
    if e == "Br":
        return "br"
    if e == "F":
        return "f"
    if e == "H":
        return "hx"
    return "c3"


# bond K (kcal/mol/A^2) by order class; r0 comes from the input geometry
# (crystal structures sit near equilibrium — this sidesteps a per-type r0
# table and keeps the minimized ligand at its experimental geometry)
_BOND_K = {1.0: 300.0, 1.5: 450.0, 2.0: 550.0, 3.0: 600.0}
_BOND_K_H = 380.0

_ANGLE_K = {3: 55.0, 2: 68.0, 1: 60.0}   # by center hybridization
_ANGLE_K_H = 42.0


def parameterize_ligand(name, struct_or_pdb, residue_filter=None,
                        add_h=True, charges=None, net_charge=None,
                        register=True):
    """Perceive + parameterize a ligand and register it as a residue
    template.

    ``struct_or_pdb``: PDBStructure or path; ``residue_filter``: residue
    name to extract (default: the single HETATM residue present).
    ``charges``: optional explicit per-atom charges (overrides Gasteiger);
    ``net_charge``: if given, Gasteiger charges are shifted uniformly to
    this total.  Returns (template_dict, PDBStructure incl. added H).
    """
    from .pdbio import read_pdb

    struct = (read_pdb(struct_or_pdb) if isinstance(struct_or_pdb, str)
              else struct_or_pdb)
    if residue_filter is not None:
        sel = [i for i in range(struct.natoms)
               if struct.res_names[i] == residue_filter]
    else:
        sel = list(range(struct.natoms))
    if not sel:
        raise ValueError(f"no atoms for residue {residue_filter}")
    index = {g: k for k, g in enumerate(sel)}
    coords = struct.coords[sel]
    els = [struct.elements[i] for i in sel]
    names = [struct.atom_names[i] for i in sel]

    bonds = None
    if struct.conect:
        inner = [(index[a], index[b]) for (a, b) in struct.conect
                 if a in index and b in index]
        if inner:
            bonds = inner
    perc = perceive(els, coords, bonds=bonds)

    # explicit hydrogens
    h_parent = np.zeros(0, int)
    if add_h:
        h_parent, h_xyz = add_hydrogens(perc, coords)
        if len(h_parent):
            # short unique names (PDB atom-name field is 4 chars)
            names = names + [f"H{k + 1}" for k in range(len(h_parent))]
            els_all = perc.elements + ["H"] * len(h_parent)
            coords = np.concatenate([coords, h_xyz])
            bonds_all = list(perc.bonds) + [
                (int(p), len(perc.elements) + k)
                for k, p in enumerate(h_parent)]
            # re-run typing info with H present
            full = Perception(
                elements=els_all,
                bonds=bonds_all,
                order={**perc.order, **{(int(p), len(perc.elements) + k): 1.0
                                        for k, p in enumerate(h_parent)}},
                aromatic=perc.aromatic + [False] * len(h_parent),
                rings=perc.rings,
                hybrid=perc.hybrid + [0] * len(h_parent),
                formal=np.concatenate([perc.formal, np.zeros(len(h_parent))]),
                implicit_h=[0] * len(els_all),
            )
            perc = full
    n = len(perc.elements)
    adj = {i: [] for i in range(n)}
    for a, b in perc.bonds:
        adj[a].append(b)
        adj[b].append(a)

    # types
    types = [_atom_type(perc, i, adj) for i in range(n)]
    for k, p in enumerate(h_parent):
        i = len(perc.elements) - len(h_parent) + k
        pe = perc.elements[p]
        types[i] = ("hn" if pe == "N" else "hl" if pe == "O"
                    else "hr" if perc.hybrid[p] == 2 else "hx")

    # charges
    if charges is None:
        import warnings
        warnings.warn(
            f"ligand {name}: using built-in Gasteiger (PEOE) charges and "
            "generic GAFF-class bonded terms. Typical deviation from the "
            "reference's AM1-BCC/GAFF-2.11 setup is 0.05-0.15 e on polar "
            "atoms (quantified in docs/ligand_fidelity.md); for "
            "production, import antechamber output via "
            "register_ligand_frcmod / register_ligand_ffxml.",
            stacklevel=2)
        q = gasteiger_charges(perc.elements, perc.bonds, perc.hybrid,
                              perc.formal)
        if net_charge is not None:
            q = q + (net_charge - q.sum()) / n
    else:
        q = np.asarray(charges, float)

    # bonded parameters keyed by the *type tuples* present, r0/theta0 from
    # the observed geometry class averages
    xyz = coords * 10.0
    bond_params = {}
    for (a, b) in perc.bonds:
        ta, tb = types[a], types[b]
        key = (ta, tb) if (ta, tb) in bond_params or (tb, ta) not in \
            bond_params else (tb, ta)
        o = perc.order[(min(a, b), max(a, b))]
        K = _BOND_K_H if "h" in (ta[0], tb[0]) else _BOND_K[o]
        r = float(np.linalg.norm(xyz[a] - xyz[b]))
        if key in bond_params:
            K0, r0, cnt = bond_params[key]
            bond_params[key] = (K, (r0 * cnt + r) / (cnt + 1), cnt + 1)
        else:
            bond_params[key] = (K, r, 1)
    bond_params = {k: (K, r0) for k, (K, r0, _) in bond_params.items()}

    angle_params = {}
    for j in range(n):
        nb = sorted(adj[j])
        for ii in range(len(nb)):
            for kk in range(ii + 1, len(nb)):
                a, c = nb[ii], nb[kk]
                ta, tj, tc = types[a], types[j], types[c]
                key = (ta, tj, tc)
                if key[::-1] in angle_params:
                    key = key[::-1]
                va = xyz[a] - xyz[j]
                vc = xyz[c] - xyz[j]
                cosang = np.dot(va, vc) / (np.linalg.norm(va)
                                           * np.linalg.norm(vc))
                th = math.degrees(math.acos(max(-1.0, min(1.0, cosang))))
                K = (_ANGLE_K_H if types[a][0] == "h" or types[c][0] == "h"
                     else _ANGLE_K[max(1, min(3, perc.hybrid[j] or 3))])
                if key in angle_params:
                    K0, t0, cnt = angle_params[key]
                    angle_params[key] = (K, (t0 * cnt + th) / (cnt + 1),
                                         cnt + 1)
                else:
                    angle_params[key] = (K, th, 1)
    angle_params = {k: (K, t0) for k, (K, t0, _) in angle_params.items()}

    # torsions by central-bond class (GAFF-class generic barriers)
    dihedral_params = {}
    seen_central = set()
    for (j, k) in perc.bonds:
        tj, tk = types[j], types[k]
        if (tj, tk) in seen_central or (tk, tj) in seen_central:
            continue
        seen_central.add((tj, tk))
        o = perc.order[(min(j, k), max(j, k))]
        if tj[0] == "h" or tk[0] == "h":
            continue
        if o >= 1.5 or (perc.hybrid[j] == 2 and perc.hybrid[k] == 2):
            # aromatic / conjugated / double: planar 2-fold barrier
            pk = {1.0: 1.0, 1.5: 14.5 / 4, 2.0: 26.6 / 4, 3.0: 0.0}[
                min(o, 3.0) if o in (1.0, 1.5, 2.0, 3.0) else 1.5]
            if o == 1.0:
                pk = 2.5      # conjugated single bond (biaryl/amide-ish)
            dihedral_params[("X", tj, tk, "X")] = [(pk, 180.0, 2)]
        else:
            dihedral_params[("X", tj, tk, "X")] = [(1.40 / 9, 0.0, 3)]

    # impropers: keep sp2 centers planar
    improper_params = {}
    for i in range(n):
        if perc.hybrid[i] == 2 and len(adj[i]) == 3:
            improper_params[("X", "X", types[i], "X")] = (1.1, 180.0, 2)

    atoms = {nm: (t, float(qi)) for nm, t, qi in zip(names, types, q)}
    bonds_named = [(names[a], names[b]) for (a, b) in perc.bonds]

    # make H atom names unique (duplicates break template matching)
    assert len(set(names)) == len(names), "duplicate atom names"

    tmpl = None
    if register:
        tmpl = amber.register_residue(
            name, atoms, bonds_named,
            formal_charge=int(round(q.sum())),
            atom_types={t: LIGAND_TYPES[t] for t in set(types)},
            bond_params=bond_params,
            angle_params=angle_params,
            dihedral_params=dihedral_params,
            normalize=True)
        amber.IMPROPERS.update(improper_params)

    out = PDBStructure(
        atom_names=names,
        res_names=[name] * n,
        res_ids=[1] * n,
        chain_ids=["A"] * n,
        elements=list(perc.elements),
        coords=coords,
        box=None,
    )
    return tmpl, out
