"""MDSystem: force-field parameters as tensors, and the system builder.

Counterpart of ``isokann_tpu/md/system.py`` for the methods NoCutoff,
CutoffNonPeriodic and CutoffPeriodic (reaction field; minimum image when
periodic), Ewald and PME (one method under two names, as in the
reference: the erfc real space within the cutoff and the structure-factor
reciprocal sum of ``md/ewald.py``, with OpenMM's error tolerance
``ewald_tol``), and for OBC2 implicit solvent (``implicit="obc2"``, which
forces NoCutoff, with the reference's element-based Born radii and scale
factors).  LJPME is not ported.  The reference's dense incidence
matrices were a TPU device (difference vectors as matmuls); the port
gathers by index instead, so it keeps only the index tables.

Two pair layouts, as in the reference (``dense_pairs``): the dense (n, n)
Coulomb / LJ scale matrices for the all-pairs force paths, or, above
``DENSE_PAIRS_MAX`` atoms (or on request), only the sparse exception list
``excl_idx/excl_qq/excl_lj`` that the O(n) cell-list engine
(``md/neighbor.py``) reads.  Both carry the exception list.  Units follow
OpenMM: nm, kJ/mol, ps, amu, elementary charges.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from . import amber
from .pdbio import PDBStructure, read_pdb
from .topology import Topology, build_topology

KCAL = 4.184                    # kJ per kcal
COULOMB = 138.935456            # kJ mol^-1 nm e^-2  (OpenMM ONE_4PI_EPS0)
KB = 0.00831446261815324        # kJ/mol/K

METHODS = ("NoCutoff", "CutoffNonPeriodic", "CutoffPeriodic", "Ewald",
           "PME")
PERIODIC = ("CutoffPeriodic", "Ewald", "PME")
EWALD = ("Ewald", "PME")
DENSE_PAIRS_MAX = 4000   # above this, build_system(dense_pairs="auto")
                         # switches to the O(n) neighbor-engine layout


@dataclass
class MDSystem:
    """Per-system parameter tensors needed by the force evaluations."""

    bond_idx: torch.Tensor      # (nb, 2) int64
    bond_k: torch.Tensor        # (nb,) kJ/mol/nm^2  (E = k (r-r0)^2)
    bond_r0: torch.Tensor       # (nb,) nm
    angle_idx: torch.Tensor     # (na, 3)
    angle_k: torch.Tensor       # (na,) kJ/mol/rad^2
    angle_t0: torch.Tensor      # (na,) rad
    dih_idx: torch.Tensor       # (nd, 4), one row per torsion term
    dih_pk: torch.Tensor        # (nd,) kJ/mol
    dih_phase: torch.Tensor     # (nd,) rad
    dih_n: torch.Tensor         # (nd,) float periodicity
    charges: torch.Tensor       # (n,)
    rmin_half: torch.Tensor     # (n,) nm
    eps: torch.Tensor           # (n,) kJ/mol
    qq_scale: torch.Tensor      # (n, n) Coulomb pair scale (0 excl, 1-4,
                                # 1); (0, 0) without dense pairs
    lj_scale: torch.Tensor      # (n, n), or (0, 0)
    masses: torch.Tensor        # (n,) amu
    gb_radii: Optional[torch.Tensor] = None   # (n,) intrinsic Born radii
    gb_scales: Optional[torch.Tensor] = None  # (n,) OBC scale factors
    method: str = "CutoffPeriodic"
    cutoff: float = 1.0         # nm
    eps_rf: float = 78.5        # reaction-field dielectric
    box: Optional[tuple] = None  # (3,) nm box lengths, or None
    use_dispersion: bool = False
    disp_c6sum: float = 0.0     # sum_ij 2 eps_ij rmin_ij^6  [kJ/mol nm^6]
    disp_c12sum: float = 0.0    # sum_ij  eps_ij rmin_ij^12  [kJ/mol nm^12]
    implicit: Optional[str] = None   # None or "obc2"
    excl_idx: Optional[torch.Tensor] = None   # (m, 2) int64, i < j
    excl_qq: Optional[torch.Tensor] = None    # (m,) target Coulomb scale
    excl_lj: Optional[torch.Tensor] = None    # (m,) target LJ scale
    dense_pairs: bool = True
    ewald_kvecs: Optional[torch.Tensor] = None   # (nk, 3) [1/nm], Ewald/PME
    ewald_coefs: Optional[torch.Tensor] = None   # (nk,) [kJ/mol per |S|^2]
    ewald_alpha: float = 0.0    # splitting parameter [1/nm]

    @property
    def natoms(self):
        return self.charges.shape[0]

    @property
    def dim(self):
        return 3 * self.natoms

    @property
    def device(self):
        return self.charges.device

    def replace(self, **kw) -> "MDSystem":
        return dataclasses.replace(self, **kw)


def sparse_exclusions(top: Topology, scee: float, scnb: float):
    """Sparse exception list: (idx (m, 2) i < j, qq_w (m,), lj_w (m,)) with
    the target pair scales (0 for 1-2/1-3, scee/scnb for 1-4), sorted by
    pair.  O(n * degree); a pair that is both 1-4 and 1-2/1-3 takes the
    stronger exclusion, as in Amber."""
    adj = top.neighbors()
    w = {}
    for (i, j, k, l) in top.propers:
        if i != l:
            w[(min(i, l), max(i, l))] = (scee, scnb)
    for a in range(top.natoms):
        for b in adj[a]:
            w[(min(a, b), max(a, b))] = (0.0, 0.0)
            for c in adj[b]:
                if c != a:
                    w[(min(a, c), max(a, c))] = (0.0, 0.0)
    items = sorted(w.items())
    idx = np.asarray([p for p, _ in items], np.int64).reshape(-1, 2)
    qq_w = np.asarray([v[0] for _, v in items], np.float64)
    lj_w = np.asarray([v[1] for _, v in items], np.float64)
    return idx, qq_w, lj_w


def _exclusion_scales(top: Topology, scee: float, scnb: float):
    """Dense (n, n) pair-scale matrices: 0 for 1-2/1-3, scee/scnb for 1-4,
    1 elsewhere, 0 diagonal (1-2/1-3 override 1-4, as in Amber)."""
    n = top.natoms
    adj = top.neighbors()
    qq = np.ones((n, n))
    lj = np.ones((n, n))
    np.fill_diagonal(qq, 0.0)
    np.fill_diagonal(lj, 0.0)
    for (i, j, k, l) in top.propers:
        if i != l:
            qq[i, l] = qq[l, i] = scee
            lj[i, l] = lj[l, i] = scnb
    for a in range(n):
        for b in adj[a]:
            qq[a, b] = qq[b, a] = 0.0
            lj[a, b] = lj[b, a] = 0.0
            for c in adj[b]:
                if c != a:
                    qq[a, c] = qq[c, a] = 0.0
                    lj[a, c] = lj[c, a] = 0.0
    return qq, lj


# OBC2 intrinsic radii [nm] and scale factors by element (OpenMM defaults)
_GB_RADII = {"H": 0.12, "C": 0.17, "N": 0.155, "O": 0.15, "F": 0.15,
             "P": 0.185, "S": 0.18}
_GB_SCALES = {"H": 0.85, "C": 0.72, "N": 0.79, "O": 0.85, "F": 0.88,
              "P": 0.86, "S": 0.96}


def _gb_params(top: Topology):
    """Per-atom OBC2 (radius, scale) by element; mbondi-style 0.13 nm for
    a hydrogen bonded to a nitrogen."""
    radii = np.empty(top.natoms)
    scales = np.empty(top.natoms)
    adj = top.neighbors()
    for i, t in enumerate(top.atom_types):
        el = "H" if t.startswith("H") else t[0]
        r = _GB_RADII.get(el, 0.15)
        if el == "H":
            for j in adj[i]:
                if top.atom_types[j].startswith("N"):
                    r = 0.13
                    break
        radii[i] = r
        scales[i] = _GB_SCALES.get(el, 0.8)
    return radii, scales


def _dispersion_sums(rmin_half, eps):
    """(S6, S12) over all ordered atom pairs for the isotropic LJ tail
    correction (OpenMM's homogeneous-fluid approximation)."""
    pars = np.stack([np.asarray(rmin_half, np.float64),
                     np.asarray(eps, np.float64)], axis=1)
    uniq, counts = np.unique(pars, axis=0, return_counts=True)
    rmin = uniq[:, 0][:, None] + uniq[:, 0][None, :]
    epsij = np.sqrt(uniq[:, 1][:, None] * uniq[:, 1][None, :])
    w = counts[:, None].astype(np.float64) * counts[None, :]
    return (float(np.sum(w * 2.0 * epsij * rmin ** 6)),
            float(np.sum(w * epsij * rmin ** 12)))


def build_system(source, method: str = "auto", cutoff: float = 1.0,
                 eps_rf: float = 78.5, implicit: Optional[str] = None,
                 dispersion_correction: bool = True, dense_pairs="auto",
                 ewald_tol: float = 5e-4, device=None) -> MDSystem:
    """MDSystem from a PDB path / PDBStructure / Topology, its tensors on
    ``device`` (the GPU unless the caller names another; with no GPU and no
    device this raises).

    ``method="auto"`` picks CutoffPeriodic when the PDB has a box and
    CutoffNonPeriodic otherwise, as the reference does.
    ``implicit="obc2"`` adds OBC2 GBSA implicit solvent and forces
    NoCutoff.  ``method="Ewald"`` or ``"PME"`` (a box required) adds the
    Ewald tables at error tolerance ``ewald_tol`` (OpenMM's
    ewaldErrorTolerance).  ``dense_pairs``: True builds the dense (n, n)
    scale matrices, False only the sparse exception list (forces then run
    through the cell-list engine, which needs a periodic method), "auto"
    switches at ``DENSE_PAIRS_MAX`` atoms."""
    device = resolve_device(device)
    box = None
    if isinstance(source, str):
        struct = read_pdb(source)
        box = struct.box
        top = build_topology(struct)
    elif isinstance(source, PDBStructure):
        box = source.box
        top = build_topology(source)
    else:
        top = source

    if implicit not in (None, "obc2"):
        raise NotImplementedError(f"implicit solvent {implicit!r} is not "
                                  f"ported; supported: 'obc2'")
    if implicit is not None:
        method = "NoCutoff"
    if method == "auto":
        method = "CutoffPeriodic" if box is not None else "CutoffNonPeriodic"
    if method not in METHODS:
        where = (" (ROADMAP Queue 1 item 7)" if method == "LJPME" else "")
        raise NotImplementedError(
            f"nonbonded method {method!r} is not ported{where}; supported: "
            f"{METHODS}")
    if method in EWALD and box is None:
        raise ValueError(f"method={method} requires a periodic box")
    if box is not None and method in PERIODIC:
        cutoff = min(cutoff, 0.999 * float(min(box)) / 2)   # cutoff < box/2
    alpha, kvecs, coefs = 0.0, np.zeros((0, 3)), np.zeros(0)
    if method in EWALD:
        from .ewald import ewald_alpha, ewald_kvectors
        alpha = ewald_alpha(float(cutoff), ewald_tol)
        kvecs, coefs = ewald_kvectors(box, alpha, ewald_tol)

    types = top.atom_types
    bond_idx, bond_k, bond_r0 = [], [], []
    for (a, b) in top.bonds:
        k, r0 = amber.lookup_bond(types[a], types[b])
        bond_idx.append((a, b))
        bond_k.append(k * KCAL * 100.0)   # kcal/A^2 -> kJ/nm^2
        bond_r0.append(r0 / 10.0)

    angle_idx, angle_k, angle_t0 = [], [], []
    for (a, b, c) in top.angles:
        k, t0 = amber.lookup_angle(types[a], types[b], types[c])
        angle_idx.append((a, b, c))
        angle_k.append(k * KCAL)
        angle_t0.append(np.deg2rad(t0))

    dih_idx, dih_pk, dih_phase, dih_n = [], [], [], []
    for (i, j, k, l) in top.propers:
        for (pk, phase, n) in amber.lookup_dihedral(types[i], types[j],
                                                    types[k], types[l]):
            if pk == 0.0:
                continue
            dih_idx.append((i, j, k, l))
            dih_pk.append(pk * KCAL)
            dih_phase.append(np.deg2rad(phase))
            dih_n.append(float(n))
    for (i, j, c, l) in top.impropers:
        par = amber.lookup_improper(types[i], types[j], types[c], types[l])
        if par is None:
            continue
        pk, phase, n = par
        dih_idx.append((i, j, c, l))
        dih_pk.append(pk * KCAL)
        dih_phase.append(np.deg2rad(phase))
        dih_n.append(float(n))

    rmin_half = np.array([amber.lj_params(t)[0] / 10.0 for t in types])
    eps = np.array([amber.lj_params(t)[1] * KCAL for t in types])
    use_disp = bool(dispersion_correction and box is not None
                    and method in PERIODIC)
    s6, s12 = _dispersion_sums(rmin_half, eps) if use_disp else (0.0, 0.0)
    if dense_pairs == "auto":
        dense_pairs = top.natoms <= DENSE_PAIRS_MAX
    qq, lj = (_exclusion_scales(top, amber.SCEE, amber.SCNB) if dense_pairs
              else (np.zeros((0, 0)), np.zeros((0, 0))))
    eidx, eqq, elj = sparse_exclusions(top, amber.SCEE, amber.SCNB)
    gb_radii, gb_scales = (_gb_params(top) if implicit
                           else (np.zeros(0), np.zeros(0)))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float64),
                               dtype=torch.float32, device=device)

    def idx(x, width):
        return torch.as_tensor(np.asarray(x, np.int64).reshape(-1, width),
                               device=device)

    return MDSystem(
        bond_idx=idx(bond_idx, 2), bond_k=f32(bond_k), bond_r0=f32(bond_r0),
        angle_idx=idx(angle_idx, 3), angle_k=f32(angle_k),
        angle_t0=f32(angle_t0),
        dih_idx=idx(dih_idx, 4), dih_pk=f32(dih_pk),
        dih_phase=f32(dih_phase), dih_n=f32(dih_n),
        charges=f32(top.charges), rmin_half=f32(rmin_half), eps=f32(eps),
        qq_scale=f32(qq), lj_scale=f32(lj), masses=f32(top.masses),
        gb_radii=f32(gb_radii), gb_scales=f32(gb_scales),
        method=method, cutoff=float(cutoff), eps_rf=float(eps_rf),
        box=tuple(float(b) for b in box) if box is not None else None,
        use_dispersion=use_disp, disp_c6sum=s6, disp_c12sum=s12,
        implicit=implicit, excl_idx=idx(eidx, 2), excl_qq=f32(eqq),
        excl_lj=f32(elj), dense_pairs=bool(dense_pairs),
        ewald_kvecs=f32(kvecs), ewald_coefs=f32(coefs),
        ewald_alpha=float(alpha),
    )
