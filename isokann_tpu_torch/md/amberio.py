"""Amber prmtop / inpcrd (rst7) I/O: the exact-parameter import path.

Counterpart of ``isokann_tpu/md/amberio.py``.  AmberTools' ``tleap``
writes a prmtop whose tables are the fully resolved per-term parameters
(ff14SB / ff19SB / GAFF / OL3, whatever was loaded); ``load_prmtop`` +
``system_from_prmtop`` turn that file into an ``MDSystem`` through
``system.system_from_tables`` with no force-field lookup, its tensors on
``device`` (the GPU unless the caller names another).
``save_prmtop`` writes any built ``MDSystem`` as a prmtop that
AmberTools / ParmEd / OpenMM load, the same text as the JAX package's for
equal tables; ``read_rst7`` / ``write_rst7`` move coordinates.

Conventions (Amber 12+ prmtop spec):
- CHARGE is q * 18.2223; ANGLE_EQUIL_VALUE and DIHEDRAL_PHASE are radians;
  bond/angle K follow E = K dx^2 (same convention as MDSystem, kcal/A^2).
- BONDS_*/ANGLES_*/DIHEDRALS_* store coordinate offsets (atom index * 3);
  a negative 3rd dihedral index suppresses the 1-4 pair, a negative 4th
  marks an improper.
- LENNARD_JONES_ACOEF/BCOEF: A = eps rmin^12, B = 2 eps rmin^6 per type
  pair (lower-triangle packing via NONBONDED_PARM_INDEX); the per-type LJ
  is read from the diagonal (a warning when the off-diagonals leave
  Lorentz-Berthelot), SCEE / SCNB give the 1-4 scales, RADII / SCREEN the
  OBC2 tables under ``implicit="obc2"``, CMAP_* the torsion-torsion maps.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

KCAL = 4.184
AMBER_CHARGE = 18.2223          # prmtop charge unit: q [e] * 18.2223
AMBER_VEL = 20.455              # velocities: A per (1/20.455) ps


def _host(a, dtype=None):
    """A system table (tensor on any device, or array) as host numpy, in
    its own dtype unless ``dtype`` is given."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------

def _parse_format(fmt: str):
    """'20a4' / '5E16.8' / '10I8' / '8(F9.5)' -> (count, kind, width)."""
    import re
    fmt = fmt.replace("(", "").replace(")", "")
    m = re.match(r"\s*(\d*)\s*([aAiIeEfF])\s*(\d+)", fmt)
    if not m:
        return (1, "a", 80)
    return (int(m.group(1) or 1), m.group(2).lower(), int(m.group(3)))


def load_prmtop(path: str) -> dict:
    """Parse a prmtop into {FLAG: list-of-values} (numeric flags -> floats/
    ints, a-format flags -> fixed-width strings, stripped)."""
    sections: dict[str, list] = {}
    flag = None
    kind, width = "a", 80
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if line.startswith("%VERSION"):
                continue
            if line.startswith("%FLAG"):
                flag = line.split()[1]
                sections[flag] = []
                kind, width = "a", 80
                continue
            if line.startswith("%FORMAT"):
                _, kind, width = _parse_format(line[line.index("(") + 1:
                                                    line.rindex(")")])
                continue
            if line.startswith("%COMMENT") or flag is None:
                continue
            if kind == "a":
                for i in range(0, len(line), width):
                    chunk = line[i:i + width]
                    if chunk.strip() or len(chunk) == width:
                        sections[flag].append(chunk.strip())
            elif kind == "i":
                sections[flag].extend(int(t) for t in line.split())
            else:
                sections[flag].extend(float(t.replace("D", "E"))
                                      for t in line.split())
    return sections


# POINTERS indices (Amber prmtop spec)
_PTR = dict(NATOM=0, NTYPES=1, NBONH=2, MBONA=3, NTHETH=4, MTHETA=5,
            NPHIH=6, MPHIA=7, NNB=10, NRES=11, NUMBND=15, NUMANG=16,
            NPTRA=17, IFBOX=20)


def read_rst7(path: str):
    """Read an Amber inpcrd/rst7.  Returns (coords (n, 3) [nm],
    velocities (n, 3) [nm/ps] or None, box (3,) [nm] or None)."""
    with open(path) as f:
        lines = f.read().splitlines()
    header = lines[1].split()
    natoms = int(header[0])
    vals = []
    for line in lines[2:]:
        for i in range(0, len(line.rstrip()), 12):
            chunk = line[i:i + 12]
            if chunk.strip():
                vals.append(float(chunk))
    vals = np.asarray(vals)
    need = natoms * 3
    coords = vals[:need].reshape(natoms, 3) / 10.0
    rest = vals[need:]
    vel = None
    box = None
    if rest.shape[0] >= need:                       # velocities present
        vel = rest[:need].reshape(natoms, 3) * AMBER_VEL / 10.0
        rest = rest[need:]
    if rest.shape[0] >= 3:                          # box lengths (+ angles)
        if rest.shape[0] >= 6 and not np.allclose(rest[3:6], 90.0):
            raise ValueError("only rectangular boxes are supported "
                             f"(angles {rest[3:6]})")
        box = rest[:3] / 10.0
    return coords, vel, box


def _lj_from_acoef(sec, ntypes):
    """Per-type (rmin_half [nm], eps [kJ]) from the diagonal A/B
    coefficients; warns if off-diagonals deviate from Lorentz-Berthelot
    (LJEDIT / NBFIX-style tables are not representable)."""
    nbidx = np.asarray(sec["NONBONDED_PARM_INDEX"], int)
    A = np.asarray(sec["LENNARD_JONES_ACOEF"], float)
    B = np.asarray(sec["LENNARD_JONES_BCOEF"], float)
    rmin_half = np.zeros(ntypes)
    eps = np.zeros(ntypes)
    for t in range(ntypes):
        p = nbidx[ntypes * t + t]
        if p < 0:
            raise ValueError("10-12 hydrogen-bond terms are not supported")
        a, b = A[p - 1], B[p - 1]
        if a > 0 and b > 0:
            rmin = (2.0 * a / b) ** (1.0 / 6.0)     # A
            rmin_half[t] = rmin / 2.0 / 10.0        # nm
            eps[t] = (b * b / (4.0 * a)) * KCAL     # kJ
    worst = 0.0
    for t in range(ntypes):
        for u in range(t + 1, ntypes):
            p = nbidx[ntypes * t + u]
            if p < 0:
                raise ValueError("10-12 hydrogen-bond terms not supported")
            a = A[p - 1]
            rmin = (rmin_half[t] + rmin_half[u]) * 10.0
            e = math.sqrt(eps[t] * eps[u]) / KCAL
            a_lb = e * rmin ** 12
            if a > 1e-10:
                worst = max(worst, abs(a - a_lb) / a)
    if worst > 1e-4:
        warnings.warn(f"prmtop LJ off-diagonals deviate from "
                      f"Lorentz-Berthelot by up to {worst:.2e} (LJEDIT?); "
                      f"the combination-rule engine cannot represent them")
    return rmin_half, eps


def system_from_prmtop(prmtop: str, inpcrd: str | None = None,
                       method: str = "auto", cutoff: float = 1.0,
                       implicit: str | None = None, box=None,
                       dense_pairs="auto", ewald_tol: float = 5e-4,
                       dispersion_correction: bool = True, device=None):
    """Build an MDSystem from tleap output with zero parameter lookups.

    Returns ``(system, coords, meta)``: coords (natoms, 3) [nm] from the
    inpcrd (or None), meta = dict(atom_names, amber_types, residue_labels,
    residue_pointers, velocities).

    ``method='auto'``: PME when the prmtop/inpcrd carries a box (Amber
    periodic default), NoCutoff otherwise.  ``implicit='obc2'`` uses the
    prmtop's own RADII/SCREEN tables (tleap ``set default PBRadii``).
    The system's tensors land on ``device`` (the GPU unless the caller
    names another)."""
    from .system import system_from_tables

    sec = load_prmtop(prmtop)
    ptr = sec["POINTERS"]
    natom = ptr[_PTR["NATOM"]]
    ntypes = ptr[_PTR["NTYPES"]]

    charges = np.asarray(sec["CHARGE"], float) / AMBER_CHARGE
    masses = np.asarray(sec["MASS"], float)
    tidx = np.asarray(sec["ATOM_TYPE_INDEX"], int) - 1
    rh_t, eps_t = _lj_from_acoef(sec, ntypes)
    rmin_half = rh_t[tidx]
    eps = eps_t[tidx]

    bond_k_t = np.asarray(sec["BOND_FORCE_CONSTANT"], float)
    bond_r_t = np.asarray(sec["BOND_EQUIL_VALUE"], float)
    ang_k_t = np.asarray(sec["ANGLE_FORCE_CONSTANT"], float)
    ang_t_t = np.asarray(sec["ANGLE_EQUIL_VALUE"], float)
    dih_k_t = np.asarray(sec["DIHEDRAL_FORCE_CONSTANT"], float)
    dih_n_t = np.asarray(sec["DIHEDRAL_PERIODICITY"], float)
    dih_p_t = np.asarray(sec["DIHEDRAL_PHASE"], float)
    nptra = len(dih_k_t)
    scee_t = np.asarray(sec.get("SCEE_SCALE_FACTOR", [1.2] * nptra), float)
    scnb_t = np.asarray(sec.get("SCNB_SCALE_FACTOR", [2.0] * nptra), float)
    scee_t = np.where(scee_t == 0.0, 1.2, scee_t)
    scnb_t = np.where(scnb_t == 0.0, 2.0, scnb_t)

    def triples(name):
        v = np.asarray(sec.get(name, []), int).reshape(-1, 3)
        return v

    def quads(name):
        return np.asarray(sec.get(name, []), int).reshape(-1, 4)

    def quints(name):
        return np.asarray(sec.get(name, []), int).reshape(-1, 5)

    bonds = np.concatenate([triples("BONDS_INC_HYDROGEN"),
                            triples("BONDS_WITHOUT_HYDROGEN")], axis=0)
    angles = np.concatenate([quads("ANGLES_INC_HYDROGEN"),
                             quads("ANGLES_WITHOUT_HYDROGEN")], axis=0)
    dihs = np.concatenate([quints("DIHEDRALS_INC_HYDROGEN"),
                           quints("DIHEDRALS_WITHOUT_HYDROGEN")], axis=0)

    bond_idx = bonds[:, :2] // 3
    bp = bonds[:, 2] - 1
    bond_k = bond_k_t[bp] * KCAL * 100.0
    bond_r0 = bond_r_t[bp] / 10.0

    angle_idx = angles[:, :3] // 3
    ap = angles[:, 3] - 1
    angle_k = ang_k_t[ap] * KCAL
    angle_t0 = ang_t_t[ap]                           # radians already

    # exclusions: EXCLUDED_ATOMS_LIST pairs start fully excluded, proper
    # dihedral rows mark their (i, l) 1-4 at (1/scee, 1/scnb), then
    # 1-2/1-3 (bonds/angles) override back to 0 — stronger exclusion wins,
    # matching ``system.sparse_exclusions``
    excl: dict[tuple, tuple] = {}
    nexc = np.asarray(sec["NUMBER_EXCLUDED_ATOMS"], int)
    exlist = np.asarray(sec["EXCLUDED_ATOMS_LIST"], int)
    pos = 0
    for i in range(natom):
        for j in exlist[pos:pos + nexc[i]]:
            if j > 0:                                # 0 entries are padding
                a, b = i, j - 1
                excl[(min(a, b), max(a, b))] = (0.0, 0.0)
        pos += nexc[i]

    dih_rows = []
    for (ii, jj, kk, ll, p) in dihs:
        i, j = ii // 3, jj // 3
        k, l = abs(kk) // 3, abs(ll) // 3
        p -= 1
        if kk >= 0 and ll >= 0 and i != l:           # proper with 1-4
            excl[(min(i, l), max(i, l))] = (1.0 / scee_t[p], 1.0 / scnb_t[p])
        if dih_k_t[p] != 0.0:
            dih_rows.append((i, j, k, l, dih_k_t[p] * KCAL,
                             dih_p_t[p], dih_n_t[p]))
    for (a, b) in bond_idx:
        excl[(min(a, b), max(a, b))] = (0.0, 0.0)
    for (a, _, c) in angle_idx:
        excl[(min(a, c), max(a, c))] = (0.0, 0.0)

    items = sorted(excl.items())
    excl_idx = np.asarray([p for p, _ in items], np.int32).reshape(-1, 2)
    excl_qq = np.asarray([v[0] for _, v in items])
    excl_lj = np.asarray([v[1] for _, v in items])

    dih_rows = np.asarray(dih_rows, float).reshape(-1, 7)

    # CMAP torsion-torsion maps (ff19SB tleap CMAP_*; chamber
    # CHARMM_CMAP_*): 6-int index rows = 5 chained atoms (1-based, NOT
    # coordinate offsets) + 1-based type; grids tabulated from -180 deg
    cmap_kw = {}
    pref = ("CMAP" if "CMAP_COUNT" in sec
            else "CHARMM_CMAP" if "CHARMM_CMAP_COUNT" in sec else None)
    if pref is not None:
        nterms, ntyp = sec[f"{pref}_COUNT"][:2]
        res = sec[f"{pref}_RESOLUTION"][:ntyp]
        if len(set(res)) > 1:
            raise ValueError(f"mixed CMAP resolutions {sorted(set(res))} "
                             f"are not supported")
        grids = []
        for t in range(ntyp):
            vals = sec[f"{pref}_PARAMETER_{t + 1:02d}"]
            R = int(res[t])
            grids.append(np.asarray(vals, float).reshape(R, R) * KCAL)
        idx6 = np.asarray(sec[f"{pref}_INDEX"], int).reshape(-1, 6)
        a = idx6[:, :5] - 1
        cmap_kw = dict(
            cmap_idx=np.stack([a[:, 0], a[:, 1], a[:, 2], a[:, 3],
                               a[:, 1], a[:, 2], a[:, 3], a[:, 4]], axis=1),
            cmap_type=idx6[:, 5] - 1, cmap_grids=grids)

    coords = vel = None
    if inpcrd is not None:
        coords, vel, fbox = read_rst7(inpcrd)
        if box is None:
            box = fbox
    if box is None and "BOX_DIMENSIONS" in sec:
        bd = sec["BOX_DIMENSIONS"]
        box = np.asarray(bd[1:4], float) / 10.0
    ifbox = ptr[_PTR["IFBOX"]]
    if ifbox > 1:
        raise ValueError("only rectangular (IFBOX<=1) boxes are supported")
    if method == "auto":
        method = "PME" if box is not None else "NoCutoff"

    gb_radii = gb_scales = None
    if implicit is not None:
        if implicit != "obc2":
            raise ValueError("only implicit='obc2' is supported")
        if "RADII" not in sec:
            raise ValueError("prmtop has no RADII section (re-save with "
                             "tleap `set default PBRadii mbondi2`)")
        gb_radii = np.asarray(sec["RADII"], float) / 10.0
        gb_scales = np.asarray(sec["SCREEN"], float)
        box = None
        method = "NoCutoff"

    system = system_from_tables(
        masses=masses, charges=charges, rmin_half=rmin_half, eps=eps,
        bond_idx=bond_idx, bond_k=bond_k, bond_r0=bond_r0,
        angle_idx=angle_idx, angle_k=angle_k, angle_t0=angle_t0,
        dih_idx=dih_rows[:, :4].astype(np.int32), dih_pk=dih_rows[:, 4],
        dih_phase=dih_rows[:, 5], dih_n=dih_rows[:, 6],
        excl_idx=excl_idx, excl_qq=excl_qq, excl_lj=excl_lj,
        method=method, cutoff=cutoff, box=box,
        gb_radii=gb_radii, gb_scales=gb_scales,
        dense_pairs=dense_pairs, ewald_tol=ewald_tol,
        dispersion_correction=dispersion_correction, device=device,
        **cmap_kw)
    meta = dict(atom_names=sec.get("ATOM_NAME", []),
                amber_types=sec.get("AMBER_ATOM_TYPE", []),
                residue_labels=sec.get("RESIDUE_LABEL", []),
                residue_pointers=sec.get("RESIDUE_POINTER", []),
                velocities=vel)
    return system, coords, meta


# --------------------------------------------------------------------------
# writing
# --------------------------------------------------------------------------

def _wrap(values, per_line, fmt):
    out = []
    for i in range(0, len(values), per_line):
        out.append("".join(fmt % v for v in values[i:i + per_line]))
    if not values:
        out.append("")
    return out


def _flag(name, fortran, values, per_line, fmt):
    return [f"%FLAG {name}", f"%FORMAT({fortran})"] + \
        _wrap(values, per_line, fmt)


def save_prmtop(system, path: str, atom_names=None, amber_types=None,
                residue_labels=None, residue_pointers=None,
                improper_mask=None, title="generated by isokann_tpu"):
    """Write an MDSystem as an Amber prmtop (+ return the text).

    The output is readable by ParmEd/OpenMM/pmemd — the external
    cross-validation hook for the embedded force field.  ``improper_mask``
    (optional, len = n dihedral rows) marks rows written with a negative
    fourth index; without it every row is written as a proper.  Exception
    pairs whose scales cannot ride a dihedral's 1-4 slot (no torsion
    connects them) fall back to full exclusion with a warning."""
    bond_idx = _host(system.bond_idx, int)
    bond_k = _host(system.bond_k, float) / (KCAL * 100.0)
    bond_r0 = _host(system.bond_r0, float) * 10.0
    angle_idx = _host(system.angle_idx, int)
    angle_k = _host(system.angle_k, float) / KCAL
    angle_t0 = _host(system.angle_t0, float)
    dih_idx = _host(system.dih_idx, int)
    dih_pk = _host(system.dih_pk, float) / KCAL
    dih_phase = _host(system.dih_phase, float)
    dih_n = _host(system.dih_n, float)
    charges = _host(system.charges, float)
    rmin_half = _host(system.rmin_half, float) * 10.0
    eps = _host(system.eps, float) / KCAL
    masses = _host(system.masses, float)
    excl_idx = _host(system.excl_idx, int).reshape(-1, 2)
    excl_qq = _host(system.excl_qq, float)
    excl_lj = _host(system.excl_lj, float)
    n = len(masses)

    # LJ types: unique (rmin_half, eps) pairs
    pairs = np.stack([np.round(rmin_half, 8), np.round(eps, 10)], axis=1)
    uniq, tidx = np.unique(pairs, axis=0, return_inverse=True)
    ntypes = len(uniq)
    nbidx = np.zeros((ntypes, ntypes), int)
    acoef, bcoef = [], []
    p = 0
    for i in range(ntypes):
        for j in range(i + 1):
            rmin = uniq[i, 0] + uniq[j, 0]
            e = math.sqrt(uniq[i, 1] * uniq[j, 1])
            acoef.append(e * rmin ** 12)
            bcoef.append(2.0 * e * rmin ** 6)
            p += 1
            nbidx[i, j] = nbidx[j, i] = p

    def param_table(cols):
        """unique rows -> (table rows, 1-based index per input row)"""
        if len(cols[0]) == 0:
            return np.zeros((0, len(cols))), np.zeros(0, int)
        rows = np.stack([np.round(np.asarray(c, float), 9)
                         for c in cols], axis=1)
        u, inv = np.unique(rows, axis=0, return_inverse=True)
        return u, inv + 1

    bt, bp = param_table([bond_k, bond_r0])
    at, ap = param_table([angle_k, angle_t0])

    # dihedral params carry per-term scee/scnb: derive from the exception
    # scales this row is chosen to own
    pend = {}
    for (a, b), wq, wl in zip(excl_idx, excl_qq, excl_lj):
        if wq > 0.0 or wl > 0.0:
            pend[(min(a, b), max(a, b))] = (wq, wl)
    own = np.zeros(len(dih_idx), bool)
    scee = np.full(len(dih_idx), 1.2)
    scnb = np.full(len(dih_idx), 2.0)
    improper = (np.zeros(len(dih_idx), bool) if improper_mask is None
                else np.asarray(improper_mask, bool))
    for r, (i, j, k, l) in enumerate(dih_idx):
        key = (min(i, l), max(i, l))
        if not improper[r] and key in pend:
            wq, wl = pend.pop(key)
            own[r] = True
            scee[r] = 1.0 / wq if wq > 0 else 1e30
            scnb[r] = 1.0 / wl if wl > 0 else 1e30
    if pend:
        # 1-4 pairs whose torsion terms all have zero force constant were
        # dropped from MDSystem (build_system skips pk==0 rows); carry
        # their scales on synthetic zero-k torsions along a real bond path
        adj = [[] for _ in range(n)]
        for (a, b) in bond_idx:
            adj[a].append(int(b))
            adj[b].append(int(a))
        extra = []
        for (i, l), (wq, wl) in sorted(pend.items()):
            j = k = None
            for jj in adj[i]:
                for kk in adj[jj]:
                    if kk != i and l in adj[kk] and kk != l and jj != l:
                        j, k = jj, kk
                        break
                if j is not None:
                    break
            if j is None:                   # no bonded path: any 2 others
                others = [a for a in range(n) if a not in (i, l)]
                j, k = others[0], others[1]
            extra.append((i, j, k, l,
                          1.0 / wq if wq > 0 else 1e30,
                          1.0 / wl if wl > 0 else 1e30))
        if extra:
            e = np.asarray(extra, float)
            dih_idx = np.concatenate([dih_idx,
                                      e[:, :4].astype(int)], axis=0)
            dih_pk = np.concatenate([dih_pk, np.zeros(len(e))])
            dih_phase = np.concatenate([dih_phase, np.zeros(len(e))])
            dih_n = np.concatenate([dih_n, np.ones(len(e))])
            scee = np.concatenate([scee, e[:, 4]])
            scnb = np.concatenate([scnb, e[:, 5]])
            own = np.concatenate([own, np.ones(len(e), bool)])
            improper = np.concatenate([improper, np.zeros(len(e), bool)])
    dt, dp = param_table([dih_pk, dih_phase, dih_n, scee, scnb])

    is_h = masses < 3.5

    def split_h(idx, mask3):
        sel = mask3
        return idx[sel], idx[~sel]

    bh, ba = split_h(np.arange(len(bond_idx)),
                     is_h[bond_idx].any(axis=1)
                     if len(bond_idx) else np.zeros(0, bool))
    ah, aa = split_h(np.arange(len(angle_idx)),
                     is_h[angle_idx].any(axis=1)
                     if len(angle_idx) else np.zeros(0, bool))
    dh, da = split_h(np.arange(len(dih_idx)),
                     is_h[dih_idx].any(axis=1)
                     if len(dih_idx) else np.zeros(0, bool))

    def bond_rows(rows):
        out = []
        for r in rows:
            i, j = bond_idx[r]
            out += [i * 3, j * 3, bp[r]]
        return out

    def angle_rows(rows):
        out = []
        for r in rows:
            i, j, k = angle_idx[r]
            out += [i * 3, j * 3, k * 3, ap[r]]
        return out

    def dih_rows(rows):
        out = []
        for r in rows:
            i, j, k, l = dih_idx[r]
            # a negative mark cannot ride atom index 0; Amber's convention
            # is to reverse the torsion (the angle is reversal-invariant)
            if (not own[r] and k == 0) or (improper[r] and l == 0):
                i, j, k, l = l, k, j, i
            k3 = k * 3 if own[r] else -(k * 3)
            l3 = -(l * 3) if improper[r] else l * 3
            out += [i * 3, j * 3, k3, l3, dp[r]]
        return out

    # excluded-atoms list (every pair, regardless of scale — 1-4s are
    # excluded from the plain nonbonded sum and re-added by their torsion)
    partners = [[] for _ in range(n)]
    for (a, b) in excl_idx:
        partners[min(a, b)].append(max(a, b) + 1)
    nexc, exlist = [], []
    for i in range(n):
        ps = sorted(partners[i])
        if not ps:
            ps = [0]
        nexc.append(len(ps))
        exlist.extend(ps)

    if atom_names is None:
        atom_names = [f"A{i+1}" for i in range(n)]
    if amber_types is None:
        amber_types = [f"t{tidx[i]+1}" for i in range(n)]
    if residue_labels is None:
        residue_labels, residue_pointers = ["SYS"], [1]

    ptrs = [0] * 31
    ptrs[_PTR["NATOM"]] = n
    ptrs[_PTR["NTYPES"]] = ntypes
    ptrs[_PTR["NBONH"]] = len(bh)
    ptrs[_PTR["MBONA"]] = ptrs[12] = len(ba)
    ptrs[_PTR["NTHETH"]] = len(ah)
    ptrs[_PTR["MTHETA"]] = ptrs[13] = len(aa)
    ptrs[_PTR["NPHIH"]] = len(dh)
    ptrs[_PTR["MPHIA"]] = ptrs[14] = len(da)
    ptrs[_PTR["NNB"]] = len(exlist)
    ptrs[_PTR["NRES"]] = len(residue_labels)
    ptrs[_PTR["NUMBND"]] = len(bt)
    ptrs[_PTR["NUMANG"]] = len(at)
    ptrs[_PTR["NPTRA"]] = len(dt)
    ptrs[18] = ntypes                               # NATYP
    ptrs[_PTR["IFBOX"]] = 1 if system.box is not None else 0

    E, I = "%16.8E", "%8d"
    lines = ["%VERSION  VERSION_STAMP = V0001.000"]
    lines += _flag("TITLE", "20a4", [title[:80]], 1, "%s")
    lines += _flag("POINTERS", "10I8", ptrs, 10, I)
    lines += _flag("ATOM_NAME", "20a4",
                   [f"{s:<4.4}" for s in atom_names], 20, "%s")
    lines += _flag("CHARGE", "5E16.8", list(charges * AMBER_CHARGE), 5, E)
    lines += _flag("ATOMIC_NUMBER", "10I8",
                   [_guess_z(m) for m in masses], 10, I)
    lines += _flag("MASS", "5E16.8", list(masses), 5, E)
    lines += _flag("ATOM_TYPE_INDEX", "10I8", list(tidx + 1), 10, I)
    lines += _flag("NUMBER_EXCLUDED_ATOMS", "10I8", nexc, 10, I)
    lines += _flag("NONBONDED_PARM_INDEX", "10I8",
                   list(nbidx.reshape(-1)), 10, I)
    lines += _flag("RESIDUE_LABEL", "20a4",
                   [f"{s:<4.4}" for s in residue_labels], 20, "%s")
    lines += _flag("RESIDUE_POINTER", "10I8", list(residue_pointers), 10, I)
    lines += _flag("BOND_FORCE_CONSTANT", "5E16.8", list(bt[:, 0]), 5, E)
    lines += _flag("BOND_EQUIL_VALUE", "5E16.8", list(bt[:, 1]), 5, E)
    lines += _flag("ANGLE_FORCE_CONSTANT", "5E16.8", list(at[:, 0]), 5, E)
    lines += _flag("ANGLE_EQUIL_VALUE", "5E16.8", list(at[:, 1]), 5, E)
    lines += _flag("DIHEDRAL_FORCE_CONSTANT", "5E16.8", list(dt[:, 0]), 5, E)
    lines += _flag("DIHEDRAL_PERIODICITY", "5E16.8", list(dt[:, 2]), 5, E)
    lines += _flag("DIHEDRAL_PHASE", "5E16.8", list(dt[:, 1]), 5, E)
    lines += _flag("SCEE_SCALE_FACTOR", "5E16.8", list(dt[:, 3]), 5, E)
    lines += _flag("SCNB_SCALE_FACTOR", "5E16.8", list(dt[:, 4]), 5, E)
    lines += _flag("LENNARD_JONES_ACOEF", "5E16.8", acoef, 5, E)
    lines += _flag("LENNARD_JONES_BCOEF", "5E16.8", bcoef, 5, E)
    lines += _flag("BONDS_INC_HYDROGEN", "10I8", bond_rows(bh), 10, I)
    lines += _flag("BONDS_WITHOUT_HYDROGEN", "10I8", bond_rows(ba), 10, I)
    lines += _flag("ANGLES_INC_HYDROGEN", "10I8", angle_rows(ah), 10, I)
    lines += _flag("ANGLES_WITHOUT_HYDROGEN", "10I8", angle_rows(aa), 10, I)
    lines += _flag("DIHEDRALS_INC_HYDROGEN", "10I8", dih_rows(dh), 10, I)
    lines += _flag("DIHEDRALS_WITHOUT_HYDROGEN", "10I8",
                   dih_rows(da), 10, I)
    lines += _flag("EXCLUDED_ATOMS_LIST", "10I8", exlist, 10, I)
    lines += _flag("AMBER_ATOM_TYPE", "20a4",
                   [f"{s:<4.4}" for s in amber_types], 20, "%s")
    if system.gb_radii is not None and system.gb_radii.shape[0] == n:
        lines += _flag("RADII", "5E16.8",
                       list(_host(system.gb_radii) * 10.0), 5, E)
        lines += _flag("SCREEN", "5E16.8",
                       list(_host(system.gb_scales)), 5, E)
    from .cmap import has_cmap
    if has_cmap(system):
        # patch coefficient c[0,0] of each cell IS the grid value, so the
        # raw grids round-trip exactly through the bicubic precompute
        coefs = _host(system.cmap_coefs, float)
        ci = _host(system.cmap_idx, int)
        ct = _host(system.cmap_type, int)
        if not np.array_equal(ci[:, 4:7], ci[:, 1:4]):
            warnings.warn("CMAP terms whose two torsions are not chained "
                          "over 5 atoms cannot be written to prmtop; "
                          "dropping them")
            keep = np.all(ci[:, 4:7] == ci[:, 1:4], axis=1)
            ci, ct = ci[keep], ct[keep]
        ntyp, R = coefs.shape[0], coefs.shape[1]
        lines += _flag("CMAP_COUNT", "2I8", [len(ci), ntyp], 2, I)
        lines += _flag("CMAP_RESOLUTION", "20I4", [R] * ntyp, 20, "%4d")
        for t in range(ntyp):
            lines += _flag(f"CMAP_PARAMETER_{t + 1:02d}", "8(F9.5)",
                           list(coefs[t, :, :, 0, 0].reshape(-1) / KCAL),
                           8, "%9.5f")
        rows = []
        for (r8, t) in zip(ci, ct):
            rows += [r8[0] + 1, r8[1] + 1, r8[2] + 1, r8[3] + 1,
                     r8[7] + 1, t + 1]
        lines += _flag("CMAP_INDEX", "6I8", rows, 6, I)
    if system.box is not None:
        lines += _flag("BOX_DIMENSIONS", "5E16.8",
                       [90.0] + [b * 10.0 for b in system.box], 5, E)
    text = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return text


def write_rst7(path: str, coords, box=None,
               title="generated by isokann_tpu"):
    """Write coordinates (n, 3) [nm] (+ optional box) as an Amber inpcrd."""
    coords = np.asarray(coords, float).reshape(-1, 3) * 10.0
    vals = list(coords.reshape(-1))
    lines = [title, "%5d" % len(coords)]
    if box is not None:
        pass
    for i in range(0, len(vals), 6):
        lines.append("".join("%12.7f" % v for v in vals[i:i + 6]))
    if box is not None:
        lines.append("".join("%12.7f" % (b * 10.0) for b in box)
                     + "".join("%12.7f" % 90.0 for _ in range(3)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


_ELEMENT_MASSES = [(1.008, 1), (4.0, 2), (6.94, 3), (9.01, 4), (10.81, 5),
                   (12.01, 6), (14.01, 7), (16.00, 8), (19.00, 9),
                   (20.18, 10), (22.99, 11), (24.31, 12), (26.98, 13),
                   (28.09, 14), (30.97, 15), (32.06, 16), (35.45, 17),
                   (39.95, 18), (39.10, 19), (40.08, 20), (55.85, 26),
                   (65.38, 30), (79.90, 35), (126.90, 53)]


def _guess_z(mass):
    if mass <= 0:
        return 0
    best = min(_ELEMENT_MASSES, key=lambda mz: abs(mz[0] - mass))
    return best[1] if abs(best[0] - mass) < 1.5 else 0
