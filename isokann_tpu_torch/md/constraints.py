"""Holonomic distance constraints: SHAKE and RATTLE.

Counterpart of ``isokann_tpu/md/constraints.py``: the reference's
constraint selection (``which``: "HBonds", "HAngles", "AllBonds" or
None, explicit ``pairs`` and rigid ``water``), relaxed in two parts, the
water block first, as in the reference:

- **The water block.**  When the waters form one contiguous (O, H1, H2)*
  block of molecule stride 3 (TIP3P) or 4 (a massless fourth site at the
  end of each molecule, which the solver leaves where it is), as
  ``md.solvate.solvate`` lays them out, their three distance constraints
  (two O-H rods and the H-H distance that closes the triangle) are
  relaxed together on a (..., nw, 3, 3) view by Jacobi sweeps, 25 for
  SHAKE and 12 for RATTLE.  Each sweep updates all three constraints of
  every water at once, with no gather or scatter.
- **The generic path.**  Every other constraint (and waters that are not
  one such block, with their three distances) is relaxed by colored
  Gauss-Seidel: the reference's greedy coloring over the sorted
  constraints splits them into classes in which no atom appears twice,
  so the classes are the reference's.  A class is one gather of its
  atoms and one indexed write-back of both ends (indices unique within
  the class: deterministic, no atomics); the classes are swept in order,
  ``iters`` times for SHAKE and ``max(1, iters // 2)`` for RATTLE.

Float32 design notes: SHAKE works on the displacement of a half drift
(``shake_displacement``), not on positions, so that the velocity
recovered from it does not inherit the positions' rounding divided by
dt/2; the positions may carry a low part (a float pair), which enters
the reference bond vectors.  The fixed factors of each update (inverse
masses over their sum, times the reference vectors) are formed once a
call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .solvate import R_HH, R_OH


def _select(system, which, pairs):
    """The reference's generic constraint lengths {(i, j): r0}, i < j:
    bonds by ``which`` (massless sites left out), explicit ``pairs`` and
    HAngles' triangulated angles."""
    masses = system.masses.detach().cpu().numpy()
    bidx = system.bond_idx.detach().cpu().numpy().reshape(-1, 2)
    r0 = system.bond_r0.detach().cpu().numpy()
    is_h = masses < 3.5
    if which in ("HBonds", "HAngles"):
        sel = is_h[bidx[:, 0]] | is_h[bidx[:, 1]]
    elif which == "AllBonds":
        sel = np.ones(len(bidx), bool)
    elif which is None:
        sel = np.zeros(len(bidx), bool)
    else:
        raise ValueError(f"unsupported constraints {which!r}; use "
                         f"'HBonds', 'HAngles', 'AllBonds' or None")
    if len(bidx):
        # massless virtual sites are placed, never constrained
        sel = sel & (masses[bidx[:, 0]] > 0) & (masses[bidx[:, 1]] > 0)
    lens = {tuple(sorted((int(a), int(b)))): float(l)
            for (a, b), l in zip(bidx[sel], r0[sel])}
    for (a, b, d) in (pairs or []):
        lens[tuple(sorted((int(a), int(b))))] = float(d)
    if which == "HAngles":
        # |ac|^2 = r_ab^2 + r_bc^2 - 2 r_ab r_bc cos(theta0) for H-X-H and
        # H-O-X angles, with the O-X bond added where X is heavy
        bond_r0 = {tuple(sorted((int(a), int(b)))): float(l)
                   for (a, b), l in zip(bidx, r0)}
        is_o = (masses > 15.5) & (masses < 16.5)
        aidx = system.angle_idx.detach().cpu().numpy().reshape(-1, 3)
        at0 = system.angle_t0.detach().cpu().numpy()
        for (a, b, c), t0 in zip(aidx, at0):
            a, b, c = int(a), int(b), int(c)
            hxh = is_h[a] and is_h[c]
            hox = is_o[b] and (is_h[a] or is_h[c])
            if not (hxh or hox):
                continue
            rab = bond_r0.get(tuple(sorted((a, b))))
            rbc = bond_r0.get(tuple(sorted((b, c))))
            if rab is None or rbc is None:
                continue
            lens[tuple(sorted((a, c)))] = math.sqrt(
                rab * rab + rbc * rbc - 2.0 * rab * rbc * math.cos(float(t0)))
            if hox and not hxh:
                key = tuple(sorted((a if not is_h[a] else c, b)))
                if key in bond_r0:
                    lens[key] = bond_r0[key]
    return lens


def _water_block(trip):
    """(start, stride, role positions) of waters ``trip`` (nw, 3) that form
    one contiguous block of stride 3 or 4 with a uniform atom order, else
    None."""
    lo = trip.min(axis=1)
    rel = trip - lo[:, None]
    S = int(np.diff(lo)[0]) if len(lo) > 1 else 3
    if (S in (3, 4) and np.all(np.sort(rel, axis=1) == [0, 1, 2])
            and np.all(rel == rel[0]) and np.all(np.diff(lo) == S)
            and rel.max() < S):
        return int(lo[0]), S, rel[0]
    return None


def _colors(ii, jj):
    """The reference's greedy coloring of constraints (ii[k], jj[k]) in
    order: each takes the least color neither of its atoms has yet."""
    color = np.zeros(len(ii), np.int64)
    atom_colors: dict = {}
    for k, (a, b) in enumerate(zip(ii, jj)):
        used = atom_colors.get(a, set()) | atom_colors.get(b, set())
        c = 0
        while c in used:
            c += 1
        color[k] = c
        atom_colors.setdefault(a, set()).add(c)
        atom_colors.setdefault(b, set()).add(c)
    return color


class ConstraintSet:
    """Distance constraints of ``system`` relaxed by SHAKE (positions) and
    RATTLE (velocities).

    ``which``: "HBonds" (bonds with a hydrogen, mass < 3.5), "HAngles"
    (HBonds plus H-X-H and H-O-X angles triangulated into distances;
    ``iters`` at least 50), "AllBonds" or None; ``pairs``: explicit (i, j,
    d) constraints; ``water``: (nw, 3) O, H1, H2 indices of rigid
    waters."""

    def __init__(self, system, which="HBonds", water=None, iters: int = 25,
                 pairs=None):
        lens = _select(system, which, pairs)
        masses = system.masses.detach().cpu().numpy().astype(np.float64)
        self.natoms = len(masses)
        self.which = which
        trip = np.asarray(water if water is not None else
                          np.zeros((0, 3)), np.int64).reshape(-1, 3)
        for (o, h1, h2) in trip:
            lens[tuple(sorted((int(o), int(h1))))] = R_OH
            lens[tuple(sorted((int(o), int(h2))))] = R_OH
            lens[tuple(sorted((int(h1), int(h2))))] = R_HH
        block = _water_block(trip) if len(trip) else None
        self.wstart, self.nwater, self.wstride = None, 0, 3
        # the water block's constraints as the cyclic role-position pairs
        # (0, 1), (1, 2), (2, 0): the pair vectors are then x - roll(x)
        # over the block's first three sites; the H-H pair is the one
        # without the oxygen
        self.pairs = ((0, 1), (1, 2), (2, 0))
        self._np = {}
        if block is not None:
            self.wstart, self.wstride, rel = block
            self.nwater = len(trip)
            o = int(rel[0])
            invm = np.zeros(3)
            invm[list(rel)] = 1.0 / masses[trip[0]]
            self._np = dict(
                w_invm=invm.astype(np.float32),
                w_r0=np.asarray([R_OH if o in p else R_HH
                                 for p in self.pairs], np.float32))
            for (a, b, c) in trip:
                for p in ((a, b), (a, c), (b, c)):
                    lens.pop(tuple(sorted((int(p[0]), int(p[1])))), None)

        items = sorted(lens.items())
        self.idx_i = np.asarray([p[0] for p, _ in items], np.int64)
        self.idx_j = np.asarray([p[1] for p, _ in items], np.int64)
        self.r0 = np.asarray([l for _, l in items], np.float32)
        if which == "HAngles":
            # triangle clusters need more Gauss-Seidel sweeps
            iters = max(iters, 50)
        self.iters = int(iters)
        self.ngeneric = len(items)
        self.ncons = self.ngeneric + 3 * self.nwater
        color = _colors(self.idx_i, self.idx_j)
        self.classes = [np.flatnonzero(color == c)
                        for c in range(int(color.max(initial=-1)) + 1)]
        self._invm = np.where(masses > 0, 1.0 / np.where(masses > 0, masses,
                                                          1.0), 0.0)
        self._dev = {}

    def on(self, device) -> dict:
        """The tables as tensors on ``device``: for the water block, inverse
        masses by role position ``w`` (3, 1) and per pair 1/m_i + 1/m_j,
        twice that, r0 and r0^2; for the generic path, per class the atom
        indices ``idx`` (2m,) (first ends, then second ends), r0^2, the
        inverse masses of both ends over their sum ``wf`` (2, m, 1) (the
        first ends negated) and 1/m_i + 1/m_j."""
        key = str(torch.device(device))
        if key in self._dev:
            return self._dev[key]
        t = {}
        if self.nwater:
            w = self._np["w_invm"]
            wsum = np.asarray([w[i] + w[j] for i, j in self.pairs],
                              np.float32)
            r0 = self._np["w_r0"]
            t.update({k: torch.as_tensor(v, device=device) for k, v in dict(
                w=w[:, None], wsum=wsum, twsum=2.0 * wsum, r0=r0,
                r02=r0 ** 2).items()})
        classes = []
        for ks in self.classes:
            ci, cj = self.idx_i[ks], self.idx_j[ks]
            wi = self._invm[ci].astype(np.float32)
            wj = self._invm[cj].astype(np.float32)
            wsum = wi + wj
            classes.append({k: torch.as_tensor(v, device=device) for k, v in
                            dict(idx=np.concatenate([ci, cj]),
                                 r02=self.r0[ks] ** 2,
                                 wf=np.stack([-wi / wsum, wj / wsum]
                                             )[:, :, None],
                                 wsum=wsum).items()})
        t["classes"] = classes
        t["i"] = torch.as_tensor(self.idx_i, device=device)
        t["j"] = torch.as_tensor(self.idx_j, device=device)
        t["gr0"] = torch.as_tensor(self.r0, device=device)
        self._dev[key] = t
        return t

    # -- the water block view ----------------------------------------------

    def _wview(self, arr):
        """(..., 3N) -> (..., nw, 3, 3) view of the water block's first
        three sites."""
        lead = arr.shape[:-1]
        a = arr.reshape(*lead, self.natoms, 3)
        s, S = self.wstart, self.wstride
        return a[..., s:s + S * self.nwater, :].reshape(
            *lead, self.nwater, S, 3)[..., :3, :]

    def _wset(self, arr, wat):
        """``arr`` with its water block's first three sites replaced by
        ``wat``."""
        lead = arr.shape[:-1]
        s, S = 3 * self.wstart, self.wstride
        e = s + 3 * S * self.nwater
        if S > 3:
            rest = arr[..., s:e].reshape(*lead, self.nwater, S, 3)[..., 3:, :]
            wat = torch.cat([wat, rest], dim=-2)
        return torch.cat([arr[..., :s],
                          wat.reshape(*lead, 3 * S * self.nwater),
                          arr[..., e:]], dim=-1)

    # Each water sweep is about ten whole-tensor operations over every
    # water and all three of its constraints.  With the cyclic pairs,
    # pair a is (a, a + 1): its vector is x_a - x_(a+1), and atom a moves
    # by w_a lam_(a-1) d_(a-1) (second end of pair a - 1) - w_a lam_a d_a
    # (first end of pair a), with the two w d products fixed per call
    # (SHAKE folds its 1 / (2 (w_i + w_j)) into them).

    @staticmethod
    def _pairvec(xw):
        """(..., nw, 3, 3) block positions -> the pair vectors."""
        return xw - torch.roll(xw, -1, dims=-2)

    @staticmethod
    def _ends(t, d, scale=None):
        """The fixed factors of the update along pair vectors d: w_a
        d_(a-1) and w_a d_a for each atom a, each pair's factor times
        ``scale`` (3,) if given."""
        if scale is not None:
            d = d * scale[:, None]
        return t["w"] * torch.roll(d, 1, dims=-2), t["w"] * d

    @staticmethod
    def _move(xw, lam, ends):
        """xw moved by the pair multipliers lam (..., nw, 3)."""
        second, first = ends
        xw = torch.addcmul(xw, torch.roll(lam, 1, dims=-1)[..., None],
                           second)
        return torch.addcmul(xw, lam[..., None], first, value=-1.0)

    # -- the generic path ----------------------------------------------------

    @staticmethod
    def _cvec(a3, c):
        """Class ``c``'s gathered rows (B, 2, m, 3) of (B, n, 3) ``a3``
        (first ends, then second ends) and its pair vectors a_i - a_j."""
        rows = a3.index_select(1, c["idx"]).view(a3.shape[0], 2, -1, 3)
        ri, rj = rows.unbind(1)
        return rows, ri - rj

    def _sweeps(self, a3, classes, fixed, sweeps, multiplier):
        """``sweeps`` colored Gauss-Seidel sweeps of the classes over
        (B, n, 3) ``a3``, in place: each class's rows move by
        ``multiplier(pair vectors, fixed)`` (B, m) along its fixed factors
        (B, 2, m, 3), written back with one indexed copy."""
        for _ in range(sweeps):
            for c, (ref, f) in zip(classes, fixed):
                rows, g = self._cvec(a3, c)
                a3.index_copy_(1, c["idx"], torch.addcmul(
                    rows, multiplier(g, ref, c)[:, None, :, None],
                    f).view(a3.shape[0], -1, 3))
        return a3

    # -- position constraints (SHAKE) -----------------------------------------

    def shake_displacement(self, x_ref, dx, x_lo=None):
        """SHAKE on a displacement: the constrained displacement from flat
        positions ``x_ref`` (..., 3N), which meet the constraints, for the
        unconstrained ``dx``, moving along the bond directions of
        ``x_ref`` (classic SHAKE linearisation): ``iters`` Jacobi sweeps of
        the water block, then ``iters`` colored Gauss-Seidel sweeps of the
        generic constraints.  ``x_lo``: the low part of the positions when
        they are carried as a float pair (x_ref + x_lo).

        The same iteration as the reference's SHAKE on positions, carried
        in the displacement: a half drift moves an atom ~1e-3 nm, so the
        displacement keeps ~1e4 times finer bits than positions of a few
        nm, and the velocity recovered from it as dx / (dt/2) does not
        inherit the positions' rounding divided by dt/2 (~1e-4 nm/ps in
        float32 at 2 fs)."""
        t = self.on(dx.device)
        if self.nwater:
            dref = self._pairvec(self._wview(x_ref))
            if x_lo is not None:
                dref = dref + self._pairvec(self._wview(x_lo))
            ends = self._ends(t, dref, 1.0 / t["twsum"])
            dw = self._wview(dx)
            for _ in range(self.iters):
                d = dref + self._pairvec(dw)
                lam = ((torch.linalg.vecdot(d, d) - t["r02"])
                       / torch.linalg.vecdot(d, dref))
                dw = self._move(dw, lam, ends)
            dx = self._wset(dx, dw)
        if not self.ngeneric:
            return dx
        n = self.natoms
        x3 = x_ref.reshape(-1, n, 3)
        fixed = []
        for c in t["classes"]:
            dref = self._cvec(x3, c)[1]
            if x_lo is not None:
                dref = dref + self._cvec(x_lo.reshape(-1, n, 3), c)[1]
            # c_k / (2 (w_i + w_j) d.dref) moves end i by -w_i/(w_i+w_j)
            # and end j by w_j/(w_i+w_j) of dref / 2
            fixed.append((dref, c["wf"] * (0.5 * dref[:, None])))

        def multiplier(g, dref, c):
            d = g + dref
            return ((torch.linalg.vecdot(d, d) - c["r02"])
                    / torch.linalg.vecdot(d, dref))

        d3 = self._sweeps(dx.reshape(-1, n, 3).clone(), t["classes"], fixed,
                          self.iters, multiplier)
        return d3.reshape(dx.shape)

    def shake(self, x_ref, x):
        """Project flat positions ``x`` (..., 3N) onto the constraint
        manifold from ``x_ref`` (``shake_displacement`` of x - x_ref)."""
        return x_ref + self.shake_displacement(x_ref, x - x_ref)

    # -- velocity constraints (RATTLE) ----------------------------------------

    def rattle(self, x, v):
        """Remove the velocity components along the constrained bonds
        (..., 3N): ``max(1, iters // 2)`` Jacobi sweeps of the water block,
        then as many colored Gauss-Seidel sweeps of the generic
        constraints."""
        t = self.on(v.device)
        sweeps = max(1, self.iters // 2)
        if self.nwater:
            d = self._pairvec(self._wview(x))
            ends = self._ends(t, d)
            den = t["wsum"] * torch.linalg.vecdot(d, d)
            vc = self._wview(v)
            for _ in range(sweeps):
                lam = torch.linalg.vecdot(self._pairvec(vc), d) / den
                vc = self._move(vc, lam, ends)
            v = self._wset(v, vc)
        if not self.ngeneric:
            return v
        n = self.natoms
        x3 = x.reshape(-1, n, 3)
        fixed = []
        for c in t["classes"]:
            d = self._cvec(x3, c)[1]
            # rv / ((w_i + w_j) |d|^2) moves end i by -w_i d, end j by w_j d
            s = (1.0 / torch.linalg.vecdot(d, d))[..., None]
            fixed.append((d, c["wf"] * (d * s)[:, None]))
        v3 = self._sweeps(v.reshape(-1, n, 3).clone(), t["classes"], fixed,
                          sweeps, lambda g, d, c: torch.linalg.vecdot(g, d))
        return v3.reshape(v.shape)

    def max_violation(self, x) -> float:
        """Largest |r - r0| over the constraints of flat frames ``x``
        (..., 3N), in nm."""
        x = torch.as_tensor(x)
        t = self.on(x.device)
        x = x.reshape(-1, 3 * self.natoms)
        worst = 0.0
        if self.nwater:
            d = self._pairvec(self._wview(x))
            r = torch.sqrt(torch.sum(d * d, dim=-1))
            worst = float(torch.max(torch.abs(r - t["r0"])))
        if self.ngeneric:
            x3 = x.reshape(-1, self.natoms, 3)
            d = x3[:, t["i"]] - x3[:, t["j"]]
            r = torch.sqrt(torch.sum(d * d, dim=-1))
            worst = max(worst, float(torch.max(torch.abs(r - t["gr0"]))))
        return worst
