"""Rigid-water constraints: SHAKE and RATTLE on contiguous TIP3P blocks.

Counterpart of ``isokann_tpu/md/constraints.py`` for its rigid-water fast
path (``_wview``, ``_wset``, ``_shake_water``, ``_rattle_water``,
``shake``, ``rattle``, ``max_violation``): when the waters form one
contiguous (O, H1, H2)* block, as ``md.solvate.solvate`` lays them out,
their three distance constraints (two O-H rods and the H-H distance that
closes the triangle) are relaxed together on a (..., nw, 3, 3) view by
Jacobi sweeps, 25 for SHAKE and 12 for RATTLE, as in the reference.  Each
sweep updates all three constraints of every water at once.

The generic path (``which="HBonds"``, ``"HAngles"``, ``"AllBonds"``:
colored Gauss-Seidel over arbitrary bond constraints) is not ported and
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .solvate import R_HH, R_OH



class ConstraintSet:
    """Rigid TIP3P waters ``water`` ((nw, 3) O, H1, H2 indices) of
    ``system``, relaxed by SHAKE (positions) and RATTLE (velocities)."""

    def __init__(self, system, which=None, water=None, iters: int = 25):
        if which is not None:
            raise NotImplementedError(
                f"constraints {which!r} (the generic bond-constraint "
                f"solver) are not ported; only rigid water is")
        trip = np.asarray(water if water is not None else
                          np.zeros((0, 3)), np.int64).reshape(-1, 3)
        if not len(trip):
            raise ValueError("ConstraintSet needs at least one water")
        lo = trip.min(axis=1)
        rel = trip - lo[:, None]
        stride = int(np.diff(lo)[0]) if len(lo) > 1 else 3
        if not (stride == 3 and np.all(np.sort(rel, axis=1) == [0, 1, 2])
                and np.all(rel == rel[0]) and np.all(np.diff(lo) == 3)):
            raise NotImplementedError(
                "only waters in one contiguous (O, H1, H2)* block are "
                "ported; scattered waters need the generic solver")
        masses = system.masses.detach().cpu().numpy().astype(np.float64)
        self.natoms = len(masses)
        self.wstart = int(lo[0])
        self.nwater = len(trip)
        self.iters = int(iters)
        self.ncons = 3 * self.nwater
        # the constraints as the cyclic block-position pairs (0, 1),
        # (1, 2), (2, 0): the pair vectors are then x - roll(x) along the
        # block; the H-H pair is the one without the oxygen
        o = int(rel[0][0])
        self.pairs = ((0, 1), (1, 2), (2, 0))
        invm = np.zeros(3)
        invm[list(rel[0])] = 1.0 / masses[trip[0]]
        self._np = dict(
            w_invm=invm.astype(np.float32),
            w_r0=np.asarray([R_OH if o in p else R_HH for p in self.pairs],
                            np.float32))
        self._dev = {}

    def on(self, device) -> dict:
        """The per-block tables as tensors on ``device``: inverse masses
        by block position ``w`` (3, 1), and per pair 1/m_i + 1/m_j, twice
        that, r0 and r0^2."""
        key = str(torch.device(device))
        if key not in self._dev:
            w = self._np["w_invm"]
            wsum = np.asarray([w[i] + w[j] for i, j in self.pairs],
                              np.float32)
            r0 = self._np["w_r0"]
            self._dev[key] = {
                k: torch.as_tensor(v, device=device) for k, v in dict(
                    w=w[:, None], wsum=wsum, twsum=2.0 * wsum, r0=r0,
                    r02=r0 ** 2).items()}
        return self._dev[key]

    # -- the water block view ----------------------------------------------

    def _wview(self, arr):
        """(..., 3N) -> (..., nw, 3, 3) view of the water block."""
        lead = arr.shape[:-1]
        a = arr.reshape(*lead, self.natoms, 3)
        s = self.wstart
        return a[..., s:s + 3 * self.nwater, :].reshape(
            *lead, self.nwater, 3, 3)

    def _wset(self, arr, wat):
        """``arr`` with its water block replaced by ``wat``."""
        lead = arr.shape[:-1]
        s = 3 * self.wstart
        e = s + 9 * self.nwater
        return torch.cat([arr[..., :s], wat.reshape(*lead, 9 * self.nwater),
                          arr[..., e:]], dim=-1)

    # Each sweep is about ten whole-tensor operations over every water
    # and all three of its constraints.  With the cyclic pairs, pair a is
    # (a, a + 1): its vector is x_a - x_(a+1), and atom a moves by
    # w_a lam_(a-1) d_(a-1) (second end of pair a - 1) - w_a lam_a d_a
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

    # -- position constraints (SHAKE) -----------------------------------------

    def shake_displacement(self, x_ref, dx, x_lo=None):
        """SHAKE on a displacement: the constrained displacement from flat
        positions ``x_ref`` (..., 3N), which meet the constraints, for the
        unconstrained ``dx``, moving along the bond directions of
        ``x_ref`` (classic SHAKE linearisation), ``iters`` Jacobi sweeps.
        ``x_lo``: the low part of the positions when they are carried as
        a float pair (x_ref + x_lo).

        The same iteration as the reference's SHAKE on positions, carried
        in the displacement: a half drift moves an atom ~1e-3 nm, so the
        displacement keeps ~1e4 times finer bits than positions of a few
        nm, and the velocity recovered from it as dx / (dt/2) does not
        inherit the positions' rounding divided by dt/2 (~1e-4 nm/ps in
        float32 at 2 fs)."""
        t = self.on(dx.device)
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
        return self._wset(dx, dw)

    def shake(self, x_ref, x):
        """Project flat positions ``x`` (..., 3N) onto the constraint
        manifold from ``x_ref`` (``shake_displacement`` of x - x_ref)."""
        return x_ref + self.shake_displacement(x_ref, x - x_ref)

    # -- velocity constraints (RATTLE) ----------------------------------------

    def rattle(self, x, v):
        """Remove the velocity components along the constrained bonds
        (..., 3N), ``max(1, iters // 2)`` Jacobi sweeps."""
        t = self.on(v.device)
        d = self._pairvec(self._wview(x))
        ends = self._ends(t, d)
        den = t["wsum"] * torch.linalg.vecdot(d, d)
        vc = self._wview(v)
        for _ in range(max(1, self.iters // 2)):
            lam = torch.linalg.vecdot(self._pairvec(vc), d) / den
            vc = self._move(vc, lam, ends)
        return self._wset(v, vc)

    def max_violation(self, x) -> float:
        """Largest |r - r0| over the constraints of flat frames ``x``
        (..., 3N), in nm."""
        x = torch.as_tensor(x)
        t = self.on(x.device)
        d = self._pairvec(self._wview(x.reshape(-1, 3 * self.natoms)))
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        return float(torch.max(torch.abs(r - t["r0"])))
