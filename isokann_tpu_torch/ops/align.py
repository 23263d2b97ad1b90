"""Kabsch alignment, aligned RMSD and pairwise aligned RMSD on tensors;
counterpart of ``isokann_tpu/ops/align.py`` (reference
``src/utils/align.jl``).

A structure is ``(natoms, 3)`` and batches lead: ``(batch, natoms, 3)``;
the ``flat`` forms take ``(..., 3N)`` rows as the data layer stores them.
Optional per-atom ``weights``.  Everything runs batched on the device of
its inputs: the rotation includes the Kabsch determinant sign fix (no
reflections), and ``aligned_rmsd`` takes its rotation from Theobald's
QCP (elementwise arithmetic and one 3 x 3 product per pair) with the
residual summed directly, as the reference does.

``aligntrajectory`` aligns each frame onto its aligned predecessor.  The
reference runs that as a sequential scan; here it is one batched Kabsch
of each raw frame onto the raw frame before it and a running product of
those rotations (Kabsch is equivariant: the rotation of frame t onto
aligned frame t-1 is the running product up to t-1 times the rotation of
raw frame t onto raw frame t-1), taken as a log-depth scan in float64.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_struct(x):
    """(..., 3N) -> (..., N, 3)."""
    return x.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // 3, 3))


def _weights_and_sum(weights, n, x):
    if weights is None:
        return torch.ones(n, dtype=x.dtype, device=x.device), float(n)
    w = torch.as_tensor(weights, dtype=x.dtype, device=x.device)
    return w, w.sum()


def centered(x, weights=None):
    """Remove the (weighted) centroid; x: (..., N, 3)."""
    x = torch.as_tensor(x)
    w, ws = _weights_and_sum(weights, x.shape[-2], x)
    return x - torch.sum(x * w[:, None], dim=-2, keepdim=True) / ws


def kabsch_rotation(x, y, weights=None):
    """Proper rotation R minimizing |R y - x| for centered structures
    x, y: (..., N, 3).  Returns (..., 3, 3) in x's dtype; the 3 x 3 SVD
    runs in float64 (as ``aligned_rmsd``'s rotation: more exact, and on
    the card one set of solver kernels for both dtypes)."""
    w, _ = _weights_and_sum(weights, x.shape[-2], x)
    h = (x * w[:, None]).transpose(-1, -2) @ y               # (..., 3, 3)
    u, _, vt = torch.linalg.svd(h.double())
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones(det.shape + (2,), dtype=u.dtype,
                              device=u.device), det[..., None]], dim=-1)
    return ((u * d[..., None, :]) @ vt).to(x.dtype)


def _pair(x, ys, flat):
    x, ys = torch.as_tensor(x), torch.as_tensor(ys)
    return (_as_struct(x), _as_struct(ys)) if flat else (x, ys)


def align(x, ys, weights=None, flat=True):
    """Align every structure of ``ys`` onto ``x``.  flat=True: x (3N,),
    ys (..., 3N); flat=False: x (N, 3), ys (..., N, 3)."""
    xs_, ys_ = _pair(x, ys, flat)
    w, ws = _weights_and_sum(weights, xs_.shape[-2], xs_)
    mx = torch.sum(xs_ * w[:, None], dim=-2, keepdim=True) / ws
    yc = centered(ys_, weights)
    r = kabsch_rotation(xs_ - mx, yc, weights)
    out = yc @ r.transpose(-1, -2) + mx
    return out.reshape(torch.as_tensor(ys).shape) if flat else out


def _qcp_lambda_max(h, ga, gb, iters=40):
    """Largest eigenvalue of the 4 x 4 quaternion key matrix of the 3 x 3
    correlation ``h`` (Theobald's characteristic quartic, Newton from
    (ga + gb) / 2, which converges monotonically to the largest root):
    the maximum over proper rotations only."""
    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]

    sxx2, syy2, szz2 = sxx * sxx, syy * syy, szz * szz
    sxy2, syx2 = sxy * sxy, syx * syx
    sxz2, szx2 = sxz * sxz, szx * szx
    syz2, szy2 = syz * syz, szy * szy

    c2 = -2.0 * (sxx2 + syy2 + szz2 + sxy2 + syx2 + sxz2 + szx2
                 + syz2 + szy2)
    c1 = 8.0 * (sxx * syz * szy + syy * szx * sxz + szz * sxy * syx
                - sxx * syy * szz - syz * szx * sxy - szy * syx * sxz)

    sxzpszx, sxzmszx = sxz + szx, sxz - szx
    syzpszy, syzmszy = syz + szy, syz - szy
    sxypsyx, sxymsyx = sxy + syx, sxy - syx
    sxxpsyy, sxxmsyy = sxx + syy, sxx - syy
    a = sxy2 + sxz2 - syx2 - szx2
    b = syy2 + szz2 - sxx2 + syz2 + szy2
    c = 2.0 * (syz * szy - syy * szz)
    c0 = (a * a + (b + c) * (b - c)
          + (-sxzpszx * syzmszy + sxymsyx * (sxxmsyy - szz))
          * (-sxzmszx * syzpszy + sxymsyx * (sxxmsyy + szz))
          + (-sxzpszx * syzpszy - sxypsyx * (sxxpsyy - szz))
          * (-sxzmszx * syzmszy - sxypsyx * (sxxpsyy + szz))
          + (sxypsyx * syzpszy + sxzpszx * (sxxmsyy + szz))
          * (-sxymsyx * syzmszy + sxzpszx * (sxxpsyy + szz))
          + (sxypsyx * syzmszy + sxzmszx * (sxxmsyy - szz))
          * (-sxymsyx * syzpszy + sxzmszx * (sxxpsyy - szz)))

    lam = 0.5 * (ga + gb)
    for _ in range(iters):
        lam2 = lam * lam
        p = lam2 * lam2 + c2 * lam2 + c1 * lam + c0
        dp = lam * (4.0 * lam2 + 2.0 * c2) + c1
        ok = torch.abs(dp) > 1e-30
        lam = lam - torch.where(ok, p / torch.where(ok, dp, 1.0), 0.0)
    return lam


def _qcp_rotation(h, ga, gb, iters=40):
    """Optimal proper rotation R (..., 3, 3) from the 3 x 3 correlation
    ``h``: the key matrix's eigenvector for lambda_max, read off the
    best-conditioned column of the adjugate of (K - lam I), as a
    quaternion.  The convention of ``kabsch_rotation`` (R y onto x)."""
    lam = _qcp_lambda_max(h, ga, gb, iters)
    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]

    k00 = sxx + syy + szz - lam
    k11 = sxx - syy - szz - lam
    k22 = syy - sxx - szz - lam
    k33 = szz - sxx - syy - lam
    k01, k02, k03 = syz - szy, szx - sxz, sxy - syx
    k12, k13, k23 = sxy + syx, szx + sxz, syz + szy

    A = torch.stack([k00, k01, k02, k03,
                     k01, k11, k12, k13,
                     k02, k12, k22, k23,
                     k03, k13, k23, k33], dim=-1)
    A = A.reshape(tuple(A.shape[:-1]) + (4, 4))

    def minor(i, j):
        r = [k for k in range(4) if k != i]
        c = [k for k in range(4) if k != j]
        m = A[..., r, :][..., :, c]
        return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                                - m[..., 1, 2] * m[..., 2, 1])
                - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                                  - m[..., 1, 2] * m[..., 2, 0])
                + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                                  - m[..., 1, 1] * m[..., 2, 0]))

    # adj(A) = c q q^T for the singular symmetric A: column j is q scaled
    # by c q_j; take the one of largest norm
    cols = torch.stack([torch.stack([((-1) ** (i + j)) * minor(j, i)
                                     for i in range(4)], dim=-1)
                        for j in range(4)], dim=-1)          # (..., 4, 4)
    nsq = torch.sum(cols * cols, dim=-2)
    onehot = torch.nn.functional.one_hot(torch.argmax(nsq, dim=-1),
                                         4).to(cols.dtype)
    q = torch.sum(cols * onehot[..., None, :], dim=-1)       # (..., 4)
    nrm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    # a degenerate adjugate (several optimal rotations): the identity,
    # since the residual does not depend on the rotation there
    e0 = torch.zeros_like(q)
    e0[..., 0] = 1.0
    q = torch.where(nrm > 1e-20, q / torch.where(nrm > 1e-20, nrm, 1.0), e0)

    # the conjugate quaternion: the key matrix's eigenvector rotates x
    # onto y
    w, x, y, z = q[..., 0], -q[..., 1], -q[..., 2], -q[..., 3]
    r00 = w * w + x * x - y * y - z * z
    r11 = w * w - x * x + y * y - z * z
    r22 = w * w - x * x - y * y + z * z
    r01, r02 = 2 * (x * y - w * z), 2 * (x * z + w * y)
    r10, r12 = 2 * (x * y + w * z), 2 * (y * z - w * x)
    r20, r21 = 2 * (x * z - w * y), 2 * (y * z + w * x)
    R = torch.stack([r00, r01, r02, r10, r11, r12, r20, r21, r22], dim=-1)
    return R.reshape(tuple(R.shape[:-1]) + (3, 3))


def aligned_rmsd(x, ys, weights=None, flat=True):
    """RMSD of ``x`` to each structure of ``ys`` after optimal alignment:
    the QCP rotation, then the residual summed directly (no
    ga + gb - 2 lam cancellation, so rmsd(x, x) is ~float eps).  The
    rotation (the quartic's root and the key matrix's adjugate, a few
    hundred operations a pair) is taken in float64: in float32 the
    adjugate of a nearly exact fit loses digits, and a rotated copy of a
    20-atom structure came out 3e-5 nm from itself."""
    xs_, ys_ = _pair(x, ys, flat)
    w, ws = _weights_and_sum(weights, xs_.shape[-2], xs_)
    xc = xs_ - torch.sum(xs_ * w[:, None], dim=-2, keepdim=True) / ws
    yc = centered(ys_, weights)
    xw = xc * w[:, None]
    h = xw.transpose(-1, -2) @ yc                            # (..., 3, 3)
    ga = torch.sum(xw * xc, dim=(-1, -2))
    gb = torch.sum(yc * yc * w[:, None], dim=(-1, -2))
    r = _qcp_rotation(h.double(), ga.double(), gb.double()).to(xc.dtype)
    d = xc - yc @ r.transpose(-1, -2)
    return torch.sqrt(torch.sum(d * d * w[:, None], dim=(-1, -2)) / ws)


def aligned_rmsd_one_to_many(x, ys, weights=None):
    """The distance of picking: x (3N,), ys (m, 3N) -> (m,)."""
    return aligned_rmsd(x, ys, weights=weights)


def pairwise_aligned_rmsd(xs, mask=None, weights=None, memsize=1_000_000_000):
    """All-pairs aligned RMSD of the (n, 3N) rows ``xs``, or of the pairs
    where the boolean ``mask`` is set: a dense (n, n) float64 numpy matrix
    with NaN elsewhere and 0 on the diagonal.  The pairs go through
    ``aligned_rmsd`` in batches of about ``memsize`` bytes of structures."""
    xs = torch.as_tensor(xs)
    n = xs.shape[0]
    if mask is None:
        i, j = np.triu_indices(n, k=1)
    else:
        i, j = np.nonzero(np.asarray(mask))
    out = np.full((n, n), np.nan, dtype=np.float64)
    np.fill_diagonal(out, 0.0)
    natoms = xs.shape[1] // 3
    batch = max(1, int(memsize // max(xs.element_size() * 3 * natoms * 2,
                                      1)))
    ti = torch.as_tensor(i, device=xs.device)
    tj = torch.as_tensor(j, device=xs.device)
    for lo in range(0, len(i), batch):
        sl = slice(lo, lo + batch)
        d = aligned_rmsd(xs[ti[sl]].reshape(-1, natoms, 3),
                         xs[tj[sl]].reshape(-1, natoms, 3),
                         weights=weights, flat=False)
        d = d.double().cpu().numpy()
        out[i[sl], j[sl]] = d
        out[j[sl], i[sl]] = d
    return out


def _running_product(r):
    """Inclusive prefix product r[0] r[1] ... r[t] of (T, 3, 3), by
    log-depth doubling (Hillis-Steele)."""
    d = 1
    while d < r.shape[0]:
        r = torch.cat([r[:d], r[:-d] @ r[d:]], dim=0)
        d *= 2
    return r


def aligntrajectory(traj, weights=None):
    """Each frame of ``traj`` (T, 3N) aligned onto its aligned
    predecessor, the first one centered (reference
    ``src/utils/align.jl:123-130``)."""
    traj = torch.as_tensor(traj)
    c = centered(_as_struct(traj).double(), weights)         # (T, N, 3)
    if c.shape[0] > 1:
        s = _running_product(kabsch_rotation(c[:-1], c[1:], weights))
        c = torch.cat([c[:1], c[1:] @ s.transpose(-1, -2)], dim=0)
    return c.to(traj.dtype).reshape(traj.shape)
