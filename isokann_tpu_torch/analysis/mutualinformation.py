"""Mutual information between each feature and chi by a gridded 2-D
Gaussian KDE; counterpart of ``isokann_tpu/analysis/mutualinformation.py``
(reference ``src/utils/mutualinformation.jl``), batched over features on
the data's device, in chunks that bound the memory.

The estimate is computed in float64 and returned in float32: it is a
small difference of large sums (an MI of ~0.02 from ~1e4 grid cells),
and a float32 evaluation is ~1e-4 off (both packages' float32 code paths
disagree with float64 by 1e-4-3e-4 relative on independent samples)."""

from __future__ import annotations

import math

import torch

from .._device import as_tensor

# elements of one chunk's (features, samples, grid) kernel table
_CHUNK_ELEMENTS = 1 << 25


def _grid(v, gridsize):
    """(..., gridsize) grids over the last axis of ``v``, padded by 1e-6
    of the range."""
    lo = v.min(dim=-1, keepdim=True).values
    hi = v.max(dim=-1, keepdim=True).values
    pad = 1e-6 * (hi - lo + 1e-6)
    u = torch.linspace(0.0, 1.0, gridsize, dtype=v.dtype, device=v.device)
    return (lo - pad) + u * ((hi + pad) - (lo - pad))


def _kernel(v, g, bw):
    """Gaussian kernel table (..., n, gridsize) of samples ``v``
    (..., n) on the grids ``g`` (..., gridsize), bandwidths ``bw`` (...,
    1)."""
    bw = bw[..., None]
    return (torch.exp(-0.5 * ((g[..., None, :] - v[..., :, None]) / bw)
                      ** 2) / (bw * math.sqrt(2 * math.pi)))


def _silverman(v):
    n = v.shape[-1]
    return 1.06 * torch.std(v, dim=-1, correction=0,
                            keepdim=True) * n ** (-1 / 5) + 1e-9


def _kde_mi_batch(x, ys, gridsize, bandwidth):
    """MI of ``x`` (n,) with each row of ``ys`` (F, n)."""
    n = x.shape[0]
    xg, yg = _grid(x, gridsize), _grid(ys, gridsize)     # (G,), (F, G)
    dx = xg[1] - xg[0]
    dy = (yg[:, 1] - yg[:, 0])[:, None, None]
    if bandwidth is None:
        bx, by = _silverman(x), _silverman(ys)
    else:
        bx = torch.full((1,), float(bandwidth), dtype=x.dtype,
                        device=x.device)
        by = torch.full((ys.shape[0], 1), float(bandwidth), dtype=x.dtype,
                        device=x.device)
    kx = _kernel(x, xg, bx)                               # (n, G)
    ky = _kernel(ys, yg, by)                              # (F, n, G)
    pxy = torch.einsum("ng,fnh->fgh", kx, ky) / n         # (F, Gx, Gy)
    px = torch.sum(pxy, dim=2, keepdim=True) * dy
    py = torch.sum(pxy, dim=1, keepdim=True) * dx
    ratio = pxy / (px * py + 1e-30)
    integrand = torch.where(pxy > 0, pxy * torch.log(ratio + 1e-30),
                            torch.zeros_like(pxy))
    return torch.sum(integrand, dim=(1, 2)) * dx * dy[:, 0, 0]


def kde_mi(x, y, gridsize=100, bandwidth=None):
    """Mutual information of two samples by a gridded 2-D Gaussian KDE,
    bandwidths by Silverman's rule (population standard deviation)
    unless given (reference ``kde_mi``,
    ``src/utils/mutualinformation.jl:3-22``).  Tensors stay on their
    device; a 0-d float32 tensor."""
    x = as_tensor(x, torch.float64).ravel()
    y = as_tensor(y, torch.float64, device=x.device).to(x.device).ravel()
    return _kde_mi_batch(x, y[None, :], gridsize, bandwidth)[0].to(
        torch.float32)


def mutual_information(iso, gridsize=100, **kwargs):
    """MI of each feature of ``iso``'s start points with chi (reference
    ``mutual_information``, ``src/utils/mutualinformation.jl:24-29``):
    (nfeatures,) on the data's device."""
    f = iso.data.features                                 # (n, F)
    c = iso.chis()[:, 0].to(torch.float64)
    n, nf = f.shape
    chunk = max(1, _CHUNK_ELEMENTS // max(n * gridsize, 1))
    ys = f.to(torch.float64).T.contiguous()
    return torch.cat([_kde_mi_batch(c, ys[lo:lo + chunk], gridsize,
                                    kwargs.get("bandwidth"))
                      for lo in range(0, nf, chunk)]).to(torch.float32)
