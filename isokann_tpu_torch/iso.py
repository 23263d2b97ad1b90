"""The ISOKANN learner: ``Iso`` and its training loop.

Counterpart of ``isokann_tpu/iso.py`` for the shift-scale path.  Where the
reference fuses all Koopman iterations into one ``lax.scan`` program,
this is an eager loop with the same semantics (``iso.py:78-156`` there):

- the dataset is padded to its capacity bucket by repeating rows; a mask
  (1 real, 0 padding) and ``n_true`` keep every loss an average over the
  real rows, and the repeats leave the shift-scale min/max exact;
- each iteration computes the target from the current model (no
  gradient), then runs ``epochs`` epochs of SGD on it;
- full batch when the bucket fits one minibatch (no permutation);
  otherwise a random permutation of the bucket cut into minibatches, with
  the loss scaled by ``cap / n_true``;
- every loss is the per-observation mean; a non-finite loss raises;
- Girsanov-weighted bursts (``WeightedSamples``) give the weighted
  Koopman estimate sum_k w chi / k, as the reference's ``yw`` does.

Adaptive sampling: ``addcoords``, ``resample_kde``, ``resample_strat``
and ``run_kde`` (``iso.py:563-619`` there).
"""

from __future__ import annotations

import time
import warnings
from typing import List

import numpy as np
import scipy.linalg
import torch

from ._device import make_generator
from .data import SimulationData, WeightedSamples, bucket_capacity, pad_rows
from .optim import NesterovRegularized
from .targets import DomainError, TransformShiftscale, expectation


class Iso:
    """Model + optimiser + data + target transform + training loop.

    ``Iso(data)`` or ``Iso(sim=sim, nx=100, nk=5)``; then ``run(n)``."""

    def __init__(self, data=None, sim=None, nx=100, nk=2, model=None,
                 opt=None, target=None, minibatch=100, nout=1, gen=None):
        self.gen = make_generator(gen)
        if data is None:
            if sim is None:
                raise ValueError("Iso needs data or sim")
            data = SimulationData.from_sim(sim, nx=nx, nk=nk, gen=self.gen)
        self.data = data
        device = data.features.device
        if model is None:
            sim_ = getattr(data, "sim", None)
            if sim_ is not None and hasattr(sim_, "defaultmodel"):
                model = sim_.defaultmodel(n=data.featuredim, nout=nout,
                                          gen=self.gen)
            else:
                from .models import autonet
                model = autonet(data.featuredim, nout=nout, gen=self.gen)
        self.model = model.to(device)
        self.opt = opt if opt is not None else NesterovRegularized()
        self.optimizer = self.opt(self.model.parameters())
        if self.model.outputdim != 1:
            raise NotImplementedError("multi-dimensional chi is not ported")
        self.target = target if target is not None else TransformShiftscale()
        self.minibatch = minibatch
        self.losses: List[float] = []

    # ---- evaluation -------------------------------------------------------

    @torch.no_grad()
    def chis(self, data=None):
        """chi at the start points, (n, d)."""
        data = self.data if data is None else data
        return self.model(data.features)

    @torch.no_grad()
    def koopman(self):
        """Koopman expectation of chi over the bursts, (n, d)."""
        return expectation(self.model, self.data.propfeatures)

    def rates(self):
        """Coarse-grained rate matrix Q with Kchi = exp(tau Q) chi."""
        x = self.chis().double().cpu().numpy()
        y = self.koopman().double().cpu().numpy()
        return rates(x, y) / self.data.sim.lagtime

    # ---- training ---------------------------------------------------------

    def run(self, n=1, epochs=1):
        """n Koopman iterations x ``epochs`` epochs of SGD."""
        xs, ys = self.data.features, self.data.propfeatures
        nx = xs.shape[0]
        cap = bucket_capacity(nx)
        device = xs.device
        if isinstance(ys, WeightedSamples):
            ys = WeightedSamples(pad_rows(ys.values, cap),
                                 pad_rows(ys.weights, cap))
        else:
            ys = pad_rows(ys, cap)
        xs = pad_rows(xs, cap)
        mask = torch.zeros(cap, device=device)
        mask[:nx] = 1.0
        n_true = float(nx)
        mb = self.minibatch
        bs = cap if (mb == 0 or cap < mb) else mb
        nb = cap // bs
        losses = []
        for _ in range(n):
            with torch.no_grad():
                kchi = expectation(self.model, ys)
                target = self.target.fused_target(kchi, mask, n_true)
            for _ in range(epochs):
                losses.append(self._epoch(xs, target, mask, n_true, cap, bs,
                                          nb))
        losses = torch.stack(losses).cpu().numpy()
        if not np.all(np.isfinite(losses)):
            raise DomainError(
                "The ISOKANN model collapsed under training. Try reducing "
                "the learning rate or increasing regularization")
        self.losses.extend(losses.tolist())
        return self

    def _step(self, x, y, m, norm):
        self.optimizer.zero_grad(set_to_none=True)
        loss = torch.sum((self.model(x) - y) ** 2 * m[:, None]) / norm
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _epoch(self, xs, target, mask, n_true, cap, bs, nb):
        if nb == 1 and bs == cap:
            # full batch: a permutation would not change the gradient
            return self._step(xs, target, mask, n_true)
        scale = cap / n_true
        perm = torch.randperm(cap, generator=self.gen)[:nb * bs]
        perm = perm.reshape(nb, bs).to(xs.device)
        ls = [self._step(xs[idx], target[idx], mask[idx] * scale, bs)
              for idx in perm]
        return torch.stack(ls).sum() * bs / cap

    # ---- adaptive sampling --------------------------------------------------

    def addcoords(self, coords):
        """Extend the data with new start points (``nk`` bursts each)."""
        self.data = self.data.addcoords(coords, gen=self.gen)
        return self

    def resample_kde(self, ny, **kwargs):
        """Add ``ny`` start points by KDE gap-filling in chi."""
        self.data = self.data.resample_kde(self.model, ny, gen=self.gen,
                                           **kwargs)
        return self

    def resample_strat(self, ny, **kwargs):
        """Add ``ny`` start points stratified uniformly in chi."""
        self.data = self.data.resample_strat(self.model, ny, gen=self.gen,
                                             **kwargs)
        return self

    def run_kde(self, generations=1, iter=100, cutoff=np.inf, kde=1,
                unique=True, showprogress=False):
        """generations x (KDE resampling -> keep the last ``cutoff`` points
        -> ``run(iter)``)."""
        t_kde = t_train = 0.0
        for g in range(generations):
            t0 = time.time()
            self.resample_kde(kde, unique=unique)
            t_kde += time.time() - t0
            if len(self.data) > cutoff:
                self.data = self.data[len(self.data) - int(cutoff):]
            t0 = time.time()
            self.run(iter)
            t_train += time.time() - t0
            if showprogress:
                print(f"[run_kde] gen {g + 1}/{generations} "
                      f"loss={self.losses[-1]:.4g} n={len(self.data)} "
                      f"t_train={t_train:.1f}s t_kde={t_kde:.1f}s",
                      flush=True)
        return self

    def __repr__(self):
        s = (f"Iso(model={self.model.sizes}, "
             f"target={type(self.target).__name__}, "
             f"minibatch={self.minibatch}, data={self.data!r}")
        if self.losses:
            s += f" loss={self.losses[-1]:.3g} (n={len(self.losses)})"
        return s + ")"


def rates(x: np.ndarray, y: np.ndarray):
    """K from least squares chi @ K = kchi, then the matrix log
    (x, y: (n, d) float64).  Eigenvalues escaping (0, 1) are clamped with
    a warning: the rates are then upper bounds."""
    if x.shape[1] == 1:
        x = np.hstack([x, 1.0 - x])
        y = np.hstack([y, 1.0 - y])
    K, *_ = np.linalg.lstsq(x, y, rcond=None)
    K = K.T
    w, V = np.linalg.eig(K)
    order = np.argsort(np.real(w))[::-1]
    rest = w[order[1:]]
    dom_ok = np.real(w[order[0]]) <= 1.0 + 1e-6
    rest_ok = np.all(np.abs(rest) < 1.0) and np.all(np.real(rest) > 0.0)
    if not (dom_ok and rest_ok):
        warnings.warn(
            "fitted Koopman matrix has eigenvalues outside (0, 1) "
            f"({np.real(w).round(5).tolist()}): the slow process is not "
            "resolved at this lag; rates are clamped upper bounds")
    if rest_ok and np.real(w[order[0]]) >= 1.0:
        w = w.copy()
        w[order[0]] = 1.0 - 1e-9
        K = np.real(V @ np.diag(w) @ np.linalg.inv(V))
    elif not rest_ok or np.any(np.real(w) >= 1.0):
        w = np.clip(np.real(w), 1e-12, 1.0 - 1e-9) + 0j
        K = np.real(V @ np.diag(w) @ np.linalg.inv(V))
    return np.real(scipy.linalg.logm(K))
