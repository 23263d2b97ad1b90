"""The ISOKANN learner: ``Iso``, its training loops, loggers and
snapshots.

Counterpart of ``isokann_tpu/iso.py``.  Where the reference fuses all
Koopman iterations into one ``lax.scan`` program, this is an eager loop
with the same semantics (``iso.py:60-158`` there):

- the dataset is padded to its capacity bucket by repeating rows; a mask
  (1 real, 0 padding) and ``n_true`` keep every loss an average over the
  real rows, and the repeats leave the shift-scale min/max exact;
- each iteration computes the target from the current model (no
  gradient), then runs ``epochs`` epochs of SGD on it;
- full batch when the bucket fits one minibatch (no permutation);
  otherwise a random permutation of the bucket cut into minibatches, with
  the loss scaled by ``cap / n_true``;
- every loss is the per-observation mean (a sum loss makes ISA collapse);
  a non-finite loss raises;
- a chi of d > 1 dimensions weights each dimension by 1 / (std of its
  target + 1e-12) over the real rows;
- Girsanov-weighted bursts (``WeightedSamples``) give the weighted
  Koopman estimate sum_k w chi / k, as the reference's ``yw`` does.

On the card each optimizer step is replayed from a CUDA graph captured
after ``GRAPH_WARMUP`` eager steps of its input shape (``_StepGraph``):
the same kernels with a few launches, so that training is not bound by
the host's launch rate.

Targets: a fused target (``TransformShiftscale``) is computed on the
device inside the loop, whose losses reach the host once per ``run``.  A
host target (``TransformISA``, the default for d > 1, and the other
transforms of ``targets.py``) goes through ``targets.isotarget``: one
transfer of chi to the host per iteration.

Adaptive sampling: ``addcoords``, ``resample_kde``, ``resample_strat``
and ``run_kde``.  Diagnostics: ``rates``, ``exit_rates``,
``chi_exit_rate``, ``koopman_variance``, ``simulationtime``,
``validationloss`` and the loggers.  Snapshots: ``save`` / ``load``.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, List

import numpy as np
import scipy.linalg
import torch

from ._device import make_generator, resolve_device
from .data import (SimulationData, WeightedSamples, bucket_capacity,
                   pad_rows, values)
from .models import MLP
from .optim import NesterovRegularized
from .targets import (DomainError, TransformISA, TransformShiftscale,
                      expectation, isotarget)
from . import targets as T


# eager optimizer steps of an input shape before its step is captured as
# a CUDA graph (the optimiser's state is created by the first)
GRAPH_WARMUP = 3


class _StepGraph:
    """One optimizer step of ``iso`` (``Iso._eager_step``) captured as a
    CUDA graph over static copies of its inputs.  The graph holds the
    model's parameters, their gradients and the optimiser's state by
    address; the caller copies each step's inputs in and takes a copy of
    the loss out."""

    def __init__(self, iso, x, y, w, m):
        self.x, self.y, self.w, self.m = (t.clone() for t in (x, y, w, m))
        self.norm = torch.ones((), device=x.device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=iso._stream):
            self.loss = iso._eager_step(self.x, self.y, self.w, self.m,
                                        self.norm)

    def __call__(self, x, y, w, m, norm):
        for dst, src in ((self.x, x), (self.y, y), (self.w, w),
                         (self.m, m)):
            dst.copy_(src)
        self.norm.fill_(norm)
        self.graph.replay()
        return self.loss.clone()


# ==========================================================================
# Loggers
# ==========================================================================

@dataclass
class FunctionLogger:
    """Calls ``f(iso)`` every ``logevery`` iterations."""

    f: Callable
    name: str = "logger"
    values: list = field(default_factory=list)
    iters: list = field(default_factory=list)
    logevery: int = 1

    def log(self, iso):
        last = self.iters[-1] if self.iters else 0
        if last + self.logevery > len(iso.losses):
            return
        self.values.append(self.f(iso))
        self.iters.append(len(iso.losses))

    def diagnostic(self):
        return (self.name, self.values[-1] if self.values else None)


@dataclass
class ValidationLossLogger:
    """Validation loss against held-out data (``validationloss``)."""

    data: Any
    losses: list = field(default_factory=list)
    iters: list = field(default_factory=list)
    logevery: int = 10

    def log(self, iso):
        if len(iso.losses) % self.logevery != 0:
            return
        self.losses.append(validationloss(iso, self.data))
        self.iters.append(len(iso.losses))

    def diagnostic(self):
        return ("validation loss", self.losses[-1] if self.losses else None)


def ValidationLogger(valdata, logevery=1):
    """A ``FunctionLogger`` of the validation loss."""
    return FunctionLogger(f=lambda iso: validationloss(iso, valdata),
                          name="validation loss", logevery=logevery)


def _host_model(model):
    """``model`` on host inputs and outputs: float32 numpy."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def f(z):
        z = torch.as_tensor(z, dtype=torch.float32, device=device)
        return model(z).cpu().numpy()

    return f


def validationloss(iso, valdata):
    """Mean squared distance of chi on the validation start points to
    the shift-scaled Kchi on them, with the shift and scale taken over
    the validation and the training Kchi together (1-D chi)."""
    f = _host_model(iso.model)
    c = f(T.features(valdata)).ravel()
    k1 = np.asarray(expectation(f, T.propfeatures(valdata))).ravel()
    k2 = np.asarray(expectation(f, iso.data.propfeatures)).ravel()
    ks = np.concatenate([k1, k2])
    lo, hi = ks.min(), ks.max()
    skc = ((ks - lo) / (hi - lo))[:len(c)]
    return float(np.mean((c - skc) ** 2))


class Iso:
    """Model + optimiser + data + target transform + training loop.

    ``Iso(data)`` or ``Iso(sim=sim, nx=100, nk=5)``; then ``run(n)``.
    ``target`` defaults to ``TransformShiftscale`` for a 1-D chi and
    ``TransformISA`` for ``nout`` > 1; ``loggers`` are called during
    ``run`` and ``validation`` data adds a ``ValidationLossLogger``."""

    def __init__(self, data=None, sim=None, nx=100, nk=2, model=None,
                 opt=None, target=None, minibatch=100, nout=1, gen=None,
                 loggers=None, validation=None):
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
        if target is None:
            target = (TransformShiftscale() if self.model.outputdim == 1
                      else TransformISA())
        self.target = target
        self.minibatch = minibatch
        self.losses: List[float] = []
        self.loggers = list(loggers) if loggers else []
        if validation is not None:
            self.loggers.append(ValidationLossLogger(data=validation))
        self._graph = self._graph_key = self._stream = None
        self._warm = (None, 0)

    # ---- evaluation -------------------------------------------------------

    @torch.no_grad()
    def chis(self, data=None):
        """chi at the start points, (n, d)."""
        data = self.data if data is None else data
        return self.model(T.features(data))

    @torch.no_grad()
    def chicoords(self, xs):
        """chi at raw coordinates (featurized first), (n, d)."""
        xs = torch.as_tensor(xs, dtype=torch.float32,
                             device=self.data.features.device)
        return self.model(self.data.featurizer(xs).to(torch.float32))

    @torch.no_grad()
    def koopman(self):
        """Koopman expectation of chi over the bursts, (n, d)."""
        return expectation(self.model, self.data.propfeatures)

    def chi_kchi(self):
        return T.chi_kchi(self.model, self.data)

    @property
    def coords(self):
        return self.data.coords

    @property
    def features(self):
        return self.data.features

    @property
    def propcoords(self):
        return self.data.propcoords

    @property
    def propfeatures(self):
        return self.data.propfeatures

    def rates(self):
        """Coarse-grained rate matrix Q with Kchi = exp(tau Q) chi."""
        x = self.chis().double().cpu().numpy()
        y = self.koopman().double().cpu().numpy()
        return rates(x, y) / self.data.sim.lagtime

    def exit_rates(self):
        return -np.diag(self.rates())

    def chi_exit_rate(self):
        """The exit rate of Ernst and Weber (2017, chap. 3.3) from the
        affine fit Kchi ~ g1 chi + g2."""
        x, Kx = self.chi_kchi()
        return chi_exit_rate(x.cpu().numpy(), Kx.cpu().numpy(),
                             self.data.sim.lagtime)

    def koopman_variance(self):
        """Variance of chi over the Koopman samples, summed over the chi
        dimensions and divided by d n."""
        vals = values(self.data.propfeatures)
        n, k = vals.shape[:2]
        with torch.no_grad():
            chi = self.model(vals.reshape(n * k, -1)).reshape(n, k, -1)
        chi = chi.cpu().numpy()
        d = chi.shape[-1]
        return float(np.sum((chi - chi.mean(axis=1, keepdims=True)) ** 2)
                     / d / n)

    def simulationtime(self):
        """Total simulated time in the dataset: n k lag."""
        n, k = values(self.data.propfeatures).shape[:2]
        return n * k * self.data.sim.lagtime

    # ---- training ---------------------------------------------------------

    def run(self, n=1, epochs=1):
        """n Koopman iterations x ``epochs`` epochs of SGD.  With loggers,
        the losses reach the host and the loggers run after each
        iteration (a host target) or every ``min(logevery)`` iterations
        (a fused target)."""
        fused = getattr(self.target, "fused", False)
        chunk = n
        if self.loggers:
            chunk = (min([getattr(g, "logevery", 1) for g in self.loggers]
                         + [n]) if fused else 1)
        done = 0
        while done < n:
            c = min(chunk, n - done)
            if fused:
                losses = self._run_fused(c, epochs)
            else:
                losses = [loss for _ in range(c)
                          for loss in self._train_iteration(isotarget(self),
                                                            epochs)]
            self._record(losses)
            done += c
            for logger in self.loggers:
                logger.log(self)
        return self

    def _record(self, losses):
        """Bring the device losses to the host (one transfer) and raise
        on a non-finite one."""
        losses = torch.stack(losses).cpu().numpy()
        if not np.all(np.isfinite(losses)):
            raise DomainError(
                "The ISOKANN model collapsed under training. Try reducing "
                "the learning rate or increasing regularization")
        self.losses.extend(losses.tolist())

    def _padded(self):
        """(xs, mask, n_true, cap, bs, nb) of the bucket-padded data."""
        xs = self.data.features
        nx = xs.shape[0]
        cap = bucket_capacity(nx)
        mask = torch.zeros(cap, device=xs.device)
        mask[:nx] = 1.0
        mb = self.minibatch
        bs = cap if (mb == 0 or cap < mb) else mb
        return pad_rows(xs, cap), mask, float(nx), cap, bs, cap // bs

    def _run_fused(self, n, epochs):
        """n iterations of a fused target; returns the device losses."""
        xs, mask, n_true, cap, bs, nb = self._padded()
        ys = self.data.propfeatures
        if isinstance(ys, WeightedSamples):
            ys = WeightedSamples(pad_rows(ys.values, cap),
                                 pad_rows(ys.weights, cap))
        else:
            ys = pad_rows(ys, cap)
        d = self.model.outputdim
        losses = []
        for _ in range(n):
            with torch.no_grad():
                kchi = expectation(self.model, ys)
                target = self.target.fused_target(kchi, mask, n_true)
                if d > 1:
                    # masked std: over the real rows only
                    m = mask[:, None]
                    mu = torch.sum(target * m, dim=0) / n_true
                    var = torch.sum((target - mu) ** 2 * m, dim=0) / n_true
                    w = 1.0 / (torch.sqrt(var) + 1e-12)
                else:
                    w = torch.ones(1, device=xs.device)
            for _ in range(epochs):
                losses.append(self._epoch(xs, target, w, mask, n_true, cap,
                                          bs, nb))
        return losses

    def _train_iteration(self, target, epochs):
        """``epochs`` epochs against a fixed host target (n, d); returns
        the device losses.  For d > 1 each dimension is weighted by
        1 / (std + 1e-12) of the (unpadded) target, ddof 0."""
        xs, mask, n_true, cap, bs, nb = self._padded()
        target = np.asarray(target, np.float32)
        d = target.shape[-1]
        w = (1.0 / (np.std(target, axis=0) + 1e-12) if d > 1
             else np.ones((1,), np.float32))
        w = torch.as_tensor(w, dtype=torch.float32, device=xs.device)
        target = pad_rows(torch.as_tensor(target, device=xs.device), cap)
        return [self._epoch(xs, target, w, mask, n_true, cap, bs, nb)
                for _ in range(epochs)]

    def _eager_step(self, x, y, w, m, norm):
        self.optimizer.zero_grad(set_to_none=True)
        loss = torch.sum(((self.model(x) - y) * w) ** 2 * m[:, None]) / norm
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _step(self, x, y, w, m, norm):
        """One optimizer step on the minibatch (x, y), loss weights w, row
        weights m and normalizer norm.  On the card, the first
        ``GRAPH_WARMUP`` steps of an input shape run eagerly on a side
        stream (the first creates the optimiser's state); the next is
        captured as a CUDA graph (``_StepGraph``) that replays every later
        step of that shape: the same kernels on the same tensors, with a
        few launches in place of an eager step's ~100.  One graph is kept
        (a run has one shape; the shape changes as the data grows)."""
        if not x.is_cuda:
            return self._eager_step(x, y, w, m, norm)
        key = (tuple(x.shape), tuple(y.shape), tuple(w.shape))
        if self._graph is None or self._graph_key != key:
            if self._warm[0] != key:
                self._graph, self._warm = None, (key, 0)
            if self._warm[1] < GRAPH_WARMUP:
                self._warm = (key, self._warm[1] + 1)
                return self._on_stream(self._eager_step, x, y, w, m, norm)
            self._graph, self._graph_key = _StepGraph(self, x, y, w, m), key
        return self._graph(x, y, w, m, norm)

    def _on_stream(self, fn, *args):
        """``fn(*args)`` on the capture stream, ordered after and before the
        current stream's work."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=args[0].device)
        cur = torch.cuda.current_stream(self._stream.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream), warnings.catch_warnings():
            # a capturable Adam warns when it steps outside a capture
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            out = fn(*args)
        cur.wait_stream(self._stream)
        return out

    def _epoch(self, xs, target, w, mask, n_true, cap, bs, nb):
        if nb == 1 and bs == cap:
            # full batch: a permutation would not change the gradient
            return self._step(xs, target, w, mask, n_true)
        scale = cap / n_true
        perm = torch.randperm(cap, generator=self.gen)[:nb * bs]
        perm = perm.reshape(nb, bs).to(xs.device)
        ls = [self._step(xs[idx], target[idx], w, mask[idx] * scale, bs)
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

    def save(self, path):
        save(path, self)


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


def chi_exit_rate(x, Kx, tau):
    """alpha + beta from the affine least-squares fit Kx ~ g1 x + g2:
    alpha = -log(g1) / tau, beta = alpha g2 / (g1 - 1)."""
    x = np.asarray(x, dtype=np.float64).ravel()
    Kx = np.asarray(Kx, dtype=np.float64).ravel()
    A = np.stack([x, np.ones_like(x)], axis=1)
    (g1, g2), *_ = np.linalg.lstsq(A, Kx, rcond=None)
    alpha = -np.log(g1) / tau
    beta = alpha * g2 / (g1 - 1.0)
    return alpha + beta


# ==========================================================================
# Snapshots
# ==========================================================================

def _cpu(a):
    if isinstance(a, WeightedSamples):
        return WeightedSamples(a.values.cpu(), a.weights.cpu())
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    if isinstance(a, dict):
        return {k: _cpu(v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_cpu(v) for v in a)
    return a


def _to(a, device):
    if isinstance(a, WeightedSamples):
        return WeightedSamples(a.values.to(device), a.weights.to(device))
    return a.to(device)


def save(path, iso):
    """Snapshot of ``iso`` to ``path`` (``torch.save``): the model's and
    the optimiser's state dicts and the data as CPU tensors, the host
    generator's state, the losses, the target and the simulation
    (pickled without its bias)."""
    m = iso.model
    state = dict(
        opt=iso.opt,
        model_spec=dict(sizes=m.sizes, activation=m.activation,
                        lastactivation=m.lastactivation,
                        layernorm=m.layernorm),
        model_state=_cpu(m.state_dict()),
        opt_state=_cpu(iso.optimizer.state_dict()),
        gen_state=iso.gen.get_state(),
        losses=list(iso.losses),
        minibatch=iso.minibatch,
        target=iso.target,
        data=dict(features=_cpu(iso.data.features),
                  propfeatures=_cpu(iso.data.propfeatures),
                  coords=_cpu(iso.data.coords),
                  propcoords=_cpu(iso.data.propcoords),
                  sim=iso.data.sim, featurizer=iso.data.featurizer))
    torch.save(state, path)


def _load_optimizer_state(optimizer, sd):
    """``optimizer.load_state_dict(sd)``, keeping this optimiser's
    ``capturable`` flags (a snapshot taken on the card may load on the
    CPU, and the other way round) with its step counters where they need
    them: on the parameters' device when capturable, else on the CPU."""
    flags = [g.get("capturable") for g in optimizer.param_groups]
    optimizer.load_state_dict(sd)
    for group, flag in zip(optimizer.param_groups, flags):
        if flag is None:
            continue
        group["capturable"] = flag
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(
                    device=p.device if flag else "cpu", dtype=torch.float32)


def load(path, sim=None, device=None):
    """An ``Iso`` from a ``save`` snapshot, on ``device`` (the card unless
    the caller names another).  ``sim`` replaces the saved simulation;
    the saved one must run on ``device``."""
    device = resolve_device(device)
    state = torch.load(path, weights_only=False)
    d = state["data"]
    sim = d["sim"] if sim is None else sim
    sim_device = getattr(sim, "device", device)
    if torch.device(sim_device) != device:
        raise ValueError(f"the simulation runs on {sim_device}, not on "
                         f"{device}: pass sim= built for {device}")
    data = SimulationData(sim, d["features"].to(device),
                          _to(d["propfeatures"], device),
                          d["coords"].to(device),
                          _to(d["propcoords"], device), d["featurizer"])
    model = MLP(**state["model_spec"], device=device)
    model.load_state_dict(state["model_state"])
    gen = torch.Generator()
    gen.set_state(state["gen_state"])
    iso = Iso(data=data, model=model, opt=state["opt"],
              target=state["target"], minibatch=state["minibatch"],
              gen=gen)
    _load_optimizer_state(iso.optimizer, state["opt_state"])
    iso.losses = list(state["losses"])
    return iso
