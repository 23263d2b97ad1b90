"""SimulationData, Girsanov-weighted samples and capacity-bucket padding;
counterpart of ``isokann_tpu/data.py`` (``WeightedSamples``, ``lastcat``,
``bootstrap``, trajectory pairs, subsampling, ``SimulationData`` with its
constructors, merging, chi-stratified and KDE resampling, the
trajectory-built datasets and the chi-sorted PDB export) and of the
``bucket_capacity``/``_pad_rows`` helpers of ``isokann_tpu/iso.py``.

Arrays are batch-leading tensors on the simulation's device:
xs (n, d), ys (n, k, d), features (n, f) and (n, k, f); ys and their
features may be ``WeightedSamples`` (values (n, k, ...), weights (n, k)).
Host numpy is used only for host decisions: the byte comparison of
``resample_kde(unique=True)``, the stratified and KDE picks and the ESS
diagnostic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ._device import draw_seed, make_generator


def identity(x):
    return x


@dataclass
class WeightedSamples:
    """Girsanov-reweighted Koopman samples: ``values`` (n, k, ...) and
    their likelihood-ratio ``weights`` (n, k)."""

    values: torch.Tensor
    weights: torch.Tensor

    @property
    def shape(self):
        return self.values.shape

    def __getitem__(self, i):
        return WeightedSamples(self.values[i], self.weights[i])

    def ess(self):
        """Per-start effective sample size (sum w)^2 / sum w^2 over the
        walker axis, (n,) float64 numpy: k for uniform weights, -> 1 when
        one walker dominates."""
        w = self.weights.detach().cpu().double().numpy()
        return (w.sum(-1) ** 2) / ((w * w).sum(-1) + 1e-300)


def values(ys):
    return ys.values if isinstance(ys, WeightedSamples) else ys


def weights(ys):
    return ys.weights if isinstance(ys, WeightedSamples) else None


def _weights_or_ones(ys):
    w = weights(ys)
    if w is None:
        v = values(ys)
        return torch.ones(v.shape[:2], dtype=v.dtype, device=v.device)
    return w


def lastcat(x, y):
    """Concatenate along the batch (leading) axis.  If either side is
    weighted, so is the result, and unweighted rows get weight 1."""
    if isinstance(x, WeightedSamples) or isinstance(y, WeightedSamples):
        return WeightedSamples(
            torch.cat([values(x), values(y)], dim=0),
            torch.cat([_weights_or_ones(x), _weights_or_ones(y)], dim=0))
    return torch.cat([x, y], dim=0)


def flattenfirst(a):
    """(n, k, ...) -> (n k, ...), of the values when weighted."""
    a = values(a)
    return a.reshape((-1,) + tuple(a.shape[2:]))


def flattenlast(a):
    """Keep the first dimension and flatten the rest (the reference's
    ``flattenlast``; with batch-leading arrays ``flattenfirst`` is
    usually the one wanted)."""
    a = values(a)
    return a.reshape(a.shape[0], -1)


def getobs(x, idx):
    """Rows ``idx`` of a tensor, a ``WeightedSamples`` or a tuple of
    them."""
    if isinstance(x, tuple):
        return tuple(getobs(xi, idx) for xi in x)
    return x[idx]


def to_device(tree, device):
    """A nested structure (dict, list, tuple) of tensors and
    ``WeightedSamples`` with every tensor detached and moved to
    ``device``; other leaves unchanged."""
    if isinstance(tree, WeightedSamples):
        return WeightedSamples(to_device(tree.values, device),
                               to_device(tree.weights, device))
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def bucket_capacity(n: int) -> int:
    """Round a dataset size up to its capacity bucket (two per octave:
    8, 12, 16, 24, 32, 48, ...), as the reference's trainer does."""
    if n <= 8:
        return 8
    p = 1 << (n - 1).bit_length()
    return 3 * p // 4 if 3 * p // 4 >= n else p


def pad_rows(a, cap: int):
    """Pad the leading axis to ``cap`` by repeating rows from the front
    (duplicates keep min/max exact; a mask removes them from losses)."""
    n = a.shape[0]
    if n == cap:
        return a
    if n == 0:
        raise ValueError("cannot pad an empty batch")
    reps = -(-(cap - n) // n)
    return torch.cat([a] + [a] * reps, dim=0)[:cap]


def bootstrap(sim, nx, ny, gen=None):
    """Initial data by propagating the sim's start state: nx start points
    from ``sim.randx0`` and ny bursts from each, ``(xs, ys)``."""
    gen = make_generator(gen)
    xs = sim.randx0(nx, gen=gen)
    return xs, sim.propagate(xs, ny, gen=gen)


def data_from_trajectory(xs, reverse=True, stride=1, lag=1):
    """(x, y) pairs of a trajectory ``xs`` (T, d): with ``reverse`` both
    neighbours ``lag`` frames away are Koopman samples (k = 2), else the
    next one (k = 1).  Reference ``src/data.jl:88-100``."""
    xs = torch.as_tensor(xs)
    n = xs.shape[0]
    if reverse:
        rng = torch.arange(lag, n - lag, stride, device=xs.device)
        return xs[rng], torch.stack([xs[rng - lag], xs[rng + lag]], dim=1)
    rng = torch.arange(0, n - lag, stride, device=xs.device)
    return xs[rng], xs[rng + lag][:, None, :]


def data_from_trajectories(xss, **kwargs):
    """``data_from_trajectory`` of each trajectory, concatenated
    (reference ``src/data.jl:113-130``)."""
    datas = [data_from_trajectory(xs, **kwargs) for xs in xss]
    return (torch.cat([d[0] for d in datas], dim=0),
            torch.cat([d[1] for d in datas], dim=0))


def model_bucketed(model, xs):
    """``model(xs)`` without gradient, as host numpy.  The reference pads
    the batch to its capacity bucket so that its compiled forward pass is
    reused as the pool grows; an eager model compiles nothing per shape,
    so nothing is padded here."""
    with torch.no_grad():
        return model(xs).detach().cpu().numpy()


def subsample_inds(model, xs, n, keepedges=True, seed=None):
    """Indices such that ``model(xs[inds])`` is approximately uniform, per
    chi dimension; a (near-)constant chi falls back to uniform random
    picks.  The same ``seed`` gives the same picks, as the JAX package's
    from a key whose last word is that seed."""
    from .sample import subsample_uniformgrid

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        chi = model(xs).detach().cpu().numpy()           # (m, d)
    inds = []
    for j in range(chi.shape[-1]):
        col = chi[:, j]
        lo, hi = col.min(), col.max()
        if hi - lo < 1e-12:
            inds.extend(rng.choice(
                len(col), size=min(n, len(col)), replace=False))
            continue
        inds.extend(subsample_uniformgrid((col - lo) / (hi - lo), n,
                                          keepedges=keepedges, rng=rng))
    return np.asarray(inds, dtype=int)


def subsample(model, data, n, gen=None):
    """``n`` points of ``data`` (a tensor (m, f) or (m, k, f), or an
    (xs, ys) tuple picked by its xs) uniform in ``model``'s chi
    (``subsample_inds``; reference ``src/data.jl:49-58``)."""
    seed = draw_seed(make_generator(gen))
    if isinstance(data, tuple):
        return getobs(data, _index(subsample_inds(model, data[0], n,
                                                  seed=seed), data[0]))
    if data.ndim == 3:
        data = flattenfirst(data)
    return data[_index(subsample_inds(model, data, n, seed=seed), data)]


def subsample_random(data, nx, gen=None):
    """``nx`` distinct observations of ``data`` (a tensor, a
    ``WeightedSamples`` or a tuple of them) drawn uniformly (reference
    ``src/data.jl:141-146``)."""
    first = data[0] if isinstance(data, tuple) else values(data)
    n = first.shape[0]
    if nx > n:
        raise ValueError(f"cannot draw {nx} of {n} observations")
    idx = torch.randperm(n, generator=make_generator(gen))[:nx]
    return getobs(data, idx.to(first.device))


def _index(inds, like):
    return torch.as_tensor(inds, dtype=torch.long, device=like.device)


@dataclass
class SimulationData:
    """Simulation + coordinates + features bundle."""

    sim: Any
    features: torch.Tensor       # (n, f)
    propfeatures: torch.Tensor   # (n, k, f)
    coords: torch.Tensor         # (n, d)
    propcoords: torch.Tensor     # (n, k, d)
    featurizer: Callable

    @classmethod
    def from_sim(cls, sim, nx: int = None, nk: int = None, xs=None,
                 featurizer=None, gen=None):
        """nx start points and nk Koopman bursts from each: for a
        simulation with ``bootstrap_data`` and no bias, its multi-chain
        bootstrap, as the reference takes it; else ``sim.randx0`` (unless
        ``xs`` is given) and ``sim.propagate``."""
        gen = make_generator(gen)
        if xs is None:
            if (hasattr(sim, "bootstrap_data")
                    and getattr(sim, "bias", None) is None):
                feat = (featurizer or getattr(sim, "featurizer", None)
                        or identity)
                xs, ys, fxs, fys = sim.bootstrap_data(nx, nk, featurizer=feat,
                                                      gen=gen)
                return cls(sim, fxs, fys, xs, ys, feat)
            xs = sim.randx0(nx, gen=gen)
        ys = sim.propagate(xs, nk, gen=gen)
        return cls.from_coords(sim, xs, ys, featurizer=featurizer)

    @classmethod
    def from_coords(cls, sim, xs, ys, featurizer=None, features=None):
        """From coordinates, with optional precomputed (fxs, fys).  A
        weighted ys keeps its weights on its features."""
        if featurizer is None:
            featurizer = getattr(sim, "featurizer", None) or identity
        if features is None:
            fys = featurizer(values(ys))
            if isinstance(ys, WeightedSamples):
                fys = WeightedSamples(fys, ys.weights)
            features = (featurizer(xs), fys)
        fxs, fys = features
        if isinstance(fys, WeightedSamples):
            fys = WeightedSamples(fys.values.to(torch.float32),
                                  fys.weights.to(torch.float32))
        else:
            fys = fys.to(torch.float32)
        return cls(sim, fxs.to(torch.float32), fys, xs, ys, featurizer)

    @classmethod
    def from_trajectory(cls, xs, sim=None, featurizer=None, **kwargs):
        """From a (T, d) trajectory through ``data_from_trajectory``
        (``kwargs``); the simulation defaults to an
        ``ExternalSimulation``."""
        from .simulators.base import ExternalSimulation
        sim = ExternalSimulation() if sim is None else sim
        x, y = data_from_trajectory(xs, **kwargs)
        return cls.from_coords(sim, x, y, featurizer=featurizer)

    @property
    def featuredim(self):
        return self.features.shape[-1]

    @property
    def nk(self):
        return values(self.propfeatures).shape[1]

    @property
    def dim(self):
        return self.coords.shape[-1]

    def __len__(self):
        return self.features.shape[0]

    def __getitem__(self, i):
        if isinstance(i, int):
            i = slice(i, i + 1)
        return SimulationData(self.sim, self.features[i],
                              self.propfeatures[i], self.coords[i],
                              self.propcoords[i], self.featurizer)

    def features_of(self, coords):
        """Raw coordinates featurized with this data's featurizer, on its
        device, float32."""
        coords = torch.as_tensor(coords, device=self.features.device)
        return self.featurizer(coords).to(torch.float32)

    @property
    def pdbfile(self):
        return getattr(self.sim, "pdbfile", None)

    # ---- merging & growth ------------------------------------------------

    def merge(self, other: "SimulationData") -> "SimulationData":
        """Both datasets in one, keeping this one's sim and featurizer;
        ``other`` is featurized anew if its featurizer differs."""
        if (other.featurizer is self.featurizer
                or other.featurizer == self.featurizer):
            f2, fy2 = other.features, other.propfeatures
        else:
            f2 = self.featurizer(other.coords).to(torch.float32)
            fy2 = self.featurizer(values(other.propcoords)).to(torch.float32)
            if isinstance(other.propcoords, WeightedSamples):
                fy2 = WeightedSamples(fy2, other.propcoords.weights)
        return SimulationData(
            self.sim, lastcat(self.features, f2),
            lastcat(self.propfeatures, fy2),
            lastcat(self.coords, other.coords),
            lastcat(self.propcoords, other.propcoords), self.featurizer)

    def addcoords(self, coords, gen=None) -> "SimulationData":
        """Propagate new start points under the sim (``nk`` bursts each)
        and append them."""
        new = SimulationData.from_sim(self.sim, xs=coords, nk=self.nk,
                                      featurizer=self.featurizer, gen=gen)
        return self.merge(new)

    def resample_strat(self, model, n, keepedges=False, gen=None):
        """Add ``n`` start points picked among the bursts' end points,
        stratified uniformly in chi (``chistratcoords``)."""
        if n == 0:
            return self
        gen = make_generator(gen)
        xs = self.chistratcoords(model, n, keepedges=keepedges,
                                 seed=draw_seed(gen))
        return self.addcoords(xs, gen=gen)

    def chistratcoords(self, model, n, keepedges=False, seed=None):
        """The bursts' end points picked by ``subsample_inds``."""
        idxs = subsample_inds(model, flattenfirst(self.propfeatures), n,
                              keepedges=keepedges, seed=seed)
        cs = flattenfirst(self.propcoords)
        return cs[torch.as_tensor(idxs, device=cs.device)]

    def resample_kde(self, model, n, bandwidth=0.02, unique=True, gen=None):
        """Add ``n`` start points picked among the bursts' end points so
        that chi over the start points approaches a uniform density
        (``sample.resample_kde_ash``).  ``unique`` drops end points that
        already are start points (byte comparison on the host)."""
        from .sample import resample_kde_ash

        if n == 0:
            return self
        ycoords = flattenfirst(self.propcoords)
        if unique:
            sampled = {c.tobytes() for c in self.coords.cpu().numpy()}
            selinds = np.asarray(
                [i for i, c in enumerate(ycoords.cpu().numpy())
                 if c.tobytes() not in sampled], dtype=int)
            if len(selinds) == 0:
                return self
        else:
            selinds = np.arange(ycoords.shape[0])
        sel = torch.as_tensor(selinds, device=ycoords.device)
        with torch.no_grad():
            chix = model(self.features)[:, 0].cpu().numpy()
            chiy = model(flattenfirst(self.propfeatures)[sel])[:, 0]
            chiy = chiy.cpu().numpy()
        m1 = min(chix.min(), chiy.min())
        m2 = max(chix.max(), chiy.max())
        chix = (chix - m1) / (m2 - m1)
        chiy = (chiy - m1) / (m2 - m1)
        iy = resample_kde_ash(chix, chiy, n, bandwidth=bandwidth)
        pick = torch.as_tensor(selinds[iy], device=ycoords.device)
        return self.addcoords(ycoords[pick], gen=gen)

    def laggedtrajectory(self, n, gen=None):
        """``n`` lagged frames of the simulation from the last start point
        (reference ``src/simulation.jl:267``)."""
        return self.sim.laggedtrajectory(n, x0=self.coords[-1], gen=gen)

    def __repr__(self):
        return (f"SimulationData(sim={type(self.sim).__name__}, "
                f"n={len(self)}, nk={self.nk}, dim={self.dim}, "
                f"featuredim={self.featuredim})")


def mergedata(d1: SimulationData, d2: SimulationData) -> SimulationData:
    return d1.merge(d2)


def addcoords(d: SimulationData, coords, gen=None) -> SimulationData:
    return d.addcoords(coords, gen=gen)


def resample_strat(d: SimulationData, model, n, **kwargs) -> SimulationData:
    return d.resample_strat(model, n, **kwargs)


def resample_kde(d: SimulationData, model, n, **kwargs) -> SimulationData:
    return d.resample_kde(model, n, **kwargs)


def trajectorydata_linear(sim, steps, reverse=False, gen=None, **kwargs):
    """One lagged trajectory of ``steps`` frames from the default start
    state as chain data (reference ``src/simulation.jl:278-283``);
    ``kwargs`` go to ``SimulationData.from_coords``."""
    xs = sim.laggedtrajectory(steps, gen=make_generator(gen))
    x, y = data_from_trajectory(xs, reverse=reverse)
    return SimulationData.from_coords(sim, x, y, **kwargs)


def trajectorydata_bursts(sim, steps, nk, x0=None, gen=None, **kwargs):
    """One lagged trajectory of ``steps`` frames from ``x0`` (default: the
    start state) with ``nk`` Koopman bursts from each frame (reference
    ``src/simulation.jl:291-298``)."""
    gen = make_generator(gen)
    x0 = sim.coords if x0 is None else x0
    xs = sim.laggedtrajectory(steps, x0=x0, gen=gen)
    ys = sim.propagate(xs, nk, gen=gen)
    return SimulationData.from_coords(sim, xs, ys, **kwargs)


def exportdata(data, model, sim, path="out/data.pdb"):
    """The coordinates of ``data`` ((n, d) or (n, k, d)) sorted by
    ``model``'s first chi, with repeated frames dropped (the first of
    equal first coordinates kept), written as a PDB trajectory on
    ``sim.pdbfile``; returns the written frames, host numpy (reference
    ``src/data.jl:159-170``)."""
    from .md.pdbio import write_pdb_traj

    dd = values(data)
    dd = dd.reshape(-1, dd.shape[-1])
    with torch.no_grad():
        ks = torch.as_tensor(model(dd))[:, 0].cpu().numpy()
    dd = dd.detach().cpu().numpy()[np.argsort(ks)]
    _, uniq = np.unique(dd[:, 0], return_index=True)
    dd = dd[np.sort(uniq)]
    write_pdb_traj(path, sim.pdbfile, dd)
    return dd


def exportsorted(iso, path="out/sorted.pdb"):
    """Every start point of ``iso``'s data in order of rising chi,
    each aligned onto the one before (``aligntrajectory``), written as a
    PDB trajectory; returns ``path`` (reference ``src/data.jl:176-183``)."""
    from .md.pdbio import write_pdb_traj
    from .ops.align import aligntrajectory

    order = np.argsort(iso.chis()[:, 0].cpu().numpy())
    xs = iso.data.coords[_index(order, iso.data.coords)]
    write_pdb_traj(path, iso.data.pdbfile, aligntrajectory(xs))
    return path
