"""MDSimulation: molecular dynamics of a small vacuum system on one GPU.

Counterpart of ``isokann_tpu/simulators/mdsim.py`` for the plain
LangevinMiddle path.  Defaults mirror the reference: 310 K, friction 1/ps,
2 fs steps, 100 steps per Koopman lag, auto cutoff method, the bundled
alanine dipeptide.

Every unbiased propagation goes through
``md.langevin_kernel.langevin_middle``: on the card that is the
hand-written CUDA kernel (any batch size, B = 1 included), on the CPU its
plain PyTorch version.  On the card the kernel takes systems of up to 64
atoms and raises for larger ones.

With a ``bias`` (``md.integrators.optcontrol``), ``propagate`` runs
Girsanov-weighted ABOBA and returns ``WeightedSamples``: on the card
through ``md.girsanov_kernel.aboba_girsanov`` (the hand-written kernel,
any batch size) when the bias's chi model is one the kernel takes, and
raising otherwise; on the CPU through the plain recursion
``md.integrators.aboba_girsanov`` with the bias callable.  As in the
reference, biased walkers that diverge are not retried.

GBSA, constraints, virtual sites, Ewald, a biased ``trajectory`` and the
Brownian integrator are not ported.
"""

from __future__ import annotations

import warnings

import torch

from .._device import make_generator, resolve_device
from ..data import WeightedSamples
from ..features import FeaturesAll, default_featurizer
from ..md import girsanov_kernel as GK
from ..md import integrators as I
from ..md import langevin_kernel as LK
from ..md.pdbio import read_pdb
from ..md.system import build_system
from .base import IsoSimulation


class MDSimulation(IsoSimulation):
    """Batched molecular dynamics with the reference's interface.

    - pdb: path to a PDB file (default: bundled alanine dipeptide)
    - steps: integrator steps per Koopman lag
    - temp [K], friction [1/ps], step [ps]
    - features: None (all pairs under 100 atoms) or a callable
    - method/cutoff: nonbonded method ("auto": CutoffPeriodic with a box,
      CutoffNonPeriodic without)
    - bias: optional ``bias(x, t, sigma, F) -> u`` (sigma-scaled), e.g.
      ``optcontrol(iso)``: ``propagate`` then returns Girsanov-weighted
      ``WeightedSamples``
    - device: where walkers live; default "cuda", raising without a GPU
    """

    def __init__(self, pdb=None, steps: int = 100, temp: float = 310.0,
                 friction: float = 1.0, step: float = 0.002, features=None,
                 method: str = "auto", cutoff: float = 1.0, bias=None,
                 device=None):
        self.device = resolve_device(device)
        self.bias = bias
        if pdb is None:
            from ..md.fixtures import alanine_dipeptide_pdb
            pdb = alanine_dipeptide_pdb()
        self.pdbfile = pdb
        self.steps = int(steps)
        self.temp = float(temp)
        self.friction = float(friction)
        self.step = float(step)
        self.structure = read_pdb(pdb)
        self.system = build_system(pdb, method=method, cutoff=cutoff,
                                   device=self.device)
        self.masses3 = torch.repeat_interleave(self.system.masses, 3)
        self.plan = LK.LangevinPlan(self.system, self.temp, self.friction,
                                    self.step)
        self._x0 = torch.as_tensor(self.structure.coords.reshape(-1),
                                   dtype=torch.float32, device=self.device)
        self.featurizer = default_featurizer(self.natoms, features)

    # ---- accessors ---------------------------------------------------------

    @property
    def natoms(self):
        return self.system.natoms

    @property
    def dim(self):
        return 3 * self.natoms

    @property
    def lagtime(self):
        """Physical lag in ps."""
        return self.steps * self.step

    @property
    def coords(self):
        return self._x0

    def defaultmodel(self, n=None, nout=1, gen=None, **kwargs):
        from ..models import autonet
        return autonet(n if n is not None else self.dim, nout=nout, gen=gen,
                       **kwargs).to(self.device)

    def random_velocities(self, gen, shape):
        return I.maxwell_boltzmann(gen, self.masses3, self.temp, shape)

    # ---- propagation -------------------------------------------------------

    def _integrate(self, x, v, nsteps, gen):
        """LangevinMiddle for (B, 3N) walkers: the kernel on the card, its
        plain version on the CPU."""
        return LK.langevin_middle(self.plan, x, v, nsteps, gen)

    def _run(self, xs, nsteps, gen):
        v0 = self.random_velocities(gen, xs.shape)
        return self._integrate(xs, v0, nsteps, gen)[0]

    def _girsanov(self, xs, p0, nsteps, gen):
        """Biased ABOBA for (B, 3N) walkers -> (q, logw).  On the card an
        ``optcontrol`` bias whose chi model the kernel takes runs in the
        Girsanov kernel, any other bias raises; on the CPU the plain
        recursion runs with the bias callable."""
        spec = getattr(self.bias, "optcontrol_spec", None)
        if xs.device.type == "cpu":
            q, _, logw = I.aboba_girsanov(
                lambda z: LK.forces(self.plan, z), self.bias, xs, p0,
                self.masses3, self.temp, self.friction, self.step, nsteps,
                gen)
            return q, logw
        if spec is None or not self.kernel_takes_bias():
            raise NotImplementedError(
                f"no Girsanov kernel on {xs.device} for this bias: the "
                f"card takes optcontrol biases over FeaturesAll with a "
                f"sigmoid / identity MLP chi model")
        plan = GK.GirsanovPlan.for_model(self.plan, spec["model"],
                                         spec["forcescale"])
        q, _, logw = GK.aboba_girsanov(
            plan, spec["model"], xs, p0, nsteps, spec["b"], spec["qrate"],
            spec["Tmax"], gen)
        return q, logw

    def kernel_takes_bias(self) -> bool:
        """Whether the Girsanov kernel computes ``self.bias``: an
        ``optcontrol`` bias over ``FeaturesAll`` whose chi model is a
        sigmoid / identity MLP over all pair distances (any LayerNorm),
        for a system of at most 64 atoms."""
        spec = getattr(self.bias, "optcontrol_spec", None)
        return (spec is not None
                and isinstance(spec["featurizer"], FeaturesAll)
                and GK.takes_model(spec["model"], self.plan.np)
                and self.natoms <= LK.MAX_ATOMS)

    def propagate(self, x0, nk, gen=None, steps=None):
        """(n, 3N) -> (n, nk, 3N) Koopman bursts: all n*nk walkers in one
        launch.  The walker count is padded to a power of two (>= 8), as
        in the reference; walkers that diverge are retried up to three
        times with fresh noise, then fall back to their start state.

        With a bias: ``WeightedSamples`` of the bursts (n, nk, 3N) and
        their Girsanov weights exp(logw) (n, nk), from momenta drawn from
        the Maxwell-Boltzmann distribution; no retry."""
        gen = make_generator(gen)
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        n, d = x0.shape
        nsteps = self.steps if steps is None else int(steps)
        xs = torch.repeat_interleave(x0, nk, dim=0)
        nw = n * nk
        bucket = max(8, 1 << (nw - 1).bit_length())
        if bucket != nw:
            xs = torch.cat([xs, xs[-1:].expand(bucket - nw, d)], dim=0)
        if self.bias is not None:
            p0 = self.random_velocities(gen, xs.shape) * self.masses3
            q, logw = self._girsanov(xs, p0, nsteps, gen)
            return WeightedSamples(q[:nw].reshape(n, nk, d),
                                   torch.exp(logw[:nw]).reshape(n, nk))
        ys = self._run(xs, nsteps, gen)[:nw]
        for _ in range(3):
            bad = ~torch.isfinite(ys).all(dim=-1)
            if not bool(bad.any()):
                break
            retry = self._run(xs, nsteps, gen)[:nw]
            ys = torch.where(bad[:, None], retry, ys)
        bad = ~torch.isfinite(ys).all(dim=-1)
        if bool(bad.any()):
            warnings.warn(f"{int(bad.sum())} walkers diverged after "
                          f"retries; falling back to their start states")
            ys = torch.where(bad[:, None], xs[:nw], ys)
        return ys.reshape(n, nk, d)

    def trajectory(self, steps=None, saveevery=1, x0=None,
                   sample_velocities=True, resample_velocities=False,
                   gen=None):
        """(nsave, 3N) single-walker trajectory, one kernel launch (B = 1)
        per saved frame.  Stops early with a warning if it diverges.
        Unbiased only: a biased trajectory is not ported."""
        if self.bias is not None:
            raise NotImplementedError("a biased trajectory is not ported")
        gen = make_generator(gen)
        steps = self.steps if steps is None else int(steps)
        x = (self._x0 if x0 is None else torch.as_tensor(
            x0, dtype=torch.float32, device=self.device)).reshape(1, -1)
        v = (self.random_velocities(gen, x.shape) if sample_velocities
             else torch.zeros_like(x))
        saves = []
        for _ in range(steps // saveevery):
            if resample_velocities:
                v = self.random_velocities(gen, x.shape)
            x, v = self._integrate(x, v, saveevery, gen)
            if not bool(torch.isfinite(x).all()):
                warnings.warn(f"trajectory diverged after {len(saves)} "
                              f"frames; returning partial result")
                break
            saves.append(x[0])
        if not saves:
            raise FloatingPointError("trajectory diverged immediately; "
                                     "reduce the timestep")
        return torch.stack(saves)

    def laggedtrajectory(self, lags, steps=None, x0=None,
                         resample_velocities=True, gen=None):
        """``lags`` frames ``steps`` integrator steps apart, velocities
        resampled per lag."""
        steps = self.steps if steps is None else int(steps)
        return self.trajectory(steps=lags * steps, saveevery=steps, x0=x0,
                               resample_velocities=resample_velocities,
                               gen=gen)

    def randx0(self, n, gen=None):
        """n start points from a lagged trajectory of the default state."""
        return self.laggedtrajectory(n, gen=gen)

    def __repr__(self):
        return (f"MDSimulation({self.natoms} atoms, steps={self.steps}, "
                f"temp={self.temp}K, friction={self.friction}/ps, "
                f"dt={self.step}ps, {self.system.method}, {self.device})")

