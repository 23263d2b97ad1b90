"""MDSimulation: molecular dynamics of a peptide on one GPU.

Counterpart of ``isokann_tpu/simulators/mdsim.py``.  Defaults mirror the
reference: 310 K, friction 1/ps, 2 fs steps, 100 steps per Koopman lag,
auto cutoff method, the bundled alanine dipeptide.

Unbiased LangevinMiddle propagation takes one of five force routes, as
the reference's ``_force_fn`` / ``_pallas_eligible`` /
``_nb_kernel_eligible`` choose on a TPU (read "TPU" as "CUDA"):

- ``"fused"``: at most 64 atoms in vacuum, without constraints, Ewald or
  virtual sites.  Whole trajectories in
  ``md.langevin_kernel.langevin_middle`` (kernel A; any batch size).
- ``"hybrid"``: 64 < atoms <= 640 with a non-periodic method (OBC2
  implicit solvent or vacuum reaction field).  The plain LangevinMiddle
  recursion (``md.integrators.langevin_middle``) over
  ``md.gb_kernel.force_flat_hybrid``: kernel D for the nonbonded + GBSA
  forces at every step, analytic bonded forces.
- ``"neighbor"``: a periodic system built with ``dense_pairs=False``
  (automatic above ``md.system.DENSE_PAIRS_MAX`` atoms), e.g. a peptide in
  a TIP3P box (``addwater=True``).  The recursion over
  ``md.neighbor.force_flat_neighbor``: the cell-list sweep in
  ``md.neighbor_kernel.neighbor_sweep`` (kernel E; the erfc real space
  under Ewald / PME) at every step, the exception corrections, the
  reciprocal sum and the sparse bonded forces analytically.  After each
  propagation a sample of frames is checked for cell overflow; an
  overflow regrows the plan and warns.  With ``neighbor_mode="verlet"``
  an unbiased ``propagate`` runs on per-atom Verlet lists instead
  (``md.verlet``, plain PyTorch, as the reference's XLA path), rebuilt
  every few steps and whenever an atom has moved skin/2; an overflowed
  list warns.
- ``"plain"``: at most 64 atoms with OBC2, constraints, Ewald / PME or
  virtual sites.
  The recursion over the all-pairs forces, where the reference runs
  autograd ``force_flat`` on a TPU (no kernel there): analytic
  (``md.gbsa_force.force_flat_analytic``) under NoCutoff and the reaction
  field, autograd ``force_flat`` under Ewald / PME.
- ``"dense"``: every other system with dense pairs: periodic ones above
  64 atoms (every Ewald / PME system among them), non-periodic ones above
  640.  The same forces as "plain", as the reference runs its XLA
  all-pairs ``force_flat`` on a TPU (no kernel there); its (B, n, n)
  intermediates grow as B n^2.

Every route with a constraint set (``constraints=`` and / or rigid
water, ``md.constraints``) runs the constrained recursion: SHAKE / RATTLE
at every step, in ``propagate``, ``trajectory``, ``bootstrap_data``,
``randx0`` and the biased ABOBA.  On the CPU every route runs, each
wrapper taking its kernel's plain version.  On the card the recursion
draws each step's noise from a CUDA ``torch.Generator`` seeded from the
caller's generator.

``integrator="brownian"`` makes ``propagate`` overdamped Euler-Maruyama
(``md.integrators.brownian``) over ``force``: on the fused route kernel
A's forces entry at every step (its trajectory entry is LangevinMiddle
only, as the reference's fused kernel is), retried and falling back to
the start states as LangevinMiddle does.  Chains (``trajectory``,
``bootstrap_data``) stay LangevinMiddle, as in the reference.

With a ``bias`` (``md.integrators.optcontrol``), ``propagate`` runs
Girsanov-weighted ABOBA and returns ``WeightedSamples``:

- on the card's fused route, the whole biased trajectory runs in
  ``md.girsanov_kernel.aboba_girsanov`` (kernel B, any batch size) when
  the bias's chi model is one the kernel takes;
- every other bias, route and device runs the plain ABOBA recursion
  (``md.integrators.aboba_girsanov``) over ``force`` with the bias
  callable, as the reference's XLA biased path does: kernel A's forces
  entry at every step on the fused route, kernel D on the hybrid route
  (and inside an ``optcontrol`` bias over all-pairs features of >= 512
  atoms, e.g. villin with ``FeaturesAll``, kernels C and C′ once each
  per step), kernel E on the neighbor route.  A constrained system runs
  the constrained ABOBA (SHAKE on the drifts, the bias projected onto
  the constraint tangent space, RATTLE after the O step).

As in the reference, biased walkers that diverge are not retried.  A
biased ``trajectory`` is one ABOBA recursion over the saved frames
(``WeightedSamples`` of the frames and their running weights), so a
biased ``randx0`` returns its values; ``integrate_langevin``,
``integrate_girsanov`` and ``langevin_girsanov`` are the reference's
direct integrators over ``force``.

``bootstrap_data`` (the reference's dataset bootstrap, which
``SimulationData.from_sim`` takes for an unbiased simulation) runs
``chains`` lagged chains from the default state as one batch of walkers
through the route above, drops a burn-in and returns the frames
chain-major; the reference's split into a fused and a staged program
(its v5e program limits) has no counterpart: one path with the same
semantics.

Virtual sites (the TIP4P-Ew M point of ``water_model="tip4pew"``,
``md.vsites``) have an integrator mass of 1e30 amu, so the integrators
leave them in place; the hybrid and neighbor routes place them before
every force and hand their forces back to the parents (the plain and
dense routes do so inside ``md.forces.force_flat``), and every output
frame is placed.  NPT is ``md.barostat.npt_langevin``.

``MDSimulation.from_system`` wraps an ``MDSystem`` built elsewhere (an
Amber prmtop through ``md.amberio``, a serialized OpenMM System through
``md.openmm_xml``): the same set-up as ``__init__`` after its build, so
an imported system takes the route a built one of its kind takes.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .._device import make_generator, noise_generator, resolve_device
from ..data import WeightedSamples, values
from ..features import FeaturesAll, default_featurizer
from ..md import forces as F
from ..md import gb_kernel as GB
from ..md import gbsa_force as GF
from ..md import girsanov_kernel as GK
from ..md import integrators as I
from ..md import langevin_kernel as LK
from ..md import neighbor as NB
from ..md.constraints import ConstraintSet
from ..md.pdbio import read_pdb
from ..md.solvate import solvate, water_msites, water_triplets
from ..md.system import EWALD, PERIODIC, build_system
from ..md.vsites import (attach_vsites, has_vsites, place_vsites_flat,
                         redistribute_forces_flat)
from .base import IsoSimulation


def force_route(system, constrained: bool = False) -> str:
    """The force route of ``system``: "fused" (kernel A), "hybrid"
    (kernel D + analytic bonded terms), "neighbor" (kernel E + analytic
    corrections and bonded terms), "plain" (all-pairs forces, no kernel,
    at most 64 atoms) or "dense" (the same above).  A system with
    virtual sites never takes "fused": kernel A integrates every atom."""
    n = system.natoms
    if not system.dense_pairs:
        return "neighbor"
    if n <= LK.MAX_ATOMS:
        return ("fused" if system.implicit is None and not constrained
                and system.method not in EWALD and not has_vsites(system)
                else "plain")
    if n <= GB.MAX_ATOMS and system.method not in PERIODIC:
        return "hybrid"
    return "dense"


def solute_pairs(nsolute: int):
    """The reference's default features of a solvated system: all solute
    pairs under 100 solute atoms, else 100 drawn uniformly without
    replacement from the C(nsolute, 2) pairs by ``default_rng(0)``."""
    if nsolute < 100:
        return [(i, j) for i in range(nsolute)
                for j in range(i + 1, nsolute)]
    rng = np.random.default_rng(0)
    total = nsolute * (nsolute - 1) // 2
    ids = rng.choice(total, size=min(100, total), replace=False)
    ii = (np.floor((1 + np.sqrt(1 + 8 * ids)) / 2)).astype(int)
    jj = ids - ii * (ii - 1) // 2
    bad = jj < 0          # float-sqrt one-off correction
    ii[bad] -= 1
    jj[bad] = ids[bad] - ii[bad] * (ii[bad] - 1) // 2
    return [(int(j), int(i)) for i, j in zip(ii, jj)]


def integrator_masses3(system):
    """Per-coordinate integrator masses: a massless virtual site weighs
    1e30 amu, so every integrator leaves it in place (no force response,
    no Maxwell-Boltzmann velocity) without the NaNs of an infinite mass."""
    m = system.masses
    return torch.repeat_interleave(torch.where(m > 0, m, 1e30), 3)


class MDSimulation(IsoSimulation):
    """Batched molecular dynamics with the reference's interface.

    - pdb: path to a PDB file (default: bundled alanine dipeptide)
    - steps: integrator steps per Koopman lag
    - temp [K], friction [1/ps], step [ps]
    - features: None (all pairs under 100 atoms, else 100 random pairs),
      a radius in nm (C-alpha pairs + local heavy-atom pairs of the PDB),
      a pair list, an atom list (all pairs among them) or a callable
      such as ``FeaturesAll()``
    - method/cutoff: nonbonded method ("auto": CutoffPeriodic with a box,
      CutoffNonPeriodic without; "Ewald", "PME" or "LJPME" with a box)
    - constraints: None, "HBonds", "HAngles" or "AllBonds" (SHAKE /
      RATTLE, ``md.constraints.ConstraintSet``; the langevin integrator
      only)
    - implicit: None or "obc2" (OBC2 GBSA implicit solvent; forces
      NoCutoff)
    - addwater: surround the solute with a TIP3P box (``padding`` nm each
      side) and neutralising Na+/Cl- (plus ``ionic_strength`` mol/l
      NaCl); the default features become solute pairs only
    - rigidwater: constrain the waters (SHAKE / RATTLE); their bond and
      angle terms are dropped from a sparse system
    - water_model: "tip3p" or "tip4pew" (the M points become virtual
      sites)
    - dense_pairs: True (dense (n, n) pair scales), False (O(n) cell-list
      engine, the "neighbor" route) or "auto" (switch at 4000 atoms)
    - neighbor_mode: "cells" (kernel E's sweep every step) or "verlet"
      (Verlet lists at cutoff + ``skin`` nm in an unbiased ``propagate``
      on the neighbor route, ``md.verlet``)
    - bias: optional ``bias(x, t, sigma, F) -> u`` (sigma-scaled), e.g.
      ``optcontrol(iso)``: ``propagate`` then returns Girsanov-weighted
      ``WeightedSamples``
    - integrator: "langevin" (LangevinMiddle) or "brownian" (overdamped
      Euler-Maruyama in ``propagate``; rigid water then stays flexible,
      with a warning)
    - minimize: start from the FIRE-minimized structure
    - dispersion_correction: add the long-range LJ tail (periodic systems
      with a cutoff, as OpenMM's default)
    - dtype: ``torch.float32`` (or ``np.float32``, the default: every
      kernel route above) or ``torch.float64`` (``np.float64``): the
      system, the walkers and every force, energy and integrator in
      float64 through the plain version of each route, never a kernel
      (the kernels are float32); ``route`` still names the route and
      ``plain_versions`` is True.  Features and the learner stay float32,
      as in the JAX package.  Any other dtype raises ``ValueError``.
    - device: where walkers live; default "cuda", raising without a GPU

    With a process group of more than one rank
    (``parallel.distributed.initialize``), ``propagate`` shards the
    walkers over the ranks (``parallel.sharded_propagate``).
    """

    def __init__(self, pdb=None, steps: int = 100, temp: float = 310.0,
                 friction: float = 1.0, step: float = 0.002, features=None,
                 method: str = "auto", cutoff: float = 1.0, implicit=None,
                 addwater: bool = False, padding: float = 1.0,
                 ionic_strength: float = 0.0, rigidwater: bool = True,
                 water_model: str = "tip3p", dense_pairs="auto",
                 bias=None, integrator: str = "langevin",
                 minimize: bool = False, constraints=None,
                 neighbor_mode: str = "cells", skin: float = 0.2,
                 dispersion_correction: bool = True,
                 dtype=torch.float32, device=None):
        self._options(steps, temp, friction, step, integrator, bias,
                      neighbor_mode, skin, device, dtype)
        if addwater and implicit is not None:
            raise ValueError("addwater and implicit solvent are exclusive")
        if pdb is None:
            from ..md.fixtures import alanine_dipeptide_pdb
            pdb = alanine_dipeptide_pdb()
        self.pdbfile = pdb
        # the arguments, as provenance (escalate_lag updates their steps)
        self.constructor = dict(
            pdb=pdb, steps=steps, temp=temp, friction=friction, step=step,
            features=features, method=method, cutoff=cutoff,
            implicit=implicit, addwater=addwater, padding=padding,
            ionic_strength=ionic_strength, rigidwater=rigidwater,
            water_model=water_model, dense_pairs=dense_pairs,
            integrator=integrator, minimize=minimize,
            constraints=constraints, neighbor_mode=neighbor_mode, skin=skin,
            dispersion_correction=dispersion_correction)
        self.structure = read_pdb(pdb)
        nsolute = self.structure.natoms
        if addwater:
            # the solute keeps its atom indices; ions, then waters follow
            self.structure = solvate(self.structure, padding=padding,
                                     ionic_strength=ionic_strength,
                                     model=water_model)
        self.system = build_system(self.structure, method=method,
                                   cutoff=cutoff, implicit=implicit,
                                   dense_pairs=dense_pairs,
                                   dispersion_correction=dispersion_correction,
                                   dtype=self.dtype, device=self.device)
        # 4-site waters: the M rows become virtual sites
        vsi, vsp, vsw = water_msites(self.structure)
        if len(vsi):
            self.system = attach_vsites(self.system, vsi, vsp, vsw)
        if constraints is not None and integrator != "langevin":
            raise ValueError("constraints require the langevin integrator")
        wt = water_triplets(self.structure) if rigidwater else None
        wt = wt if wt is not None and len(wt) else None
        if wt is not None and integrator != "langevin":
            warnings.warn("rigid water requires the langevin integrator; "
                          "waters stay flexible")
            wt = None
        self.constraint_set = (
            ConstraintSet(self.system, constraints, water=wt)
            if constraints is not None or wt is not None else None)
        if wt is not None and not self.system.dense_pairs:
            # the constraints replace the waters' bond and angle terms
            self.system = NB.strip_rigid_water_bonded(self.system, wt)
        if addwater and features is None:
            features = solute_pairs(nsolute)
        self._setup(self.structure.coords, minimize, features, pdb)

    @classmethod
    def from_system(cls, system, x0, steps: int = 100, temp: float = 310.0,
                    friction: float = 1.0, step: float = 0.002,
                    integrator: str = "langevin", features=None,
                    minimize: bool = False, bias=None, constraints=None,
                    constraint_pairs=None, source=None, device=None):
        """An MDSimulation around a prebuilt ``MDSystem``: the entry point
        of imported systems (``md.amberio.system_from_prmtop``,
        ``md.openmm_xml.load_system_xml``) whose parameters are used as
        they are; no PDB or force-field lookup runs.

        - ``x0``: start coordinates, (natoms, 3) or flat (3 natoms,) [nm]
        - ``constraint_pairs``: explicit (i, j, d_nm) distance constraints
          (e.g. the XML ``<Constraints>`` block, OpenMM's rigid water);
          combined with the ``constraints`` class string if both are given
        - ``features``: pair list / atom list / callable (a radius needs a
          PDB and raises); default all pairs under 100 atoms, else 100
          random pairs
        - ``source``: provenance kept in ``constructor`` and ``pdbfile``
        - ``device``: where walkers live (default "cuda", raising without
          a GPU); the system's tensors must be there

        The route, plans, constraints and featurizer follow from the system
        as in ``__init__``: an imported system on the card takes its
        kernel route (A, D or E) or the plain / dense route exactly as a
        built one does."""
        self = cls.__new__(cls)
        self._options(steps, temp, friction, step, integrator, bias,
                      "cells", 0.2, device, system.charges.dtype)
        if system.device.type != self.device.type:
            raise ValueError(f"the system's tensors are on {system.device}, "
                             f"the simulation's device is {self.device}: "
                             f"build the system with device={device!r}")
        if (constraints is not None or constraint_pairs) \
                and integrator != "langevin":
            raise ValueError("constraints require the langevin integrator")
        self.constructor = dict(
            from_system=True, source=source, steps=steps, temp=temp,
            friction=friction, step=step, integrator=integrator,
            features=features, minimize=minimize, constraints=constraints,
            constraint_pairs=constraint_pairs)
        self.pdbfile = source
        self.structure = None
        self.system = system
        self.constraint_set = (
            ConstraintSet(self.system, constraints, pairs=constraint_pairs)
            if constraints is not None or constraint_pairs else None)
        self._setup(x0, minimize, features, None)
        return self

    def _options(self, steps, temp, friction, step, integrator, bias,
                 neighbor_mode, skin, device, dtype):
        """The run options, checked, shared by ``__init__`` and
        ``from_system``."""
        if any(dtype == f for f in (torch.float32, np.float32)):
            self.dtype = torch.float32
        elif any(dtype == f for f in (torch.float64, np.float64)):
            self.dtype = torch.float64
        else:
            raise ValueError(f"MDSimulation runs in float32 (the kernel "
                             f"routes) or float64 (their plain versions), "
                             f"not {dtype}")
        # float64 runs every route's plain version: the kernels are float32
        self.plain_versions = self.dtype == torch.float64
        if neighbor_mode not in ("cells", "verlet"):
            raise ValueError(f"unknown neighbor_mode {neighbor_mode!r}")
        if integrator not in ("langevin", "brownian"):
            raise ValueError(f"unknown integrator {integrator!r}")
        self.device = resolve_device(device)
        self.steps = int(steps)
        self.temp = float(temp)
        self.friction = float(friction)
        self.step = float(step)
        self.integrator = integrator
        self.bias = bias
        self.neighbor_mode = neighbor_mode
        self.skin = float(skin)

    def _setup(self, x0, minimize, features, pdb):
        """The set-up after the system and its constraints exist, shared by
        ``__init__`` and ``from_system``: integrator masses, the force
        route and its plan, the start state (minimized on request), the
        neighbor plan sized from it and the featurizer."""
        self.masses3 = integrator_masses3(self.system)
        self.route = force_route(self.system,
                                 self.constraint_set is not None)
        self.plan = (LK.LangevinPlan(self.system, self.temp, self.friction,
                                     self.step)
                     if self.route == "fused" else None)
        self.gbplan = (GB.GBPlan(self.system) if self.route == "hybrid"
                       else None)
        self.retries = 0
        self.overflows = 0     # neighbor-cell overflows seen (and regrown)
        self.vplan = None      # the Verlet lists' plan, built at first use
        self.verlet_diag = None   # the last Verlet run's diagnostics
        self._x0 = torch.as_tensor(x0, dtype=self.dtype,
                                   device=self.device).reshape(-1)
        if minimize:
            self._x0 = self.minimize(self._x0)
        # capacity from the float32 start coordinates, as the reference
        self.nbplan = (NB.NeighborPlan(
            self.system, x0=self._x0.cpu().numpy().reshape(-1, 3))
            if self.route == "neighbor" else None)
        self.featurizer = default_featurizer(pdb, self.natoms, features)

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

    def setcoords(self, x):
        """Make ``x`` (3N,) the default start state (of ``trajectory`` and
        ``randx0``)."""
        self._x0 = torch.as_tensor(x, dtype=self.dtype,
                                   device=self.device).reshape(-1)

    def defaultmodel(self, n=None, nout=1, gen=None, **kwargs):
        from ..models import autonet
        return autonet(n if n is not None else self.dim, nout=nout, gen=gen,
                       device=self.device, **kwargs)

    def masses(self):
        """Per-atom masses (N,) in amu (0 for a virtual site)."""
        return self.system.masses

    def random_velocities(self, gen, shape):
        return I.maxwell_boltzmann(gen, self.masses3, self.temp, shape)

    def potential(self, x):
        """Potential energy [kJ/mol] at flat coords (batched)."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        return F.potential_energy_flat(self.system, x)

    def minimize(self, x=None, maxiter=500):
        """FIRE energy minimization of ``x`` (default: the start state); on
        the card, a system without a box replays its steps from a CUDA
        graph (``minimize_energy(graph=True)``)."""
        from ..md.minimize import minimize_energy
        x = self._x0 if x is None else torch.as_tensor(
            x, dtype=self.dtype, device=self.device)
        return place_vsites_flat(self.system, minimize_energy(
            lambda z: F.potential_energy_flat(self.system, z), x,
            maxiter=maxiter, graph=self.system.box is None))

    # ---- propagation -------------------------------------------------------

    def force(self, x):
        """Forces (B, 3N) -> (B, 3N) by the system's route (its kernel's
        plain version under ``plain_versions``)."""
        plain = self.plain_versions
        if self.route == "fused":
            return (LK.forces_plain if plain else LK.forces)(self.plan, x)
        if self.route == "hybrid":
            return self._sites(lambda z: GB.force_flat_hybrid(
                self.gbplan, z, plain=plain), x)
        if self.route == "neighbor":
            # float64: the tensor sweep, the reference's XLA sweep
            sweep = NB.tensor_sweep if plain else None
            return self._sites(lambda z: NB.force_flat_neighbor(
                self.system, z, self.nbplan, sweep=sweep), x)
        if self.system.method not in EWALD:
            # analytic: about a third of autograd's launches, no backward
            return self._sites(lambda z: GF.force_flat_analytic(
                self.system, z), x)
        return F.force_flat(self.system, x)

    def _sites(self, fn, x):
        """``fn``'s forces at ``x`` (B, 3N) with the virtual sites placed
        first and their forces handed back to the parents."""
        if not has_vsites(self.system):
            return fn(x)
        xp = place_vsites_flat(self.system, x)
        return redistribute_forces_flat(self.system, fn(xp), xp)

    def _integrate(self, x, v, nsteps, gen):
        """LangevinMiddle for (B, 3N) walkers: kernel A's whole
        trajectories on the fused route (its plain version on the CPU and
        under ``plain_versions``), else the recursion over
        ``self.force``; ``gen=None`` runs the noiseless recursion."""
        if self.route == "fused":
            run = (LK.langevin_middle_plain if self.plain_versions
                   else LK.langevin_middle)
            return run(self.plan, x, v, nsteps, gen, noise=gen is not None)
        return I.langevin_middle(self.force, x, v, self.masses3, self.temp,
                                 self.friction, self.step, nsteps,
                                 noise_generator(gen, x.device),
                                 self.constraint_set)

    def _run(self, xs, nsteps, gen):
        """An unbiased propagation of (B, 3N) walkers by the integrator."""
        if self.integrator == "brownian":
            return I.brownian(self.force, xs, self.masses3, self.temp,
                              self.friction, self.step, nsteps,
                              noise_generator(gen, xs.device))
        v0 = self.random_velocities(gen, xs.shape)
        if self.neighbor_mode == "verlet" and self.route == "neighbor":
            return self._verlet(xs, v0, nsteps, gen)
        return self._integrate(xs, v0, nsteps, gen)[0]

    def _verlet(self, xs, v0, nsteps, gen):
        """LangevinMiddle on Verlet lists (``md.verlet``) for (B, 3N)
        walkers; keeps the run's ``verlet_diag`` and warns when a list
        overflowed (its forces miss pairs)."""
        from ..md.verlet import VerletPlan, langevin_middle_verlet
        if self.vplan is None:
            self.vplan = VerletPlan(self.system, x0=self._x0, skin=self.skin)
        x, _, diag = langevin_middle_verlet(
            self.system, self.vplan, xs, v0, self.masses3, self.temp,
            self.friction, self.step, nsteps, noise_generator(gen, xs.device),
            constraints=self.constraint_set,
            wrap_force=lambda fn: (lambda z: self._sites(fn, z)))
        self.verlet_diag = dict(max_disp=float(diag["max_disp"]),
                                n_over=int(diag["n_over"]),
                                rebuilds=diag["rebuilds"])
        if self.verlet_diag["n_over"]:
            warnings.warn(
                f"verlet lists overflowed by {self.verlet_diag['n_over']} "
                f"atoms: forces of this propagation miss pairs; raise K")
        return x

    def biased_route(self, device) -> str:
        """How a biased propagation on ``device`` runs: "kernel" (the
        Girsanov kernel, on the card for a bias it takes) or "recursion"
        (the plain ABOBA recursion over ``force``)."""
        return ("kernel" if torch.device(device).type != "cpu"
                and not self.plain_versions and self.kernel_takes_bias()
                else "recursion")

    def _aboba(self, bias, xs, p0, nsteps, gen, **kwargs):
        """The plain ABOBA recursion over ``force`` under ``bias``, with
        the system's constraints."""
        return I.aboba_girsanov(
            self.force, bias, xs, p0, self.masses3, self.temp,
            self.friction, self.step, nsteps, noise_generator(gen, xs.device),
            constraints=self.constraint_set, **kwargs)

    def _girsanov(self, xs, p0, nsteps, gen):
        """Biased ABOBA for (B, 3N) walkers -> (q, logw), by
        ``biased_route``."""
        if self.biased_route(xs.device) == "recursion":
            q, _, logw = self._aboba(self.bias, xs, p0, nsteps, gen)
            return q, logw
        spec = self.bias.optcontrol_spec
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
        for a system on the fused route (at most 64 atoms in vacuum)."""
        spec = getattr(self.bias, "optcontrol_spec", None)
        return (spec is not None and self.route == "fused"
                and isinstance(spec["featurizer"], FeaturesAll)
                and GK.takes_model(spec["model"], self.plan.np))

    def propagate(self, x0, nk, gen=None, steps=None):
        """(n, 3N) -> (n, nk, 3N) Koopman bursts: all n*nk walkers in one
        launch.  The walker count is padded to a power of two (>= 8), as
        in the reference; walkers that diverge are retried up to three
        times with fresh noise (``self.retries`` counts these reruns of
        the whole batch), then fall back to their start state.

        Walker sharding, the reference's rule: with more than one rank
        (``parallel.device_count() > 1``) and a padded batch that divides
        by their number, each rank propagates its contiguous rows (with
        the noise the unsharded run gives them) and every rank gets the
        whole batch; the result equals the unsharded run's.  Every rank
        passes the same ``x0`` and a generator in the same state.

        With a bias: ``WeightedSamples`` of the bursts (n, nk, 3N) and
        their Girsanov weights exp(logw) (n, nk), from momenta drawn from
        the Maxwell-Boltzmann distribution; no retry.  A biased batch is
        not sharded: every rank computes all of it, the same bits on
        each."""
        gen = make_generator(gen)
        x0 = torch.as_tensor(x0, dtype=self.dtype, device=self.device)
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
            self._check_cell_overflow(q[:nw])
            q = place_vsites_flat(self.system, q[:nw])
            return WeightedSamples(q.reshape(n, nk, d),
                                   torch.exp(logw[:nw]).reshape(n, nk))
        mesh = self._walker_mesh(bucket)

        def run():
            if mesh is None:
                return self._run(xs, nsteps, gen)[:nw]
            from ..parallel import sharded_propagate
            return sharded_propagate(
                mesh, lambda x, g: self._run(x, nsteps, g), xs, gen)[:nw]

        # under sharding every rank holds the gathered batch, so the
        # retry decisions (and the cell-overflow check) read the same
        # values on every rank, and the ranks' generators stay in step
        ys = run()
        for _ in range(3):
            bad = ~torch.isfinite(ys).all(dim=-1)
            if not bool(bad.any()):
                break
            self.retries += 1
            retry = run()
            ys = torch.where(bad[:, None], retry, ys)
        bad = ~torch.isfinite(ys).all(dim=-1)
        if bool(bad.any()):
            warnings.warn(f"{int(bad.sum())} walkers diverged after "
                          f"retries; falling back to their start states")
            ys = torch.where(bad[:, None], xs[:nw], ys)
        self._check_cell_overflow(ys)
        return place_vsites_flat(self.system, ys).reshape(n, nk, d)

    def _walker_mesh(self, bucket):
        """The mesh that shards a padded batch of ``bucket`` walkers, or
        None: more than one rank and a bucket that divides by their
        number (the reference's rule, not a fallback)."""
        from ..parallel import device_count, make_mesh
        count = device_count()
        if count > 1 and bucket % count == 0:
            return make_mesh()
        return None

    def _start(self, x0):
        """(B, 3N) start walkers: ``x0`` or the default state."""
        x0 = self._x0 if x0 is None else torch.as_tensor(
            x0, dtype=self.dtype, device=self.device)
        return x0.reshape(-1, self.dim)

    def _lagged_frames(self, x, v, nframes, steps, resample_velocities,
                       gen):
        """Frames of the (B, 3N) walkers ``x`` taken ``steps`` integrator
        steps apart, velocities drawn from Maxwell-Boltzmann at the start
        of each lag where asked: (k, B, 3N) for the first k <= nframes lags
        at which every walker is finite.  The cell occupancy of every kept
        frame is checked (``_check_cell_overflow``)."""
        frames = []
        for _ in range(nframes):
            if resample_velocities:
                v = self.random_velocities(gen, x.shape)
            x, v = self._integrate(x, v, steps, gen)
            if not bool(torch.isfinite(x).all()):
                break
            frames.append(x)
        out = torch.stack(frames) if frames else x.new_empty((0,) + x.shape)
        self._check_cell_overflow(out, sample=out.shape[0] * out.shape[1])
        return place_vsites_flat(self.system, out)

    def trajectory(self, steps=None, saveevery=1, x0=None,
                   sample_velocities=True, resample_velocities=False,
                   gen=None):
        """(nsave, 3N) single-walker trajectory, one kernel launch (B = 1)
        per saved frame.  Stops early with a warning if it diverges.

        With a bias: ``WeightedSamples`` of the saved frames and their
        Girsanov weights, from one ABOBA recursion over ``force`` (t and
        logw run on across the frames; momenta drawn from Maxwell-
        Boltzmann, whatever the velocity flags say)."""
        gen = make_generator(gen)
        steps = self.steps if steps is None else int(steps)
        x = self._start(x0)
        if self.bias is not None:
            p0 = self.random_velocities(gen, x.shape) * self.masses3
            qs, logws, _ = self._aboba(self.bias, x, p0, steps, gen,
                                       save_every=saveevery)
            self._check_cell_overflow(qs[:, 0], sample=16)
            return WeightedSamples(place_vsites_flat(self.system, qs[:, 0]),
                                   torch.exp(logws[:, 0]))
        v = (self.random_velocities(gen, x.shape)
             if sample_velocities and not resample_velocities
             else torch.zeros_like(x))
        nsave = steps // saveevery
        out = self._lagged_frames(x, v, nsave, saveevery,
                                  resample_velocities, gen)[:, 0]
        if len(out) < nsave:
            warnings.warn(f"trajectory diverged after {len(out)} "
                          f"frames; returning partial result")
        if not len(out):
            raise FloatingPointError("trajectory diverged immediately; "
                                     "reduce the timestep")
        return out

    def _check_cell_overflow(self, ys, sample: int = 8):
        """The neighbor route's safety net: the cell capacity is sized from
        the start coordinates, and density drift that overflows a cell
        drops interactions.  Checks the occupancy of up to ``sample``
        finite frames of ``ys`` on the host; on overflow the plan regrows
        (margin 2) from the first of them for later calls, and a warning
        says that the frames just returned carried degraded forces."""
        plan = self.nbplan
        if plan is None:
            return
        xf = ys.detach().reshape(-1, self.dim)[:sample].cpu().numpy()
        xf = xf[np.all(np.isfinite(xf), axis=1)]
        if not len(xf):
            return                 # divergence is handled by the caller
        dropped = plan.overflow(xf)
        if dropped:
            self.nbplan = NB.NeighborPlan(
                self.system, x0=xf[0].reshape(-1, 3), margin=2.0,
                cell_div=plan.cell_div)
            self.overflows += 1
            warnings.warn(
                f"neighbor cell overflow ({dropped} atoms dropped): forces "
                f"of this propagation were degraded; cell capacity regrown "
                f"{plan.C} -> {self.nbplan.C} for subsequent calls")

    def laggedtrajectory(self, lags, steps=None, x0=None,
                         resample_velocities=True, gen=None):
        """``lags`` frames ``steps`` integrator steps apart, velocities
        resampled per lag."""
        steps = self.steps if steps is None else int(steps)
        return self.trajectory(steps=lags * steps, saveevery=steps, x0=x0,
                               resample_velocities=resample_velocities,
                               gen=gen)

    def randx0(self, n, gen=None):
        """n start points from a lagged trajectory of the default state
        (with a bias, its values: the weights are dropped)."""
        return values(self.laggedtrajectory(n, gen=gen))

    # ---- direct integrators ------------------------------------------------

    def integrate_langevin(self, x0=None, steps=None, perturbation=None,
                           gen=None):
        """Naive underdamped Euler-Maruyama (``md.integrators.langevin_em``)
        over ``force`` from ``x0`` (default: the start state), Maxwell-
        Boltzmann velocities, an optional force ``perturbation(x)``;
        (B, 3N) positions after ``steps``."""
        gen = make_generator(gen)
        x0 = self._start(x0)
        steps = self.steps if steps is None else int(steps)
        v0 = self.random_velocities(gen, x0.shape)
        x, _ = I.langevin_em(self.force, x0, v0, self.masses3, self.temp,
                             self.friction, self.step, steps,
                             noise_generator(gen, x0.device),
                             perturbation=perturbation)
        return x

    def integrate_girsanov(self, x0=None, steps=None, bias=None, gen=None):
        """Overdamped Euler-Maruyama under ``bias`` (default: the
        simulation's) with Girsanov weights
        (``md.integrators.brownian_girsanov``); returns (x, logw)."""
        gen = make_generator(gen)
        bias = bias or self.bias
        if bias is None:
            raise ValueError("integrate_girsanov needs a bias")
        x0 = self._start(x0)
        steps = self.steps if steps is None else int(steps)
        return I.brownian_girsanov(self.force, bias, x0, self.masses3,
                                   self.temp, self.friction, self.step,
                                   steps, noise_generator(gen, x0.device))

    def langevin_girsanov(self, x0=None, steps=None, bias=None, saveevery=1,
                          sigmascaled=True, gen=None):
        """Underdamped ABOBA with Girsanov weights from one walker
        (default: the start state) under ``bias`` (default: the
        simulation's, else zero); ``WeightedSamples`` of the frames saved
        every ``saveevery`` steps."""
        gen = make_generator(gen)
        bias = bias or self.bias or (lambda q, t, sigma, F:
                                     torch.zeros_like(q))
        x = self._start(x0)[:1]
        steps = self.steps if steps is None else int(steps)
        p0 = self.random_velocities(gen, x.shape) * self.masses3
        qs, logws, _ = self._aboba(bias, x, p0, steps, gen,
                                   save_every=saveevery,
                                   sigmascaled=sigmascaled)
        return WeightedSamples(qs[:, 0], torch.exp(logws[:, 0]))

    # ---- dataset bootstrap -------------------------------------------------

    @staticmethod
    def bootstrap_chains(nx: int, chains=None, burnin=None):
        """``(chains, burnin)`` of ``bootstrap_data`` for ``nx`` frames:
        by default the largest divisor of nx up to 8 that leaves each
        chain at least 4 lags, and ``nlag * (chains - 1) // 2`` burn-in
        lags (the mean depth of one chain of nx lags)."""
        if chains is None:
            chains = max((d for d in range(1, 9)
                          if nx % d == 0 and nx // d >= 4), default=1)
        if nx % chains != 0:
            raise ValueError(f"chains={chains} must divide nx={nx}")
        if burnin is None:
            burnin = (nx // chains) * (chains - 1) // 2
        return chains, burnin

    def bootstrap_data(self, nx: int, nk: int, featurizer=None, gen=None,
                       chains=None, burnin=None):
        """The reference's dataset bootstrap: nx lagged frames from
        ``chains`` independent chains of the default state, nk Koopman
        bursts from each and the features of both; ``(xs, ys, fxs,
        fys)``.

        The chains run as one batch of ``chains`` walkers through the
        system's route (``_integrate``), ``nx // chains + burnin`` lags
        each, velocities drawn from Maxwell-Boltzmann at the start of
        every lag, in the lag loop of ``trajectory`` (so every frame's
        cell occupancy is checked); the first ``burnin`` frames of each
        chain are dropped and the rest stacked chain-major, (nx, 3N).
        ``chains=1`` (burn-in 0) is ``laggedtrajectory(nx)``.  The bursts go through
        ``propagate`` with the bias off (padded, diverged walkers
        retried)."""
        gen = make_generator(gen)
        featurizer = featurizer or self.featurizer
        chains, burnin = self.bootstrap_chains(nx, chains, burnin)
        nlag = nx // chains
        x = self._x0[None, :].repeat(chains, 1)
        frames = self._lagged_frames(x, torch.zeros_like(x), nlag + burnin,
                                     self.steps, True, gen)
        if len(frames) < nlag + burnin:
            raise FloatingPointError(
                "dataset bootstrap diverged (non-finite coordinates): the "
                "initial structure appears unstable at this timestep — "
                "construct the simulation with minimize=True or a smaller "
                "`step`")
        xs = frames[burnin:].transpose(0, 1).reshape(nx, self.dim)
        bias, self.bias = self.bias, None
        try:
            ys = self.propagate(xs, nk, gen=gen)
        finally:
            self.bias = bias
        fxs = featurizer(xs).to(torch.float32)
        fys = featurizer(ys).to(torch.float32)
        return xs, ys, fxs, fys

    def __repr__(self):
        return (f"MDSimulation({self.natoms} atoms, steps={self.steps}, "
                f"temp={self.temp}K, friction={self.friction}/ps, "
                f"dt={self.step}ps, {self.system.method}, "
                f"implicit={self.system.implicit}, {self.route}, "
                f"{self.device})")

