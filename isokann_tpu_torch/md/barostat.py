"""Monte Carlo barostat and NPT propagation on a box given at run time.

Counterpart of ``isokann_tpu/md/barostat.py``, with OpenMM's
MonteCarloBarostat semantics:

- every ``interval`` steps propose V' = V + dV, dV ~ U(-s, s);
- molecule centres scale by (V'/V)^(1/3) (molecules stay rigid, so
  constraints stay satisfied);
- accept with exp(-beta (dU + P dV - N_mol kT ln(V'/V)));
- s adapts toward ~50% acceptance: x1.1 or /1.1 by the acceptance over
  the last 10 proposals.

The box is a run-time value of the force and energy paths (``box=``), so
a volume move rebuilds no table: on the dense route it stays a tensor; on
the neighbor route it is read to the host once a block of ``interval``
steps, for kernel E's launches (``md.neighbor_kernel``), whose cell grid
keeps its counts while the edges scale.  The plan's ``box_slack`` keeps
the stencil valid while the box shrinks to (1 - box_slack) of the plan's;
a proposal below that rebuilds the plan at its box first, and a cell
overflow on a block's end frame rebuilds it with the capacity regrown
(and warns: that block's forces missed pairs).  The acceptance test runs
on the host, once a move.  ``_uniforms`` is the seam of the move's two
draws.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .._device import noise_generator
from . import integrators as I
from .forces import _minus_grad, potential_energy, potential_energy_flat
from .system import KB, MDSystem

BAR_TO_KJ_NM3 = 0.0602214076      # 1 bar in kJ/mol/nm^3


def molecule_map(sys: MDSystem, extra_pairs=None):
    """(natoms,) molecule ids from the bond graph (host, once).
    ``extra_pairs``: connectivity missing from ``sys.bond_idx`` (rigid
    waters on the sparse path have their bonds stripped; pass their
    pairs, or each water atom is a molecule of its own)."""
    n = sys.natoms
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    pairs = [tuple(p) for p in sys.bond_idx.detach().cpu().numpy()]
    if extra_pairs is not None:
        pairs += [tuple(p) for p in np.asarray(extra_pairs).reshape(-1, 2)]
    for a, b in pairs:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[ra] = rb
    roots = [find(i) for i in range(n)]
    uniq = {r: k for k, r in enumerate(dict.fromkeys(roots))}
    return np.asarray([uniq[r] for r in roots], np.int64)


def _uniforms(gen):
    """The move's two draws from ``gen``: the volume step's fraction in
    [-1, 1) and the acceptance test's uniform in [0, 1)."""
    u = torch.rand(2, generator=gen, dtype=torch.float64)
    return float(2.0 * u[0] - 1.0), float(u[1])


class MonteCarloBarostat:
    """The barostat's tables and its volume move."""

    def __init__(self, sys: MDSystem, pressure: float = 1.0,
                 temp: float = 300.0, interval: int = 25,
                 initial_scale: float = None, x0=None,
                 box_slack: float = 0.1, extra_pairs=None):
        if sys.box is None:
            raise ValueError("barostat requires a periodic box")
        self.sys = sys
        self.box_slack = float(box_slack)
        self.plan = None
        self.replans = 0
        if not sys.dense_pairs:
            self.replan(x0, sys.box)
            self.replans = 0        # rebuilds after this first plan
        self.pressure = float(pressure) * BAR_TO_KJ_NM3   # kJ/mol/nm^3
        self.kt = KB * float(temp)
        self.interval = int(interval)
        mol = molecule_map(sys, extra_pairs=extra_pairs)
        dev = sys.charges.device
        self.mol_id = torch.as_tensor(mol, device=dev)
        self.nmol = int(mol.max()) + 1
        # mass-weighted molecule centres as one (nmol, natoms) product
        M = np.zeros((self.nmol, sys.natoms), np.float32)
        M[mol, np.arange(sys.natoms)] = sys.masses.detach().cpu().numpy()
        self.center_M = torch.as_tensor(M / M.sum(axis=1, keepdims=True),
                                        device=dev)
        V0 = float(np.prod(sys.box))
        self.scale0 = float(initial_scale if initial_scale is not None
                            else 0.01 * V0)

    def replan(self, x, box):
        """Build the neighbor plan at ``box`` (three numbers) with its
        capacity sized on ``x`` (natoms, 3; or None): one stencil valid
        for boxes down to (1 - box_slack) of ``box``."""
        from .neighbor import NeighborPlan, box_np
        self.plan = NeighborPlan(
            self.sys.replace(box=tuple(box_np(box).tolist())),
            x0=None if x is None
            else torch.as_tensor(x).detach().cpu().numpy().reshape(-1, 3),
            box_slack=self.box_slack)
        self.replans += 1

    def covers(self, box) -> bool:
        """Whether the plan's stencil is valid at ``box``."""
        from .neighbor import box_np
        return bool(np.all(box_np(box) >= (1.0 - self.box_slack)
                           * self.plan.box))

    def overflow(self, x, box) -> int:
        """Atoms that the plan's cells at ``box`` drop from ``x`` (natoms,
        3)."""
        b = self.plan.geometry(x.device, box)["box"]
        xw = x - b * torch.floor(x / b)
        return int(self.plan.sorted_frame(xw, box)[3])

    def init_state(self, box=None):
        """(box (3,) float32 tensor, dV scale, attempted, accepted,
        accepted in the current window of 10)."""
        box = torch.as_tensor(self.sys.box if box is None else box,
                              dtype=torch.float32,
                              device=self.sys.charges.device)
        return (box, torch.tensor(self.scale0, dtype=torch.float32,
                                  device=box.device), 0, 0, 0)

    def energy(self, x, box):
        """Potential energy of one walker ``x`` (natoms, 3), sites placed,
        in the box ``box``."""
        if self.plan is not None:
            from .neighbor import potential_energy_neighbor
            return potential_energy_neighbor(self.sys, x, self.plan, box)
        return potential_energy(self.sys, x, box)

    def move(self, gen, x, state):
        """One MC volume move of ``x`` (natoms, 3) with draws from ``gen``;
        returns (x', state')."""
        from .vsites import place_vsites
        box, dv_scale, n_att, n_acc, win_acc = state
        # site rows are stale during dynamics: place them first; a rigid
        # translation of each molecule keeps them placed
        x = place_vsites(self.sys, x)
        u_dv, u_acc = _uniforms(gen)
        V = torch.prod(box)
        dV = dv_scale * u_dv
        Vn = V + dV
        f = (Vn / V) ** (1.0 / 3.0)
        # the float32 table promoted to float64 walkers, as JAX promotes
        centers = torch.matmul(self.center_M.to(x.dtype), x)
        xn = x + ((f - 1.0) * centers)[self.mol_id]
        boxn = box * f
        if self.plan is not None and not self.covers(boxn):
            self.replan(xn, boxn)
        w = (self.energy(xn, boxn) - self.energy(x, box)
             + self.pressure * dV - self.nmol * self.kt * torch.log(Vn / V))
        accept = (u_acc < float(torch.exp(torch.clamp(-w / self.kt,
                                                      -50.0, 50.0)))
                  and float(Vn) > 0)
        if accept:
            x, box = xn, boxn
        n_att, n_acc, win_acc = n_att + 1, n_acc + accept, win_acc + accept
        # OpenMM's adaptation: the acceptance over the last 10 attempts
        if n_att % 10 == 0:
            frac = win_acc / 10.0
            if frac < 0.25:
                dv_scale = dv_scale / 1.1
            elif frac > 0.75:
                dv_scale = torch.minimum(dv_scale * 1.1,
                                         0.3 * torch.prod(box))
            win_acc = 0
        return x, (box, dv_scale, n_att, n_acc, win_acc)


def npt_langevin(sim, x0=None, gen=None, steps=1000, pressure=1.0,
                 interval=25, temp=None):
    """NPT propagation of one walker: blocks of ``interval``
    LangevinMiddle steps in the box of the block, each followed by an MC
    volume move; no constraints, as in the reference.  On the neighbor
    route kernel E sweeps every step in the current box; on the dense
    route forces come from autograd with the box as a tensor.  Returns (x
    (3N,), box (3,), info dict); on the neighbor route ``info`` counts
    the atoms the cells dropped on the blocks' end frames (``overflow``,
    must be 0) and the plan's rebuilds (``replans``)."""
    from .vsites import place_vsites_flat, redistribute_forces_flat
    from .._device import make_generator
    sys = sim.system
    temp = float(temp if temp is not None else sim.temp)
    gen = make_generator(0 if gen is None else gen)
    x = (sim.coords if x0 is None else torch.as_tensor(
        x0, dtype=sim.coords.dtype, device=sim.device)).reshape(1, -1)
    # a float64 simulation takes the tensor sweep, no kernel; the box
    # state stays float32, as the JAX package keeps it
    sweep = None
    if getattr(sim, "plain_versions", False):
        from .neighbor import tensor_sweep as sweep
    baro = MonteCarloBarostat(sys, pressure=pressure, temp=temp,
                              interval=interval, x0=x)

    if baro.plan is not None:
        from .neighbor import box_np, force_flat_neighbor

        def force(xf, box):
            # the analytic path: place the sites, hand their forces back
            xp = place_vsites_flat(sys, xf)
            f = force_flat_neighbor(sys, xp, baro.plan, sweep=sweep,
                                    box=box)
            return redistribute_forces_flat(sys, f, xp)

        def block_box(box):
            return box_np(box)          # once a block, for the launches
    else:
        def force(xf, box):
            return _minus_grad(lambda z: potential_energy_flat(sys, z, box),
                               xf)

        def block_box(box):
            return box

    noise = noise_generator(gen, x.device)
    v = I.maxwell_boltzmann(gen, sim.masses3, temp, x.shape)
    state = baro.init_state()
    boxes = []
    dropped = 0
    for _ in range(max(1, steps // interval)):
        box = block_box(state[0])
        x, v = I.langevin_middle(lambda z: force(z, box), x, v, sim.masses3,
                                 temp, sim.friction, sim.step, interval,
                                 noise)
        if baro.plan is not None:
            over = baro.overflow(x.reshape(-1, 3), box)
            if over:
                warnings.warn(
                    f"cell overflow: {over} atoms dropped on a block's end "
                    f"frame; the forces of that block missed pairs; "
                    f"capacity regrown")
                baro.replan(x.reshape(-1, 3), box)
            dropped += over
        xm, state = baro.move(gen, x.reshape(-1, 3), state)
        x = xm.reshape(1, -1)
        boxes.append(state[0])
    box_f, dv_scale, n_att, n_acc, _ = state
    info = dict(boxes=torch.stack(boxes), attempted=n_att, accepted=n_acc,
                acceptance=n_acc / max(n_att, 1), dv_scale=float(dv_scale),
                overflow=dropped, replans=baro.replans)
    return x[0], box_f, info
