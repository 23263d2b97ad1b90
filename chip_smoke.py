#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``isokann_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``isokann_tpu_torch/csrc`` with
nvcc (one process per source, in parallel) and holds each against its
plain PyTorch version on the card.  Then it drives seven paths through the
port's entry points, and the goldens after them:

- the alanine-dipeptide ISOKANN quickstart (``bench.py``'s pipeline:
  ``SimulationData.from_sim(nx=100, nk=5)``, the reference's multi-chain
  bootstrap of 5 chains x (20 + 40 burn-in) lags at B=5, then
  propagate(nk=5) of 512 padded walkers x 100 LangevinMiddle steps,
  all-pairs features, 100 Koopman iterations of the pairnet chi model with
  AdamRegularized, then chis/koopman/rates): the LangevinMiddle kernel;
  then the lag tools on its chi (``lag_sweep`` and ``rates_resolved`` at
  50/100/200 steps, ``cktest`` at factor 2; one launch a propagation);
  then, on a copy of that learner, the adaptive loop's growth:
  ``addcoords(20)`` (a lagged trajectory from the last point),
  ``picking_aligned`` of 10 burst ends by aligned RMSD, ``run_kde_dash``
  (3 generations), 4 KDE needles in chi, ``addextrapolates`` (with and
  without the levelset minimization) and ``exportsorted`` read back:
  the data grows by exactly what each step adds, kernel A launches once
  a lag and once a propagation; then, on another copy, the chi ensemble
  (``ChiEnsemble`` of 8 members, ``run(100)``, ``chi_std``,
  ``resample_uncertainty(ny=8, explore=0.25)``, ``run(50)``; one launch of
  kernel A), timed against 8 sequential ``Iso.run(100)``; then, on
  further copies, the analysis layer (the reactive path as
  ``examples/alanine.py`` writes it, the same ids from the dense min-plus
  route on the card, the marginal free energy, the mutual information of
  the 231 features, ``constrained_free_energy`` over 200 steps at B=8,
  ``local_mean_force`` and ``reactionpath_ode`` at 11 x 5 RK4 steps:
  kernel A's forces entry once a force evaluation) and the
  enhanced-sampling simulators (``adaptive_metadynamics`` as
  ``examples/enhanced_sampling.py --full``, ``run_metadynamics``,
  ``run_both``, a gridded bias, the guided bridges of a two-output
  learner over 0.2 ps, ``EffectiveSimulation`` with 1,000 steps and on
  the two-output learner with 100: the forces entry once a biased step
  and once an effective table, the LangevinMiddle kernel once a
  propagation of new start points);
- Girsanov-weighted optimal-control sampling on the chi that path
  trained: ``optcontrol`` + a biased ``propagate`` of 100 x 5 walkers, then
  ``run_girsanov(generations=3, iter=100, kde=50, forcescale=0.5)``: the
  Girsanov kernel, 256 padded walkers x 100 ABOBA steps per generation;
  then the biased paths that kernel B does not run, each through kernel
  A's forces entry once a step: a biased ``trajectory`` (100 steps, every
  10th saved) and ``randx0(4)`` under the quickstart's bias, a
  propagation of 4 x 8 walkers under a bias the Girsanov kernel does not
  take, a Brownian ``MDSimulation`` propagation, and the direct
  integrators ``integrate_langevin``, ``integrate_girsanov`` and
  ``langevin_girsanov``.

- the reference's trp-cage production loop (``tools/run_trpcage_
  production.py``): ``peptide_pdb`` builds TC5B (313 atoms) from sequence
  and minimizes it in OBC2 implicit solvent (FIRE steps replayed from a
  CUDA graph, held against the eager loop over 30 steps),
  ``MDSimulation(steps=100,
  implicit="obc2")``, ``Iso(nx=5, nk=8)`` (nx cut from the reference's
  100) over 100 random-pair features, 2 generations of ``run(300)`` +
  ``resample_strat(3)`` + the 2000-point cutoff, then chis/koopman/rates:
  the nonbonded + GBSA force kernel at every MD step (randx0's 500
  single-walker steps, 64 padded walkers x 100 steps in propagate, 32 x
  100 per generation); then the production tool's stages on that pilot
  (``lag_sweep`` at 100/200 steps, ``cktest``, two generations of its
  ``campaign()`` of ``tools/run_trpcage_production_torch.py``,
  checkpointed after each, ``escalate_lag`` to 200 steps and a generation
  there, then one more generation twice: relaunched from the checkpoint
  through the tool's resume path and on the learner in memory, which must
  agree: 1,600 steps of the same kernel), then the tool's reactive path
  of the campaign's start points (no kernel).

- the reference's explicit-solvent configuration
  (``examples/solvated_peptide.py``, full variant): ``peptide_pdb``
  builds AQGSAELAKVM and minimizes it (300 FIRE steps),
  ``MDSimulation(addwater=True, padding=1.0, steps=100)`` puts it in a
  TIP3P box (7,744 atoms, 2,526 rigid waters, reaction field under
  minimum image), 4 walkers equilibrate for 200 steps, then randx0's
  lagged trajectory of 4 frames at 50-step lags (200 single-walker steps
  from the equilibrated frame), propagate of
  16 walkers x 100 steps, ``Iso.run(200)`` on the 100 solute-pair
  features, chis/koopman/rates, then a biased propagation of the 16
  walkers under a chi-gradient bias (constrained ABOBA): the cell-list
  pair-sweep kernel at every constrained MD step.

- villin HP35 with all-pairs features on the hybrid route
  (``tools/run_villin_scale.py``'s system, ``examples/villin.py``'s
  minimization): ``peptide_pdb`` builds it from sequence and minimizes it
  in OBC2 (800 FIRE steps), ``MDSimulation(steps=100, implicit="obc2",
  features=FeaturesAll())`` = 588 atoms and 172,578 pair features,
  ``Iso(nx=8, nk=4)`` (the bootstrap: 2 chains x (4 + 2 burn-in) lags
  at B=2) with the default chi model (535 M parameters),
  ``run(50)``, ``optcontrol`` + a biased ``propagate`` of 8 x 4 walkers,
  ``run_girsanov(generations=1, iter=50, kde=8, forcescale=0.5)``,
  chis/koopman/rates: the force kernel at every MD step, and inside the
  bias at every biased step the pair-distance kernels (forward and
  gradient), which also featurize every new batch.

- generic constraints, the dense route and Ewald / PME: alanine with
  HBonds (6 walkers, one 20-step lag on the plain route) and HAngles at
  3 fs; villin with HBonds on the hybrid route (``examples/villin.py`` at
  ``small=True``: OBC2, 0.5 nm radius features, ``Iso(nx=8, nk=1)``, one
  generation of ``resample_strat(2)`` + ``resample_kde(2)`` +
  ``run(10)``, 10-step lags): kernel D once a constrained step; solvated
  alanine at its defaults (``examples/alanine_water.py``: 1,009 atoms,
  minimized by 250 FIRE steps, ``Iso(nx=20, nk=2)``, ``run(20)``,
  10-step lags) on
  the dense route (autograd all-pairs forces, no kernel); the JAX test's
  PME box (1,012 atoms) on the dense and the neighbor route, held against
  each other, kernel E's erfc sweep against its plain version and the
  reciprocal forces against float64 on the CPU, then phase 12's peptide
  with ``method="PME", constraints="HBonds"``: 16 walkers x 25 steps
  through kernel E.

- virtual sites, the barostat, LJPME, CMAP and Verlet lists: phase 12's
  peptide in TIP4P-Ew water (``tools/tip4p_solvated_tpu.py``: padding
  0.85, PME, the neighbor route; 4 walkers x 100 steps through kernel E
  with the M sites placed around every sweep, every output frame placed);
  ``npt_langevin`` on phase 12's PME peptide with flexible waters (200
  steps, a volume move every 20, kernel E at the box of each block, E held
  against its plain version at boxes scaled by 0.95 and 1.04); LJPME on
  the JAX test's box (dense against neighbor route) and on phase 12's
  peptide (kernel E's dispersion branch against its plain version, 4
  walkers x 100 steps); the CMAP forces of the JAX test's toy chain
  against autograd and float64; the peptide on Verlet lists at the
  default skin (4 walkers x 50 steps, lists rebuilt at the reference's
  interval and whenever an atom has moved skin/2, no kernel; the plan's
  forces against kernel E's cell route).

- the alanine goldens (``tests/test_golden_md.py``): chi trained on the
  committed MSM data (1,536 x 8 bursts, 800 iterations) must correlate
  >= 0.98 with the committed eigenfunction, and fresh dynamics (384
  committed starts x 4 walkers x 500 steps, one launch of the
  LangevinMiddle kernel) >= 0.97; chi trained on the committed solvated
  features (768 x 4 bursts, ``ExternalSimulation`` data, 600 iterations)
  >= 0.95 with its eigenfunction;
- the toy goldens (``tests/test_golden.py``) at their sizes: Doublewell
  (> 0.99 against the exact eigenfunction, and its eigenvalue),
  Triplewell with a 3-D ISA chi (both slow eigenfunctions in its span,
  R >= 0.95), Mueller-Brown (> 0.98), the reaction paths of the trained
  Doublewell (``reactionpath_minimum``, ``reactionpath_ode``) and the
  committor of the Triplewell's rates, then a save/load round trip of the
  trained Doublewell learner and ``run_girsanov`` on it.

It times the kernels: E whole (its ``ms``, layout and sweep, as an MD
step pays it) and its sweep alone (``sweep_ms``), and E's layout kernel
against ``kernel_records``, its plain version; D also on villin; C and
C′ warm (``ms``: the inputs of the previous launch in the L2, as on the
path) and cold (``cold_ms``: behind a 128 MB write).  Besides each
kernel against its plain version, it holds that a walker's result does
not depend on the batch: row 0 of a batch equals the walker alone, bit
for bit, for D (B=37 and 1024), B (B=256, noiseless and noisy) and C′
(B=37 and 64, which also equals its tiled mirror bit for bit and gives
the same bits at other launch shapes).
Each phase prints one line; any failed check exits non-zero.  The last
two lines are a JSON list of the kernels (launches on their path, error
against the plain version, times, bound) and ``{"ok": true, "device":
{...}}``.  Needs one CUDA GPU; exits 2 without one.  Imports nothing of
JAX.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import threading
import warnings
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

LIMIT_S = 180          # watchdog: the whole run, kernel build included
TB, TSTEPS = 4, 10     # solvated temperature witness: walkers, steps
HP35 = "LSDEDFKAVFGMTRSAFANLPLWKQQNLKKEKGLF"    # villin headpiece
ROOT = os.path.dirname(os.path.abspath(__file__))


def watchdog():
    def fire():
        print(f"chip_smoke: watchdog fired after {LIMIT_S} s", flush=True)
        os._exit(1)
    t = threading.Timer(LIMIT_S, fire)
    t.daemon = True
    t.start()


def phase(name, t0, msg=""):
    print(f"phase {name}: ok {time.perf_counter() - t0:.2f}s {msg}",
          flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(f"check failed: {what}")


def cuda_ms(fn, reps=1):
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """``fn()`` once and its device time in ms, by CUDA events, without a
    warm-up call (for the plain versions, already run)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _production_tool():
    """``tools/run_trpcage_production_torch.py`` as a module."""
    import importlib.util
    path = os.path.join(ROOT, "tools", "run_trpcage_production_torch.py")
    spec = importlib.util.spec_from_file_location(
        "run_trpcage_production_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

def _counted_kernels():
    """Every kernel wrapper that counts launches."""
    from isokann_tpu_torch.md import gb_kernel as GB
    from isokann_tpu_torch.md import girsanov_kernel as GK
    from isokann_tpu_torch.md import langevin_kernel as LK
    from isokann_tpu_torch.md import neighbor_kernel as NBK
    from isokann_tpu_torch.ops import pairdists_kernel as PK
    return (LK.langevin_middle, LK.forces, GK.aboba_girsanov, GB.gb_force,
            NBK.neighbor_sweep, NBK.neighbor_layout, PK.sqpairdist_fwd,
            PK.sqpairdist_bwd)


def constraints_phase(vpdb, stamp):
    """Generic bond constraints on the card: alanine with HBonds (the JAX
    test's system, ``tests/test_md.py``: 6 walkers, one 20-step lag, the
    plain route) and HAngles at 3 fs (30 steps), then villin with HBonds
    on the hybrid route (``examples/villin.py`` at ``small=True``: OBC2,
    0.5 nm radius features, NesterovRegularized, nx 8, nk 1, one
    generation of resample_strat(2) + resample_kde(2) + run(10); steps
    cut 50 -> 10; from phase 15's minimized structure): kernel D once a
    constrained step.  Returns D's launches and the step times."""
    import numpy as np
    import torch
    import isokann_tpu_torch as itt
    from isokann_tpu_torch.md import gb_kernel as GB
    from isokann_tpu_torch.md.integrators import KB
    out = {}
    for k in _counted_kernels():
        k.launches = 0
    t1 = time.perf_counter()
    csim = itt.MDSimulation(steps=20, constraints="HBonds")
    cs = csim.constraint_set
    require(csim.route == "plain" and cs.ngeneric == cs.ncons == 12
            and cs.nwater == 0, "alanine HBonds: 12 constraints, plain route")
    cgen = itt.make_generator(70)
    ys = csim.propagate(csim.coords[None].repeat(6, 1), 1, gen=cgen)[:, 0]
    e = csim.potential(ys)
    e0 = float(csim.potential(csim.coords[None])[0])
    viol = cs.max_violation(ys)
    ebound = e0 + 3 * 1.5 * KB * 310 * csim.natoms
    require(bool(torch.isfinite(ys).all()), "alanine HBonds: finite frames")
    require(viol < 1e-4, "alanine HBonds held to 1e-4 nm")
    require(bool((e < ebound).all()), "alanine HBonds: E < E0 + 4.5 kB T N")
    hsim = itt.MDSimulation(steps=30, step=0.003, constraints="HAngles")
    hy = hsim.propagate(hsim.coords[None], 2, gen=cgen)
    torch.cuda.synchronize()
    t_ala = time.perf_counter() - t1
    require(bool(torch.isfinite(hy).all()), "alanine HAngles 3 fs: finite")
    require(all(k.launches == 0 for k in _counted_kernels()),
            "the constrained plain route launches no kernel")
    print(f"  alanine HBonds: {cs.ncons} constraints in {len(cs.classes)} "
          f"classes, 6 walkers x 20 steps: violation {viol:.2e} nm (tol "
          f"1e-4), energies max {float(e.max()):.1f} < {ebound:.1f} kJ/mol;"
          f" HAngles ({hsim.constraint_set.ncons} constraints, "
          f"{len(hsim.constraint_set.classes)} classes, "
          f"{hsim.constraint_set.iters} sweeps) 2 walkers x 30 steps of "
          f"3 fs finite, violation "
          f"{hsim.constraint_set.max_violation(hy):.2e} nm; "
          f"{t_ala:.3f}s {stamp}")

    t1 = time.perf_counter()
    vsim = itt.MDSimulation(pdb=vpdb, steps=10, implicit="obc2",
                            constraints="HBonds", features=0.5)
    vcs = vsim.constraint_set
    require(vsim.route == "hybrid" and vcs.ngeneric > 250
            and vcs.nwater == 0, "villin HBonds on the hybrid route")
    vgen = itt.make_generator(71)
    r0 = vsim.retries
    viso = itt.Iso(sim=vsim, nx=8, nk=1, opt=itt.NesterovRegularized(),
                   gen=vgen)
    torch.cuda.synchronize()
    tv = {"Iso": time.perf_counter() - t1}
    props = 1                       # the bootstrap's bursts
    for g in range(1):
        for name, fn in (("strat", lambda: viso.resample_strat(2)),
                         ("kde", lambda: viso.resample_kde(2)),
                         ("run", lambda: viso.run(10))):
            t2 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            tv[f"{name}{g}"] = time.perf_counter() - t2
        props += 2
    vchi = viso.chis()
    torch.cuda.synchronize()
    t_vil = time.perf_counter() - t1
    chains, burnin = vsim.bootstrap_chains(8)
    lags = 8 // chains + burnin
    want = vsim.steps * (lags + props + vsim.retries - r0)
    d_path = GB.gb_force.launches
    vl = np.asarray(viso.losses)
    vviol = max(vcs.max_violation(viso.data.coords),
                vcs.max_violation(viso.data.propcoords))
    require(d_path == want, "villin HBonds: gb_force once a constrained "
                            "step")
    require(len(vl) == 10 and np.all(np.isfinite(vl)),
            "villin HBonds: finite losses")
    require(vviol < 1e-4, "villin HBonds held to 1e-4 nm on the data")
    require(len(viso.data) == 12 and bool(torch.isfinite(vchi).all()),
            "villin HBonds: the data grew by 4, finite chi")
    require(all(k.launches == 0 for k in _counted_kernels()
                if k is not GB.gb_force), "villin HBonds: no other kernel")

    # a constrained hybrid step and kernel D alone, noiseless, B = 2 / 8
    step_ms, d_ms = {}, {}
    for b in (2, 8):
        x = viso.data.coords[:b].contiguous()
        v = vcs.rattle(x, vsim.random_velocities(itt.make_generator(72),
                                                 x.shape))
        step_ms[b] = cuda_ms(lambda: vsim._integrate(x, v, 4, None)) / 4
        d_ms[b] = cuda_ms(lambda: GB.gb_force(vsim.gbplan, x), reps=20)
    print(f"  villin HBonds ({vsim.natoms} atoms, {vcs.ncons} constraints "
          f"in {len(vcs.classes)} classes, {viso.data.featuredim} radius "
          f"features): Iso(nx=8, nk=1) + resample_strat(2) + "
          f"resample_kde(2) + run(10) {t_vil:.3f}s ("
          + " ".join(f"{k} {v:.3f}" for k, v in tv.items())
          + f"); loss {vl[0]:.4f} -> "
          f"{vl[-1]:.4f}; violation {vviol:.2e} nm (tol 1e-4); retries "
          f"{vsim.retries - r0}; gb_force launches {d_path} (expected "
          f"{want}: {vsim.steps} x ({lags} bootstrap lags at B={chains} + "
          f"{props} propagations)); constrained hybrid step "
          + ", ".join(f"B={b} {step_ms[b]:.3f} ms (gb_force {d_ms[b]:.4f} "
                      f"ms, the rest {step_ms[b] - d_ms[b]:.3f})"
                      for b in (2, 8)) + f" {stamp}")
    out.update(d_launches=d_path, t_ala=t_ala, t_villin=t_vil,
               step_ms=step_ms, d_ms=d_ms)
    return out


def solvated_dense_phase(stamp):
    """The dense route on the card: ``examples/alanine_water.py`` at its
    small depth (``addwater=True, padding=0.8``, nx 20, nk 2, run(20);
    steps cut 100 -> 10; the example's ``minimize=True`` (500 FIRE steps)
    cut to ``setcoords(minimize(maxiter=250))``): 1,009 atoms, rigid
    waters, autograd all-pairs forces (no kernel).  Returns the step times
    and memory."""
    import numpy as np
    import torch
    import isokann_tpu_torch as itt
    for k in _counted_kernels():
        k.launches = 0
    t1 = time.perf_counter()
    dsim = itt.MDSimulation(addwater=True, padding=0.8, steps=10)
    dsim.setcoords(dsim.minimize(maxiter=250))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t1
    dcs = dsim.constraint_set
    require(dsim.natoms == 1009 and dsim.route == "dense"
            and dsim.system.dense_pairs and dcs.nwater > 0,
            "solvated alanine: 1,009 atoms on the dense route")
    # device memory: the peak of each stage above what was allocated
    # before it (the earlier phases' tensors)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    diso = itt.Iso(sim=dsim, nx=20, nk=2, gen=73)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t1
    path_mem = torch.cuda.max_memory_allocated() - held
    t1 = time.perf_counter()
    diso.run(20)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t1
    chi = diso.chis()
    dl = np.asarray(diso.losses)
    viol = max(dcs.max_violation(diso.data.coords),
               dcs.max_violation(diso.data.propcoords))
    require(all(k.launches == 0 for k in _counted_kernels()),
            "the dense route launches no kernel")
    require(np.all(np.isfinite(dl)), "solvated dense: finite losses")
    require(viol < 1e-4, "solvated dense: rigid waters held to 1e-4 nm")
    require(bool(torch.isfinite(chi).all()) and float(chi.min()) >= 0.0
            and float(chi.max()) <= 1.0, "solvated dense: chi in [0, 1]")
    chains = dsim.bootstrap_chains(20)[0]
    step_ms, mem = {}, {}
    for b in (chains, 40, 64):
        x = diso.data.propcoords.reshape(-1, dsim.dim)[:b].contiguous()
        x = x.repeat(-(-b // x.shape[0]), 1)[:b].contiguous()
        v = dcs.rattle(x, dsim.random_velocities(itt.make_generator(74),
                                                 x.shape))
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step_ms[b] = cuda_ms(lambda: dsim._integrate(x, v, 5, None)) / 5
        mem[b] = torch.cuda.max_memory_allocated() - held
    print(f"  solvated alanine, dense route: {dsim.natoms} atoms, "
          f"{dcs.nwater} rigid waters, box {dsim.system.box} nm; "
          f"MDSimulation (solvate + system) + 250 FIRE steps "
          f"{t_build:.3f}s, Iso(nx=20, nk=2) {t_data:.3f}s (bootstrap "
          f"{chains} chains at B={chains}, propagate 64 padded walkers), "
          f"run(20) {t_train:.3f}s; loss {dl[0]:.4f} -> {dl[-1]:.4f}; chi "
          f"[{float(chi.min()):.4f}, {float(chi.max()):.4f}]; violation "
          f"{viol:.2e} nm; dense step "
          + ", ".join(f"B={b} {step_ms[b]:.3f} ms (peak +"
                      f"{mem[b] / 2 ** 30:.2f} GiB)" for b in step_ms)
          + f"; the bootstrap and propagation's peak +"
            f"{path_mem / 2 ** 30:.2f} GiB (over what was allocated before) "
            f"{stamp}")
    return dict(t_build=t_build, t_data=t_data, step_ms=step_ms, mem=mem,
                path_mem=path_mem)


def pme_phase(spdb, x_eq, sxs, nks, stamp):
    """Ewald / PME on the card: the JAX test's PME box (``tests/
    test_ewald.py``: alanine, ``padding=0.9, method="PME"``, 1,012 atoms)
    on the dense route and, with ``dense_pairs=False``, on the neighbor
    route (kernel E's erfc sweep + the reciprocal sum + the exceptions),
    held against each other on 4 perturbed frames, E against its plain
    version and the reciprocal forces against float64 on the CPU; both
    propagated 2 lags of 3 steps at B=4; then phase 12's solvated peptide
    with ``method="PME", constraints="HBonds"`` from phase 12's
    equilibrated frame: its 16 walkers (``sxs`` x ``nks``), one 25-step
    lag through E.  Returns E's launches and errors."""
    import numpy as np
    import torch
    import isokann_tpu_torch as itt
    from isokann_tpu_torch.md import ewald as EW
    from isokann_tpu_torch.md import forces as F
    from isokann_tpu_torch.md import neighbor as NB
    from isokann_tpu_torch.md import neighbor_kernel as NBK
    dev = torch.device("cuda")
    kw = dict(addwater=True, padding=0.9, steps=3, method="PME")
    t1 = time.perf_counter()
    pd = itt.MDSimulation(**kw)
    pn = itt.MDSimulation(dense_pairs=False, **kw)
    t_build = time.perf_counter() - t1
    sysn = pn.system
    require(pd.natoms == pn.natoms == 1012 and pd.route == "dense"
            and pn.route == "neighbor" and sysn.method == "PME",
            "the PME box: 1,012 atoms on the dense and neighbor routes")
    rng = np.random.default_rng(0)
    n = pd.natoms
    xs = torch.as_tensor(
        pd.coords.cpu().numpy().reshape(1, n, 3)
        + rng.normal(scale=0.003, size=(4, n, 3)), dtype=torch.float32,
        device=dev)
    xb = xs.reshape(4, -1).contiguous()
    xg = xs.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(F.nonbonded_energy(pd.system, xg).sum(), xg)
    f_d = -g
    f_n = (NB.force_flat_neighbor(sysn, xb, pn.nbplan).reshape(xs.shape)
           - NB.bonded_force_sparse(sysn, xs))
    dn = float((f_n - f_d).abs().max())
    dn_tol = 2e-4 * float(f_d.abs().max()) + 0.5
    alpha = sysn.ewald_alpha
    f_k = NBK.neighbor_sweep(sysn, pn.nbplan, xb, alpha)
    f_p = NBK.neighbor_sweep_plain(sysn, pn.nbplan, xb, alpha)
    sweep_err = float((f_k - f_p).abs().max())
    sweep_rel = sweep_err / float(f_p.abs().max())
    kv, cf, q = sysn.ewald_kvecs, sysn.ewald_coefs, sysn.charges
    f_r = EW.ewald_recip_force(kv, cf, q, xs)
    f_r64 = EW.ewald_recip_force(kv.double().cpu(), cf.double().cpu(),
                                 q.double().cpu(), xs.double().cpu())
    rec_rel = float((f_r.double().cpu() - f_r64).abs().max()
                    / f_r64.abs().max())
    print(f"  PME box: {n} atoms, box {sysn.box} nm, cutoff {sysn.cutoff} "
          f"nm, alpha {alpha:.4f}/nm, {kv.shape[0]} k-vectors; 4 frames: "
          f"neighbor route (E erfc + reciprocal + exceptions) vs dense "
          f"route max |df| {dn:.4f} (tol {dn_tol:.4f} = 2e-4 max|f| + 0.5);"
          f" neighbor_sweep erfc vs plain max rel err {sweep_rel:.3e} (tol "
          f"1e-5); reciprocal forces vs float64 on the CPU max rel err "
          f"{rec_rel:.3e} (tol 1e-5) {stamp}")
    require(dn < dn_tol, "PME: neighbor route vs dense route")
    require(sweep_rel < 1e-5, "PME: neighbor_sweep erfc vs plain")
    require(rec_rel < 1e-5, "PME: reciprocal forces vs float64")

    for k in _counted_kernels():
        k.launches = 0
    pgen = itt.make_generator(75)
    r0 = pn.retries
    t1 = time.perf_counter()
    ends = {}
    for sim in (pd, pn):
        y = sim.coords[None].repeat(4, 1)
        for _ in range(2):
            y = sim.propagate(y, 1, gen=pgen)[:, 0]
        e = sim.potential(y)
        require(bool(torch.isfinite(y).all())
                and bool(torch.isfinite(e).all()),
                "PME: finite frames and energies on both routes")
        require(sim.constraint_set.max_violation(y) < 1e-4,
                "PME: rigid waters held")
        ends[sim.route] = e
    torch.cuda.synchronize()
    t_prop = time.perf_counter() - t1
    e_box = NBK.neighbor_sweep.launches
    want_box = pn.steps * (2 + pn.retries - r0)
    require(e_box == want_box and NBK.neighbor_layout.launches == want_box,
            "PME box: layout and sweep once a neighbor-route step")
    require(pn.overflows == 0, "PME box: no cell overflow")

    t1 = time.perf_counter()
    psim = itt.MDSimulation(pdb=spdb, addwater=True, padding=1.0,
                            steps=25, method="PME", constraints="HBonds")
    t_pbuild = time.perf_counter() - t1
    pcs = psim.constraint_set
    require(psim.natoms == 7744 and psim.route == "neighbor"
            and pcs.nwater == 2526 and pcs.ngeneric > 0,
            "PME peptide: 7,744 atoms, rigid waters and solute HBonds, "
            "neighbor route")
    psim.setcoords(x_eq)
    n0 = NBK.neighbor_sweep.launches
    r0 = psim.retries
    t1 = time.perf_counter()
    yp = psim.propagate(sxs, nks, gen=pgen)
    torch.cuda.synchronize()
    t_pep = time.perf_counter() - t1
    e_pep = NBK.neighbor_sweep.launches - n0
    want_pep = psim.steps * (1 + psim.retries - r0)
    pviol = pcs.max_violation(yp)
    print(f"  PME box: 2 lags x {pn.steps} steps at B=4 on both routes "
          f"{t_prop:.3f}s (energies dense {ends['dense'].tolist()}, "
          f"neighbor {ends['neighbor'].tolist()}), neighbor_sweep launches "
          f"{e_box} (expected {want_box}); PME peptide with HBonds "
          f"({psim.natoms} atoms, {pcs.ngeneric} solute constraints in "
          f"{len(pcs.classes)} classes, {psim.system.ewald_kvecs.shape[0]} "
          f"k-vectors; MDSimulation {t_pbuild:.3f}s): propagate "
          f"{sxs.shape[0]}x{nks} x {psim.steps} steps {t_pep:.3f}s "
          f"({1e3 * t_pep / psim.steps:.3f} ms/step at B="
          f"{sxs.shape[0] * nks}); violation {pviol:.2e} nm (tol 1e-4); "
          f"overflows {psim.overflows}; neighbor_sweep launches {e_pep} "
          f"(expected {want_pep}) {stamp}")
    require(bool(torch.isfinite(yp).all()), "PME peptide: finite frames")
    require(pviol < 1e-4, "PME peptide: constraints held to 1e-4 nm")
    require(psim.overflows == 0, "PME peptide: no cell overflow")
    require(e_pep == want_pep
            and NBK.neighbor_layout.launches == e_box + e_pep,
            "PME peptide: layout and sweep once a step")
    require(all(k.launches == 0 for k in _counted_kernels()
                if k not in (NBK.neighbor_sweep, NBK.neighbor_layout)),
            "the PME paths launch no other kernel")
    return dict(e_launches=e_box + e_pep, sweep_err=sweep_err,
                t_prop=t_prop, t_pep=t_pep, t_build=t_build + t_pbuild)


def _frames(x, n, seed, scale=0.003):
    """``n`` frames (n, 3N) of ``x`` (3N,) moved by normals of ``scale`` nm
    from ``default_rng(seed)``, on ``x``'s device."""
    import numpy as np
    import torch
    z = np.random.default_rng(seed).normal(scale=scale, size=(n, x.numel()))
    return (x[None] + torch.as_tensor(z, dtype=torch.float32,
                                      device=x.device)).contiguous()


def _sweep_vs_plain(sys, plan, xb, alpha=None, beta=None, box=None):
    """Kernel E against its plain version on (B, 3N) walkers: (max
    relative error, max absolute error)."""
    from isokann_tpu_torch.md import neighbor_kernel as NBK
    f_k = NBK.neighbor_sweep(sys, plan, xb, alpha, beta, box=box)
    f_p = NBK.neighbor_sweep_plain(sys, plan, xb, alpha, beta, box=box)
    err = float((f_k - f_p).abs().max())
    return err / float(f_p.abs().max()), err


def tip4p_phase(spdb, stamp):
    """TIP4P-Ew water on the card: ``tools/tip4p_solvated_tpu.py``'s
    configuration (phase 12's peptide, ``water_model="tip4pew",
    padding=0.85, method="PME", dense_pairs=False``, 100-step lags, 4
    walkers; one lag instead of four): one ``propagate`` through kernel E
    with the sites placed before every sweep and their forces handed to
    the parents; every output frame placed, the waters rigid; E against
    its plain version on the placed frames at B=1 and B=4; the energy
    blind to a site row and not to its O.  Returns E's launches."""
    import torch
    import isokann_tpu_torch as itt
    from isokann_tpu_torch.md import neighbor_kernel as NBK
    from isokann_tpu_torch.md.solvate import M_WEIGHTS, R_OH, water_triplets
    for k in _counted_kernels():
        k.launches = 0
    t1 = time.perf_counter()
    sim = itt.MDSimulation(pdb=spdb, addwater=True, water_model="tip4pew",
                           padding=0.85, steps=100, method="PME",
                           dense_pairs=False)
    t_build = time.perf_counter() - t1
    sys, cs = sim.system, sim.constraint_set
    vs = sys.vs_idx
    nv = int(vs.shape[0])
    print(f"  TIP4P-Ew box: {sim.natoms} atoms, {nv} M sites, {cs.nwater} "
          f"waters (stride {cs.wstride}, {cs.ngeneric} other constraints), "
          f"box {sys.box} nm, {sys.ewald_kvecs.shape[0]} k-vectors, plan "
          f"grid {tuple(int(c) for c in sim.nbplan.nc)} capacity "
          f"{sim.nbplan.C}; MDSimulation {t_build:.3f}s")
    require(sim.route == "neighbor" and nv > 1000 and cs.nwater == nv
            and cs.wstride == 4 and cs.ngeneric == 0,
            "TIP4P-Ew: sites on the neighbor route, a stride-4 water block")
    gen = itt.make_generator(80)
    r0 = sim.retries
    t1 = time.perf_counter()
    y = sim.propagate(sim.coords[None].repeat(4, 1), 1, gen=gen)[:, 0]
    torch.cuda.synchronize()
    t_prop = time.perf_counter() - t1
    e_path = NBK.neighbor_sweep.launches
    want = sim.steps * (1 + sim.retries - r0)
    y3 = y.reshape(4, -1, 3)
    par = sys.vs_gather[vs]
    w = M_WEIGHTS
    placed = (w[0] * y3[:, par[:, 0]] + w[1] * y3[:, par[:, 1]]
              + w[2] * y3[:, par[:, 2]])
    m_err = float((y3[:, vs] - placed).abs().max())
    trip = torch.as_tensor(water_triplets(sim.structure), device=y.device)
    oh = torch.cat([torch.linalg.norm(y3[:, trip[:, 0]] - y3[:, trip[:, k]],
                                      dim=-1) for k in (1, 2)])
    oh_err = float((oh - R_OH).abs().max())
    errs = {b: _sweep_vs_plain(sys, sim.nbplan, y[:b].contiguous(),
                               sys.ewald_alpha) for b in (1, 4)}
    x0 = y[0].reshape(-1, 3)
    x2, x3 = x0.clone(), x0.clone()
    x2[vs[0]] += 1.0
    x3[par[0, 0]] += 0.05
    e1, e2, e3 = sim.potential(torch.stack([x0, x2, x3]).reshape(3, -1)
                               ).tolist()
    print(f"  TIP4P-Ew propagate 4 walkers (8 padded) x {sim.steps} steps "
          f"{t_prop:.3f}s ({1e3 * t_prop / sim.steps:.3f} ms/step); M sites "
          f"placed within {m_err:.2e} nm (tol 2e-6), O-H {oh_err:.2e} nm "
          f"from R_OH (tol 2e-3); overflows {sim.overflows}; E vs plain on "
          f"the placed frames max rel err "
          + ", ".join(f"B={b} {e[0]:.3e}" for b, e in errs.items())
          + f" (tol 1e-5); energy {e1:.3f}, an M row moved 1 nm {e2:.3f}, "
            f"its O moved 0.05 nm {e3:.3f} kJ/mol; neighbor_sweep launches "
            f"{e_path} (expected {want}) {stamp}")
    require(bool(torch.isfinite(y).all()), "TIP4P-Ew: finite frames")
    require(m_err < 2e-6, "TIP4P-Ew: every M placed on every output frame")
    require(oh_err < 2e-3, "TIP4P-Ew: rigid waters")
    require(sim.overflows == 0, "TIP4P-Ew: no cell overflow")
    require(all(e[0] < 1e-5 for e in errs.values()),
            "TIP4P-Ew: kernel E vs plain at B=1 and B=4")
    require(abs(e2 - e1) <= max(1e-6 * abs(e1), 1e-3) and abs(e3 - e1) > 1.0,
            "TIP4P-Ew: the energy places the sites")
    require(e_path == want and NBK.neighbor_layout.launches == e_path + 2,
            "TIP4P-Ew: layout and sweep once a step")
    return dict(e_launches=e_path, err=max(e[1] for e in errs.values()),
                t_build=t_build, t_prop=t_prop)


def npt_phase(spdb, x_eq, stamp):
    """NPT on the card: phase 12's peptide with PME and flexible waters
    (``npt_langevin`` runs no constraints, as the reference's), its
    equilibrated frame, 200 steps of ``npt_langevin`` at ``interval=20``:
    kernel E every step at the box of the block, a volume move every 20
    steps (energies by the tensor sweep), no cell overflow on a block's
    end frame and the volume inside what one plan covers; the static box
    passed at run time against the static energy; E at boxes scaled by
    0.95 and 1.04 against its plain version at the same boxes.  Returns
    E's launches and its time at the path's batch (B = 1)."""
    import numpy as np
    import torch
    import isokann_tpu_torch as itt
    from isokann_tpu_torch.md import barostat as BA
    from isokann_tpu_torch.md import neighbor as NB
    from isokann_tpu_torch.md import neighbor_kernel as NBK
    t1 = time.perf_counter()
    sim = itt.MDSimulation(pdb=spdb, addwater=True, padding=1.0, steps=100,
                           method="PME", rigidwater=False)
    t_build = time.perf_counter() - t1
    sys = sim.system
    require(sim.natoms == 7744 and sim.route == "neighbor"
            and sim.constraint_set is None,
            "NPT peptide: 7,744 atoms, flexible waters, the neighbor route")
    sim.setcoords(x_eq)
    plan = NB.NeighborPlan(sys, x0=x_eq.cpu().numpy().reshape(-1, 3),
                           box_slack=0.1)
    x3 = x_eq.reshape(-1, 3)
    e0 = float(NB.potential_energy_neighbor(sys, x3, plan))
    e1 = float(NB.potential_energy_neighbor(sys, x3, plan, box=sys.box))
    xq = _frames(x_eq, 4, 82)
    errs, err_abs, ms, plain_ms = {}, 0.0, {}, {}
    for f in (0.95, 1.04):
        box = tuple(b * f for b in sys.box)
        xf = (xq * f).contiguous()       # the molecules' density kept
        for b in (1, 4):
            errs[f, b], ea = _sweep_vs_plain(sys, plan, xf[:b].contiguous(),
                                             sys.ewald_alpha, box=box)
            err_abs = max(err_abs, ea)
        x1 = xf[:1].contiguous()
        ms[f] = cuda_ms(lambda: NBK.neighbor_sweep(sys, plan, x1,
                                                   sys.ewald_alpha, box=box),
                        reps=20)
        _, plain_ms[f] = timed(lambda: NBK.neighbor_sweep_plain(
            sys, plan, x1, sys.ewald_alpha, box=box))
    for k in _counted_kernels():
        k.launches = 0
    t1 = time.perf_counter()
    xf, box_f, info = BA.npt_langevin(sim, gen=itt.make_generator(81),
                                      steps=200, interval=20, pressure=1.0)
    torch.cuda.synchronize()
    t_npt = time.perf_counter() - t1
    e_path = NBK.neighbor_sweep.launches
    ratio = float(torch.prod(box_f)) / float(np.prod(sys.box))
    print(f"  NPT peptide ({sim.natoms} atoms, PME, flexible waters; "
          f"MDSimulation {t_build:.3f}s): energy at the static box "
          f"{e0:.3f}, the same box at run time {e1:.3f} kJ/mol (tol 1e-3 + "
          f"1e-6|E|); E vs plain at scaled boxes max rel err "
          + ", ".join(f"x{f} B={b} {e:.3e}" for (f, b), e in errs.items())
          + f" (tol 1e-5); E at B=1 " + ", ".join(
              f"x{f} {ms[f]:.4f} ms (plain {plain_ms[f]:.3f} ms)"
              for f in ms)
          + f"; npt_langevin 200 steps at interval 20 {t_npt:.3f}s: "
            f"{info['attempted']} moves attempted, {info['accepted']} "
            f"accepted, dV scale {info['dv_scale']:.4f} nm^3, volume x"
            f"{ratio:.4f}, box {[round(b, 4) for b in box_f.tolist()]} nm, "
            f"cell overflow on the blocks' end frames {info['overflow']}, "
            f"plan rebuilds {info['replans']}; neighbor_sweep launches "
            f"{e_path} (expected 200) {stamp}")
    require(abs(e0 - e1) < 1e-3 + 1e-6 * abs(e0),
            "NPT: the static box at run time gives the static energy")
    require(all(e < 1e-5 for e in errs.values()),
            "NPT: kernel E vs plain at scaled boxes")
    require(bool(torch.isfinite(xf).all()), "NPT: finite frame")
    require(info["attempted"] == 10, "NPT: 10 moves attempted")
    require(info["overflow"] == 0, "NPT: no cell overflow")
    # a plan is valid down to (1 - box_slack) of its box, 0.1 here
    require(0.9 ** 3 < ratio < 2.0, "NPT: the volume within 0.729-2x")
    require(e_path == 200 and NBK.neighbor_layout.launches == 200,
            "NPT: layout and sweep once a step")
    require(all(k.launches == 0 for k in _counted_kernels()
                if k not in (NBK.neighbor_sweep, NBK.neighbor_layout)),
            "NPT launches no other kernel")
    return dict(e_launches=e_path, err=err_abs, ms=ms[0.95],
                plain_ms=plain_ms[0.95], t_npt=t_npt)


def ljpme_phase(spdb, x_eq, stamp):
    """LJPME on the card: the JAX test's LJPME box (``tests/test_ljpme.py``:
    alanine, padding 0.62) on the dense route and, with ``dense_pairs=
    False``, on the neighbor route, held against each other; phase 12's
    peptide with ``method="LJPME"``: kernel E's dispersion branch against
    its plain version at B=1 and B=4, its time and bound, and one 100-step
    lag of 4 walkers from the equilibrated frame.  Returns E's launches,
    error, times and bound."""
    import torch
    import isokann_tpu_torch as itt
    from isokann_tpu_torch.md import forces as F
    from isokann_tpu_torch.md import neighbor as NB
    from isokann_tpu_torch.md import neighbor_kernel as NBK
    kw = dict(addwater=True, padding=0.62, method="LJPME")
    ld = itt.MDSimulation(**kw)
    ln = itt.MDSimulation(dense_pairs=False, **kw)
    require(ld.route == "dense" and ln.route == "neighbor"
            and ln.system.method == "LJPME" and not ln.system.use_dispersion,
            "the LJPME box on the dense and neighbor routes")
    x = ld.coords.reshape(-1, 3)
    e_d = float(F.nonbonded_energy(ld.system, x[None])[0])
    e_n = float(NB.neighbor_nonbonded_energy(ln.system, x, ln.nbplan))
    print(f"  LJPME box ({ld.natoms} atoms, beta {ln.system.ljpme_beta:.4f}"
          f"/nm): nonbonded energy dense {e_d:.3f}, neighbor {e_n:.3f} "
          f"kJ/mol (tol 0.2 + 2e-4|E|) {stamp}")
    require(abs(e_n - e_d) < 0.2 + 2e-4 * abs(e_d),
            "LJPME: neighbor route vs dense route")

    t1 = time.perf_counter()
    sim = itt.MDSimulation(pdb=spdb, addwater=True, padding=1.0, steps=100,
                           method="LJPME")
    t_build = time.perf_counter() - t1
    sys, plan = sim.system, sim.nbplan
    require(sim.natoms == 7744 and sim.route == "neighbor"
            and sim.constraint_set.nwater == 2526,
            "LJPME peptide: 7,744 atoms, rigid waters, the neighbor route")
    sim.setcoords(x_eq)
    alpha, beta = NB._alpha(sys), NB._beta(sys)
    xq = _frames(x_eq, 8, 83)
    errs = {b: _sweep_vs_plain(sys, plan, xq[:b].contiguous(), alpha, beta)
            for b in (1, 4)}
    ms = {b: cuda_ms(lambda: NBK.neighbor_sweep(
        sys, plan, xq[:b].contiguous(), alpha, beta), reps=10)
        for b in (1, 8)}
    ms_erfc = cuda_ms(lambda: NBK.neighbor_sweep(sys, plan, xq, alpha),
                      reps=10)
    _, plain_ms = timed(lambda: NBK.neighbor_sweep_plain(
        sys, plan, xq[:1].contiguous(), alpha, beta))
    in_range = NBK.pair_counts(sys, plan, xq[:1])[0]
    bms, by = NBK.bound_ms(plan, 8, 8 * in_range, alpha, beta)
    for k in _counted_kernels():
        k.launches = 0
    gen = itt.make_generator(84)
    r0 = sim.retries
    t1 = time.perf_counter()
    y = sim.propagate(x_eq[None], 4, gen=gen)[0]
    torch.cuda.synchronize()
    t_prop = time.perf_counter() - t1
    e_path = NBK.neighbor_sweep.launches
    want = sim.steps * (1 + sim.retries - r0)
    viol = sim.constraint_set.max_violation(y)
    print(f"  LJPME peptide ({sim.natoms} atoms; MDSimulation "
          f"{t_build:.3f}s): E's dispersion branch vs plain max rel err "
          + ", ".join(f"B={b} {e[0]:.3e}" for b, e in errs.items())
          + f" (tol 1e-5); E with the branch B=1 {ms[1]:.4f} ms, B=8 "
            f"{ms[8]:.4f} ms (without it, erfc only, B=8 {ms_erfc:.4f} ms; "
            f"plain B=1 {plain_ms:.3f} ms; bound at B=8 {bms:.4f} ms, {by}, "
            f"{in_range} pairs in cutoff a walker); propagate 4 walkers (8 "
            f"padded) x {sim.steps} steps {t_prop:.3f}s "
            f"({1e3 * t_prop / sim.steps:.3f} ms/step); violation "
            f"{viol:.2e} nm; overflows {sim.overflows}; neighbor_sweep "
            f"launches {e_path} (expected {want}) {stamp}")
    require(all(e[0] < 1e-5 for e in errs.values()),
            "LJPME: kernel E's dispersion branch vs plain")
    require(bool(torch.isfinite(y).all()) and viol < 1e-4,
            "LJPME peptide: finite frames, rigid waters")
    require(sim.overflows == 0, "LJPME peptide: no cell overflow")
    require(e_path == want and NBK.neighbor_layout.launches == want,
            "LJPME peptide: layout and sweep once a step")
    return dict(e_launches=e_path, err=max(e[1] for e in errs.values()),
                ms=ms[8], ms1=ms[1], plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, t_prop=t_prop)


def cmap_verlet_phase(spdb, x_eq, stamp):
    """CMAP and Verlet lists on the card: the CMAP forces of the JAX test's
    toy chain (``tests/test_cmap.py``) against autograd and against
    float64 on the CPU; phase 12's peptide with ``neighbor_mode="verlet"``
    at the default skin: one 50-step lag of 4 walkers on the lists (no
    kernel: the reference's Verlet path is XLA), then the forces from
    the plan it built against kernel E's cell route (1e-5 of max|f|,
    ``tests/test_verlet.py``).  Returns the Verlet times."""
    import numpy as np
    import torch
    import isokann_tpu_torch as itt
    from isokann_tpu_torch.md import cmap as CM
    from isokann_tpu_torch.md import neighbor as NB
    from isokann_tpu_torch.md.system import system_from_tables
    from isokann_tpu_torch.md.verlet import build_lists, force_verlet
    R = 24
    ang = -np.pi + 2 * np.pi * np.arange(R) / R
    P, S = np.meshgrid(ang, ang, indexing="ij")
    grid = 2.0 * np.cos(P) * np.sin(S)
    csys = system_from_tables(
        masses=[12.0] * 5, charges=[0.0] * 5, rmin_half=[0.0] * 5,
        eps=[0.0] * 5, bond_idx=[(i, i + 1) for i in range(4)],
        bond_k=[1e4] * 4, bond_r0=[0.15] * 4,
        excl_idx=[(i, j) for i in range(5) for j in range(i + 1, 5)],
        excl_qq=[0.0] * 10, excl_lj=[0.0] * 10,
        cmap_idx=[[0, 1, 2, 3, 1, 2, 3, 4]], cmap_type=[0],
        cmap_grids=[grid], method="NoCutoff")
    zig = np.array([[0.0, 0.0, 0.0], [0.15, 0.0, 0.0], [0.2, 0.14, 0.0],
                    [0.35, 0.15, 0.05], [0.4, 0.28, 0.12]])
    xs = torch.as_tensor(zig[None] + np.random.default_rng(85).normal(
        scale=0.02, size=(16, 5, 3)), dtype=torch.float32,
        device=x_eq.device)
    fc = CM.cmap_force(csys, xs)
    xg = xs.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(CM.cmap_energy(csys, xg).sum(), xg)
    c64 = csys.replace(cmap_coefs=csys.cmap_coefs.double().cpu(),
                       cmap_idx=csys.cmap_idx.cpu(),
                       cmap_type=csys.cmap_type.cpu())
    f64 = CM.cmap_force(c64, xs.double().cpu())
    scale = float(f64.abs().max())
    rel_ag = float((fc + g).abs().max()) / scale
    rel_64 = float((fc.double().cpu() - f64).abs().max()) / scale
    print(f"  CMAP toy chain, 16 frames: analytic forces vs autograd max rel "
          f"err {rel_ag:.3e}, vs float64 on the CPU {rel_64:.3e} (tol 1e-5); "
          f"energies {CM.cmap_energy(csys, xs)[:3].tolist()} {stamp}")
    require(rel_ag < 1e-5 and rel_64 < 1e-5, "CMAP forces")

    t1 = time.perf_counter()
    sim = itt.MDSimulation(pdb=spdb, addwater=True, padding=1.0, steps=50,
                           neighbor_mode="verlet")
    sim.setcoords(x_eq)
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t1
    for k in _counted_kernels():
        k.launches = 0
    gen = itt.make_generator(86)
    t1 = time.perf_counter()
    y = sim.propagate(x_eq[None], 4, gen=gen)[0]
    torch.cuda.synchronize()
    t_prop = time.perf_counter() - t1
    launched = sum(k.launches for k in _counted_kernels())
    d = sim.verlet_diag
    viol = sim.constraint_set.max_violation(y)
    # the plan the propagation built and used, held against E's cell route
    sys, vp = sim.system, sim.vplan
    box = torch.as_tensor(sys.box, dtype=torch.float32, device=x_eq.device)
    x3 = x_eq.reshape(1, -1, 3)
    t1 = time.perf_counter()
    lists, n_over = build_lists(vp, sys, x3 - box * torch.floor(x3 / box))
    torch.cuda.synchronize()
    t_list = time.perf_counter() - t1
    f_v = force_verlet(sys, x3, lists).reshape(1, -1)
    f_c = NB.force_flat_neighbor(sys, x_eq[None], sim.nbplan)
    rel = float((f_v - f_c).abs().max() / f_c.abs().max())
    periodic = -(-sim.steps // vp.rebuild_every)
    print(f"  Verlet lists on the peptide ({sim.natoms} atoms, skin "
          f"{vp.skin} nm, K {vp.K}, {vp.M} candidates an atom, rebuilt every "
          f"{vp.rebuild_every} steps and when an atom moved skin/2; "
          f"MDSimulation {t_sim:.3f}s, one build {t_list:.3f}s, overflow "
          f"{int(n_over[0])}): forces vs kernel E's cell route max rel err "
          f"{rel:.3e} (tol 1e-5); propagate 4 walkers (8 padded) x "
          f"{sim.steps} steps {t_prop:.3f}s ({1e3 * t_prop / sim.steps:.3f} "
          f"ms/step): builds {d['rebuilds']} ({periodic} at the interval, "
          f"{d['rebuilds'] - periodic} for a displacement), n_over "
          f"{d['n_over']}, max_disp {d['max_disp']:.4f} nm (< skin/2 = "
          f"{vp.skin / 2:.3f}), violation {viol:.2e} nm; kernel launches "
          f"{launched} {stamp}")
    require(int(n_over[0]) == 0 and rel < 1e-5,
            "Verlet: complete lists, forces equal to the cell route's")
    require(bool(torch.isfinite(y).all()) and viol < 1e-4,
            "Verlet: finite frames, rigid waters")
    require(d["n_over"] == 0 and d["max_disp"] < vp.skin / 2,
            "Verlet: lists exact over the lag")
    require(d["rebuilds"] >= periodic, "Verlet: rebuilt at the interval")
    require(launched == 0, "the Verlet route launches no kernel")
    return dict(t_sim=t_sim, t_list=t_list, t_prop=t_prop)


def _learner_copy(iso, gen):
    """A copy of the learner ``iso`` (its data, a copy of its weights and
    optimiser state, its losses) that later phases do not see."""
    import isokann_tpu_torch as itt
    c = itt.Iso(data=iso.data, model=copy.deepcopy(iso.model), opt=iso.opt,
                minibatch=iso.minibatch, gen=gen)
    c.optimizer.load_state_dict(copy.deepcopy(iso.optimizer.state_dict()))
    c.losses = list(iso.losses)
    return c


def _staged(times):
    """A ``stage(name, fn)`` that runs ``fn()`` to a synchronise and keeps
    its seconds in ``times``."""
    import torch

    def stage(name, fn):
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t1
        return out
    return stage


def analysis_phase(iso, stamp):
    """The analysis layer on a copy of the quickstart learner: the
    reactive path as ``examples/alanine.py:28`` writes it (sigma 1,
    maxjump 1; the host's scipy Bellman-Ford) and the same ids from the
    dense min-plus route on the card; the marginal free energy; the MI of
    the 231 features with chi; 8 levelset start points uniform in chi,
    ``constrained_free_energy`` over 200 steps (2,000 cut to 200: 200
    launches of kernel A's forces entry at B=8) and ``local_mean_force``
    (one launch); ``reactionpath_ode`` at steps 11, substeps 5 (220
    launches at B=1).  Kernel A's forces entry is the only kernel."""
    import numpy as np
    import torch
    import isokann_tpu_torch as itt
    from isokann_tpu_torch import analysis as A
    from isokann_tpu_torch.md import langevin_kernel as LK
    from isokann_tpu_torch.md.pdbio import read_pdb_traj

    for k in _counted_kernels():
        k.launches = 0
    aiso = _learner_copy(iso, 50)
    sim = aiso.data.sim
    ta, fl = {}, {}
    stage = _staged(ta)

    def forces(name, fn, want):
        n0 = LK.forces.launches
        out = stage(name, fn)
        fl[name] = (LK.forces.launches - n0, want)
        return out

    with tempfile.TemporaryDirectory() as out_dir:
        path = os.path.join(out_dir, "reactive_path.pdb")
        ids = stage("save_reactive_path", lambda: itt.save_reactive_path(
            aiso, sigma=1.0, maxjump=1.0, out=path))
        back = read_pdb_traj(path) if os.path.exists(path) else None
    chi = aiso.chis()[:, 0]
    dense = stage("reactive_path(device=True)", lambda: itt.reactive_path(
        chi, aiso.data.coords, sigma=1.0, maxjump=1.0,
        weights=sim.masses(), device=True))
    host = stage("reactive_path(device=False)", lambda: itt.reactive_path(
        chi, aiso.data.coords, sigma=1.0, maxjump=1.0,
        weights=sim.masses()))
    centers, F = stage("marginal_free_energy",
                       lambda: itt.marginal_free_energy(aiso))
    counts = np.histogram(chi.cpu().numpy(), bins=len(centers))[0]
    mi = stage("mutual_information", lambda: itt.mutual_information(aiso))
    xs = stage("sample_uniform_chi_coords",
               lambda: A.sample_uniform_chi_coords(aiso, 8))
    cchi, cF = forces("constrained_free_energy(steps=200)",
                      lambda: itt.constrained_free_energy(
                          aiso, xs, steps=200, gen=itt.make_generator(51)),
                      200)
    mchi, mF = forces("local_mean_force", lambda: A.local_mean_force(
        aiso, xs, nbins=4), 1)
    rp = forces("reactionpath_ode(steps=11, substeps=5)",
                lambda: itt.reactionpath_ode(aiso, xs[4], steps=11,
                                             substeps=5), 11 * 5 * 4)
    rchi = aiso.chicoords(rp)[:, 0]
    others = sum(k.launches for k in _counted_kernels()
                 if k is not LK.forces)
    f_an = LK.forces.launches
    print(f"  analysis: reactive path {len(ids)} of {len(aiso.data)} frames "
          f"(chi {float(chi[ids[0]]):.4f} -> {float(chi[ids[-1]]):.4f}), "
          f"written and read back {None if back is None else back.shape}, "
          f"dense min-plus route the same ids: {dense == ids}, host route "
          f"{host == ids}; marginal F over {int((counts > 0).sum())} filled "
          f"of {len(counts)} bins, max {float(F[counts > 0].max()):.3f} "
          f"kJ/mol; MI max {float(mi.max()):.4f} (feature "
          f"{int(mi.argmax())}) mean {float(mi.mean()):.4f}; constrained "
          f"free energy at chi {np.round(cchi, 4).tolist()}: "
          f"{np.round(cF, 3).tolist()} kJ/mol; local mean force at "
          f"{np.round(mchi, 4).tolist()}: {np.round(mF, 3).tolist()}; "
          f"reactionpath_ode chi {[round(float(c), 4) for c in rchi]}; "
          f"langevin_forces launches {f_an} by stage {fl}; other kernels "
          f"{others}; seconds "
          f"{ {k: round(v, 3) for k, v in ta.items()} } {stamp}")
    require(len(ids) >= 2 and back is not None
            and back.shape == (len(ids), sim.dim)
            and np.all(np.isfinite(back)),
            "save_reactive_path: >= 2 frames, written and read back")
    require(dense == ids and host == ids,
            "the reactive path: the same ids on the card's min-plus route")
    fin = counts > 0
    require(np.all(np.isfinite(F[fin])) and np.all(np.isinf(F[~fin]))
            and F[fin].min() == 0.0,
            "marginal_free_energy: finite where filled, minimum 0")
    require(mi.shape == (sim.natoms * (sim.natoms - 1) // 2,)
            and bool(torch.isfinite(mi).all()),
            "mutual_information: (231,), finite")
    require(xs.shape == (8, sim.dim) and cchi.shape == (8,)
            and np.all(np.diff(cchi) >= 0) and np.all(np.isfinite(cchi))
            and np.all(np.isfinite(cF)),
            "constrained_free_energy: finite, sorted by chi")
    require(mchi.shape == (4,) and np.all(np.isfinite(mF)),
            "local_mean_force finite")
    require(rp.shape == (11, sim.dim) and bool(torch.isfinite(rp).all()),
            "reactionpath_ode: (11, 66), finite")
    require(all(got == want for got, want in fl.values())
            and f_an == sum(v[0] for v in fl.values()),
            "kernel A's forces entry once a force evaluation")
    require(others == 0, "analysis runs no other kernel")
    return dict(f_launches=f_an, t=ta)


def analysis_goldens_phase(dw_iso, tw_iso, stamp):
    """The analysis layer on the golden learners: ``reactionpath_minimum``
    and ``reactionpath_ode`` on the Doublewell at the sizes and bars of
    ``tests/test_analysis.py:157-177`` (autograd forces, no kernel; the
    ODE at 5 RK4 substeps a frame, not 20), and
    ``solve_committor`` on the Triplewell's 3 x 3 ``rates()`` with state
    0 as A, state 2 as B.  ``rates()`` is the generator acting on chi
    (Kchi = exp(tau Q) chi: its columns sum to zero); the coarse chain's
    generator, whose rows sum to zero as the committor's boundary-row
    surgery needs, is its transpose."""
    import numpy as np
    import torch
    import isokann_tpu_torch as itt

    n0 = {k: k.launches for k in _counted_kernels()}
    tg = {}
    stage = _staged(tg)
    x0 = torch.zeros(1, device=dw_iso.data.features.device)
    path = stage("reactionpath_minimum", lambda: itt.reactionpath_minimum(
        dw_iso, x0, steps=11, miniter=3))
    pchi = dw_iso.chicoords(path)[:, 0].cpu().numpy()
    ode = stage("reactionpath_ode", lambda: itt.reactionpath_ode(
        dw_iso, x0 + 0.1, steps=21, orth=0.001, substeps=5))
    ochi = dw_iso.chicoords(ode)[:, 0].cpu().numpy()
    Q = np.asarray(tw_iso.rates(), np.float64).T
    q = stage("solve_committor", lambda: itt.solve_committor(
        Q, np.array([2.0, 0.0, 1.0])))
    print(f"  analysis on the goldens: Doublewell reactionpath_minimum "
          f"{tuple(path.shape)}, chi sweep {pchi.max() - pchi.min():.4f} "
          f"(> 0.25); reactionpath_ode {tuple(ode.shape)}, chi rising on "
          f"{int(np.sum(np.diff(ochi) > 0))} of 20 steps (>= 12); "
          f"Triplewell generator (rates().T) {np.round(Q, 5).tolist()}, "
          f"row sums {np.round(Q.sum(axis=1), 6).tolist()}, committor "
          f"{q.tolist()}; seconds "
          f"{ {k: round(v, 3) for k, v in tg.items()} } {stamp}")
    require(path.shape[1] == 1 and bool(torch.isfinite(path).all())
            and pchi.max() - pchi.min() > 0.25,
            "reactionpath_minimum: chi sweeps more than 0.25")
    require(ode.shape == (21, 1) and bool(torch.isfinite(ode).all())
            and np.sum(np.diff(ochi) > 0) >= 12,
            "reactionpath_ode: chi rises on >= 12 of 20 steps")
    require(abs(q[0]) <= 1e-8 and abs(q[2] - 1.0) <= 1e-8
            and 0.0 <= q[1] <= 1.0,
            "committor: boundary values, interior in [0, 1]")
    require(all(k.launches == n for k, n in n0.items()),
            "the golden analysis runs no kernel")
    return tg


def enhanced_sampling_phase(iso, stamp):
    """The enhanced-sampling simulators on copies of the quickstart
    learner: ``examples/enhanced_sampling.py --full``'s step 3
    (``adaptive_metadynamics(deposit=30, height=0.5, sigma=0.1)``: 100
    biased ABOBA steps at B=1, 3 frames deposited) and ``run(100)``;
    ``run_metadynamics(generations=1, iter=20, deposit=30)``;
    ``run_both(generations=1, samples_kde=1, iter=20)``; a gridded bias
    inside ``wt_free_energy``; bridges on a two-output learner over the
    quickstart data (``run_bridges(generations=1, train=20, eps=10, T=0.2
    ps)``, 1.0 ps cut to 0.2: 2 bridges x 100 steps); and
    ``EffectiveSimulation(h=0.5, dt=1e-6, steps=1000)`` with its
    trajectory and bursts, and over the two-output learner (its 2 x 2
    Cholesky) a 100-step trajectory.  Kernel A: its forces entry once a
    biased step and once for each effective table, its trajectory entry
    once a propagation of new start points."""
    import numpy as np
    import torch
    import isokann_tpu_torch as itt
    from isokann_tpu_torch.md import langevin_kernel as LK

    for k in _counted_kernels():
        k.launches = 0
    eiso = _learner_copy(iso, 60)
    sim = eiso.data.sim
    r0 = sim.retries
    te, fl, grew = {}, {}, {}
    stage = _staged(te)
    want_lm = 0

    def counted(name, fn, forces, props):
        """``fn()`` staged, with its forces-entry launches against
        ``forces`` and the data's growth; ``props`` propagations."""
        nonlocal want_lm
        n0, f0 = len(eiso.data), LK.forces.launches
        out = stage(name, fn)
        fl[name] = (LK.forces.launches - f0, forces)
        grew[name] = len(eiso.data) - n0
        want_lm += props
        return out

    x_last = eiso.data.coords[-1]
    res = counted("adaptive_metadynamics", lambda: itt.adaptive_metadynamics(
        eiso, deposit=30, height=0.5, sigma=0.1, gen=61), 100, 1)
    drift = float(torch.linalg.norm(res["xnew"][-1] - x_last))
    l0 = len(eiso.losses)
    stage("run(100)", lambda: eiso.run(100))
    require(len(eiso.losses) == l0 + 100 and np.all(np.isfinite(
        eiso.losses)), "adaptive_metadynamics + run(100): finite losses")
    counted("run_metadynamics", lambda: itt.run_metadynamics(
        eiso, generations=1, iter=20, deposit=30), 100, 1)
    counted("run_both", lambda: itt.run_both(
        eiso, generations=1, samples_kde=1, iter=20), 100, 2)
    grid = itt.MetadynamicsStateGridded(
        eiso.chis(), [np.linspace(0.0, 1.0, 101)], 1.0, 0.1)
    wtF = itt.MetadynamicsSimulation(eiso, mdstate=grid).wt_free_energy(
        np.linspace(0.0, 1.0, 11)[:, None])
    # bridges: a two-output learner on the quickstart data (no bootstrap)
    biso = itt.Iso(data=itt.SimulationData.from_coords(
        sim, iso.data.coords, iso.data.propcoords), nout=2, gen=62,
        opt=itt.AdamRegularized())
    stage("Iso(nout=2).run(50)", lambda: biso.run(50))
    nb0, f0 = len(biso.data), LK.forces.launches
    stage("run_bridges", lambda: itt.run_bridges(
        biso, generations=1, train=20, eps=10.0, T=0.2,
        gen=itt.make_generator(63)))
    fl["run_bridges"] = (LK.forces.launches - f0, 200)
    rows = biso.bridge_telemetry
    want_lm += sum(r["n_new"] > 0 for r in rows)
    f0 = LK.forces.launches
    eff = stage("EffectiveSimulation", lambda: itt.EffectiveSimulation(
        _learner_copy(iso, 64), h=0.5, dt=1e-6, steps=1000))
    fl["EffectiveSimulation"] = (LK.forces.launches - f0, 1)
    etraj = stage("trajectory()", lambda: eff.trajectory(gen=65))
    eprop = stage("propagate(zs[:8], 4)", lambda: eff.propagate(
        eff.kde.zs[:8], 4, gen=66))
    f0 = LK.forces.launches
    eff2 = stage("EffectiveSimulation(nout=2)",
                 lambda: itt.EffectiveSimulation(biso, h=0.5, dt=1e-6,
                                                 steps=100))
    fl["EffectiveSimulation(nout=2)"] = (LK.forces.launches - f0, 1)
    etraj2 = stage("trajectory(), K=2", lambda: eff2.trajectory(gen=67))
    b2, L2 = eff2.b_and_sigma(eff2.kde.zs)
    A2 = eff2.kde.marginal(eff2.kde.zs)[:, 2:].reshape(-1, 2, 2)
    llt = float(torch.max(torch.abs(L2 @ L2.transpose(-1, -2) - A2))
                / torch.max(torch.abs(A2)))
    f_es, lm_es = LK.forces.launches, LK.langevin_middle.launches
    want_lm += sim.retries - r0
    others = sum(k.launches for k in _counted_kernels()
                 if k not in (LK.forces, LK.langevin_middle))
    print(f"  enhanced_sampling: adaptive_metadynamics drift {drift:.4f} nm "
          f"(maxnorm 20), data grew {grew}; losses {eiso.losses[l0]:.4f} -> "
          f"{eiso.losses[-1]:.4f}; gridded wt_free_energy "
          f"{np.round(wtF.cpu().numpy(), 3).tolist()}; bridges {rows}, "
          f"two-output data {nb0} -> {len(biso.data)}; effective table "
          f"{tuple(eff.kde.fs.shape)}, trajectory {tuple(etraj.shape)} "
          f"({float(etraj[0, 0]):.5f} -> {float(etraj[-1, 0]):.5f}), bursts "
          f"{tuple(eprop.shape)}; two-output table "
          f"{tuple(eff2.kde.fs.shape)}, trajectory {tuple(etraj2.shape)}, "
          f"|L L^T - A| / |A| {llt:.2e}; langevin_forces launches {f_es} by stage "
          f"{fl}; langevin_middle launches {lm_es} (expected {want_lm}, "
          f"retries {sim.retries - r0}); other kernels {others}; seconds "
          f"{ {k: round(v, 3) for k, v in te.items()} } {stamp}")
    require(grew["adaptive_metadynamics"] == 3 and drift < 20.0
            and res["xnew"].shape == (3, sim.dim)
            and bool(torch.isfinite(res["xnew"]).all()),
            "adaptive_metadynamics: 3 finite frames deposited, drift < 20")
    require(grew["run_metadynamics"] == 3 and grew["run_both"] == 2
            and np.all(np.isfinite(eiso.losses)),
            "run_metadynamics and run_both: the data grows, losses finite")
    require(wtF.shape == (11,) and bool(torch.isfinite(wtF).all())
            and bool((wtF <= 0).all()),
            "gridded wt_free_energy finite and <= 0")
    require(len(rows) == 2 and all(r["frames"] == 100 and r["finite"]
                                   and r["n_new"] <= min(10, r["n_transition"])
                                   and (r["n_new"] > 0) == (r["n_transition"]
                                                            > 0)
                                   for r in rows)
            and len(biso.data) == nb0 + sum(r["n_new"] for r in rows)
            and np.all(np.isfinite(biso.losses)),
            "bridges: both trajectories finite, the data grown by their "
            "deposits")
    require(eff.dim == 1 and eff.kde.fs.shape == (len(iso.data), 2)
            and etraj.shape == (1000, 1) and eprop.shape == (8, 4, 1)
            and bool(torch.isfinite(eff.kde.fs).all())
            and bool(torch.isfinite(etraj).all())
            and bool(torch.isfinite(eprop).all()),
            "EffectiveSimulation: finite table, trajectory and bursts")
    require(eff2.dim == 2 and eff2.kde.fs.shape == (len(biso.data), 6)
            and etraj2.shape == (100, 2)
            and bool(torch.isfinite(eff2.kde.fs).all())
            and bool(torch.isfinite(etraj2).all())
            and bool(torch.isfinite(b2).all()) and llt < 1e-5,
            "EffectiveSimulation with two outputs: finite table and "
            "trajectory, L L^T = A at the table points to 1e-5")
    require(all(got == want for got, want in fl.values())
            and f_es == sum(v[0] for v in fl.values()),
            "kernel A's forces entry once a biased step and once for each "
            "effective table")
    require(lm_es == want_lm, "kernel A once a propagation of new points")
    require(others == 0, "enhanced sampling runs no other kernel")
    return dict(f_launches=f_es, lm_launches=lm_es, t=te)


def main():
    watchdog()
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import isokann_tpu_torch as itt
    from isokann_tpu_torch import goldens as G
    from isokann_tpu_torch import sample as S
    from isokann_tpu_torch._device import noise_generator
    from isokann_tpu_torch import workflows as W
    from isokann_tpu_torch.md.fixtures import build_peptide, peptide_pdb
    from isokann_tpu_torch.md.minimize import minimize_energy
    from isokann_tpu_torch.md import forces as F
    from isokann_tpu_torch.md.pdbio import read_pdb, read_pdb_traj
    from isokann_tpu_torch.models import densenet
    from isokann_tpu_torch.md.system import build_system
    from isokann_tpu_torch.md import gb_kernel as GB
    from isokann_tpu_torch.md import girsanov_kernel as GK
    from isokann_tpu_torch.md import integrators as I
    from isokann_tpu_torch.md import langevin_kernel as LK
    from isokann_tpu_torch.md import neighbor as NB
    from isokann_tpu_torch.md import neighbor_kernel as NBK
    from isokann_tpu_torch.md.integrators import KB
    from isokann_tpu_torch.ops import pairdists_kernel as PK
    dev = torch.device("cuda")

    # ---- 1. device -------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    stamp = f"[{smi}]"
    phase("device", t0, f"{kind}, torch {torch.__version__}, "
                        f"CUDA {torch.version.cuda}")

    # ---- 2. build: one nvcc per source, all started together ---------------
    # While nvcc runs, the three peptides of phases 9, 12 and 15 are built
    # and minimized (FIRE over autograd, its steps replayed from a CUDA
    # graph: no hand-written kernel); their seconds are reported in those
    # phases.
    t0 = time.perf_counter()
    pdb = os.path.join(ROOT, "build", "chip_smoke", "trpcage.pdb")
    spdb = os.path.join(ROOT, "build", "chip_smoke", "solvated_peptide.pdb")
    vpdb = os.path.join(ROOT, "build", "chip_smoke", "villin.pdb")
    os.makedirs(os.path.dirname(pdb), exist_ok=True)
    with ThreadPoolExecutor(5) as pool:
        jobs = [pool.submit(k.lib) for k in (LK.langevin_middle,
                                             GK.aboba_girsanov, GB.gb_force,
                                             NBK.neighbor_sweep,
                                             PK.sqpairdist_fwd)]
        t1 = time.perf_counter()
        peptide_pdb("NLYIQWLKDGGPSSGRPPPS", pdb, minimize=True,
                    maxiter=1500, implicit="obc2")
        torch.cuda.synchronize()
        t_min = time.perf_counter() - t1
        t1 = time.perf_counter()
        peptide_pdb("AQGSAELAKVM", spdb, minimize=True, maxiter=300)
        torch.cuda.synchronize()
        ts_pep = time.perf_counter() - t1
        t1 = time.perf_counter()
        peptide_pdb(HP35, vpdb, minimize=True, maxiter=800, implicit="obc2")
        torch.cuda.synchronize()
        tv_pep = time.perf_counter() - t1
        # the FIRE steps replayed from the CUDA graph against the eager
        # loop: 30 steps of trp-cage from its built structure
        tsys = build_system(pdb, implicit="obc2")
        x_built = torch.as_tensor(build_peptide(
            "NLYIQWLKDGGPSSGRPPPS").coords.reshape(-1),
            dtype=torch.float32, device=dev)
        fire, fire_s = {}, {}
        for graph in (False, True):
            t1 = time.perf_counter()
            fire[graph] = minimize_energy(
                lambda z: F.potential_energy_flat(tsys, z), x_built,
                maxiter=30, graph=graph)
            torch.cuda.synchronize()
            fire_s[graph] = time.perf_counter() - t1
        fire_err = float((fire[True] - fire[False]).abs().max())
        print(f"  FIRE, trp-cage, 30 steps: CUDA graph {fire_s[True]:.3f}s, "
              f"eager {fire_s[False]:.3f}s, max coordinate difference "
              f"{fire_err:.3e} nm (tol 1e-5) {stamp}", flush=True)
        require(fire_err < 1e-5, "FIRE on the CUDA graph = the eager loop")
        for job in jobs:
            job.result()
    LK.forces.lib()
    NBK.neighbor_layout.lib()
    GK.chi_grad.lib()
    PK.sqpairdist_bwd.lib()
    log = sorted(p for p in os.listdir(os.path.join(ROOT, "build",
                                                    "torch_kernels"))
                 if p.endswith(".log"))
    for p in log:
        with open(os.path.join(ROOT, "build", "torch_kernels", p)) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {p.split('-')[0]}:", line.strip())
    phase("build", t0, f"nvcc langevin_middle "
                       f"{LK.langevin_middle.build_seconds:.2f}s, "
                       f"aboba_girsanov "
                       f"{GK.aboba_girsanov.build_seconds:.2f}s, gb_force "
                       f"{GB.gb_force.build_seconds:.2f}s, neighbor_sweep "
                       f"{NBK.neighbor_sweep.build_seconds:.2f}s, sqpairdist "
                       f"{PK.sqpairdist_fwd.build_seconds:.2f}s (parallel), "
                       f"peptides {t_min:.2f}s + {ts_pep:.2f}s + "
                       f"{tv_pep:.2f}s meanwhile")

    # ---- 3. kernel against plain ------------------------------------------
    t0 = time.perf_counter()
    sim = itt.MDSimulation(device="cuda")
    plan = sim.plan
    rng = np.random.default_rng(0)
    B = 512
    x = (sim.coords[None, :] + torch.as_tensor(
        rng.normal(scale=0.01, size=(B, sim.dim)), dtype=torch.float32,
        device=dev)).contiguous()
    gen = itt.make_generator(1)
    v0 = sim.random_velocities(gen, x.shape)
    # the quickstart launches the kernel at B=5 (its bootstrap chains) and
    # B=512 (propagate, and lag_tools' propagations); the adaptive phase at
    # B=1 (addcoords(20)'s lags), 128 (its 100 bursts), 64 (50 bursts of
    # the aligned picks) and 32 (20 bursts of each KDE generation, of the
    # KDE needles and of the extrapolated points); B=37 also covers a
    # partly filled last block.  Its forces entry runs at B=1 and B=32 on
    # the biased paths (phase biased_paths)
    chains_qs = sim.bootstrap_chains(100)[0]
    ferr = fae = lm_err = 0.0
    for b in (B, 128, 64, 37, 32, chains_qs, 1):
        xb, vb = x[:b].contiguous(), v0[:b].contiguous()
        f_k = LK.forces(plan, xb)
        f_p = LK.forces_plain(plan, xb)
        fe = float((f_k - f_p).abs().max() / f_p.abs().max())
        xk, vk = LK.langevin_middle(plan, xb, vb, 10, gen, noise=False)
        xp, vp = LK.langevin_middle_plain(plan, xb, vb, 10, noise=False)
        xrel = float((xk - xp).abs().max() / xp.abs().max())
        vrel = float((vk - vp).abs().max() / vp.abs().max())
        ae = max(float((xk - xp).abs().max()), float((vk - vp).abs().max()))
        print(f"  B={b}: forces max rel err {fe:.3e} (tol 1e-5); noiseless "
              f"LangevinMiddle x10 steps: rel x {xrel:.3e} (tol 1e-5), rel v "
              f"{vrel:.3e} (tol 1e-4), max abs err {ae:.3e}")
        require(fe < 1e-5, f"forces vs plain at B={b}")
        require(xrel < 1e-5 and vrel < 1e-4,
                f"noiseless LangevinMiddle vs plain at B={b}")
        ferr, lm_err = max(ferr, fe), max(lm_err, ae)
        fae = max(fae, float((f_k - f_p).abs().max()))

    BT, NT = 4096, 2000
    xT = sim.coords[None, :].expand(BT, sim.dim).contiguous()
    vT = sim.random_velocities(itt.make_generator(2), xT.shape)
    xo, vo = LK.langevin_middle(plan, xT, vT, NT, itt.make_generator(3))
    require(bool(torch.isfinite(xo).all()), "finite temperature run")
    m3 = sim.masses3
    temp = float((m3 * vo * vo).sum(dim=1).mean() / (sim.dim * KB))
    print(f"  kinetic temperature B={BT} after {NT} steps: {temp:.2f} K "
          f"(target 310 K, tol 1%)")
    require(abs(temp - 310.0) / 310.0 < 0.01, "kinetic temperature")

    a1 = LK.langevin_middle(plan, x, v0, 20, itt.make_generator(7))
    a2 = LK.langevin_middle(plan, x, v0, 20, itt.make_generator(7))
    require(torch.equal(a1[0], a2[0]) and torch.equal(a1[1], a2[1]),
            "same seed gives the same bits")
    phase("kernel_vs_plain", t0, "forces, noiseless, temperature, "
                                 "determinism")

    # ---- 4. main path ------------------------------------------------------
    t0 = time.perf_counter()
    LK.langevin_middle.launches = 0
    NX, NK, EPISODES = 100, 5, 100
    sim = itt.MDSimulation(steps=100)
    nfeat = sim.natoms * (sim.natoms - 1) // 2
    gen = itt.make_generator(0)
    model = sim.defaultmodel(n=nfeat, gen=gen)
    torch.cuda.synchronize()
    # the reference's bootstrap: 5 chains of 20 lags after a 40-lag burn-in
    # (60 launches at B=5), then one launch of the 512 padded bursts
    chains, burnin = sim.bootstrap_chains(NX)
    r0 = sim.retries
    t1 = time.perf_counter()
    data = itt.SimulationData.from_sim(sim, nx=NX, nk=NK, gen=gen)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t1
    want_a = NX // chains + burnin + 1 + sim.retries - r0
    params0 = {k: v.clone() for k, v in model.state_dict().items()}
    iso = itt.Iso(data=data, model=model, opt=itt.AdamRegularized(), gen=1)
    t1 = time.perf_counter()
    iso.run(EPISODES)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t1
    chi = iso.chis()
    kchi = iso.koopman()
    Q = iso.rates()
    launches = LK.langevin_middle.launches
    print(f"  datagen {t_data:.3f}s (bootstrap: chains {chains}, burnin "
          f"{burnin} lags, {NX // chains} lags kept a chain), train{EPISODES} "
          f"{t_train:.3f}s, loss {iso.losses[0]:.4f} -> "
          f"{iso.losses[-1]:.4f}, kernel launches {launches} (expected "
          f"{want_a}: {NX // chains + burnin} lags at B={chains} + 1 "
          f"propagate + {sim.retries - r0} retries), rates diag "
          f"{np.diag(Q).tolist()} {stamp}")
    require((chains, burnin) == (5, 40), "quickstart bootstrap: 5 chains, "
                                         "burn-in 40 lags")
    require(launches == want_a, "the LangevinMiddle kernel launched once a "
                                "bootstrap lag and once a propagate")
    require(data.propcoords.shape == (NX, NK, sim.dim)
            and bool(torch.isfinite(data.propcoords).all()), "finite bursts")
    require(np.all(np.isfinite(iso.losses))
            and iso.losses[-1] < iso.losses[0], "losses finite, decreasing")
    require(chi.shape == (NX, 1) and bool(torch.isfinite(chi).all())
            and bool(torch.isfinite(kchi).all()), "chis finite")
    require(np.all(np.diag(Q) < 0), "rates() has a negative diagonal")

    # the same training on the CPU reference path, same data and params,
    # with both optimisers: on the card the first 3 steps run eagerly and
    # the 4th is captured as a CUDA graph that steps 4-8 replay
    sub = itt.SimulationData.from_coords(sim, data.coords[:16],
                                         data.propcoords[:16])
    for opt in (itt.AdamRegularized(), itt.NesterovRegularized()):
        runs, graphs = [], []
        for d in ("cuda", "cpu"):
            m = itt.pairnet(nfeat).to(d)
            m.load_state_dict(params0)
            sd = itt.SimulationData(sim, sub.features.to(d),
                                    sub.propfeatures.to(d), sub.coords.to(d),
                                    sub.propcoords.to(d), sub.featurizer)
            it = itt.Iso(data=sd, model=m, opt=opt, gen=4)
            runs.append(np.asarray(it.run(8).losses))
            graphs.append(it._graph is not None)
        require(graphs == [True, False],
                "the card replays a captured step; the cpu runs eagerly")
        terr = float(np.max(np.abs(runs[0] - runs[1]) / np.abs(runs[1])))
        print(f"  training on cuda (CUDA-graph steps 4-8) vs cpu, "
              f"{type(opt).__name__}, 16 points x 8 iterations: max rel "
              f"loss diff {terr:.2e} (tol 1e-4)")
        require(terr < 1e-4, "cuda training agrees with the cpu path")
    phase("main_path", t0, f"datagen {t_data:.3f}s train {t_train:.3f}s")

    # ---- 5. kernel timing --------------------------------------------------
    t0 = time.perf_counter()
    v0 = sim.random_velocities(itt.make_generator(5), x.shape)
    g6 = itt.make_generator(6)
    ms = cuda_ms(lambda: LK.langevin_middle(plan, x, v0, 100, g6), reps=5)
    plain_ms = cuda_ms(lambda: LK.langevin_middle_plain(plan, x, v0, 100,
                                                        g6))
    bms, bound_by = LK.bound_ms(plan, B, 100)
    print(f"  langevin_middle B={B} x100 steps: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({bound_by}) {stamp}")
    x1, v1 = x[:1].contiguous(), v0[:1].contiguous()
    ms1 = cuda_ms(lambda: LK.langevin_middle(plan, x1, v1, 100, g6), reps=5)
    print(f"  langevin_middle B=1 x100 steps (one randx0 lag): {ms1:.3f} ms "
          f"{stamp}")
    x5, v5 = x[:chains].contiguous(), v0[:chains].contiguous()
    ms5 = cuda_ms(lambda: LK.langevin_middle(plan, x5, v5, 100, g6), reps=5)
    b5ms, _ = LK.bound_ms(plan, chains, 100)
    print(f"  langevin_middle B={chains} x100 steps (one lag of the "
          f"quickstart's bootstrap chains): {ms5:.3f} ms, bound {b5ms:.5f} ms "
          f"({b5ms / ms5:.2%} of it) {stamp}")
    b1ms, _ = LK.bound_ms(plan, 1, 100)
    kops_a, sops_a = LK.kernel_ops(plan), LK.step_ops(plan)
    print(f"  langevin_middle operations a walker-step: {sops_a:.0f} the "
          f"function needs (the bound's), {kops_a:.0f} the kernel executes "
          f"({kops_a / sops_a:.2f}x, each pair from both sides); blocks "
          f"{LK.blocks(1)} at B=1 and {LK.blocks(B)} at B={B} (a warp per "
          f"walker, {LK.WARPS_PER_BLOCK} a block); bound at B=1 x100 steps "
          f"{b1ms:.5f} ms ({b1ms / ms1:.2%} of it)")
    fms = {b: cuda_ms(lambda: LK.forces(plan, x[:b]), reps=20)
           for b in (1, 32, B)}
    fplain_ms = cuda_ms(lambda: LK.forces_plain(plan, x[:32]), reps=5)
    fbms, fby = LK.forces_bound_ms(plan, 32)
    print(f"  forces entry (the biased paths' force, B=1 and 32): "
          f"{fms[1]:.4f} ms at B=1, {fms[32]:.4f} at B=32, {fms[B]:.4f} at "
          f"B={B}; plain {fplain_ms:.4f} ms at B=32; bound {fbms:.6f} ms at "
          f"B=32 ({fby}); max rel err {ferr:.3e}, abs {fae:.3e} {stamp}")
    BL, NL = 16384, 1000
    xL = sim.coords[None, :].expand(BL, sim.dim).contiguous()
    vL = sim.random_velocities(itt.make_generator(8), xL.shape)
    msL = cuda_ms(lambda: LK.langevin_middle(plan, xL, vL, NL, g6))
    bL, _ = LK.bound_ms(plan, BL, NL)
    rate = BL * NL / (msL * 1e-3)
    print(f"  langevin_middle B={BL} x{NL} steps: {msL:.2f} ms, "
          f"{rate:.4g} walker-steps/s, bound {bL:.3f} ms "
          f"({bL / msL:.2%} of it) {stamp}")
    phase("timing", t0)

    # ---- 5b. lag_tools: the lag sweep, rates and CK test on the quickstart --
    # The quickstart's trained chi through the port's lag tools, at the
    # lags 0.1, 0.2 and 0.4 ps: each propagation one launch of kernel A
    # (400 walkers padded to 512), the fits and bootstraps numpy on the host.
    t0 = time.perf_counter()
    LK.langevin_middle.launches = 0
    LAGS = (50, 100, 200)
    r0 = sim.retries
    tl = {}
    t1 = time.perf_counter()
    rec, lrows = W.lag_sweep(iso, steps=LAGS, nx=50, nk=8, n_boot=100,
                             gen=itt.make_generator(20), verbose=False)
    tl["lag_sweep"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    _, rrow, rrows = W.rates_resolved(iso, lags=LAGS, nx=50, nk=8,
                                      gen=itt.make_generator(21),
                                      verbose=False, return_rows=True)
    tl["rates_resolved"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    ck_ok, ckrows = W.cktest(iso, factors=(2,), nx=50, nk=8, n_boot=100,
                             gen=itt.make_generator(22), verbose=False)
    torch.cuda.synchronize()
    tl["cktest"] = time.perf_counter() - t1
    a_lag = LK.langevin_middle.launches
    want_lag = 2 * len(LAGS) + 2 + sim.retries - r0
    print(f"  lag_tools: lag_sweep recommends {rec} (steps {LAGS}: "
          f"timescales {[round(r['timescale'], 4) for r in lrows]} ps, slow "
          f"eigenvalues {[round(r['eigs'][1], 5) for r in lrows]}, resolved "
          f"{[r['resolved'] for r in lrows]}); rates_resolved at "
          f"{rrow['steps'] if rrow else None} steps: exit rates "
          f"{rrow['exit_rates'] if rrow else None}; cktest factor 2 ok="
          f"{ck_ok} max_abs_dev {ckrows[0]['max_abs_dev']:.4f}; "
          f"langevin_middle launches {a_lag} (expected {want_lag}: one a "
          f"propagation, retries {sim.retries - r0}); seconds "
          f"{ {k: round(v, 3) for k, v in tl.items()} } {stamp}")
    require(a_lag == want_lag, "lag tools: one launch of kernel A a "
                               "propagation")
    for rows_ in (lrows, rrows):
        require([r["steps"] for r in rows_] == list(LAGS)
                and all(abs(r["lag"] - r["steps"] * sim.step) < 1e-12
                        and len(r["eigs"]) == 2
                        and np.all(np.isfinite(r["eigs"]))
                        and np.all(np.isfinite(r["K"]))
                        and 0.0 <= r["resolved_frac"] <= 1.0
                        and (np.isfinite(r["timescale"])
                             or not 0.0 < r["eigs"][1] < 1.0)
                        for r in rows_), "lag_sweep rows complete and finite")
    require(all(np.all(np.isfinite(r["Q"])) and np.all(np.isfinite(
        r["exit_rates"])) for r in rrows if r["resolved"]),
        "rates_resolved: finite rates at every resolved lag")
    require(len(ckrows) == 1 and ckrows[0]["steps"] == 200
            and all(np.all(np.isfinite(ckrows[0][k]))
                    for k in ("K_pred", "K_est", "dev", "dev_lo", "dev_hi"))
            and np.isfinite(ckrows[0]["max_abs_dev"]),
            "cktest row complete and finite")
    phase("lag_tools", t0, f"lag_sweep {tl['lag_sweep']:.3f}s rates_resolved "
                           f"{tl['rates_resolved']:.3f}s cktest "
                           f"{tl['cktest']:.3f}s")

    # ---- 5c. adaptive: the adaptive loop's data, picks and extrapolation ----
    # On a copy of the quickstart's trained learner (its weights, optimiser
    # state, losses and data; the later phases keep the original), the
    # reference's ways to grow the data where chi's coverage is poor, each
    # through propagate (kernel A; 5 bursts a point, padded to a power of
    # two): addcoords(20) (20 lags at B=1 from the last point, then 100
    # bursts at B=128), 10 picks by aligned RMSD from the bursts' ends (50
    # at B=64), run_kde_dash(3 generations of kde 4 + run(20); 20 at B=32
    # each), 4 KDE needles in chi (20 at B=32) and extrapolation beyond
    # chi's extrema, then the chi-sorted export.  extrapolate's default
    # levelset minimization (fixed-step gradient descent at lr 1e-5)
    # diverges on thermal alanine frames in both packages and keeps no
    # point (tests/test_torch_sample.py), so minimize=False runs after it.
    t0 = time.perf_counter()
    LK.langevin_middle.launches = 0
    aiso = _learner_copy(iso, 30)
    r0 = sim.retries
    ta, grew, want_ad = {}, {}, 0

    def grow(name, fn, launches):
        """``fn()`` timed, with the data's growth and the launches of
        kernel A it should take (before retries)."""
        nonlocal want_ad
        n0 = len(aiso.data)
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ta[name] = time.perf_counter() - t1
        grew[name] = len(aiso.data) - n0
        want_ad += launches(grew[name]) if callable(launches) else launches
        return out

    grow("addcoords(20)", lambda: aiso.addcoords(20), 20 + 1)
    pool = itt.flattenfirst(aiso.data.propcoords)

    def pick_aligned():
        picked, qs, _ = S.picking_aligned(pool, 10)
        aiso.addcoords(picked)
        return qs

    qs = grow("picking_aligned + addcoords", pick_aligned, 1)
    grow("run_kde_dash", lambda: W.run_kde_dash(aiso, generations=3,
                                                iter=20, kde=4), 3)

    def needles():
        with torch.no_grad():
            chix = aiso.chis()[:, 0].cpu().numpy()
            chiy = aiso.model(itt.flattenfirst(aiso.data.propfeatures))
        iy = S.resample_kde_needles(chix, chiy[:, 0].cpu().numpy(), 4)
        ends = itt.flattenfirst(aiso.data.propcoords)
        aiso.addcoords(ends[torch.as_tensor(iy, device=dev)])
        return iy

    iy = grow("kde_needles + addcoords", needles, 1)
    # the minimizing run from one point a side: it keeps none (ROADMAP
    # Queue 3 (p)), at ~0.4 s a try
    for minimize, nx_ext in ((True, 1), (False, 2)):
        with torch.no_grad():
            ends = itt.flattenfirst(aiso.data.propcoords)
            chi_ends = aiso.model(
                itt.flattenfirst(aiso.data.propfeatures))[:, 0]
        name = f"addextrapolates(minimize={minimize})"
        n0 = len(aiso.data)
        grow(name, lambda: S.addextrapolates(aiso, nx_ext, stepsize=0.01,
                                             minimize=minimize),
             lambda g: int(g > 0))
        new = aiso.data.coords[n0:]
        require(grew[name] <= 2 * nx_ext
                and bool(torch.isfinite(new).all()),
                f"{name}: at most {2 * nx_ext} finite points")
        # each point's start: the burst end it lies nearest to; pushed
        # down (chi lower) from the lower half of chi, up from the upper
        start = torch.cdist(new, ends).argmin(dim=1)
        chi_new = aiso.chicoords(new)[:, 0]
        up = chi_ends[start] > chi_ends.median()
        moved = torch.where(up, chi_new - chi_ends[start],
                            chi_ends[start] - chi_new)
        print(f"  {name}: {grew[name]} points, chi {chi_ends[start].tolist()}"
              f" -> {chi_new.tolist()}")
        require(bool((moved > 0).all()), f"{name}: chi moved the way each "
                                         f"point was pushed")
    require(grew["addextrapolates(minimize=False)"] == 4,
            "extrapolate without minimization keeps 2 n points")
    with tempfile.TemporaryDirectory() as out_dir:
        spath = os.path.join(out_dir, "sorted.pdb")
        for name in ("exportsorted", "exportsorted again"):
            t1 = time.perf_counter()
            itt.exportsorted(aiso, spath)
            ta[name] = time.perf_counter() - t1
        back = torch.as_tensor(read_pdb_traj(spath), dtype=torch.float32,
                               device=dev)
    order = torch.as_tensor(np.argsort(aiso.chis()[:, 0].cpu().numpy()),
                            device=dev)
    raw = aiso.data.coords[order]
    nat = sim.natoms
    exp_err = float(itt.aligned_rmsd(back.reshape(-1, nat, 3),
                                     raw.reshape(-1, nat, 3),
                                     flat=False).max())
    at_ms = cuda_ms(lambda: itt.aligntrajectory(raw), reps=5)
    pk_ms = cuda_ms(lambda: S.picking_aligned(pool, 10))
    with warnings.catch_warnings(record=True) as rw:
        warnings.simplefilter("always")
        Qa = aiso.rates()
    a_adapt = LK.langevin_middle.launches
    want_ad += sim.retries - r0
    print(f"  adaptive: data {len(iso.data)} -> {len(aiso.data)} "
          f"({grew}); picks {qs.tolist()}; needles {iy.tolist()}; seconds "
          f"{ {k: round(v, 3) for k, v in ta.items()} }; picking_aligned "
          f"of 10 from {len(pool)} {pk_ms:.2f} ms warm; aligntrajectory "
          f"T={len(raw)} {at_ms:.3f} ms warm (CUDA events); export "
          f"{back.shape[0]} frames, max aligned RMSD to the chi-sorted "
          f"coordinates {exp_err:.2e} nm (tol 1e-4); langevin_middle "
          f"launches {a_adapt} (expected {want_ad}, retries "
          f"{sim.retries - r0}); loss {aiso.losses[-1]:.4f}; rates diag "
          f"{np.diag(Qa).tolist()}{' (clamped)' if rw else ''} {stamp}")
    require(grew["addcoords(20)"] == 20
            and grew["picking_aligned + addcoords"] == 10
            and grew["run_kde_dash"] == 12
            and grew["kde_needles + addcoords"] == 4,
            "the data grows by the points each step adds")
    require(len(set(qs.tolist())) == 10 and len(set(iy.tolist())) == 4,
            "distinct picks")
    require(a_adapt == want_ad, "kernel A launched once a lag and once a "
                                "propagation")
    require(back.shape[0] == len(aiso.data) and exp_err < 1e-4,
            "exportsorted: every start point, chi-sorted, within 1e-4 nm")
    require(np.all(np.isfinite(aiso.losses)), "adaptive losses finite")
    require(np.all(np.diag(Qa) < 0), "rates() has a negative diagonal")
    phase("adaptive", t0, " ".join(f"{k} {v:.3f}s" for k, v in ta.items()))

    # ---- 5d. ensemble: the chi ensemble, uncertainty-targeted sampling ----
    # On another copy of the quickstart learner (the later phases keep its
    # own chi): 8 members of its model's spec (231 -> 38 -> 6 -> 1), each
    # drawn anew, trained together (one batched product a layer, each
    # member's own minibatch permutation: the bucket is 128 > 100, one
    # CUDA-graph step a minibatch), chi_std, 8 new start points where the
    # members disagree most (2 of them uniform; 40 bursts, one launch of
    # kernel A at B=64), then run(50) on the 108 points.  Timed against 8
    # sequential Iso.run(100) of the same shapes.  The members' agreement
    # bar of the JAX test (pairwise corr > 0.9 after alignment,
    # tests/test_ensemble.py:37-51) is held on that test's own system
    # (Doublewell, nx 64, nk 4, 5 members, run(120)); on alanine 100
    # iterations from 8 independent draws leave members apart (the spread
    # the ensemble measures), and their correlations are printed.
    t0 = time.perf_counter()
    LK.langevin_middle.launches = 0
    EM, NX_NEW = 8, 8
    eiso = itt.Iso(data=iso.data, model=copy.deepcopy(iso.model),
                   opt=iso.opt, minibatch=iso.minibatch, gen=40)
    r0 = sim.retries
    te = {}
    t1 = time.perf_counter()
    ens = itt.ChiEnsemble(eiso, n_members=EM, gen=41)
    ens.run(EPISODES)
    torch.cuda.synchronize()
    te["ChiEnsemble + run(100)"] = time.perf_counter() - t1
    el = np.asarray(ens.losses)
    t1 = time.perf_counter()
    estd = ens.chi_std()
    torch.cuda.synchronize()
    te["chi_std"] = time.perf_counter() - t1
    echi = ens.chi_members().cpu().numpy()[:, :, 0]
    ecorr = np.corrcoef(echi)
    t1 = time.perf_counter()
    itt.resample_uncertainty(eiso, ens, ny=NX_NEW, explore=0.25,
                             gen=itt.make_generator(42))
    torch.cuda.synchronize()
    te["resample_uncertainty"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    ens.run(50)
    torch.cuda.synchronize()
    te["run(50)"] = time.perf_counter() - t1
    el2 = np.asarray(ens.losses)[EPISODES:]
    a_ens = LK.langevin_middle.launches
    want_ens = 1 + sim.retries - r0
    # 8 sequential learners of the same shapes: each captures its own step
    t1 = time.perf_counter()
    for e in range(EM):
        itt.Iso(data=iso.data,
                model=itt.pairnet(nfeat, gen=60 + e, device=dev),
                opt=iso.opt, minibatch=iso.minibatch, gen=70 + e
                ).run(EPISODES)
    torch.cuda.synchronize()
    te["8 x Iso.run(100)"] = time.perf_counter() - t1
    # the JAX test's bar on its own system
    t1 = time.perf_counter()
    dw = itt.Iso(sim=itt.Doublewell(), nx=64, nk=4, gen=43,
                 opt=itt.AdamRegularized())
    dens = itt.ChiEnsemble(dw, n_members=5, gen=44).run(120)
    dchi = dens.chi_members(torch.linspace(-1.3, 1.3, 101, device=dev)[
        :, None]).cpu().numpy()[:, :, 0]
    dcorr = np.corrcoef(dchi)
    dl = np.asarray(dens.losses)
    te["doublewell"] = time.perf_counter() - t1
    print(f"  ensemble: {EM} members x {ens.model.sizes}, data "
          f"{len(iso.data)} -> {len(eiso.data)}; losses first 10 "
          f"{el[:10].mean(axis=0).round(4).tolist()} -> last 10 "
          f"{el[-10:].mean(axis=0).round(4).tolist()}; run(50) last "
          f"{el2[-1].round(4).tolist()}; chi_std max {float(estd.max()):.4f}"
          f" mean {float(estd.mean()):.4f}; aligned pairwise corr min "
          f"{ecorr.min():.4f}, rows "
          f"{[round(float(np.sort(r)[1]), 3) for r in ecorr]}; "
          f"langevin_middle launches {a_ens} (expected {want_ens}); "
          f"Doublewell (the JAX test's system) corr min {dcorr.min():.5f}; "
          f"seconds { {k: round(v, 3) for k, v in te.items()} }: "
          f"ensemble run(100) {te['ChiEnsemble + run(100)']:.3f}s against "
          f"8 sequential Iso.run(100) {te['8 x Iso.run(100)']:.3f}s {stamp}")
    require(el.shape == (EPISODES, EM) and np.all(np.isfinite(el))
            and np.all(el[-10:].mean(axis=0) < el[:10].mean(axis=0))
            and ens.finite_members.all(),
            "every member's losses finite and falling")
    require(el2.shape == (50, EM) and np.all(np.isfinite(el2)),
            "run(50) on the grown data finite")
    require(len(eiso.data) == len(iso.data) + NX_NEW
            and eiso.data.propcoords.shape[1] == NK
            and bool(torch.isfinite(eiso.data.propcoords).all()),
            "resample_uncertainty added 8 points")
    require(estd.shape == (len(iso.data), 1)
            and bool(torch.isfinite(estd).all()), "chi_std finite")
    require(a_ens == want_ens, "one launch of kernel A for the 40 bursts")
    require(dl.shape == (120, 5) and np.all(np.isfinite(dl))
            and np.all(dl[-10:].mean(axis=0) < dl[:10].mean(axis=0))
            and dcorr.min() > 0.9,
            "Doublewell: members learn and agree after alignment")
    phase("ensemble", t0, " ".join(f"{k} {v:.3f}s" for k, v in te.items()))

    # ---- 5e. analysis: reactive paths, free energy, MI, reaction paths -----
    t0 = time.perf_counter()
    aph = analysis_phase(iso, stamp)
    phase("analysis", t0, " ".join(f"{k} {v:.3f}s" for k, v in
                                   aph["t"].items()))

    # ---- 5f. enhanced_sampling: metadynamics, bridges, effective dynamics --
    t0 = time.perf_counter()
    eph = enhanced_sampling_phase(iso, stamp)
    phase("enhanced_sampling", t0, " ".join(f"{k} {v:.3f}s" for k, v in
                                            eph["t"].items()))

    # ---- 6. Girsanov kernel against plain -----------------------------------
    t0 = time.perf_counter()
    FS, BB, QRATE, NS = 0.7, 0.4, -2.0, 10
    gm = itt.pairnet(nfeat, gen=11).to(dev)
    gplan = GK.GirsanovPlan.for_model(plan, gm, FS)
    gerr = 0.0
    for b in (512, 256, 37, 1):
        xb = x[:b].contiguous()
        pb = sim.random_velocities(itt.make_generator(12), xb.shape) \
            * sim.masses3
        f = torch.sqrt(LK.pair_delta(plan, xb.reshape(b, -1, 3))[1])
        c_k, g_k = GK.chi_grad(gplan, gm, f)
        c_p, g_p = GK.chi_grad_plain(gplan, gm, f)
        crel = float((c_k - c_p).abs().max() / c_p.abs().max())
        grel = float((g_k - g_p).abs().max() / g_p.abs().max())
        qk, pk, lk = GK.aboba_girsanov(gplan, gm, xb, pb, NS, BB, QRATE,
                                       NS * sim.step, gen, noise=False)
        qp, pp, lp = GK.aboba_girsanov_plain(gplan, gm, xb, pb, NS, BB,
                                             QRATE, NS * sim.step,
                                             noise=False)
        qrel = float((qk - qp).abs().max() / qp.abs().max())
        prel = float((pk - pp).abs().max() / pp.abs().max())
        lrel = float((lk - lp).abs().max() / lp.abs().max())
        ae = max(float((qk - qp).abs().max()), float((pk - pp).abs().max()),
                 float((lk - lp).abs().max()))
        print(f"  B={b}: chi_grad vs autograd: chi rel {crel:.3e} (tol "
              f"1e-5), dchi/df rel {grel:.3e} (tol 1e-4); noiseless "
              f"Girsanov ABOBA x{NS} steps: rel q {qrel:.3e} (tol 1e-5), "
              f"rel p {prel:.3e} (tol 1e-4), rel logw {lrel:.3e} (tol "
              f"1e-4, |logw| max {float(lp.abs().max()):.3f}), max abs err "
              f"{ae:.3e}")
        require(crel < 1e-5 and grel < 1e-4, f"chi_grad vs autograd at B={b}")
        require(qrel < 1e-5 and prel < 1e-4 and lrel < 1e-4,
                f"noiseless Girsanov ABOBA vs plain at B={b}")
        gerr = max(gerr, ae)

    # a chi model too large to stage in shared memory (231-1024-1, 0.95 MB
    # of weights) is read from device memory by the same routines
    wm = densenet([nfeat, 1024, 1], layernorm=True, gen=15).to(dev)
    wplan = GK.GirsanovPlan.for_model(plan, wm, FS)
    xu = x[:37].contiguous()
    pu = sim.random_velocities(itt.make_generator(16), xu.shape) \
        * sim.masses3
    fu = torch.sqrt(LK.pair_delta(plan, xu.reshape(37, -1, 3))[1])
    (c_k, g_k), (c_p, g_p) = (GK.chi_grad(wplan, wm, fu),
                              GK.chi_grad_plain(wplan, wm, fu))
    crel = float((c_k - c_p).abs().max() / c_p.abs().max())
    grel = float((g_k - g_p).abs().max() / g_p.abs().max())
    qk, pk, lk = GK.aboba_girsanov(wplan, wm, xu, pu, NS, BB, QRATE,
                                   NS * sim.step, gen, noise=False)
    qp, pp, lp = GK.aboba_girsanov_plain(wplan, wm, xu, pu, NS, BB, QRATE,
                                         NS * sim.step, noise=False)
    qrel = float((qk - qp).abs().max() / qp.abs().max())
    prel = float((pk - pp).abs().max() / pp.abs().max())
    lrel = float((lk - lp).abs().max() / lp.abs().max())
    print(f"  unstaged chi model 231-1024-1 B=37: chi rel {crel:.3e} (tol "
          f"1e-5), dchi/df rel {grel:.3e} (tol 1e-4); noiseless x{NS}: rel q "
          f"{qrel:.3e} (tol 1e-5), rel p {prel:.3e}, rel logw {lrel:.3e} "
          f"(tol 1e-4)")
    require(crel < 1e-5 and grel < 1e-4, "chi_grad vs autograd, unstaged")
    require(qrel < 1e-5 and prel < 1e-4 and lrel < 1e-4,
            "noiseless Girsanov ABOBA vs plain, unstaged chi model")

    # a walker's bits do not depend on the batch (one warp a walker)
    p256 = sim.random_velocities(itt.make_generator(12), (256, sim.dim)) \
        * sim.masses3
    for noise in (False, True):
        r256 = GK.aboba_girsanov(gplan, gm, x[:256].contiguous(), p256, 20,
                                 BB, QRATE, 0.04, itt.make_generator(8),
                                 noise=noise)
        r1 = GK.aboba_girsanov(gplan, gm, x[:1].contiguous(),
                               p256[:1].contiguous(), 20, BB, QRATE, 0.04,
                               itt.make_generator(8), noise=noise)
        require(all(torch.equal(a[:1], b) for a, b in zip(r256, r1)),
                f"Girsanov kernel: row 0 of B=256 equals B=1 bit for bit "
                f"(noise={noise})")
    kops_b, sops_b = GK.kernel_ops(gplan), GK.step_ops(gplan)
    print(f"  aboba_girsanov: row 0 of B=256 equals B=1 bit for bit, "
          f"noiseless and noisy; operations a walker-step: {sops_b:.0f} the "
          f"function needs (the bound's), {kops_b:.0f} the kernel executes "
          f"({kops_b / sops_b:.2f}x); blocks {GK.blocks(1)} at B=1, "
          f"{GK.blocks(256)} at B=256 (a warp per walker, "
          f"{LK.WARPS_PER_BLOCK} a block)")

    # martingale: E[w] = 1 under the trained chi's optimal-control bias.
    # The 4-sigma band of a sample mean tests E[w] = 1 only while the
    # log-weights' variance stays below ~1.  The quickstart chi is steep:
    # at forcescale 0.5 over the 100-step lag var(logw) is ~1e3 (measured
    # on the CPU plain path), where no sample of 16384 estimates E[w].  So
    # the forcescale halves from 0.5 until var(logw) < 1, each run is
    # printed, and the band is checked at the first that qualifies.
    BM = 16384
    xm = data.coords.repeat_interleave(-(-BM // NX), dim=0)[:BM].contiguous()
    gm7 = itt.make_generator(13)
    pm = sim.random_velocities(gm7, xm.shape) * sim.masses3
    fs_m, lvar = 1.0, float("inf")
    while lvar >= 1.0 and fs_m > 1 / 64:
        fs_m /= 2
        try:
            bias_m = itt.optcontrol(iso, forcescale=fs_m)
            spec_m = bias_m.optcontrol_spec
        except itt.DomainError:
            spec_m = None
        require(spec_m is not None,
                "optcontrol on the trained chi (contracting)")
        plan_m = GK.GirsanovPlan.for_model(plan, spec_m["model"], fs_m)
        _, _, lw = GK.aboba_girsanov(plan_m, spec_m["model"], xm, pm, 100,
                                     spec_m["b"], spec_m["qrate"],
                                     spec_m["Tmax"], gm7)
        w = torch.exp(lw.double())
        wmean, wstd = float(w.mean()), float(w.std())
        band = 4.0 * wstd / BM ** 0.5
        lvar = float(lw.double().var())
        ess = float(w.sum() ** 2 / (w * w).sum())
        print(f"  martingale B={BM} x100 steps, forcescale {fs_m}, trained "
              f"chi: E[w] {wmean:.5f}, std(w) {wstd:.4f}, |E[w]-1| "
              f"{abs(wmean - 1.0):.5f} (4 std/sqrt(B) = {band:.5f}), "
              f"var(logw) {lvar:.4f}, ESS {ess:.1f} of {BM}")
        require(bool(torch.isfinite(w).all()), "finite Girsanov weights")
        if fs_m == 0.5:
            spec, mplan = spec_m, plan_m
    require(1e-3 < lvar < 1.0, "a forcescale >= 1/64 with var(logw) < 1")
    require(abs(wmean - 1.0) < band, "E[w] = 1 within 4 standard errors")

    r1 = GK.aboba_girsanov(gplan, gm, x[:256].contiguous(),
                           pm[:256].contiguous(), 20, BB, QRATE, 0.04,
                           itt.make_generator(7))
    r2 = GK.aboba_girsanov(gplan, gm, x[:256].contiguous(),
                           pm[:256].contiguous(), 20, BB, QRATE, 0.04,
                           itt.make_generator(7))
    require(all(torch.equal(a, b) for a, b in zip(r1, r2)),
            "Girsanov kernel: same seed gives the same bits")
    phase("girsanov_vs_plain", t0, "chi_grad, noiseless, row 0 at B=256, "
                                   "martingale, determinism")

    # ---- 7. Girsanov path ----------------------------------------------------
    t0 = time.perf_counter()
    LK.langevin_middle.launches = 0
    GK.aboba_girsanov.launches = 0
    t1 = time.perf_counter()
    sim.bias = itt.optcontrol(iso, forcescale=1.0)
    ws = sim.propagate(data.coords, NK, gen=itt.make_generator(14))
    sim.bias = None
    torch.cuda.synchronize()
    t_prop = time.perf_counter() - t1
    require(isinstance(ws, itt.WeightedSamples)
            and ws.values.shape == (NX, NK, sim.dim)
            and bool(torch.isfinite(ws.values).all())
            and bool(torch.isfinite(ws.weights).all()),
            "biased propagate gives finite WeightedSamples")
    print(f"  optcontrol(iso, 1.0) + biased propagate {NX}x{NK}: "
          f"{t_prop:.3f}s, weights [{float(ws.weights.min()):.4g}, "
          f"{float(ws.weights.max()):.4g}], mean ESS "
          f"{float(ws.ess().mean()):.3f} of {NK}, E[w] "
          f"{float(ws.weights.mean()):.4f} {stamp}")
    n_loss = len(iso.losses)
    t1 = time.perf_counter()
    itt.run_girsanov(iso, generations=3, iter=100, kde=50, forcescale=0.5)
    torch.cuda.synchronize()
    t_gir = time.perf_counter() - t1
    g_launches = GK.aboba_girsanov.launches
    rows = iso.girsanov_telemetry
    for row in rows:
        print(f"  run_girsanov {row}")
    print(f"  run_girsanov 3 generations: {t_gir:.3f}s wall, Girsanov "
          f"kernel launches {g_launches} (LangevinMiddle "
          f"{LK.langevin_middle.launches}) {stamp}")
    require(g_launches > 0, "the Girsanov path launched the Girsanov kernel")
    require(any(r["biased"] for r in rows), "a biased generation")
    pf = iso.data.propfeatures
    require(isinstance(pf, itt.WeightedSamples)
            and bool(torch.isfinite(pf.weights).all()),
            "propfeatures are WeightedSamples with finite weights")
    gl = np.asarray(iso.losses[n_loss:]).reshape(3, 100)
    require(np.all(np.isfinite(gl)) and np.all(gl[:, -1] < gl[:, 0]),
            "finite losses falling in each generation")
    phase("girsanov_path", t0, f"propagate {t_prop:.3f}s run_girsanov "
                               f"{t_gir:.3f}s")

    # ---- 8. Girsanov kernel timing -------------------------------------------
    t0 = time.perf_counter()
    gtimes = {}
    for b in (256, 512, 16384):
        xb, pb = xm[:b].contiguous(), pm[:b].contiguous()
        gtimes[b] = cuda_ms(lambda: GK.aboba_girsanov(
            mplan, spec["model"], xb, pb, 100, spec["b"], spec["qrate"],
            spec["Tmax"], gm7), reps=1 if b > 512 else 5)
        bb, _ = GK.bound_ms(mplan, b, 100)
        print(f"  aboba_girsanov B={b} x100 steps: {gtimes[b]:.3f} ms, "
              f"{b * 100 / (gtimes[b] * 1e-3):.4g} walker-steps/s, bound "
              f"{bb:.4f} ms ({bb / gtimes[b]:.2%} of it), {GK.blocks(b)} "
              f"blocks {stamp}")
    xb, pb = xm[:256].contiguous(), pm[:256].contiguous()
    g_plain_ms = cuda_ms(lambda: GK.aboba_girsanov_plain(
        mplan, spec["model"], xb, pb, 100, spec["b"], spec["qrate"],
        spec["Tmax"], gm7))
    g_bms, g_by = GK.bound_ms(mplan, 256, 100)
    cg_ms = cuda_ms(lambda: GK.chi_grad(gplan, gm, f), reps=5)
    print(f"  aboba_girsanov plain B=256 x100 steps: {g_plain_ms:.3f} ms; "
          f"bound {g_bms:.4f} ms ({g_by}); chi_grad entry (parity only) "
          f"B=1: {cg_ms:.4f} ms {stamp}")
    phase("girsanov_timing", t0)

    # ---- 8b. biased_paths: the biased paths kernel B does not run ---------
    # On the quickstart's alanine, each through kernel A's forces entry once
    # a step (the plain recursions over MDSimulation.force): a biased
    # trajectory (100 steps, every 10th saved) and randx0(4) (400 steps)
    # under the quickstart's optcontrol bias at the forcescale where phase
    # 6 found var(logw) < 1 over a lag (at 1.0 the running weights
    # underflow to 0 within a lag), at B=1; 4 x 8 walkers (B=32) under
    # the optcontrol form over a chi model the Girsanov kernel does not
    # compute (a sigmoid output layer); a Brownian MDSimulation's bursts of
    # the same walkers (friction 1000/ps, where 2 fs of overdamped
    # dynamics is stable); integrate_langevin, and integrate_girsanov (on
    # the Brownian simulation) and langevin_girsanov under the quickstart's
    # bias, 100 steps each at B=1.
    t0 = time.perf_counter()
    for k in (LK.langevin_middle, LK.forces, GK.aboba_girsanov):
        k.launches = 0
    tb, fl = {}, {}
    bgen = itt.make_generator(80)
    bsim = itt.MDSimulation(steps=100, integrator="brownian",
                            friction=1000.0)
    rb0 = bsim.retries

    def biased(name, fn, steps):
        """``fn()`` timed, with the forces launches it should take."""
        n0 = LK.forces.launches
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        tb[name] = time.perf_counter() - t1
        fl[name] = (LK.forces.launches - n0, steps)
        return out

    qbias = sim.bias = bias_m
    try:
        btr = biased("trajectory", lambda: sim.trajectory(
            steps=100, saveevery=10, gen=bgen), 100)
        bx0 = biased("randx0(4)", lambda: sim.randx0(4, gen=bgen), 400)
        qspec = qbias.optcontrol_spec
        sim.bias = I.optcontrol_bias(
            densenet([nfeat, 38, 6, 1], lastactivation="sigmoid",
                     layernorm=True, gen=81, device=dev),
            sim.featurizer, 0.5, qspec["b"], qspec["qrate"], qspec["Tmax"])
        require(not sim.kernel_takes_bias()
                and sim.biased_route(dev) == "recursion",
                "the sigmoid-output chi model is not the Girsanov kernel's")
        bws = biased("propagate 4x8, any bias", lambda: sim.propagate(
            bx0, 8, gen=bgen), 100)
    finally:
        sim.bias = None
    bys = biased("brownian propagate 4x8", lambda: bsim.propagate(
        bx0, 8, gen=bgen), 100)
    bil = biased("integrate_langevin", lambda: sim.integrate_langevin(
        gen=bgen), 100)
    big, blw = biased("integrate_girsanov", lambda: bsim.integrate_girsanov(
        bias=qbias, gen=bgen), 100)
    blg = biased("langevin_girsanov", lambda: sim.langevin_girsanov(
        bias=qbias, gen=bgen), 100)
    f_launches = LK.forces.launches
    print(f"  biased_paths: bias forcescale {fs_m}; forces launches "
          f"{f_launches} by stage "
          f"{ {k: v[0] for k, v in fl.items()} } (expected "
          f"{ {k: v[1] for k, v in fl.items()} }), langevin_middle "
          f"{LK.langevin_middle.launches}, aboba_girsanov "
          f"{GK.aboba_girsanov.launches}; trajectory weights "
          f"{btr.weights.cpu().numpy().round(4).tolist()}; any-bias E[w] "
          f"{float(bws.weights.mean()):.4f}; Brownian retries "
          f"{bsim.retries - rb0}, max displacement "
          f"{float((bys - bx0[:, None]).abs().max()):.4f} nm; "
          f"integrate_girsanov logw {blw.cpu().numpy().round(4).tolist()}; "
          f"langevin_girsanov weights "
          f"[{float(blg.weights.min()):.4f}, {float(blg.weights.max()):.4f}]"
          f"; seconds { {k: round(v, 3) for k, v in tb.items()} } {stamp}")
    require(all(v[0] == v[1] for v in fl.values())
            and f_launches == sum(v[0] for v in fl.values()),
            "the forces entry launched once a step of every biased path")
    require(LK.langevin_middle.launches == 0
            and GK.aboba_girsanov.launches == 0,
            "the biased paths launch neither LangevinMiddle nor Girsanov")
    require(isinstance(btr, itt.WeightedSamples)
            and btr.values.shape == (10, sim.dim)
            and bool(torch.isfinite(btr.values).all())
            and bool(torch.isfinite(btr.weights).all())
            and bool((btr.weights > 0).all()),
            "biased trajectory: 10 frames, finite positive weights")
    require(not isinstance(bx0, itt.WeightedSamples)
            and bx0.shape == (4, sim.dim)
            and bool(torch.isfinite(bx0).all()), "biased randx0: values")
    require(isinstance(bws, itt.WeightedSamples)
            and bws.values.shape == (4, 8, sim.dim)
            and bool(torch.isfinite(bws.values).all())
            and bool(torch.isfinite(bws.weights).all()),
            "any-bias propagate: finite WeightedSamples")
    require(bys.shape == (4, 8, sim.dim) and bsim.retries == rb0
            and bool(torch.isfinite(bys).all())
            and float((bys - bx0[:, None]).abs().max()) > 0,
            "Brownian bursts finite and moved, no retry")
    require(bil.shape == (1, sim.dim) and bool(torch.isfinite(bil).all())
            and big.shape == (1, sim.dim)
            and bool(torch.isfinite(big).all())
            and bool(torch.isfinite(blw).all())
            and blg.values.shape == (100, sim.dim)
            and bool(torch.isfinite(blg.values).all())
            and bool(torch.isfinite(blg.weights).all()),
            "direct integrators finite")
    phase("biased_paths", t0, " ".join(f"{k} {v:.3f}s"
                                       for k, v in tb.items()))

    # ---- 9. trp-cage path ----------------------------------------------------
    # tools/run_trpcage_production.py at its production widths: TC5B built
    # from sequence and minimized in OBC2 (1500 FIRE steps), a 100-step lag,
    # nk=8, 300 iterations and 3 stratified resamples a generation, cutoff
    # 2000; the number of generations is cut to 2 and nx from 100 to 5
    # (randx0's single-walker steps were a third of the run's time).
    t0 = time.perf_counter()
    GB.gb_force.launches = 0
    LK.langevin_middle.launches = 0
    GK.aboba_girsanov.launches = 0
    GENS, ITERS, RESAMPLES, CUTOFF, TNX, TNK = 2, 300, 3, 2000, 5, 8
    t1 = time.perf_counter()
    tsim = itt.MDSimulation(pdb=pdb, steps=100, implicit="obc2")
    tgen = itt.make_generator(30)
    tmodel = tsim.defaultmodel(n=100, gen=tgen)
    t_sys = time.perf_counter() - t1
    require(tsim.natoms == 313 and tsim.route == "hybrid"
            and isinstance(tsim.featurizer, itt.FeaturesRandomPairs),
            "trp-cage: 313 atoms on the hybrid route, random-pair features")
    t1 = time.perf_counter()
    xs0 = tsim.randx0(TNX, gen=tgen)
    torch.cuda.synchronize()
    t_x0 = time.perf_counter() - t1
    n_x0 = GB.gb_force.launches
    t1 = time.perf_counter()
    ys0 = tsim.propagate(xs0, TNK, gen=tgen)
    torch.cuda.synchronize()
    t_prop = time.perf_counter() - t1
    tdata = itt.SimulationData.from_coords(tsim, xs0, ys0)
    tiso = itt.Iso(data=tdata, model=tmodel, opt=itt.AdamRegularized(),
                   gen=31)
    gen_rows = []
    for g in range(GENS):
        t1 = time.perf_counter()
        n_l = len(tiso.losses)
        tiso.run(ITERS)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t1
        tiso.resample_strat(RESAMPLES)
        if len(tiso.data) > CUTOFF:
            tiso.data = tiso.data[len(tiso.data) - CUTOFF:]
        torch.cuda.synchronize()
        gl = tiso.losses[n_l:]
        gen_rows.append(dict(gen=g, n=len(tiso.data),
                             t_gen=time.perf_counter() - t1,
                             t_train=t_train, loss_first=gl[0] if gl else
                             None, loss_last=gl[-1] if gl else None))
        print(f"  gen {g}: {gen_rows[-1]}")
    tchi = tiso.chis()
    tkchi = tiso.koopman()
    tQ = tiso.rates()
    d_launches = GB.gb_force.launches
    want = (TNX * 100 + 100 + 100 * GENS + 100 * tsim.retries)
    print(f"  trp-cage: peptide_pdb (build + 1500 FIRE steps) {t_min:.3f}s, "
          f"MDSimulation + model {t_sys:.3f}s, randx0({TNX}) {t_x0:.3f}s "
          f"({n_x0} launches), propagate {TNX}x{TNK} {t_prop:.3f}s, "
          f"generations {[round(r['t_gen'], 3) for r in gen_rows]}s "
          f"(train {[round(r['t_train'], 3) for r in gen_rows]}s), "
          f"retries {tsim.retries}, gb_force launches {d_launches} "
          f"(expected {want}), LangevinMiddle "
          f"{LK.langevin_middle.launches}, rates diag "
          f"{np.diag(tQ).tolist()} {stamp}")
    require(d_launches == want, "gb_force launches = 100 per lag-100 run")
    require(LK.langevin_middle.launches == 0
            and GK.aboba_girsanov.launches == 0,
            "the trp-cage path runs no other kernel")
    require(tdata.propcoords.shape == (TNX, TNK, tsim.dim)
            and bool(torch.isfinite(tiso.data.propcoords).all()),
            "finite trp-cage bursts")
    tl = np.asarray(tiso.losses)
    require(len(tl) == GENS * ITERS and np.all(np.isfinite(tl))
            and tl[-1] < tl[0], "losses finite and falling")
    require(len(tiso.data) == TNX + GENS * RESAMPLES,
            "resample_strat added 3 points a generation")
    require(tchi.shape == (len(tiso.data), 1)
            and bool(torch.isfinite(tchi).all())
            and bool(torch.isfinite(tkchi).all()), "chis finite")
    require(np.all(np.diag(tQ) < 0), "rates() has a negative diagonal")
    phase("trpcage_path", t0, f"randx0 {t_x0:.3f}s propagate {t_prop:.3f}s")
    tframes = tiso.data.coords      # phase 10's start frames

    # ---- 9b. trpcage_production: the production tool's stages ----------------
    # tools/run_trpcage_production_torch.py after its pilot, through its
    # public functions on phase 9's trained Iso: the lag sweep and its
    # recommendation, the CK test, two generations of the tool's campaign()
    # (run(50) instead of 300, resample_strat(3), the cutoff) checkpointed
    # after each into a temporary directory, one escalate_lag to 200 steps
    # on the copy path, called whatever the headroom says, and a generation
    # at 200 steps checkpointed again.  Then one more generation twice:
    # relaunched from that checkpoint through the tool's resume path (load
    # and the telemetry JSON) and on the learner in memory; the two must
    # agree.  Kernel D at every MD step.
    t0 = time.perf_counter()
    GB.gb_force.launches = 0
    LK.langevin_middle.launches = 0
    GK.aboba_girsanov.launches = 0
    PIT, PRES, PNX, PNK = 50, 3, 8, 4
    tp, stage_d, stage_want, stage_losses = {}, {}, {}, {}
    tool = _production_tool()
    gkw = dict(iters=PIT, resamples=PRES, cutoff=CUTOFF, label="smoke")

    def stage(name, fn, steps, retry_steps, learner=None):
        """``fn()`` timed, with its D launches against ``steps`` (one a
        step of each propagation) plus ``retry_steps`` a retry of the
        learner's simulation, and the losses it added to the learner."""
        learner = learner or tiso
        n0, rr = GB.gb_force.launches, learner.data.sim.retries
        nl = len(learner.losses)
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        tp[name] = time.perf_counter() - t1
        stage_losses[name] = len(learner.losses) - nl
        retries = learner.data.sim.retries - rr
        stage_d[name] = GB.gb_force.launches - n0
        stage_want[name] = (steps + min(retry_steps) * retries,
                            steps + max(retry_steps) * retries)
        return out

    prec, prows = stage("lag_sweep", lambda: W.lag_sweep(
        tiso, steps=(100, 200), nx=PNX, nk=PNK, gen=itt.make_generator(32),
        verbose=False), 300, (100, 200))
    prec2 = W._recommend_lag(prows)
    pck_ok, pckrows = stage("cktest", lambda: W.cktest(
        tiso, factors=(2,), nx=PNX, nk=PNK, gen=itt.make_generator(33),
        verbose=False), 300, (100, 200))
    tel, results = [], {}
    with tempfile.TemporaryDirectory() as ck:
        stage("campaign 0-1", lambda: tool.campaign(
            tiso, 2, telemetry=tel, results=results, out=ck,
            checkpoint_every=1, **gkw), 200, (100,))
        lam_before = W.training_lag_headroom(tiso)
        stage("escalate_lag", lambda: W.escalate_lag(
            tiso, 200, nx_max=8, gen=itt.make_generator(34)), 200, (200,))
        esim = tiso.data.sim
        n_escalated = len(tiso.data)
        stage("campaign 2", lambda: tool.campaign(
            tiso, 3, telemetry=tel, results=results, out=ck,
            checkpoint_every=1, start_gen=2, **gkw), 200, (200,))
        lam_after = W.training_lag_headroom(tiso)
        t1 = time.perf_counter()
        riso, meta = tool.load_campaign(ck)
        tp["load"] = time.perf_counter() - t1
        rsim = riso.data.sim
        resumed_from = meta["done"]
        ck_files = sorted(os.listdir(ck))
        require(resumed_from == 3 and len(meta["telemetry"]) == 3
                and rsim.steps == 200 and rsim.constructor["steps"] == 200
                and rsim.device == dev and rsim.route == "hybrid"
                and len(riso.data) == len(tiso.data)
                and riso.losses == tiso.losses
                and torch.equal(riso.data.coords, tiso.data.coords)
                and riso.gen.get_state().equal(tiso.gen.get_state()),
                "the checkpoint holds the learner, its generator and the "
                "escalated simulation")
        stage("resumed generation 3", lambda: tool.campaign(
            riso, 4, telemetry=meta["telemetry"], out=ck,
            checkpoint_every=1, start_gen=resumed_from,
            already_spent=meta["telemetry"][-1]["t_total"], **gkw),
            200, (200,), learner=riso)
    stage("uninterrupted generation 3", lambda: tool.campaign(
        tiso, 4, telemetry=tel, start_gen=3, **gkw), 200, (200,))
    d_prod = GB.gb_force.launches
    # the tool's analysis stage: the reactive path of the campaign's data
    with tempfile.TemporaryDirectory() as rp_dir:
        t1 = time.perf_counter()
        tool.reactive_path_stage(tiso, rp_dir, results)
        tp["reactive_path"] = time.perf_counter() - t1
        rp_frames = (read_pdb_traj(os.path.join(rp_dir, "reactive_path.pdb"))
                     if os.path.exists(os.path.join(
                         rp_dir, "reactive_path.pdb")) else None)
    print(f"  trpcage_production: reactive path of {len(tiso.data)} start "
          f"points: {results.get('reactive_path_frames')} frames, error "
          f"{results.get('reactive_path_error')!r}, read back "
          f"{None if rp_frames is None else rp_frames.shape}")
    require("reactive_path_error" not in results
            and results.get("reactive_path_frames", 0) >= 2
            and rp_frames is not None
            and rp_frames.shape == (results["reactive_path_frames"],
                                    tsim.dim),
            "trpcage_production: the tool's reactive path, >= 2 frames")
    require(GB.gb_force.launches == d_prod,
            "the reactive path launches no kernel")
    rchi, uchi = riso.chis(), tiso.chis()
    chi_dev = float((rchi - uchi).abs().max())
    loss_dev = abs(riso.losses[-1] - tiso.losses[-1])
    same_bits = (torch.equal(rchi, uchi) and riso.losses == tiso.losses
                 and torch.equal(riso.data.propcoords, tiso.data.propcoords))
    for row in tel:
        print(f"  production {row}")
    print(f"  trpcage_production: lag_sweep (100, 200) recommends {prec} "
          f"(_recommend_lag {prec2}; timescales "
          f"{[round(r['timescale'], 4) for r in prows]} ps, slow eigenvalues "
          f"{[round(r['eigs'][1], 5) for r in prows]}, resolved "
          f"{[r['resolved'] for r in prows]}); cktest factor 2 ok={pck_ok} "
          f"max_abs_dev {pckrows[0]['max_abs_dev']:.4f}; headroom "
          f"{lam_before:.5f} before escalate_lag(200) (called whatever it "
          f"says), {lam_after:.5f} after a generation at {esim.steps} "
          f"steps; escalated data {n_escalated} points; checkpoint files "
          f"{ck_files}; resumed from generation {resumed_from}: data "
          f"{len(riso.data)} / {len(tiso.data)} points, chi max deviation "
          f"{chi_dev:.3e}, last loss {riso.losses[-1]:.6f} / "
          f"{tiso.losses[-1]:.6f} (deviation {loss_dev:.3e}), bit for bit "
          f"{same_bits}; gb_force launches {d_prod} by stage {stage_d} "
          f"(expected {stage_want}); losses added by stage "
          f"{stage_losses}; seconds "
          f"{ {k: round(v, 3) for k, v in tp.items()} } {stamp}")
    require(all(stage_want[k][0] <= stage_d[k] <= stage_want[k][1]
                for k in stage_d) and d_prod == sum(stage_d.values()),
            "trpcage_production: kernel D once an MD step")
    require(LK.langevin_middle.launches == 0
            and GK.aboba_girsanov.launches == 0,
            "trpcage_production runs no other kernel")
    require([r["steps"] for r in prows] == [100, 200]
            and all(len(r["eigs"]) == 2 and np.all(np.isfinite(r["eigs"]))
                    and (np.isfinite(r["timescale"])
                         or not 0.0 < r["eigs"][1] < 1.0) for r in prows)
            and prec == prec2 and prec in (None, 100, 200),
            "trpcage_production: lag_sweep rows and recommendation")
    require(pckrows[0]["steps"] == 200
            and np.isfinite(pckrows[0]["max_abs_dev"]),
            "trpcage_production: cktest row finite")
    require(esim is not tsim and esim.steps == 200 and tsim.steps == 100
            and n_escalated == PNX
            and tiso.data.propcoords.shape[1:] == (TNK, tsim.dim),
            "escalate_lag: a copy at 200 steps re-seeded with 8 starts")
    require(ck_files == ["campaign_checkpoint.pkl",
                         "campaign_telemetry.json"]
            and [r["gen"] for r in tel] == [0, 1, 2, 3]
            and [r["steps"] for r in tel] == [100, 100, 200, 200]
            and [r["n"] for r in tel] == [TNX + GENS * PRES + PRES,
                                          TNX + GENS * PRES + 2 * PRES,
                                          PNX + PRES, PNX + 2 * PRES]
            and all(np.isfinite(r["loss"]) for r in tel),
            "campaign telemetry: four generations, finite losses")
    # campaign() goes on past a generation whose run raised DomainError
    # (a collapsed target), as the JAX tool does; such a run records no
    # loss, so each generation must have added its PIT losses
    require(all(stage_losses[k] == PIT * g for k, g in (
        ("campaign 0-1", 2), ("campaign 2", 1), ("resumed generation 3", 1),
        ("uninterrupted generation 3", 1))),
            "every campaign generation trained (no collapse passed over)")
    require(np.isfinite(lam_before) and np.isfinite(lam_after),
            "training-lag headroom finite before and after the escalation")
    require(len(riso.data) == len(tiso.data) and chi_dev <= 1e-6
            and loss_dev <= 1e-6,
            "the resumed generation equals the uninterrupted one")
    require(bool(torch.isfinite(tiso.data.propcoords).all()),
            "finite production bursts")
    phase("trpcage_production", t0,
          " ".join(f"{k} {v:.3f}s" for k, v in tp.items()))

    # ---- 10. gb_force against plain ------------------------------------------
    t0 = time.perf_counter()
    vsim = itt.MDSimulation(pdb=pdb, steps=100, method="CutoffNonPeriodic")
    require(vsim.route == "hybrid", "vacuum trp-cage on the hybrid route")
    rng = np.random.default_rng(40)
    gb_err = 0.0
    for label, s in (("OBC2", tsim), ("vacuum RF", vsim)):
        xg = (s.coords[None] + torch.as_tensor(
            rng.normal(scale=0.005, size=(256, s.dim)), dtype=torch.float32,
            device=dev)).contiguous()
        for b in (1, 37, 256):
            xb = xg[:b].contiguous()
            f_k = GB.gb_force(s.gbplan, xb)
            f_p = GB.gb_force_plain(s.gbplan, xb)
            rel = float((f_k - f_p).abs().max() / f_p.abs().max())
            gb_err = max(gb_err, float((f_k - f_p).abs().max()))
            print(f"  gb_force {label} B={b}: max rel err {rel:.3e} (tol "
                  f"1e-5), max |F| {float(f_p.abs().max()):.1f}")
            require(rel < 1e-5, f"gb_force vs plain, {label}, B={b}")
        require(torch.equal(GB.gb_force(s.gbplan, xg),
                            GB.gb_force(s.gbplan, xg)),
                f"gb_force {label}: the same input gives the same bits")

    # villin HP35 (588 atoms, 19 tiles), the largest system of the paths
    vgplan = GB.GBPlan(build_system(vpdb, implicit="obc2", device=dev))
    require(vgplan.A == 588, "villin plan: 588 atoms")
    xv0 = torch.as_tensor(read_pdb(vpdb).coords.reshape(1, -1),
                          dtype=torch.float32, device=dev)
    xvg = (xv0 + torch.as_tensor(rng.normal(scale=0.005, size=(37,
                                                               vgplan.dim)),
                                 dtype=torch.float32, device=dev))
    # villin's bootstrap launches D at B=2 (its chains), the rest at B=1
    for b in (1, 2, 37):
        xb = xvg[:b].contiguous()
        f_k = GB.gb_force(vgplan, xb)
        f_p = GB.gb_force_plain(vgplan, xb)
        rel = float((f_k - f_p).abs().max() / f_p.abs().max())
        gb_err = max(gb_err, float((f_k - f_p).abs().max()))
        print(f"  gb_force OBC2 villin B={b}: max rel err {rel:.3e} (tol "
              f"1e-5), max |F| {float(f_p.abs().max()):.1f}")
        require(rel < 1e-5, f"gb_force vs plain, villin, B={b}")
    # a walker's forces are the same bits at every batch size
    xtg = (tsim.coords[None] + torch.as_tensor(
        rng.normal(scale=0.005, size=(37, tsim.dim)), dtype=torch.float32,
        device=dev)).contiguous()
    for label, gp, xs in (("trp-cage", tsim.gbplan, xtg),
                          ("villin", vgplan, xvg)):
        f1 = GB.gb_force(gp, xs[:1].contiguous())
        f37 = GB.gb_force(gp, xs)
        f1024 = GB.gb_force(gp, xs[:1].expand(1024, -1).contiguous())
        require(torch.equal(f37[:1], f1) and torch.equal(f1024[:1], f1),
                f"gb_force {label}: row 0 of B=37 and of B=1024 equals B=1 "
                f"bit for bit")
    print("  gb_force: row 0 of B=37 and of B=1024 equals B=1 bit for bit "
          "(trp-cage, villin)")

    # minimum image: the bundled alanine (CutoffPeriodic reaction field,
    # box from its PDB), each atom moved by -1, 0 or 1 box lengths per
    # axis, so that the image changes pairs across a wrap
    pplan = GB.GBPlan(sim.system)
    require(pplan.box is not None, "alanine plan is periodic")
    xa = (sim.coords[None] + torch.as_tensor(
        rng.normal(scale=0.005, size=(256, sim.dim)), dtype=torch.float32,
        device=dev)).contiguous()
    shift = torch.as_tensor(rng.integers(-1, 2, size=(256, pplan.A, 3)),
                            dtype=torch.float32, device=dev)
    xw = (xa.reshape(256, pplan.A, 3) + shift * torch.tensor(
        pplan.box, device=dev)).reshape(256, sim.dim).contiguous()
    for b in (1, 37, 256):
        f_k = GB.gb_force(pplan, xw[:b].contiguous())
        f_p = GB.gb_force_plain(pplan, xw[:b].contiguous())
        rel = float((f_k - f_p).abs().max() / f_p.abs().max())
        gb_err = max(gb_err, float((f_k - f_p).abs().max()))
        print(f"  gb_force periodic RF (alanine, wrapped atoms) B={b}: max "
              f"rel err {rel:.3e} (tol 1e-5), max |F| "
              f"{float(f_p.abs().max()):.1f}")
        require(rel < 1e-5, f"gb_force vs plain, periodic RF, B={b}")
    f_u = GB.gb_force_plain(pplan, xa)
    wrel = float((GB.gb_force(pplan, xw) - f_u).abs().max()
                 / f_u.abs().max())
    print(f"  gb_force periodic RF B=256, wrapped against unwrapped atoms: "
          f"rel {wrel:.3e} (tol 1e-4)")
    require(wrel < 1e-4, "minimum image undoes the wraps")

    def plain_force(x):
        return F.force_flat(tsim.system, x)

    reps = -(-256 // len(tframes))
    xg = tframes.repeat(reps, 1)[:256].contiguous()  # 256 walkers
    vg = tsim.random_velocities(itt.make_generator(41), xg.shape)
    xh, vh = tsim._integrate(xg, vg, 10, None)
    xp, vp = I.langevin_middle(plain_force, xg, vg, tsim.masses3, tsim.temp,
                               tsim.friction, tsim.step, 10)
    xrel = float((xh - xp).abs().max() / xp.abs().max())
    vrel = float((vh - vp).abs().max() / vp.abs().max())
    print(f"  noiseless x10 steps B=256, hybrid vs plain force_flat: rel x "
          f"{xrel:.3e} (tol 1e-5), rel v {vrel:.3e} (tol 1e-4)")
    require(xrel < 1e-5 and vrel < 1e-4, "noiseless hybrid vs plain path")

    # kinetic temperature over the last 50 of 100 steps, B=256, the same
    # start and the same noise stream for both paths (cut for the time
    # limit, PERF.md §4)
    TCH = 25                    # steps a chunk, 4 chunks

    def kinetic_temperature(step_fn):
        x, v, temps = xg, vg, []
        for k in range(4):
            x, v = step_fn(x, v)
            if k >= 2:
                temps.append(float((tsim.masses3 * v * v).sum(dim=1).mean()
                                   / (tsim.dim * KB)))
        require(bool(torch.isfinite(x).all()), "finite temperature run")
        return float(np.mean(temps))

    gh, gp = itt.make_generator(42), itt.make_generator(42)
    t1 = time.perf_counter()
    temp_h = kinetic_temperature(lambda x, v: tsim._integrate(x, v, TCH,
                                                              gh))
    t_th = time.perf_counter() - t1
    t1 = time.perf_counter()
    temp_p = kinetic_temperature(lambda x, v: I.langevin_middle(
        plain_force, x, v, tsim.masses3, tsim.temp, tsim.friction,
        tsim.step, TCH, noise_generator(gp, dev)))
    t_tp = time.perf_counter() - t1
    print(f"  kinetic temperature B=256, steps {2 * TCH}-{4 * TCH}: hybrid "
          f"{temp_h:.2f} "
          f"K ({t_th:.1f}s), plain force_flat {temp_p:.2f} K ({t_tp:.1f}s), "
          f"target 310 K; |diff| {abs(temp_h - temp_p) / temp_p:.3%} (tol "
          f"1%)")
    require(abs(temp_h - temp_p) / temp_p < 0.01,
            "hybrid and plain paths at the same temperature")
    # two witnesses at 2 fs: trp-cage without GB (vacuum NoCutoff, a
    # smooth potential) on the same start, and alanine through the plain
    # recursion of the hybrid route (with the forces entry of kernel A's
    # module, held to its plain version in phase 3) on the start and for
    # the steps of phase 3's kernel A temperature run
    nsim = itt.MDSimulation(pdb=pdb, steps=100, method="NoCutoff")
    require(nsim.route == "hybrid", "vacuum NoCutoff trp-cage on the "
                                    "hybrid route")
    gn = itt.make_generator(44)
    temp_n = kinetic_temperature(lambda x, v: nsim._integrate(x, v, TCH,
                                                              gn))
    ga = itt.make_generator(45)
    _, va = I.langevin_middle(sim.force, xT, vT, m3, sim.temp, sim.friction,
                              sim.step, NT, noise_generator(ga, dev))
    temp_a = float((m3 * va * va).sum(dim=1).mean() / (sim.dim * KB))
    print(f"  kinetic temperature at 2 fs: trp-cage vacuum NoCutoff "
          f"{temp_n:.2f} K (B=256, {0.004 * TCH:.1f}-{0.008 * TCH:.1f} ps); "
          f"alanine plain recursion "
          f"{temp_a:.2f} K (B={BT} after {NT} steps; kernel A {temp:.2f} K)")
    require(abs(temp_a - temp) / temp < 0.01,
            "alanine: plain recursion and kernel A at the same temperature")
    phase("gb_vs_plain", t0, "OBC2, vacuum RF and periodic RF at B=1/37/256, "
                             "villin at B=1/2/37, same bits, row 0 at "
                             "B=37/1024, noiseless steps, temperature")

    # ---- 11. gb_force timing ---------------------------------------------------
    t0 = time.perf_counter()
    plan = tsim.gbplan
    d_ms = {}
    for b in (1, 32, 1024, 16384):
        xb = tsim.coords[None].expand(b, tsim.dim).contiguous()
        d_ms[b] = cuda_ms(lambda: GB.gb_force(plan, xb),
                          reps=20 if b < 16384 else 3)
        bb, by = GB.bound_ms(plan, b)
        print(f"  gb_force OBC2 B={b}: {d_ms[b]:.4f} ms, bound {bb:.4f} ms "
              f"({by}, {bb / d_ms[b]:.2%} of it) {stamp}")
    d_plain = {}
    for b in (256, 1024):
        xb = tsim.coords[None].expand(b, tsim.dim).contiguous()
        d_plain[b] = cuda_ms(lambda: GB.gb_force_plain(plan, xb), reps=3)
    d_bms, d_by = GB.bound_ms(plan, 1024)
    kops_d, sops_d = GB.kernel_ops(plan), GB.step_ops(plan)
    nbl, ncl = GB.blocks(plan, 1)
    print(f"  gb_force OBC2 operations a walker: {sops_d:.0f} the function "
          f"needs (each unordered pair once; the bound's), {kops_d:.0f} the "
          f"kernel executes ({kops_d / sops_d:.3f}x), "
          f"{GB.step_ops(plan, ordered=True):.0f} by PR 7-10's ordered-pair "
          f"count (bound at B=1024 {GB.bound_ms(plan, 1024, True)[0]:.4f} "
          f"ms, {GB.bound_ms(plan, 1024, True)[0] / d_ms[1024]:.2%} of the "
          f"time); {GB.tiles(plan)} tiles, {len(GB.tile_pairs(plan))} tile "
          f"pairs; {nbl} blocks in {ncl} cluster at B=1 "
          f"({GB.launch_shape(plan)[1]} warps a block), "
          f"{GB.gb_force.max_clusters(plan)} clusters resident at once; "
          f"villin {GB.blocks(vgplan, 1)[0]} blocks a walker, "
          f"{GB.gb_force.max_clusters(vgplan)} clusters at once")
    dv_ms = {}
    for b in (1, 32):
        xb = xv0.expand(b, -1).contiguous()
        dv_ms[b] = cuda_ms(lambda: GB.gb_force(vgplan, xb), reps=20)
        bb, by = GB.bound_ms(vgplan, b)
        print(f"  gb_force OBC2 villin (588 atoms) B={b}: {dv_ms[b]:.4f} ms, "
              f"bound {bb:.4f} ms ({by}, {bb / dv_ms[b]:.2%} of it), "
              f"{GB.blocks(vgplan, b)[0]} blocks {stamp}")
    vb = vsim.coords[None].expand(1024, vsim.dim).contiguous()
    v_ms = cuda_ms(lambda: GB.gb_force(vsim.gbplan, vb), reps=20)
    x1 = tsim.coords[None].contiguous()
    bonded_ms = cuda_ms(lambda: F.bonded_force_flat(tsim.system, x1),
                        reps=20)
    print(f"  gb_force plain B=256: {d_plain[256]:.3f} ms, B=1024: "
          f"{d_plain[1024]:.3f} ms; vacuum RF kernel B=1024: {v_ms:.4f} ms; "
          f"bonded autograd B=1: {bonded_ms:.4f} ms {stamp}")
    phase("gb_timing", t0)

    # ---- 12. solvated path --------------------------------------------------
    # examples/solvated_peptide.py's full variant at its widths: the
    # 11-residue peptide in a TIP3P box with 1 nm padding, rigid water, a
    # 100-step lag, nk = 4, 200 iterations; nx is cut from 50 to 4, the
    # biased run to 50 steps.
    t0 = time.perf_counter()
    NXS, NKS, ITS, EQS, EQW, XLAG, BSTEPS = 4, 4, 200, 200, 4, 50, 50
    t1 = time.perf_counter()
    ssim = itt.MDSimulation(pdb=spdb, addwater=True, padding=1.0, steps=100)
    ts_build = time.perf_counter() - t1
    cset, splan = ssim.constraint_set, ssim.nbplan
    print(f"  solvated peptide: {ssim.natoms} atoms, {cset.nwater} rigid "
          f"waters, box {ssim.system.box} nm, cutoff {ssim.system.cutoff} "
          f"nm, {ssim.system.excl_idx.shape[0]} exceptions; plan grid "
          f"{tuple(int(c) for c in splan.nc)}, capacity {splan.C}, "
          f"{splan.full.shape[1]} stencil cells, Newton "
          f"{splan.newton}; {len(ssim.featurizer.pairs)} solute-pair "
          f"features")
    require(ssim.natoms == 7744 and ssim.route == "neighbor"
            and cset.nwater == 2526 and not ssim.system.dense_pairs,
            "7,744 atoms with 2,526 rigid waters on the neighbor route")
    for k in (NBK.neighbor_sweep, NBK.neighbor_layout, LK.langevin_middle,
              LK.forces, GK.aboba_girsanov, GB.gb_force):
        k.launches = 0
    sgen = itt.make_generator(50)
    r0 = ssim.retries
    t1 = time.perf_counter()
    eq = ssim.propagate(ssim.coords[None].repeat(EQW, 1), 1, gen=sgen,
                        steps=EQS)
    torch.cuda.synchronize()
    ts_eq = time.perf_counter() - t1
    r1 = ssim.retries
    require(bool(torch.isfinite(eq).all()), "finite equilibration")
    ssim.setcoords(eq[0, 0])
    smodel = ssim.defaultmodel(n=len(ssim.featurizer.pairs), gen=sgen)
    t1 = time.perf_counter()
    # randx0's lagged trajectory at 50-step lags
    sxs = ssim.laggedtrajectory(NXS, steps=XLAG, gen=sgen)
    torch.cuda.synchronize()
    ts_x0 = time.perf_counter() - t1
    n_sx0 = NBK.neighbor_sweep.launches - EQS * (1 + r1 - r0)
    t1 = time.perf_counter()
    sy = ssim.propagate(sxs, NKS, gen=sgen)
    torch.cuda.synchronize()
    ts_prop = time.perf_counter() - t1
    r2 = ssim.retries
    sdata = itt.SimulationData.from_coords(ssim, sxs, sy)
    siso = itt.Iso(data=sdata, model=smodel, opt=itt.AdamRegularized(),
                   gen=51)
    t1 = time.perf_counter()
    siso.run(ITS)
    torch.cuda.synchronize()
    ts_train = time.perf_counter() - t1
    schi, skchi, sQ = siso.chis(), siso.koopman(), siso.rates()
    e_launches = NBK.neighbor_sweep.launches
    l_launches = NBK.neighbor_layout.launches
    want = (EQS * (1 + r1 - r0) + NXS * XLAG + 100 * (1 + r2 - r1))
    viol = max(cset.max_violation(sxs), cset.max_violation(sy))
    ms_x0 = 1e3 * ts_x0 / (NXS * XLAG)
    print(f"  solvated path: peptide_pdb (build + 300 FIRE steps) "
          f"{ts_pep:.3f}s, MDSimulation (solvate + system + plan) "
          f"{ts_build:.3f}s, equilibration {EQW}x{EQS} steps {ts_eq:.3f}s, "
          f"laggedtrajectory({NXS}, steps={XLAG}) {ts_x0:.3f}s ({ms_x0:.3f} "
          f"ms/step, {n_sx0} "
          f"launches), propagate {NXS}x{NKS} {ts_prop:.3f}s, run({ITS}) "
          f"{ts_train:.3f}s; loss {siso.losses[0]:.4f} -> "
          f"{siso.losses[-1]:.4f}; retries {r2 - r0}, overflows "
          f"{ssim.overflows}; constraint violation {viol:.2e} nm; "
          f"neighbor_sweep launches {e_launches}, neighbor_layout "
          f"{l_launches} (expected {want} each); rates "
          f"diag {np.diag(sQ).tolist()} {stamp}")
    require(e_launches == want and l_launches == want,
            "neighbor_layout and neighbor_sweep launches = one per MD step")
    require(LK.langevin_middle.launches == 0 and LK.forces.launches == 0
            and GK.aboba_girsanov.launches == 0
            and GB.gb_force.launches == 0,
            "the solvated path runs no other kernel")
    require(ssim.overflows == 0, "no neighbor-cell overflow")
    require(viol <= 1e-5, "rigid waters held to 1e-5 nm")
    require(sdata.propcoords.shape == (NXS, NKS, ssim.dim)
            and bool(torch.isfinite(sxs).all())
            and bool(torch.isfinite(sy).all()), "finite solvated frames")
    sl = np.asarray(siso.losses)
    require(len(sl) == ITS and np.all(np.isfinite(sl)) and sl[-1] < sl[0],
            "losses finite and falling")
    require(schi.shape == (NXS, 1) and bool(torch.isfinite(schi).all())
            and bool(torch.isfinite(skchi).all()), "chis finite")
    require(np.all(np.diag(sQ) < 0), "rates() has a negative diagonal")

    # a biased constrained propagation of the NXS x NKS walkers: the
    # optcontrol form over the chi just trained with a fixed b = 0.5 and
    # rate log(0.9) / lag (optcontrol's own fit may not contract at nx = 4,
    # ROADMAP Queue 3 (n)); forcescale 0.5.  Constrained ABOBA: SHAKE on
    # the drifts, the bias projected onto the constraint tangent space,
    # kernel E (layout and sweep) once a step, no retry.
    for k in (NBK.neighbor_sweep, NBK.neighbor_layout, LK.langevin_middle,
              LK.forces, GK.aboba_girsanov, GB.gb_force):
        k.launches = 0
    ssim.bias = I.optcontrol_bias(siso.model, ssim.featurizer, 0.5, 0.5,
                                  float(np.log(0.9)) / ssim.lagtime,
                                  ssim.lagtime)
    t1 = time.perf_counter()
    try:
        sw = ssim.propagate(sxs, NKS, gen=sgen, steps=BSTEPS)
    finally:
        ssim.bias = None
    torch.cuda.synchronize()
    ts_biased = time.perf_counter() - t1
    sviol = cset.max_violation(sw.values)
    slogw = torch.log(sw.weights)
    print(f"  solvated biased propagate {NXS}x{NKS} x{BSTEPS} constrained "
          f"ABOBA steps: {ts_biased:.3f}s "
          f"({1e3 * ts_biased / BSTEPS:.3f} ms/step); "
          f"constraint violation {sviol:.2e} nm; logw "
          f"[{float(slogw.min()):.4f}, {float(slogw.max()):.4f}], E[w] "
          f"{float(sw.weights.mean()):.4f}; neighbor_sweep launches "
          f"{NBK.neighbor_sweep.launches}, neighbor_layout "
          f"{NBK.neighbor_layout.launches} (expected {BSTEPS} each); "
          f"overflows "
          f"{ssim.overflows} {stamp}")
    require(isinstance(sw, itt.WeightedSamples)
            and sw.values.shape == (NXS, NKS, ssim.dim)
            and bool(torch.isfinite(sw.values).all())
            and bool(torch.isfinite(slogw).all())
            and float(slogw.abs().max()) > 0,
            "biased constrained propagation: finite frames and log-weights,"
            " the bias acting")
    require(sviol <= 1e-5, "biased rigid waters held to 1e-5 nm")
    require(NBK.neighbor_sweep.launches == BSTEPS
            and NBK.neighbor_layout.launches == BSTEPS,
            "biased constrained: layout and sweep once a step")
    require(LK.langevin_middle.launches == 0 and LK.forces.launches == 0
            and GK.aboba_girsanov.launches == 0
            and GB.gb_force.launches == 0,
            "the biased constrained run launches no other kernel")
    require(ssim.overflows == 0, "no neighbor-cell overflow")
    eb_launches = NBK.neighbor_sweep.launches
    phase("solvated_path", t0, f"laggedtrajectory {ts_x0:.3f}s propagate "
                               f"{ts_prop:.3f}s biased propagate "
                               f"{ts_biased:.3f}s")

    # ---- 13. neighbor_sweep against plain -----------------------------------
    t0 = time.perf_counter()
    # frames of the path: its 16 burst ends, four times, for B = 64
    xq = sy.reshape(-1, ssim.dim).repeat(4, 1)[:64].contiguous()
    nb_err, lay_err, e_plain = 0.0, 0.0, {}
    # the layout kernel against kernel_records, bit for bit (the tile
    # boxes, and the live slots: the kernel writes no other): the path's
    # plan, and a capacity of 300 where full cells drop atoms
    def same_layout(got, want):
        live = NBK.live_slots(want[1])
        r_k, r_p = got[0][live], want[0][live]
        return (torch.equal(got[1], want[1])
                and torch.equal(r_k.view(torch.int32),
                                r_p.view(torch.int32)),
                float((r_k[:, :6] - r_p[:, :6]).abs().max()))

    small = NB.NeighborPlan(ssim.system, capacity=300, cell_div=splan.cell_div)
    for p_, b in ((splan, 1), (splan, 37), (splan, 64), (small, 4)):
        xb = xq[:b].contiguous()
        got = NBK.neighbor_layout(ssim.system, p_, xb)
        same, err = same_layout(got, NBK.kernel_records(ssim.system, p_, xb))
        lay_err = max(lay_err, err)
        print(f"  neighbor_layout capacity {p_.C} B={b}: live records and "
              f"tile boxes {'equal' if same else 'differ from'} "
              f"kernel_records' bit for bit ({got[0].shape[2]} slots a "
              f"cell, {int(got[1][..., 3].sum()) // b} of {ssim.natoms} "
              f"atoms kept a walker)")
        require(same, f"neighbor_layout vs kernel_records, capacity "
                      f"{p_.C}, B={b}")
    require(small.overflow(xq[:4]) > 0, "the capacity-300 plan drops atoms")
    for label, a in (("RF", None), ("erfc", NB.ewald_alpha(1.0, 5e-4))):
        for b in ((1, 37, 64) if a is None else (1, 37)):
            xb = xq[:b].contiguous()
            f_k = NBK.neighbor_sweep(ssim.system, splan, xb, a)
            f_p, ms_p = timed(lambda: NBK.neighbor_sweep_plain(
                ssim.system, splan, xb, a))
            if a is None:
                e_plain[b] = ms_p
            rel = float((f_k - f_p).abs().max() / f_p.abs().max())
            nb_err = max(nb_err, float((f_k - f_p).abs().max()))
            print(f"  neighbor_sweep {label} B={b}: max rel err {rel:.3e} "
                  f"(tol 1e-5), max |F| {float(f_p.abs().max()):.1f}")
            require(rel < 1e-5, f"neighbor_sweep vs plain, {label}, B={b}")
    require(torch.equal(NBK.neighbor_sweep(ssim.system, splan, xq),
                        NBK.neighbor_sweep(ssim.system, splan, xq)),
            "neighbor_sweep: the same input gives the same bits")
    asim = itt.MDSimulation(addwater=True, padding=0.9, dense_pairs=False)
    aplan = asim.nbplan
    require(asim.route == "neighbor" and not aplan.newton and aplan.S > 0,
            "solvated alanine: a non-Newton plan")
    xa = (asim.coords[None] + torch.as_tensor(
        np.random.default_rng(52).normal(scale=0.003, size=(37, asim.dim)),
        dtype=torch.float32, device=dev)).contiguous()
    require(same_layout(NBK.neighbor_layout(asim.system, aplan, xa),
                        NBK.kernel_records(asim.system, aplan, xa))[0],
            "neighbor_layout vs kernel_records, non-Newton plan")
    f_k = NBK.neighbor_sweep(asim.system, aplan, xa)
    f_p = NBK.neighbor_sweep_plain(asim.system, aplan, xa)
    rel = float((f_k - f_p).abs().max() / f_p.abs().max())
    nb_err = max(nb_err, float((f_k - f_p).abs().max()))
    print(f"  neighbor_sweep solvated alanine ({asim.natoms} atoms, grid "
          f"{tuple(int(c) for c in aplan.nc)}, non-Newton) B=37: max rel "
          f"err {rel:.3e} (tol 1e-5)")
    require(rel < 1e-5, "neighbor_sweep vs plain, non-Newton plan")

    def plain_force(x):
        return NB.force_flat_neighbor(ssim.system, x, splan,
                                      sweep=NBK.neighbor_sweep_plain)

    x4 = xq[:4].contiguous()
    v4 = cset.rattle(x4, ssim.random_velocities(itt.make_generator(53),
                                                x4.shape))
    xk, vk = ssim._integrate(x4, v4, 10, None)
    xp, vp = I.langevin_middle(plain_force, x4, v4, ssim.masses3, ssim.temp,
                               ssim.friction, ssim.step, 10, None, cset)
    xrel = float((xk - xp).abs().max() / xp.abs().max())
    vrel = float((vk - vp).abs().max() / vp.abs().max())
    print(f"  noiseless constrained x10 steps B=4, kernel vs plain route: "
          f"rel x {xrel:.3e} (tol 1e-5), rel v {vrel:.3e} (tol 1e-4)")
    require(xrel < 1e-5 and vrel < 1e-4, "noiseless kernel vs plain route")

    # kinetic temperature, 3N - 3 nwater degrees of freedom, of both routes
    # from one start with one noise stream: the mean over the walkers and
    # over the last half of the run
    dof = ssim.dim - 3 * cset.nwater
    x16 = xq[:TB].contiguous()
    v16 = cset.rattle(x16, ssim.random_velocities(itt.make_generator(54),
                                                  x16.shape))

    def temperature(force, gen):
        x, v, temps = x16, v16, []
        noise = noise_generator(gen, dev)
        for k in range(TSTEPS // 10):
            x, v = I.langevin_middle(force, x, v, ssim.masses3, ssim.temp,
                                     ssim.friction, ssim.step, 10, noise,
                                     cset)
            if k >= TSTEPS // 20:
                temps.append(float((ssim.masses3 * v * v).sum(dim=1).mean()
                                   / (dof * KB)))
        require(bool(torch.isfinite(x).all()), "finite temperature run")
        return float(np.mean(temps))

    t1 = time.perf_counter()
    temp_k = temperature(ssim.force, itt.make_generator(55))
    t_tk = time.perf_counter() - t1
    t1 = time.perf_counter()
    temp_p = temperature(plain_force, itt.make_generator(55))
    t_tp = time.perf_counter() - t1
    print(f"  kinetic temperature B={TB}, steps {TSTEPS // 2}-{TSTEPS}, "
          f"{dof} degrees of freedom: kernel route {temp_k:.2f} K "
          f"({t_tk:.1f}s), plain route {temp_p:.2f} K ({t_tp:.1f}s), target "
          f"310 K; |diff| {abs(temp_k - temp_p) / temp_p:.3%} (tol 1%)")
    require(abs(temp_k - temp_p) / temp_p < 0.01,
            "kernel and plain routes at the same temperature")
    phase("neighbor_vs_plain", t0, "RF and erfc at B=1/37/64, same bits, "
                                   "non-Newton plan, noiseless steps, "
                                   "temperature")

    # ---- 14. neighbor_sweep timing ------------------------------------------
    # the wrapper, and apart: the layout kernel (its plain version
    # kernel_records beside it) and the sweep alone on records made
    # beforehand
    t0 = time.perf_counter()
    e_ms, e_prep, e_alone, l_plain, l_bound = {}, {}, {}, {}, {}
    for b in (1, 64, 256):
        xb = xq.repeat(-(-b // 64), 1)[:b].contiguous()
        reps = 20 if b == 1 else 3
        e_ms[b] = cuda_ms(lambda: NBK.neighbor_sweep(ssim.system, splan, xb),
                          reps=reps)
        e_prep[b] = cuda_ms(lambda: NBK.neighbor_layout(ssim.system, splan,
                                                        xb), reps=reps)
        l_plain[b] = cuda_ms(lambda: NBK.kernel_records(ssim.system, splan,
                                                        xb), reps=reps)
        rec, boxes = NBK.neighbor_layout(ssim.system, splan, xb)
        l_bound[b] = NBK.layout_bound_ms(splan, boxes)[0]
        fout = torch.zeros_like(xb)
        e_alone[b] = cuda_ms(lambda: NBK.neighbor_sweep.launch(
            ssim.system, splan, rec, boxes, out=fout), reps=reps)
        del rec, boxes, fout
    _, e_plain[16] = timed(lambda: NBK.neighbor_sweep_plain(
        ssim.system, splan, xq[:16].contiguous()))
    # the bound from this run's pairs: xq's 64 frames (B = 64, and four
    # times over at B = 256), its first frame at B = 1; xq holds the 16
    # burst ends four times over, so its counts are four times theirs
    nq, nd = xq.shape[0], NXS * NKS
    require(nq % nd == 0 and torch.equal(xq, xq[:nd].repeat(nq // nd, 1)),
            "xq repeats the burst ends")
    in_range, visited, culls = (nq // nd * c for c in NBK.pair_counts(
        ssim.system, splan, xq[:nd]))
    in_1 = NBK.pair_counts(ssim.system, splan, xq[:1])[0]
    e_bms, e_by = NBK.bound_ms(splan, nq, in_range)
    bounds = {1: NBK.bound_ms(splan, 1, in_1)[0], nq: e_bms,
              256: NBK.bound_ms(splan, 256, in_range * 256 // nq)[0]}
    kops = NBK.kernel_ops(in_range, visited, culls)
    sops = NBK.step_ops(in_range)
    for b in (1, 64, 256):
        print(f"  neighbor_sweep B={b}: wrapper {e_ms[b]:.4f} ms = layout "
              f"kernel {e_prep[b]:.4f} ms (bound {l_bound[b]:.4f} ms, bytes, "
              f"{l_bound[b] / e_prep[b]:.2%} of it; plain "
              f"kernel_records {l_plain[b]:.4f} ms) + sweep alone "
              f"{e_alone[b]:.4f} ms (bound {bounds[b]:.4f} ms, {e_by}, "
              f"{bounds[b] / e_alone[b]:.2%} of it) {stamp}")
    print(f"  neighbor_sweep plain B=1: {e_plain[1]:.3f} ms, B=16: "
          f"{e_plain[16]:.3f} ms, B=64: {e_plain[64]:.3f} ms; pairs in "
          f"cutoff {in_range / nq:.0f} a walker (unordered), slot pairs "
          f"tested {visited / nq:.0f} ({visited / in_range:.2f} an "
          f"unordered pair in range), culling tests {culls / nq:.0f}; "
          f"operations {sops / nq:.4g} the function needs, {kops / nq:.4g} "
          f"the kernel executes ({kops / sops:.2f}x); blocks at B=1: "
          f"{NBK.blocks(splan, 1)} ({NBK.tiles(splan)} tiles of "
          f"{NBK.TILE} slots a cell, {NBK.SPLIT} warps a tile); share "
          f"of a randx0 step (B=1) {e_ms[1] / ms_x0:.1%} {stamp}")
    phase("neighbor_timing", t0)

    # ---- 15. villin path -----------------------------------------------------
    # The system of tools/run_villin_scale.py (HP35 with ACE/NME caps, OBC2,
    # no constraints), minimized as examples/villin.py (800 FIRE steps, in
    # phase 2), with all-pairs features and the default chi model, through
    # Iso and run_girsanov at the reference's 0.2 ps Girsanov lag.  Depth
    # cuts: nx 8, nk 4, 50 + 50 iterations, kde 8, 1 generation.
    # Adam at lr 1e-5: at the default 1e-3 (and at 1e-4) the first steps
    # move each first-layer pre-activation by about lr x the sum of the
    # 172,578 LayerNorm'd features (~140 at 1e-3), every sigmoid saturates
    # alike, chi is constant over the data and the shift-scale target
    # divides 0 by 0: training raises DomainError, in the JAX package too.
    t0 = time.perf_counter()
    VNX, VNK, VIT, VGENS, VGIT, VLR = 8, 4, 50, 1, 50, 1e-5
    for k in (PK.sqpairdist_fwd, PK.sqpairdist_bwd, GB.gb_force,
              LK.langevin_middle, LK.forces, GK.aboba_girsanov,
              NBK.neighbor_sweep, NBK.neighbor_layout):
        k.launches = 0
    t1 = time.perf_counter()
    vsim = itt.MDSimulation(pdb=vpdb, steps=100, implicit="obc2",
                            features=itt.FeaturesAll())
    tv_sys = time.perf_counter() - t1
    nfeat_v = vsim.natoms * (vsim.natoms - 1) // 2
    require(vsim.natoms == 588 and vsim.route == "hybrid"
            and isinstance(vsim.featurizer, itt.FeaturesAll),
            "villin: 588 atoms on the hybrid route, all-pairs features")
    vgen = itt.make_generator(60)
    # the reference's bootstrap: 2 chains of 4 lags after a 2-lag burn-in
    vchains, vburnin = vsim.bootstrap_chains(VNX)
    vlags = VNX // vchains + vburnin
    require((vchains, vburnin) == (2, 2), "villin bootstrap: 2 chains, "
                                          "burn-in 2 lags")
    torch.cuda.reset_peak_memory_stats()
    r0 = vsim.retries
    t1 = time.perf_counter()
    viso = itt.Iso(sim=vsim, nx=VNX, nk=VNK,
                   opt=itt.AdamRegularized(adam=VLR), gen=vgen)
    torch.cuda.synchronize()
    tv_data = time.perf_counter() - t1
    nparam = sum(p.numel() for p in viso.model.parameters())
    require(viso.data.featuredim == nfeat_v == 172578
            and viso.model.sizes == (172578, 3100, 56, 1),
            "172,578 features into the default autonet (172578, 3100, 56, 1)")
    t1 = time.perf_counter()
    viso.run(VIT)
    torch.cuda.synchronize()
    tv_train = time.perf_counter() - t1
    vl0 = np.asarray(viso.losses)
    t1 = time.perf_counter()
    vsim.bias = itt.optcontrol(viso, forcescale=0.5)
    vws = vsim.propagate(viso.data.coords, VNK, gen=vgen)
    vsim.bias = None
    torch.cuda.synchronize()
    tv_prop = time.perf_counter() - t1
    require(isinstance(vws, itt.WeightedSamples)
            and vws.values.shape == (VNX, VNK, vsim.dim)
            and bool(torch.isfinite(vws.values).all())
            and bool(torch.isfinite(vws.weights).all()),
            "villin: biased propagate gives finite WeightedSamples")
    n_before = len(viso.data)
    t1 = time.perf_counter()
    itt.run_girsanov(viso, generations=VGENS, iter=VGIT, kde=VNX,
                     forcescale=0.5)
    torch.cuda.synchronize()
    tv_gir = time.perf_counter() - t1
    vrows = viso.girsanov_telemetry
    vchi, vkchi, vQ = viso.chis(), viso.koopman(), viso.rates()
    c_launches = PK.sqpairdist_fwd.launches
    cb_launches = PK.sqpairdist_bwd.launches
    dv_launches = GB.gb_force.launches
    biased_gens = sum(1 for r in vrows if r["biased"] and r["n_new"] > 0)
    grown = sum(1 for r in vrows if r["n_new"] > 0)
    biased_steps = 100 * (1 + biased_gens)
    featurizations = 2 + 2 * grown          # from_sim, then each addcoords
    want_d = (vlags * 100 + 100 * (1 + vsim.retries - r0) + biased_steps
              + 100 * (grown - biased_gens))
    for row in vrows:
        print(f"  run_girsanov {row}")
    print(f"  villin path: peptide_pdb (build + 800 FIRE steps) "
          f"{tv_pep:.3f}s, MDSimulation {tv_sys:.3f}s, Iso(nx={VNX}, "
          f"nk={VNK}) {tv_data:.3f}s (bootstrap: chains {vchains}, burnin "
          f"{vburnin} lags, {vlags * 100} steps at B={vchains} + propagate "
          f"+ featurize + a {nparam}-parameter autonet), run({VIT}) "
          f"{tv_train:.3f}s, optcontrol + biased propagate {VNX}x{VNK} "
          f"{tv_prop:.3f}s, run_girsanov {VGENS} generations {tv_gir:.3f}s; "
          f"loss {vl0[0]:.4f} -> {vl0[-1]:.4f}; weights "
          f"[{float(vws.weights.min()):.4g}, {float(vws.weights.max()):.4g}]"
          f"; retries {vsim.retries - r0}; launches: sqpairdist_fwd "
          f"{c_launches} (expected {biased_steps} biased steps + "
          f"{featurizations} featurizations), sqpairdist_bwd {cb_launches} "
          f"(expected {biased_steps}), gb_force {dv_launches} (expected "
          f"{want_d}); rates diag {np.diag(vQ).tolist()}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"{stamp}")
    require(biased_gens >= 1, "villin: at least one biased generation")
    require(cb_launches == biased_steps,
            "sqpairdist_bwd launched once per biased MD step")
    require(c_launches == biased_steps + featurizations,
            "sqpairdist_fwd launched once per biased step and featurization")
    require(dv_launches == want_d, "gb_force launched once per MD step")
    require(LK.langevin_middle.launches == 0 and LK.forces.launches == 0
            and GK.aboba_girsanov.launches == 0
            and NBK.neighbor_sweep.launches == 0
            and NBK.neighbor_layout.launches == 0,
            "the villin path runs no other kernel")
    vpf = viso.data.propfeatures
    require(isinstance(vpf, itt.WeightedSamples)
            and bool(torch.isfinite(vpf.weights).all())
            and bool(torch.isfinite(vpf.values).all()),
            "villin: finite WeightedSamples")
    vgl = np.asarray(viso.losses[VIT:]).reshape(VGENS, VGIT)
    vgrowth = np.diff([n_before] + [r["n_data"] for r in vrows])
    vends = [(round(float(a), 5), round(float(b), 5))
             for a, b in vgl[:, [0, -1]]]
    print(f"  villin losses: run({VIT}) {vl0[0]:.5f} -> {vl0[-1]:.5f}; "
          f"generations {vends}; data grew by {vgrowth.tolist()} (kde "
          f"{VNX})")
    require(np.all(np.isfinite(vl0)) and vl0[-1] < vl0[0],
            "villin: finite losses falling in run()")
    # the reference's acceptance of run_girsanov (finite losses) and the
    # whole path's: the data grew by kde in each generation that added
    # points, the bias is gone, and the last loss is below run()'s first.
    # Over 50 iterations at lr 1e-5 on data that has just grown, a
    # generation's own last loss falls below its first at some seeds only
    # (PERF.md §6: 1 of 3 seeds from randx0, 0 of 3 from the bootstrap)
    require(np.all(np.isfinite(vgl)), "villin: finite losses in each "
                                      "generation")
    require(len(viso.data) == n_before + int(vgrowth.sum())
            and all(g == VNX for g, r in zip(vgrowth, vrows)
                    if r["n_new"] > 0),
            "villin: the data grew by kde in each generation that added "
            "points")
    require(vsim.bias is None, "villin: no bias after run_girsanov")
    require(vgl[-1, -1] < vl0[0], "villin: the last generation's last loss "
                                  "below run()'s first")
    require(vchi.shape == (len(viso.data), 1)
            and bool(torch.isfinite(vchi).all())
            and bool(torch.isfinite(vkchi).all()), "villin: chis finite")
    require(np.all(np.diag(vQ) < 0), "villin: rates() negative diagonal")
    phase("villin_path", t0, f"Iso {tv_data:.3f}s run {tv_train:.3f}s "
                             f"run_girsanov {tv_gir:.3f}s")

    # ---- 16. sqpairdist against plain ------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(61)
    nv = vsim.natoms
    xv = (vsim.coords.reshape(1, nv, 3) + torch.as_tensor(
        rng.normal(scale=0.01, size=(64, nv, 3)), dtype=torch.float32,
        device=dev)).contiguous()
    c_err = cb_err = 0.0
    for b in (1, 37, 64):
        xb = xv[:b].contiguous()
        p_k = PK.sqpairdist_fwd(xb)
        p_p = PK.sqpairdist_fwd_plain(xb)
        ndiff = int((p_k != p_p).sum())
        ae = float((p_k - p_p).abs().max())
        c_err = max(c_err, ae)
        print(f"  sqpairdist_fwd B={b}: {ndiff} of {p_k.numel()} values "
              f"differ from plain (max abs {ae:.3e}; tol 1e-6 relative)")
        require(float((p_k - p_p).abs().max() / p_p.abs().max()) <= 1e-6,
                f"sqpairdist_fwd vs plain at B={b}")
    # C' at villin's 588 atoms (16-byte copies of dp rows) and at its first
    # 587 (4-byte copies), with the upper-triangular dp of the i < j
    # gather's backward and a dense one: against plain, against its tiled
    # mirror bit for bit, row 0 of each batch equal to the walker alone
    dpd = torch.as_tensor(rng.normal(size=(64, nv, nv)), dtype=torch.float32,
                          device=dev)
    for n in (nv, nv - 1):
        for form in ("upper", "dense"):
            dpn = dpd[:, :n, :n]
            dpn = (torch.triu(dpn, diagonal=1) if form == "upper"
                   else dpn).contiguous()
            alone = None
            for b in (1, 37, 64):
                xb = xv[:b, :n].contiguous()
                g_k = PK.sqpairdist_bwd(xb, dpn[:b])
                g_p = PK.sqpairdist_bwd_plain(xb, dpn[:b])
                grel = float((g_k - g_p).abs().max() / g_p.abs().max())
                cb_err = max(cb_err, float((g_k - g_p).abs().max()))
                alone = g_k[0] if alone is None else alone
                same = "" if b == 1 else (
                    f", row 0 = B=1 bit for bit: "
                    f"{torch.equal(g_k[0], alone)}")
                print(f"  sqpairdist_bwd N={n} {form} dp B={b}: max rel err "
                      f"{grel:.3e} (tol 1e-6){same}")
                require(grel <= 1e-6,
                        f"sqpairdist_bwd vs plain, N={n}, {form}, B={b}")
                require(torch.equal(g_k[0], alone),
                        f"sqpairdist_bwd row 0 at B={b} = B=1, N={n}, {form}")
            tiled = torch.equal(g_k[:37], PK.sqpairdist_bwd_tiled(
                xb[:37], dpn[:37]))
            print(f"  sqpairdist_bwd N={n} {form} dp B=37: the tiled mirror's "
                  f"bits: {tiled}")
            require(tiled, f"sqpairdist_bwd = its tiled mirror, N={n}, {form}")
    # the same bits on a repeat and at other launch shapes
    g_k = PK.sqpairdist_bwd(xv, dpd)
    shape0 = PK.launch_shape
    shapes = ((1, 1), (7, 4), (48, 2), (3, 8))
    try:
        for shape in shapes:
            PK.launch_shape = lambda n, b, s=shape: s
            require(torch.equal(PK.sqpairdist_bwd(xv, dpd), g_k),
                    f"sqpairdist_bwd: the same bits at {shape}")
    finally:
        PK.launch_shape = shape0
    print(f"  sqpairdist_bwd B=64 dense dp: the same bits at "
          f"{PK.launch_shape(nv, 64)} (the wrapper's) and at {shapes} "
          f"(blocks a walker, warps a block)")
    require(torch.equal(PK.sqpairdist_fwd(xv), PK.sqpairdist_fwd(xv))
            and torch.equal(PK.sqpairdist_bwd(xv, dpd), g_k),
            "sqpairdist: the same input gives the same bits")

    iu, ju = (torch.as_tensor(a, device=dev) for a in np.triu_indices(nv, 1))

    def plain_features(z):
        """``FeaturesAll`` through the plain versions of both kernels."""
        b = z.reshape(-1, nv, 3)
        p = PK.sqpairdist_fused_plain(b)[:, iu, ju]
        return torch.sqrt(torch.clamp(p, min=0.0)).reshape(
            z.shape[:-1] + (len(iu),))

    grads = []
    for feat in (vsim.featurizer, plain_features):
        z = xv[:32].reshape(32, -1).clone().requires_grad_(True)
        torch.sin(feat(z)).sum().backward()
        grads.append(z.grad)
    frel = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())
    # the optcontrol bias of the trained villin chi model on both routes,
    # its Koopman fit held at lambda = 0.8 (Kchi = 0.1 + 0.8 chi), so that
    # the comparison does not depend on whether this chi contracts
    chi_s = torch.linspace(0.0, 1.0, 12, device=dev)[:, None]
    stub = SimpleNamespace(
        data=SimpleNamespace(sim=vsim, featurizer=vsim.featurizer),
        model=viso.model, chis=lambda: chi_s,
        koopman=lambda: 0.1 + 0.8 * chi_s)
    bias_k = itt.optcontrol(stub, forcescale=0.5)
    stub.data.featurizer = plain_features
    bias_p = itt.optcontrol(stub, forcescale=0.5)
    sig = I.constants(vsim.masses3, vsim.temp, vsim.friction, False)
    xv32 = viso.data.propcoords.values.reshape(-1, vsim.dim)[:32]
    fb_k = bias_k(xv32, t=0.1, sigma=sig, F=None)
    fb_p = bias_p(xv32, t=0.1, sigma=sig, F=None)
    brel = float((fb_k - fb_p).abs().max() / fb_p.abs().max())
    del bias_k, bias_p
    print(f"  gradient of sum(sin(FeaturesAll)) B=32, kernel vs plain "
          f"route: max rel err {frel:.3e} (tol 1e-6); optcontrol bias force "
          f"of the trained chi model (lambda 0.8) B=32: max rel err "
          f"{brel:.3e} (tol 1e-6), max "
          f"|force| {float(fb_p.abs().max()):.4g}")
    require(frel <= 1e-6, "feature gradient, kernel vs plain route")
    require(brel <= 1e-6 and float(fb_p.abs().max()) > 0,
            "optcontrol bias force, kernel vs plain route")
    phase("sqpairdist_vs_plain", t0, "forward and backward at B=1/37/64, "
                                     "N=588/587, tiled mirror, same bits, "
                                     "feature gradient, bias")

    # ---- 17. sqpairdist timing -------------------------------------------------
    # Each launch between its own events, behind a device-side wait (warm:
    # the inputs of the previous launch, in the 50 MB L2 at B <= 32, as on
    # the path, where the gather's backward has just written dp) or behind a
    # 128 MB write (cold).
    t0 = time.perf_counter()
    flush = torch.zeros(32 * 2**20, device=dev)
    c_ms, cb_ms, c_cold, cb_cold = {}, {}, {}, {}
    c_plain, cb_plain, c_lib = {}, {}, {}

    def event_ms(fn, reps, cold):
        fn()
        pairs = []
        for _ in range(reps):
            if cold:
                flush.add_(1.0)
            else:
                torch.cuda._sleep(200_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(e) for a, e in pairs) / reps

    for b in (1, 32, 1024):
        xb = xv.repeat(-(-b // 64), 1, 1)[:b].contiguous()
        dp = torch.triu(torch.ones(b, nv, nv, device=dev), diagonal=1)
        reps = 20 if b < 1024 else 5
        fwd = lambda: PK.sqpairdist_fwd(xb)            # noqa: E731
        bwd = lambda: PK.sqpairdist_bwd(xb, dp)        # noqa: E731
        c_ms[b], c_cold[b] = event_ms(fwd, reps, False), event_ms(fwd, reps,
                                                                  True)
        cb_ms[b], cb_cold[b] = event_ms(bwd, reps, False), event_ms(bwd, reps,
                                                                    True)
        c_plain[b] = cuda_ms(lambda: PK.sqpairdist_fwd_plain(xb), reps=3)
        cb_plain[b] = cuda_ms(lambda: PK.sqpairdist_bwd_plain(xb, dp), reps=3)
        # one timed call at B=1024 (~0.43 s each, cut for the time limit)
        c_lib[b] = cuda_ms(lambda: torch.cdist(
            xb, xb, compute_mode="donot_use_mm_for_euclid_dist"),
            reps=reps if b < 1024 else 1)
        del dp
        for name, warm, cold, plain in (
                ("fwd", c_ms[b], c_cold[b], c_plain[b]),
                ("bwd", cb_ms[b], cb_cold[b], cb_plain[b])):
            bb, by = PK.bound_ms(name, b, nv)
            lib = (f", torch.cdist {c_lib[b]:.4f} ms" if name == "fwd"
                   else ", no library call")
            print(f"  sqpairdist_{name} B={b} N={nv}: warm {warm:.4f} ms, "
                  f"cold {cold:.4f} ms, bound {bb:.4f} ms ({by}, "
                  f"{bb / warm:.2%} / {bb / cold:.2%} of it), plain "
                  f"{plain:.4f} ms{lib} {stamp}")
    kb = PK.kernel_bytes("bwd", 32, nv) / PK.step_bytes("bwd", 32, nv)
    shapes = [PK.launch_shape(nv, b) for b in (1, 32, 1024)]
    print(f"  sqpairdist_bwd N={nv}: kernel_bytes / step_bytes {kb:.4f} "
          f"(dp read once; its partial sums written and read once); launch "
          f"shape at B=1/32/1024 {shapes} (blocks a walker, warps a block)")
    del flush
    # ms a biased hybrid step at B = 32, and the share of C + C' in it
    stub.data.featurizer = vsim.featurizer
    bias_t = itt.optcontrol(stub, forcescale=0.5)
    x32 = viso.data.propcoords.values.reshape(-1, vsim.dim)[:32].contiguous()
    p32 = vsim.random_velocities(itt.make_generator(62), x32.shape) \
        * vsim.masses3
    NSB = 20
    g62 = noise_generator(itt.make_generator(63), dev)
    I.aboba_girsanov(vsim.force, bias_t, x32, p32, vsim.masses3, vsim.temp,
                     vsim.friction, vsim.step, 2, g62)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    I.aboba_girsanov(vsim.force, bias_t, x32, p32, vsim.masses3, vsim.temp,
                     vsim.friction, vsim.step, NSB, g62)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t1) / NSB

    def host_ms(fn, reps=NSB):
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t1) / reps

    force_ms = host_ms(lambda: vsim.force(x32))
    bias_ms = host_ms(lambda: bias_t(x32, t=0.1, sigma=sig, F=None))
    del bias_t
    share = (c_ms[32] + cb_ms[32]) / step_ms
    print(f"  biased hybrid step B=32: {step_ms:.3f} ms a step over {NSB} "
          f"steps; of it the force (kernel D + bonded autograd) "
          f"{force_ms:.3f} ms, the bias (sqpairdist fwd, the 535 M-parameter "
          f"chi forward and backward, sqpairdist bwd) {bias_ms:.3f} ms, "
          f"sqpairdist fwd + bwd {c_ms[32] + cb_ms[32]:.4f} ms = "
          f"{share:.2%} of the step {stamp}")
    phase("sqpairdist_timing", t0)

    # ---- 17b. constraints: generic bond constraints on the plain and
    # hybrid routes (kernel D once a constrained villin step)
    t0 = time.perf_counter()
    cph = constraints_phase(vpdb, stamp)
    phase("constraints", t0, f"alanine {cph['t_ala']:.3f}s villin "
                             f"{cph['t_villin']:.3f}s")

    # ---- 17c. solvated_dense: solvated alanine on the dense route -------
    t0 = time.perf_counter()
    dph = solvated_dense_phase(stamp)
    phase("solvated_dense", t0, f"MDSimulation {dph['t_build']:.3f}s Iso "
                                f"{dph['t_data']:.3f}s")

    # ---- 17d. pme: Ewald / PME on the dense and neighbor routes ---------
    t0 = time.perf_counter()
    pph = pme_phase(spdb, eq[0, 0], sxs, NKS, stamp)
    nb_err = max(nb_err, pph["sweep_err"])
    phase("pme", t0, f"PME box 2 lags {pph['t_prop']:.3f}s PME peptide "
                     f"{pph['t_pep']:.3f}s")

    # ---- 17e. tip4p: TIP4P-Ew water, virtual sites around kernel E -------
    t0 = time.perf_counter()
    t4 = tip4p_phase(spdb, stamp)
    nb_err = max(nb_err, t4["err"])
    phase("tip4p", t0, f"MDSimulation {t4['t_build']:.3f}s propagate "
                       f"{t4['t_prop']:.3f}s")

    # ---- 17f. npt: the barostat, kernel E at the box of each block -------
    t0 = time.perf_counter()
    npt = npt_phase(spdb, eq[0, 0], stamp)
    nb_err = max(nb_err, npt["err"])
    phase("npt", t0, f"npt_langevin {npt['t_npt']:.3f}s")

    # ---- 17g. ljpme: the dispersion branch of kernel E -------------------
    t0 = time.perf_counter()
    lj = ljpme_phase(spdb, eq[0, 0], stamp)
    nb_err = max(nb_err, lj["err"])
    phase("ljpme", t0, f"LJPME peptide propagate {lj['t_prop']:.3f}s")

    # ---- 17h. cmap_verlet: CMAP forces and the Verlet-list route ---------
    t0 = time.perf_counter()
    cv = cmap_verlet_phase(spdb, eq[0, 0], stamp)
    phase("cmap_verlet", t0, f"Verlet propagate {cv['t_prop']:.3f}s")
    e_new = t4["e_launches"] + npt["e_launches"] + lj["e_launches"]

    # ---- 18. golden_md: the alanine acceptance bar ----------------------------
    # tests/test_golden_md.py through the port on the card: chi trained on
    # the committed (xs, ys) against the committed MSM eigenfunction, and
    # fresh dynamics (384 committed starts x 4 bursts of 500 steps, one
    # launch of kernel A) re-estimating it.
    t0 = time.perf_counter()
    for k in (PK.sqpairdist_fwd, PK.sqpairdist_bwd, GB.gb_force,
              LK.langevin_middle, LK.forces, GK.aboba_girsanov,
              NBK.neighbor_sweep, NBK.neighbor_layout):
        k.launches = 0
    gmd = G.load_golden_md()
    t1 = time.perf_counter()
    md_corr, md_frac = G.md_chi_run("cuda", gmd)
    torch.cuda.synchronize()
    tg_chi = time.perf_counter() - t1
    print(f"  golden_md chi: run(800) on the committed 1536 x 8 bursts, "
          f"{tg_chi:.3f}s; corr {md_corr:.4f} (>= 0.98), frac {md_frac:.3f} "
          f"(> 0.95) {stamp}")
    t1 = time.perf_counter()
    fresh = G.md_fresh_run("cuda", gmd)
    torch.cuda.synchronize()
    tg_fresh = time.perf_counter() - t1
    a_golden = LK.langevin_middle.launches
    print(f"  golden_md fresh dynamics: 384 x 4 walkers (padded to 2048) x "
          f"500 steps + MSM, {tg_fresh:.3f}s; corr {fresh['corr']:.4f} "
          f"(>= 0.97) on {fresh['frac']:.3f} finite (> 0.9), t_fresh "
          f"{fresh['t_fresh']:.4g} ps > t_gold/15 = "
          f"{fresh['t_gold'] / 15:.4g} ps; langevin_middle launches "
          f"{a_golden} {stamp}")
    require(md_frac > 0.95 and md_corr >= 0.98,
            "golden_md: trained chi reproduces the MSM eigenfunction")
    require(fresh["frac"] > 0.9 and fresh["corr"] >= 0.97
            and fresh["t_fresh"] > fresh["t_gold"] / 15.0,
            "golden_md: fresh dynamics reproduce the eigenfunction")
    require(a_golden == 1, "golden_md: one launch of kernel A")
    require(PK.sqpairdist_fwd.launches == 0 and GB.gb_force.launches == 0
            and GK.aboba_girsanov.launches == 0 and LK.forces.launches == 0
            and NBK.neighbor_sweep.launches == 0,
            "golden_md runs no other kernel")
    phase("golden_md", t0, f"chi {tg_chi:.3f}s fresh {tg_fresh:.3f}s")

    # ---- 18b. golden_solvated: the explicit-solvent acceptance bar ---------
    # tests/test_golden_md.py's solvated anchor through the port on the
    # card: chi trained on the committed float16 features of alanine in
    # water (768 x 4 bursts, 231 distances) as ExternalSimulation data,
    # pairnet(231), AdamRegularized, minibatch 256, run(600).  No kernel.
    t0 = time.perf_counter()
    k_before = {k: k.launches for k in (
        PK.sqpairdist_fwd, PK.sqpairdist_bwd, GB.gb_force,
        LK.langevin_middle, LK.forces, GK.aboba_girsanov,
        NBK.neighbor_sweep, NBK.neighbor_layout)}
    t1 = time.perf_counter()
    sv_corr, sv_frac = G.solvated_chi_run("cuda")
    torch.cuda.synchronize()
    tg_solv = time.perf_counter() - t1
    print(f"  golden_solvated chi: run(600) on the committed 768 x 4 "
          f"solvated features, {tg_solv:.3f}s; corr {sv_corr:.4f} (>= 0.95),"
          f" frac {sv_frac:.3f} (> 0.9) {stamp}")
    require(sv_frac > 0.9 and sv_corr >= 0.95,
            "golden_solvated: chi reproduces the solvated eigenfunction")
    require(all(k.launches == n for k, n in k_before.items()),
            "golden_solvated runs no kernel")
    phase("golden_solvated", t0, f"chi {tg_solv:.3f}s")

    # ---- 19. golden_toy: exact-eigenfunction goldens ------------------------
    # tests/test_golden.py through the port on the card, at its sizes and
    # iteration counts (no kernel: the toy diffusions are tensor ops).
    t0 = time.perf_counter()
    t1 = time.perf_counter()
    dw_iso, dw = G.doublewell_run("cuda")
    torch.cuda.synchronize()
    tt_dw = time.perf_counter() - t1
    print(f"  Doublewell nx=256 nk=64 run(2000): {tt_dw:.3f}s; corr "
          f"{dw['corr']:.5f} (> 0.99); rate {dw['rate']:.4f} vs exact "
          f"{dw['exact_rate']:.4f} (15%); chi_exit_rate "
          f"{dw['exit_rate']:.4g} {stamp}")
    require(abs(dw["vals"][0] - 1.0) < 1e-6 and 0.0 < dw["vals"][1] < 1.0,
            "Doublewell golden spectrum")
    require(dw["corr"] > 0.99, "Doublewell chi matches the eigenfunction")
    require(abs(dw["rate"] - dw["exact_rate"]) <= 0.15 * dw["exact_rate"],
            "Doublewell rate matches the exact eigenvalue")
    require(np.isfinite(dw["exit_rate"]) and dw["exit_rate"] > 0,
            "Doublewell chi_exit_rate finite and positive")
    t1 = time.perf_counter()
    tw = G.triplewell_run("cuda")
    torch.cuda.synchronize()
    tt_tw = time.perf_counter() - t1
    print(f"  Triplewell ISA nx=1024 nk=64 nout=3 run(1500): {tt_tw:.3f}s; "
          f"R(psi_2) {tw['R2']:.4f}, R(psi_3) {tw['R3']:.4f} (>= 0.95); row "
          f"sums {tw['rowsum_mean']:.4f} +- {tw['rowsum_std']:.4f}; wells on "
          f"columns {tw['wells']} {stamp}")
    require(tw["R2"] >= 0.95 and tw["R3"] >= 0.95,
            "Triplewell chi contains psi_2 and psi_3")
    require(abs(tw["rowsum_mean"] - 1.0) <= 0.05 and tw["rowsum_std"] < 0.1,
            "Triplewell chi rows sum to 1")
    require(sorted(tw["wells"]) == [0, 1, 2],
            "Triplewell wells on distinct columns")
    t1 = time.perf_counter()
    mb = G.mueller_brown_run("cuda")
    torch.cuda.synchronize()
    tt_mb = time.perf_counter() - t1
    print(f"  Mueller-Brown nx=512 nk=32 run(3000): {tt_mb:.3f}s; corr "
          f"{mb:.5f} (> 0.98) {stamp}")
    require(mb > 0.98, "Mueller-Brown chi matches the eigenfunction")
    t_ag = time.perf_counter()
    tg_an = analysis_goldens_phase(dw_iso, tw["iso"], stamp)
    phase("analysis_goldens", t_ag, " ".join(f"{k} {v:.3f}s" for k, v in
                                             tg_an.items()))
    t1 = time.perf_counter()
    snap = os.path.join(ROOT, "build", "chip_smoke", "doublewell.pt")
    dw_iso.save(snap)
    dw2 = itt.load(snap)
    same = torch.equal(dw2.chis(), dw_iso.chis())
    dw2.run(5)
    require(same and dw2.model.layers[0].weight.is_cuda,
            "save/load: the same chis on the card, bit for bit")
    require(len(dw2.losses) == len(dw_iso.losses) + 5
            and np.all(np.isfinite(dw2.losses)), "save/load: run(5) goes on")
    itt.run_girsanov(dw_iso, generations=2, iter=10, kde=4, forcescale=0.5)
    torch.cuda.synchronize()
    tt_sg = time.perf_counter() - t1
    grows = dw_iso.girsanov_telemetry
    gw = dw_iso.data.propfeatures.weights[-8:].double().cpu().numpy().ravel()
    gse = gw.std() / np.sqrt(len(gw))
    print(f"  save/load + run(5) + run_girsanov(2, iter=10, kde=4, "
          f"forcescale=0.5): {tt_sg:.3f}s; biased {[r['biased'] for r in grows]}"
          f", ess {[round(r['ess'] or 0, 2) for r in grows]}; new weights "
          f"mean {gw.mean():.4f} +- {gse:.4f} {stamp}")
    require(all(r["biased"] for r in grows), "Doublewell Girsanov biased")
    require(np.all(np.isfinite(gw)) and abs(gw.mean() - 1.0) < 4 * gse,
            "Doublewell Girsanov weights finite, E[w] = 1")
    phase("golden_toy", t0, f"doublewell {tt_dw:.3f}s triplewell "
                            f"{tt_tw:.3f}s mueller_brown {tt_mb:.3f}s "
                            f"save/load + girsanov {tt_sg:.3f}s")

    kernels = [{
        "name": "langevin_middle", "route": "cuda",
        "source": "isokann_tpu_torch/csrc/langevin_middle.cu",
        "replaces": "isokann_tpu/md/pallas_md.py:318",
        "launches": (launches + a_lag + a_adapt + a_ens + eph["lm_launches"]
                     + a_golden),
        "max_abs_err": lm_err,
        "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "langevin_forces", "route": "cuda",
        "source": "isokann_tpu_torch/csrc/langevin_middle.cu",
        "replaces": "isokann_tpu/md/pallas_md.py:318",
        "launches": f_launches + aph["f_launches"] + eph["f_launches"],
        "max_abs_err": fae, "ms": fms[32],
        "plain_ms": fplain_ms, "bound_ms": fbms, "bound_by": fby,
        "library_ms": None,
    }, {
        "name": "aboba_girsanov", "route": "cuda",
        "source": "isokann_tpu_torch/csrc/aboba_girsanov.cu",
        "replaces": "isokann_tpu/md/pallas_md.py:558",
        "launches": g_launches, "max_abs_err": gerr, "ms": gtimes[256],
        "plain_ms": g_plain_ms, "bound_ms": g_bms, "bound_by": g_by,
        "library_ms": None,
    }, {
        "name": "gb_force", "route": "cuda",
        "source": "isokann_tpu_torch/csrc/gb_force.cu",
        "replaces": "isokann_tpu/md/pallas_gb.py:501",
        "launches": d_launches + d_prod + dv_launches + cph["d_launches"],
        "max_abs_err": gb_err, "ms": d_ms[1024],
        "plain_ms": d_plain[1024], "bound_ms": d_bms, "bound_by": d_by,
        "library_ms": None,
    }, {
        "name": "neighbor_sweep", "route": "cuda",
        "source": "isokann_tpu_torch/csrc/neighbor_sweep.cu",
        "replaces": "isokann_tpu/md/neighbor.py:926",
        "launches": e_launches + eb_launches + pph["e_launches"] + e_new,
        "max_abs_err": nb_err,
        "ms": e_ms[64],
        "sweep_ms": e_alone[64], "plain_ms": e_plain[64], "bound_ms": e_bms,
        "bound_by": e_by, "library_ms": None,
        "ljpme_ms": lj["ms"], "ljpme_plain_ms": lj["plain_ms"],
        "ljpme_bound_ms": lj["bound_ms"], "npt_ms": npt["ms"],
    }, {
        "name": "neighbor_layout", "route": "cuda",
        "source": "isokann_tpu_torch/csrc/neighbor_sweep.cu",
        "replaces": "isokann_tpu/md/neighbor.py:926",
        "launches": l_launches + eb_launches + pph["e_launches"] + e_new,
        "max_abs_err": lay_err,
        "ms": e_prep[64],
        "plain_ms": l_plain[64],
        "bound_ms": l_bound[64], "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "sqpairdist_fwd", "route": "cuda",
        "source": "isokann_tpu_torch/csrc/sqpairdist.cu",
        "replaces": "isokann_tpu/ops/pairdists.py:168",
        "launches": c_launches, "max_abs_err": c_err, "ms": c_ms[32],
        "cold_ms": c_cold[32],
        "plain_ms": c_plain[32], "bound_ms": PK.bound_ms("fwd", 32, nv)[0],
        "bound_by": PK.bound_ms("fwd", 32, nv)[1], "library_ms": c_lib[32],
    }, {
        "name": "sqpairdist_bwd", "route": "cuda",
        "source": "isokann_tpu_torch/csrc/sqpairdist.cu",
        "replaces": "isokann_tpu/ops/pairdists.py:195",
        "launches": cb_launches, "max_abs_err": cb_err, "ms": cb_ms[32],
        "cold_ms": cb_cold[32],
        "plain_ms": cb_plain[32], "bound_ms": PK.bound_ms("bwd", 32, nv)[0],
        "bound_by": PK.bound_ms("bwd", 32, nv)[1], "library_ms": None,
    }]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the start "
          f"of main, of the watchdog's {LIMIT_S} s {stamp}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
