#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``isokann_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``isokann_tpu_torch/csrc`` with
nvcc (one process per source, in parallel) and holds each against its
plain PyTorch version on the card.  Then it drives five paths through the
port's entry points, and the goldens after them:

- the alanine-dipeptide ISOKANN quickstart (``bench.py``'s pipeline:
  randx0(100), propagate(nk=5) of 512 padded walkers x 100 LangevinMiddle
  steps, all-pairs features, 100 Koopman iterations of the pairnet chi
  model with AdamRegularized, then chis/koopman/rates): the LangevinMiddle
  kernel;
- Girsanov-weighted optimal-control sampling on the chi that path
  trained: ``optcontrol`` + a biased ``propagate`` of 100 x 5 walkers, then
  ``run_girsanov(generations=3, iter=100, kde=50, forcescale=0.5)``: the
  Girsanov kernel, 256 padded walkers x 100 ABOBA steps per generation.

- the reference's trp-cage production loop (``tools/run_trpcage_
  production.py``): ``peptide_pdb`` builds TC5B (313 atoms) from sequence
  and minimizes it in OBC2 implicit solvent, ``MDSimulation(steps=100,
  implicit="obc2")``, ``Iso(nx=5, nk=8)`` (nx cut from the reference's
  100) over 100 random-pair features, 2 generations of ``run(300)`` +
  ``resample_strat(3)`` + the 2000-point cutoff, then chis/koopman/rates:
  the nonbonded + GBSA force kernel at every MD step (randx0's 500
  single-walker steps, 64 padded walkers x 100 steps in propagate, 32 x
  100 per generation).

- the reference's explicit-solvent configuration
  (``examples/solvated_peptide.py``, full variant): ``peptide_pdb``
  builds AQGSAELAKVM and minimizes it (300 FIRE steps),
  ``MDSimulation(addwater=True, padding=1.0, steps=100)`` puts it in a
  TIP3P box (7,744 atoms, 2,526 rigid waters, reaction field under
  minimum image), 4 walkers equilibrate for 200 steps, then randx0(4)
  (400 single-walker steps from the equilibrated frame), propagate of
  16 walkers x 100 steps, ``Iso.run(200)`` on the 100 solute-pair
  features, chis/koopman/rates: the cell-list pair-sweep kernel at every
  constrained MD step.

- villin HP35 with all-pairs features on the hybrid route
  (``tools/run_villin_scale.py``'s system, ``examples/villin.py``'s
  minimization): ``peptide_pdb`` builds it from sequence and minimizes it
  in OBC2 (800 FIRE steps), ``MDSimulation(steps=100, implicit="obc2",
  features=FeaturesAll())`` = 588 atoms and 172,578 pair features,
  ``Iso(nx=8, nk=4)`` with the default chi model (535 M parameters),
  ``run(100)``, ``optcontrol`` + a biased ``propagate`` of 8 x 4 walkers,
  ``run_girsanov(generations=2, iter=50, kde=8, forcescale=0.5)``,
  chis/koopman/rates: the force kernel at every MD step, and inside the
  bias at every biased step the pair-distance kernels (forward and
  gradient), which also featurize every new batch.

- the alanine goldens (``tests/test_golden_md.py``): chi trained on the
  committed MSM data (1,536 x 8 bursts, 800 iterations) must correlate
  >= 0.98 with the committed eigenfunction, and fresh dynamics (384
  committed starts x 4 walkers x 500 steps, one launch of the
  LangevinMiddle kernel) >= 0.97;
- the toy goldens (``tests/test_golden.py``) at their sizes: Doublewell
  (> 0.99 against the exact eigenfunction, and its eigenvalue),
  Triplewell with a 3-D ISA chi (both slow eigenfunctions in its span,
  R >= 0.95), Mueller-Brown (> 0.98), then a save/load round trip of the
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

import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

LIMIT_S = 180          # watchdog: the whole run, kernel build included
TB, TSTEPS = 4, 20     # solvated temperature witness: walkers, steps
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
    from isokann_tpu_torch.md.fixtures import peptide_pdb
    from isokann_tpu_torch.md import forces as F
    from isokann_tpu_torch.md.pdbio import read_pdb
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
    # and minimized (FIRE over autograd: no hand-written kernel); their
    # seconds are reported in those phases.
    t0 = time.perf_counter()
    pdb = os.path.join(ROOT, "build", "chip_smoke", "trpcage.pdb")
    spdb = os.path.join(ROOT, "build", "chip_smoke", "solvated_peptide.pdb")
    vpdb = os.path.join(ROOT, "build", "chip_smoke", "villin.pdb")
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
    # the main path launches the kernel at B=1 (randx0) and B=512
    # (propagate); B=37 also covers a partly filled last block
    ferr = lm_err = 0.0
    for b in (B, 37, 1):
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
    t1 = time.perf_counter()
    data = itt.SimulationData.from_sim(sim, nx=NX, nk=NK, gen=gen)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t1
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
    print(f"  datagen {t_data:.3f}s, train{EPISODES} {t_train:.3f}s, "
          f"loss {iso.losses[0]:.4f} -> {iso.losses[-1]:.4f}, "
          f"kernel launches {launches}, rates diag {np.diag(Q).tolist()} "
          f"{stamp}")
    require(launches > 0, "main path launched the LangevinMiddle kernel")
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
    b1ms, _ = LK.bound_ms(plan, 1, 100)
    kops_a, sops_a = LK.kernel_ops(plan), LK.step_ops(plan)
    print(f"  langevin_middle operations a walker-step: {sops_a:.0f} the "
          f"function needs (the bound's), {kops_a:.0f} the kernel executes "
          f"({kops_a / sops_a:.2f}x, each pair from both sides); blocks "
          f"{LK.blocks(1)} at B=1 and {LK.blocks(B)} at B={B} (a warp per "
          f"walker, {LK.WARPS_PER_BLOCK} a block); bound at B=1 x100 steps "
          f"{b1ms:.5f} ms ({b1ms / ms1:.2%} of it)")
    fms = cuda_ms(lambda: LK.forces(plan, x), reps=5)
    print(f"  forces entry (parity only, not on the main path) B={B}: "
          f"{fms:.4f} ms, max rel err {ferr:.3e} {stamp}")
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
            spec_m = itt.optcontrol(iso, forcescale=fs_m).optcontrol_spec
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

    # ---- 9. trp-cage path ----------------------------------------------------
    # tools/run_trpcage_production.py at its production widths: TC5B built
    # from sequence and minimized in OBC2 (1500 FIRE steps), a 100-step lag,
    # nk=8, 300 iterations and 3 stratified resamples a generation, cutoff
    # 2000; the number of generations is cut to 2 and nx from 100 to 5
    # (randx0's single-walker steps were a third of the run's time; 10
    # until the goldens joined the script).
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
    for b in (1, 37):
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

    reps = -(-256 // len(tiso.data))
    xg = tiso.data.coords.repeat(reps, 1)[:256].contiguous()  # 256 walkers
    vg = tsim.random_velocities(itt.make_generator(41), xg.shape)
    xh, vh = tsim._integrate(xg, vg, 10, None)
    xp, vp = I.langevin_middle(plain_force, xg, vg, tsim.masses3, tsim.temp,
                               tsim.friction, tsim.step, 10)
    xrel = float((xh - xp).abs().max() / xp.abs().max())
    vrel = float((vh - vp).abs().max() / vp.abs().max())
    print(f"  noiseless x10 steps B=256, hybrid vs plain force_flat: rel x "
          f"{xrel:.3e} (tol 1e-5), rel v {vrel:.3e} (tol 1e-4)")
    require(xrel < 1e-5 and vrel < 1e-4, "noiseless hybrid vs plain path")

    # kinetic temperature over the last 200 of 400 steps, B=256, the same
    # start and the same noise stream for both paths (1000 steps until the
    # goldens joined the script: cut for its time limit)
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
    temp_h = kinetic_temperature(lambda x, v: tsim._integrate(x, v, 100, gh))
    t_th = time.perf_counter() - t1
    t1 = time.perf_counter()
    temp_p = kinetic_temperature(lambda x, v: I.langevin_middle(
        plain_force, x, v, tsim.masses3, tsim.temp, tsim.friction,
        tsim.step, 100, tsim._noise(gp, dev)))
    t_tp = time.perf_counter() - t1
    print(f"  kinetic temperature B=256, steps 200-400: hybrid {temp_h:.2f} "
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
    temp_n = kinetic_temperature(lambda x, v: nsim._integrate(x, v, 100, gn))
    ga = itt.make_generator(45)
    _, va = I.langevin_middle(sim.force, xT, vT, m3, sim.temp, sim.friction,
                              sim.step, NT, sim._noise(ga, dev))
    temp_a = float((m3 * va * va).sum(dim=1).mean() / (sim.dim * KB))
    print(f"  kinetic temperature at 2 fs: trp-cage vacuum NoCutoff "
          f"{temp_n:.2f} K (B=256, 0.4-0.8 ps); alanine plain recursion "
          f"{temp_a:.2f} K (B={BT} after {NT} steps; kernel A {temp:.2f} K)")
    require(abs(temp_a - temp) / temp < 0.01,
            "alanine: plain recursion and kernel A at the same temperature")
    phase("gb_vs_plain", t0, "OBC2, vacuum RF and periodic RF at B=1/37/256, "
                             "villin at B=1/37, same bits, row 0 at "
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
    # 100-step lag, nk = 4, 200 iterations; nx is cut from 50 to 4 (16
    # until the villin path joined the script, 8 until the goldens did).
    t0 = time.perf_counter()
    NXS, NKS, ITS, EQS, EQW = 4, 4, 200, 200, 4
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
    sxs = ssim.randx0(NXS, gen=sgen)
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
    want = (EQS * (1 + r1 - r0) + NXS * 100 + 100 * (1 + r2 - r1))
    viol = max(cset.max_violation(sxs), cset.max_violation(sy))
    ms_x0 = 1e3 * ts_x0 / (NXS * 100)
    print(f"  solvated path: peptide_pdb (build + 300 FIRE steps) "
          f"{ts_pep:.3f}s, MDSimulation (solvate + system + plan) "
          f"{ts_build:.3f}s, equilibration {EQW}x{EQS} steps {ts_eq:.3f}s, "
          f"randx0({NXS}) {ts_x0:.3f}s ({ms_x0:.3f} ms/step, {n_sx0} "
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
    phase("solvated_path", t0, f"randx0 {ts_x0:.3f}s propagate "
                               f"{ts_prop:.3f}s")

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
        noise = ssim._noise(gen, dev)
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
    # times over at B = 256), its first frame at B = 1
    nq = xq.shape[0]
    in_range, visited, culls = NBK.pair_counts(ssim.system, splan, xq)
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
    # cuts: nx 8, nk 4, 100 + 2 x 50 iterations, kde 8, 2 generations.
    # Adam at lr 1e-5: at the default 1e-3 (and at 1e-4) the first steps
    # move each first-layer pre-activation by about lr x the sum of the
    # 172,578 LayerNorm'd features (~140 at 1e-3), every sigmoid saturates
    # alike, chi is constant over the data and the shift-scale target
    # divides 0 by 0: training raises DomainError, in the JAX package too.
    t0 = time.perf_counter()
    VNX, VNK, VIT, VGENS, VGIT, VLR = 8, 4, 100, 2, 50, 1e-5
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
    want_d = (VNX * 100 + 100 * (1 + vsim.retries - r0) + biased_steps
              + 100 * (grown - biased_gens))
    for row in vrows:
        print(f"  run_girsanov {row}")
    print(f"  villin path: peptide_pdb (build + 800 FIRE steps) "
          f"{tv_pep:.3f}s, MDSimulation {tv_sys:.3f}s, Iso(nx={VNX}, "
          f"nk={VNK}) {tv_data:.3f}s (randx0 {VNX * 100} steps + propagate "
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
    require(np.all(np.isfinite(vl0)) and vl0[-1] < vl0[0]
            and np.all(np.isfinite(vgl)) and np.all(vgl[:, -1] < vgl[:, 0]),
            "villin: finite losses falling in run() and in each generation")
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
        c_lib[b] = cuda_ms(lambda: torch.cdist(
            xb, xb, compute_mode="donot_use_mm_for_euclid_dist"), reps=reps)
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
    g62 = vsim._noise(itt.make_generator(63), dev)
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
        "launches": launches + a_golden, "max_abs_err": lm_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bound_by,
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
        "launches": d_launches, "max_abs_err": gb_err, "ms": d_ms[1024],
        "plain_ms": d_plain[1024], "bound_ms": d_bms, "bound_by": d_by,
        "library_ms": None,
    }, {
        "name": "neighbor_sweep", "route": "cuda",
        "source": "isokann_tpu_torch/csrc/neighbor_sweep.cu",
        "replaces": "isokann_tpu/md/neighbor.py:926",
        "launches": e_launches, "max_abs_err": nb_err, "ms": e_ms[64],
        "sweep_ms": e_alone[64], "plain_ms": e_plain[64], "bound_ms": e_bms,
        "bound_by": e_by, "library_ms": None,
    }, {
        "name": "neighbor_layout", "route": "cuda",
        "source": "isokann_tpu_torch/csrc/neighbor_sweep.cu",
        "replaces": "isokann_tpu/md/neighbor.py:926",
        "launches": l_launches, "max_abs_err": lay_err, "ms": e_prep[64],
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
