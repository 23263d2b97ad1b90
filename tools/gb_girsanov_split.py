#!/usr/bin/env python3
"""Times kernels D (gb_force) and B (aboba_girsanov) of the PyTorch/CUDA
port and the path stages they carry, and fingerprints kernel A's output,
for one or more checkouts of the repository on one CUDA GPU.

    python3 tools/gb_girsanov_split.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (for example an unpacked ``git
archive`` of another commit); each is measured in its own process, in the
order given, so ``A B B A`` compares two versions in turns on one card.
The peptides are built and minimized once, by the first process, into
``build/kernel_split/``.  Per checkout it prints one JSON line:

- D through its wrapper, by CUDA events: trp-cage (TC5B, 313 atoms, OBC2,
  1500 FIRE steps) at B = 1, 32, 1024, and villin HP35 (588 atoms, OBC2,
  800 FIRE steps) at B = 1, 32, the minimized coordinates repeated;
- B through its wrapper: 100 steps at B = 256, 512 and 16384 on alanine
  dipeptide, with a pairnet chi from a seed (forcescale 0.5, b 0.4,
  qrate -2, Tmax 0.2 ps);
- kernel A's outputs at fixed seeds (B = 512 x 100 steps, noiseless and
  noisy) as a sha256 digest, equal where two checkouts give the same bits;
- the trp-cage randx0 step (randx0(2) = 200 single-walker hybrid steps,
  host clock ending in a synchronise, ms a step) and the wall seconds of
  ``run_girsanov(generations=3, iter=100, kde=50, forcescale=0.5)`` on the
  alanine quickstart's chi (``Iso(nx=100, nk=5)`` trained 100 iterations).

Needs a CUDA device.  Imports nothing of JAX.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TC5B = "NLYIQWLKDGGPSSGRPPPS"
HP35 = "LSDEDFKAVFGMTRSAFANLPLWKQQNLKKEKGLF"


def cuda_ms(fn, reps):
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


def host_s(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def measure(root, pdbs):
    """One checkout's numbers (run in its own process)."""
    sys.path.insert(0, root)
    import torch
    import isokann_tpu_torch as itt
    from isokann_tpu_torch.md import gb_kernel as GB
    from isokann_tpu_torch.md import girsanov_kernel as GK
    from isokann_tpu_torch.md import langevin_kernel as LK
    from isokann_tpu_torch.md.fixtures import peptide_pdb
    from isokann_tpu_torch.md.pdbio import read_pdb
    from isokann_tpu_torch.md.system import build_system
    tpdb, vpdb = pdbs
    for pdb, seq, n in ((tpdb, TC5B, 1500), (vpdb, HP35, 800)):
        if not os.path.exists(pdb):
            os.makedirs(os.path.dirname(pdb), exist_ok=True)
            peptide_pdb(seq, pdb, minimize=True, maxiter=n, implicit="obc2")
    dev = torch.device("cuda")
    out = {"root": root, "device": torch.cuda.get_device_name(0)}

    # ---- D -----------------------------------------------------------------
    for name, pdb, sizes in (("trpcage", tpdb, (1, 32, 1024)),
                             ("villin", vpdb, (1, 32))):
        plan = GB.GBPlan(build_system(pdb, implicit="obc2", device=dev))
        x0 = torch.as_tensor(read_pdb(pdb).coords.reshape(1, -1),
                             dtype=torch.float32, device=dev)
        for b in sizes:
            xb = x0.expand(b, -1).contiguous()
            reps = 50 if b == 1 else (20 if b <= 32 else 5)
            out[f"D_{name}_B{b}_ms"] = cuda_ms(lambda: GB.gb_force(plan, xb),
                                               reps)

    # ---- B -----------------------------------------------------------------
    sim = itt.MDSimulation(steps=100)
    nfeat = sim.natoms * (sim.natoms - 1) // 2
    model = itt.pairnet(nfeat, gen=11).to(dev)
    gplan = GK.GirsanovPlan.for_model(sim.plan, model, 0.5)
    gen = itt.make_generator(0)
    xg = sim.coords[None].expand(16384, -1).contiguous()
    pg = sim.random_velocities(itt.make_generator(1), xg.shape) \
        * sim.masses3
    for b in (256, 512, 16384):
        xb, pb = xg[:b].contiguous(), pg[:b].contiguous()
        out[f"B_B{b}x100_ms"] = cuda_ms(lambda: GK.aboba_girsanov(
            gplan, model, xb, pb, 100, 0.4, -2.0, 0.2, gen),
            1 if b > 512 else 3)

    # ---- A's bits ----------------------------------------------------------
    x = xg[:512].contiguous()
    v = sim.random_velocities(itt.make_generator(2), x.shape)
    h = hashlib.sha256()
    for noise in (False, True):
        xo, vo = LK.langevin_middle(sim.plan, x, v, 100,
                                    itt.make_generator(7), noise=noise)
        h.update(xo.cpu().numpy().tobytes() + vo.cpu().numpy().tobytes())
    out["A_digest"] = h.hexdigest()[:16]

    # ---- path stages -------------------------------------------------------
    tsim = itt.MDSimulation(pdb=tpdb, steps=100, implicit="obc2")
    tsim.randx0(1, gen=itt.make_generator(3))
    out["trpcage_randx0_ms_per_step"] = 1e3 * host_s(
        lambda: tsim.randx0(2, gen=itt.make_generator(4))) / 200
    iso = itt.Iso(sim=sim, nx=100, nk=5, opt=itt.AdamRegularized(), gen=5)
    iso.run(100)
    out["run_girsanov_s"] = host_s(lambda: itt.run_girsanov(
        iso, generations=3, iter=100, kde=50, forcescale=0.5))
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        import torch
        if not torch.cuda.is_available():
            print("gb_girsanov_split: no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(measure(os.path.abspath(sys.argv[2]),
                                 sys.argv[3:5])), flush=True)
        return 0
    roots = sys.argv[1:] or [HERE]
    base = os.path.join(HERE, "build", "kernel_split")
    pdbs = [os.path.join(base, "trpcage.pdb"), os.path.join(base,
                                                            "villin.pdb")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root, *pdbs], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["card"] = smi
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
