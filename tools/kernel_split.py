#!/usr/bin/env python3
"""Times kernels A (langevin_middle) and E (neighbor_sweep) of the
PyTorch/CUDA port, and the two path stages they carry, for one or more
checkouts of the repository on one CUDA GPU.

    python3 tools/kernel_split.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (for example an unpacked ``git
archive`` of another commit); each is measured in its own process, in the
order given, so ``A B B A`` compares two versions in turns on one card.
Per checkout it prints one JSON line:

- E at B = 1, 64, 256 on the 7,744-atom solvated peptide of
  ``examples/solvated_peptide.py`` (its start coordinates plus 0.02 nm of
  noise), each through the public wrappers and by CUDA events: the
  wrapper, its preparation alone (the records the sweep reads:
  ``slot_records`` in PyTorch before the redesign, ``neighbor_layout``
  after it), and the sweep alone (the wrapper with its preparation
  replaced by records made beforehand: the sweep kernel, the zeroed
  output and the wrapper's host work);
- A: 100 steps at B = 1 (one randx0 lag) and at B = 512, 1000 steps at
  B = 16384;
- the quickstart's ``SimulationData.from_sim(nx=100, nk=5)`` (host clock,
  ending in a synchronise) and the solvated randx0 step (randx0(2) = 200
  single-walker constrained steps).

Needs a CUDA device.  Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def measure(root, pdb):
    """One checkout's numbers (run in its own process)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import isokann_tpu_torch as itt
    from isokann_tpu_torch.md import langevin_kernel as LK
    from isokann_tpu_torch.md import neighbor_kernel as NBK
    from isokann_tpu_torch.md.fixtures import peptide_pdb
    out = {"root": root, "device": torch.cuda.get_device_name(0)}

    # ---- E ---------------------------------------------------------------
    if not os.path.exists(pdb):
        os.makedirs(os.path.dirname(pdb), exist_ok=True)
        peptide_pdb("AQGSAELAKVM", pdb, minimize=True, maxiter=300)
    ssim = itt.MDSimulation(pdb=pdb, addwater=True, padding=1.0, steps=100)
    sys_, plan = ssim.system, ssim.nbplan
    rng = np.random.default_rng(0)
    x0 = ssim.coords[None] + torch.as_tensor(
        rng.normal(scale=0.02, size=(256, ssim.dim)), dtype=torch.float32,
        device="cuda")
    # the wrapper prepares its records (slot_records in PyTorch before the
    # redesign, the layout kernel after it) and launches the sweep; the
    # sweep alone is the wrapper with its preparation replaced by records
    # made beforehand
    prep_name = ("neighbor_layout" if hasattr(NBK, "neighbor_layout")
                 else "slot_records")
    prepare = getattr(NBK, prep_name)
    for b in (1, 64, 256):
        xb = x0[:b].contiguous()
        reps = 20 if b == 1 else 3
        wrapper = cuda_ms(lambda: NBK.neighbor_sweep(sys_, plan, xb), reps)
        prep = cuda_ms(lambda: prepare(sys_, plan, xb), reps)
        made = prepare(sys_, plan, xb)
        setattr(NBK, prep_name, lambda *args: made)
        try:
            alone = cuda_ms(lambda: NBK.neighbor_sweep(sys_, plan, xb), reps)
        finally:
            setattr(NBK, prep_name, prepare)
        out[f"E_B{b}"] = {"wrapper_ms": wrapper, "prep_ms": prep,
                          "sweep_ms": alone}

    # ---- A ---------------------------------------------------------------
    sim = itt.MDSimulation()
    aplan = sim.plan
    gen = itt.make_generator(0)
    for b, n, reps in ((1, 100, 5), (512, 100, 5), (16384, 1000, 1)):
        xa = sim.coords[None].expand(b, sim.dim).contiguous()
        va = sim.random_velocities(itt.make_generator(1), xa.shape)
        out[f"A_B{b}x{n}_ms"] = cuda_ms(
            lambda: LK.langevin_middle(aplan, xa, va, n, gen), reps)

    # ---- path stages -------------------------------------------------------
    qsim = itt.MDSimulation(steps=100)
    itt.SimulationData.from_sim(qsim, nx=2, nk=1, gen=itt.make_generator(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    itt.SimulationData.from_sim(qsim, nx=100, nk=5,
                                gen=itt.make_generator(3))
    torch.cuda.synchronize()
    out["quickstart_datagen_s"] = time.perf_counter() - t0
    ssim.randx0(1, gen=itt.make_generator(4))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ssim.randx0(2, gen=itt.make_generator(5))
    torch.cuda.synchronize()
    out["solvated_randx0_ms_per_step"] = \
        1e3 * (time.perf_counter() - t0) / 200
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        import torch
        if not torch.cuda.is_available():
            print("kernel_split: no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(measure(os.path.abspath(sys.argv[2]),
                                 sys.argv[3])), flush=True)
        return 0
    roots = sys.argv[1:] or [HERE]
    pdb = os.path.join(HERE, "build", "kernel_split", "solvated_peptide.pdb")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root, pdb], capture_output=True,
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
