#!/usr/bin/env python3
"""The villin stage of ``chip_smoke.py`` (phase 15) at several seeds, for
one or more checkouts of the repository, on one CUDA GPU.

    python3 tools/villin_seed_witness.py [--seeds 60,61,62] ROOT [ROOT ...]

Each ROOT is the root of a checkout (for example an unpacked ``git
archive`` of another commit); each is measured in its own process, in the
order given, so ``A B B A`` compares two versions in turns on one card.
HP35 is built and minimized once (800 FIRE steps in OBC2) by the first
checkout.  Per checkout and seed it runs the stage as the smoke does:
``Iso(sim, nx=8, nk=4, opt=AdamRegularized(adam=1e-5))`` with the default
chi model, ``run(100)``, ``optcontrol`` + a biased propagate of 8 x 4
walkers, ``run_girsanov(generations=2, iter=50, kde=8, forcescale=0.5)``,
and prints one JSON line: the seconds of ``Iso`` (the dataset) and of
``run(100)``, the first and last loss of ``run()`` and of each
generation, the telemetry rows, and whether each generation's last loss
is below its first.  The checkout's ``from_sim`` decides where the data
come from (``randx0`` before the multi-chain bootstrap, the bootstrap
after it).

Needs a CUDA device.  Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP35 = "LSDEDFKAVFGMTRSAFANLPLWKQQNLKKEKGLF"


def measure(root, pdb, seeds):
    """One checkout's rows (run in its own process)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import isokann_tpu_torch as itt
    from isokann_tpu_torch.md.fixtures import peptide_pdb
    if not os.path.exists(pdb):
        os.makedirs(os.path.dirname(pdb), exist_ok=True)
        peptide_pdb(HP35, pdb, minimize=True, maxiter=800, implicit="obc2")
    vsim = itt.MDSimulation(pdb=pdb, steps=100, implicit="obc2",
                            features=itt.FeaturesAll())
    out = []
    for seed in seeds:
        gen = itt.make_generator(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iso = itt.Iso(sim=vsim, nx=8, nk=4,
                      opt=itt.AdamRegularized(adam=1e-5), gen=gen)
        torch.cuda.synchronize()
        t_iso = time.perf_counter() - t0
        t0 = time.perf_counter()
        iso.run(100)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        vsim.bias = itt.optcontrol(iso, forcescale=0.5)
        vsim.propagate(iso.data.coords, 4, gen=gen)
        vsim.bias = None
        itt.run_girsanov(iso, generations=2, iter=50, kde=8, forcescale=0.5)
        run_l = np.asarray(iso.losses[:100])
        gl = np.asarray(iso.losses[100:]).reshape(2, 50)
        out.append(dict(
            root=root, seed=seed, iso_s=t_iso, run100_s=t_run,
            run=[float(run_l[0]), float(run_l[-1])],
            generations=[[float(a), float(b)] for a, b in gl[:, [0, -1]]],
            every_generation_falls=bool(np.all(gl[:, -1] < gl[:, 0])),
            n_data=len(iso.data),
            telemetry=iso.girsanov_telemetry,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        del iso
        torch.cuda.empty_cache()
    return out


def main():
    args = sys.argv[1:]
    if len(args) > 3 and args[0] == "--one":
        import torch
        if not torch.cuda.is_available():
            print("villin_seed_witness: no CUDA device", file=sys.stderr)
            return 2
        seeds = [int(s) for s in args[3].split(",")]
        for row in measure(os.path.abspath(args[1]), args[2], seeds):
            print(json.dumps(row), flush=True)
        return 0
    seeds = "60,61,62"
    if args[:1] == ["--seeds"]:
        seeds, args = args[1], args[2:]
    roots = args or [HERE]
    pdb = os.path.join(HERE, "build", "villin_seed_witness", "villin.pdb")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root, pdb, seeds],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.strip().splitlines():
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
