#!/usr/bin/env python3
"""Does an NCCL group of one, brought up and torn down, slow the host-bound
work that follows it in the same process?

    python3 tools/nccl_host_probe.py [--iters 400] [--repeats 3] [--control]

On one GPU: a Doublewell learner's ``Iso.run(iters)`` (eager steps and
CUDA-graph replays: host-bound) timed ``repeats`` times, then the group of
``chip_smoke.py``'s ``parallel`` phase (``parallel.distributed.
initialize`` through a file store, one ``all_reduce``, ``shutdown``),
then the same runs again (``--control``: the same with no group, the
drift of the runs alone).  Prints the seconds of each run, the process's
threads (from /proc/self/task, by name) before, during and after the
group, and the card's name and power limit.  Exits 2 without a GPU.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def threads():
    """The names of this process's threads, counted."""
    names = {}
    for t in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{t}/comm") as f:
                n = f.read().strip()
        except OSError:
            continue
        names[n] = names.get(n, 0) + 1
    return names


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--control", action="store_true",
                    help="bring no group up between the two sets of runs")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("nccl_host_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import isokann_tpu_torch as itt
    from isokann_tpu_torch import parallel as P
    import torch.distributed as dist

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    sim = itt.Doublewell()
    data = itt.SimulationData.from_sim(sim, nx=256, nk=16, gen=0)
    iso = itt.Iso(data=data, opt=itt.AdamRegularized(), gen=1)
    iso.run(50)

    def runs():
        out = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iso.run(args.iters)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    before = runs()
    th_before = threads()
    t_up, th_during = None, None
    if not args.control:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        tmp = tempfile.mkdtemp(prefix="nccl_probe_")
        t0 = time.perf_counter()
        P.distributed.initialize(f"file://{tmp}/store", timeout=60)
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        t_up = time.perf_counter() - t0
        th_during = threads()
        P.distributed.shutdown()
    th_after = threads()
    after = runs()
    print(json.dumps(dict(card=smi, control=args.control,
                          iters=args.iters, nccl_up_s=t_up,
                          before_s=before, after_s=after,
                          threads_before=th_before, threads_during=th_during,
                          threads_after=th_after)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
