#!/usr/bin/env python3
"""Times kernels C (sqpairdist_fwd) and C′ (sqpairdist_bwd) of the
PyTorch/CUDA port, and the two routes of ``flatpairdists``, for one or more
checkouts of the repository on one CUDA GPU.

    python3 tools/pairdist_split.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (for example an unpacked ``git
archive`` of another commit); each is measured in its own process, in the
order given, so ``A B B A`` compares two versions in turns on one card.
Per checkout it prints one JSON line:

- C and C′ through their wrappers at villin's width (588 atoms, random
  coordinates in a 5 nm cube, an upper-triangular dp as the i < j
  gather's backward gives) at B = 1, 32 and 1024, each launch between its
  own pair of CUDA events: warm (behind a device-side wait, with the
  inputs of the previous launch, so at B <= 32 dp stays in the 50 MB L2,
  as on the path, where the gather's backward has just written it) and
  cold (behind a 128 MB write); and C′'s device time by kernel, from
  ``torch.profiler`` over 10 calls back to back;
- ``flatpairdists`` at B = 32 and N = 128, 256, 384, 512, 768 on both
  routes (``use_kernel=False``: the Gram trick; ``True``: kernels C and
  C′), the forward alone and the forward with the gradient of a fixed
  weighting of the distances, 20 calls back to back (the host's launch
  time included).

Needs a CUDA device.  Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NV = 588                      # villin HP35's atoms
SIZES = (1, 32, 1024)
CROSS_N = (128, 256, 384, 512, 768)
FLUSH_BYTES = 128 * 2**20     # more than the H100's 50 MB L2


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls, after
    one warm-up call."""
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


def event_ms(fn, reps, flush=None):
    """Mean device time of ``fn()``, each call between its own events,
    behind a write of ``flush`` (cold) or a device-side wait (warm)."""
    import torch
    fn()
    pairs = []
    for _ in range(reps):
        if flush is None:
            torch.cuda._sleep(200_000)
        else:
            flush.add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def kernel_us(fn, reps):
    """Device microseconds a call of ``fn()`` spends in each kernel whose
    name holds "sqpairdist", by ``torch.profiler`` over ``reps`` calls
    back to back."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "sqpairdist" in e.key:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            name = e.key.split("::")[-1].split("(")[0].split("<")[0]
            out[name] = total / reps
    return out


def measure(root):
    """One checkout's numbers (run in its own process)."""
    sys.path.insert(0, root)
    import torch
    from isokann_tpu_torch.ops import pairdists as P
    from isokann_tpu_torch.ops import pairdists_kernel as PK
    dev = torch.device("cuda")
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    PK.sqpairdist_fwd.lib()
    PK.sqpairdist_bwd.lib()
    out["nvcc_s"] = PK.sqpairdist_fwd.build_seconds
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.zeros(FLUSH_BYTES // 4, device=dev)
    x1 = 5.0 * torch.rand(SIZES[-1], NV, 3, generator=gen, device=dev)
    for b in SIZES:
        xb = x1[:b].contiguous()
        dp = torch.triu(torch.randn(b, NV, NV, generator=gen, device=dev),
                        diagonal=1)
        reps = 50 if b < 1024 else 10
        fwd = lambda: PK.sqpairdist_fwd(xb)            # noqa: E731
        bwd = lambda: PK.sqpairdist_bwd(xb, dp)        # noqa: E731
        out[f"C_B{b}_warm_ms"] = event_ms(fwd, reps)
        out[f"C_B{b}_cold_ms"] = event_ms(fwd, reps, flush)
        out[f"Cp_B{b}_warm_ms"] = event_ms(bwd, reps)
        out[f"Cp_B{b}_cold_ms"] = event_ms(bwd, reps, flush)
        out[f"Cp_B{b}_kernels_us"] = kernel_us(bwd, 10)
        del dp
    for n in CROSS_N:
        z = (5.0 * torch.rand(32, 3 * n, generator=gen, device=dev)
             ).requires_grad_(True)
        w = torch.randn(32, n * (n - 1) // 2, generator=gen, device=dev)
        for route, kern in (("gram", False), ("kernel", True)):
            out[f"flat_{route}_N{n}_fwd_ms"] = cuda_ms(
                lambda: P.flatpairdists(z.detach(), use_kernel=kern), 20)
            out[f"flat_{route}_N{n}_fwdbwd_ms"] = cuda_ms(
                lambda: torch.autograd.grad(
                    P.flatpairdists(z, use_kernel=kern), z, w), 20)
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        import torch
        if not torch.cuda.is_available():
            print("pairdist_split: no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    roots = sys.argv[1:] or [HERE]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True,
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
