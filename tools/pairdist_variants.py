#!/usr/bin/env python3
"""Where kernel C′ (``sqpairdist_bwd``, ``isokann_tpu_torch/csrc/
sqpairdist.cu``) spends its time, on one CUDA GPU.

    python3 tools/pairdist_variants.py

Builds the source as it stands and four variants of it, each made by
replacing a few lines of the source text (the script stops if a line it
replaces is gone), and times each through the C entry point at villin's
width (588 atoms, an upper-triangular dp) at B = 1, 32 and 1024 with the
wrapper's launch shape, each launch between its own CUDA events, warm
(behind a device-side wait, the previous inputs in the L2) and cold
(behind a 128 MB write):

- ``kernel``: the source;
- ``no_arith``: the pair arithmetic of a tile pair left out (loads, ring,
  partial writes and the second pass kept);
- ``no_loads``: each warp loads its first tile pair only and sums it
  again and again;
- ``float32``: the pair arithmetic in float32 instead of double;
- ``ring3``: a ring of three stages instead of two.

Beside them ``torch.sum(dp)``, one PyTorch call that reads the same bytes,
as a yardstick of the card's read rate at these sizes.  Prints one JSON
line.  The variants give wrong sums; only their times mean anything.
Needs a CUDA device and ``nvcc``.  Imports nothing of JAX.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NV = 588
SIZES = (1, 32, 1024)
OUT = os.path.join(HERE, "build", "pairdist_variants")

NO_ARITH = [(
    "  const int g = lane >> 2, h = lane & 3;\n  float a[4][8];",
    "  if (true) {\n    row[lane] = (double)tA[lane] + xr[lane];\n"
    "    if (!kDiag) col[lane] = (double)tB[lane];\n    return;\n  }\n"
    "  const int g = lane >> 2, h = lane & 3;\n  float a[4][8];")]
NO_LOADS = [(
    "      load_pair<kVec>(ring + ((k + kStages - 1) % kStages) * kStageF,"
    " g, xw,\n                      I, J, N, lane);",
    "      (void)I;\n      (void)J;")]
FLOAT32 = [
    ("double xi[4][3], racc[4][3], cacc[8][3];",
     "float xi[4][3], racc[4][3], cacc[8][3];"),
    ("const double xj[3] = {xc[j], xc[kTile + j], xc[2 * kTile + j]};",
     "const float xj[3] = {(float)xc[j], (float)xc[kTile + j],"
     " (float)xc[2 * kTile + j]};"),
    ("      const double s = __dadd_rn((double)a[r][c], (double)b[r]);",
     "      const float s = __fadd_rn(a[r][c], b[r]);"),
    ("        const double p = __dmul_rn(s, __dsub_rn(xi[r][q], xj[q]));\n"
     "        racc[r][q] = __dadd_rn(racc[r][q], p);\n"
     "        if (!kDiag) cacc[c][q] = __dsub_rn(cacc[c][q], p);",
     "        const float p = __fmul_rn(s, __fsub_rn(xi[r][q], xj[q]));\n"
     "        racc[r][q] = __fadd_rn(racc[r][q], p);\n"
     "        if (!kDiag) cacc[c][q] = __fsub_rn(cacc[c][q], p);"),
]
RING3 = [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]
VARIANTS = {"kernel": [], "no_arith": NO_ARITH, "no_loads": NO_LOADS,
            "float32": FLOAT32, "ring3": RING3}


def variant_source(src, edits):
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"pairdist_variants: line gone from the "
                             f"source: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(name, src, nvcc, flags):
    cu = os.path.join(OUT, f"{name}.cu")
    so = os.path.join(OUT, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([nvcc, *flags, "-o", so, cu], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    return so


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


def main():
    import torch
    if not torch.cuda.is_available():
        print("pairdist_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from isokann_tpu_torch import _build
    from isokann_tpu_torch.ops import pairdists_kernel as PK
    with open(os.path.join(HERE, "isokann_tpu_torch", "csrc",
                           "sqpairdist.cu")) as f:
        src = f.read()
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        jobs = {name: pool.submit(build, name, variant_source(src, edits),
                                  nvcc, _build.NVCC_FLAGS)
                for name, edits in VARIANTS.items()}
        libs = {name: ctypes.CDLL(job.result()) for name, job in jobs.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.zeros(32 * 2**20, device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "card": smi}
    x1 = 5.0 * torch.rand(SIZES[-1], NV, 3, generator=gen, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    for b in SIZES:
        xb = x1[:b].contiguous()
        dp = torch.triu(torch.randn(b, NV, NV, generator=gen, device=dev),
                        diagonal=1)
        dx = torch.empty_like(xb)
        part = torch.empty(b * PK.tile_pairs(NV) * PK.PART_BYTES // 8,
                           dtype=torch.float64, device=dev)
        blocks, warps = PK.launch_shape(NV, b)
        reps = 30 if b < 1024 else 8
        for name, lib in libs.items():
            fn_c = lib.sqpairdist_bwd
            fn_c.argtypes = [p, p, p, p, i, i, i, i, p]
            fn_c.restype = i

            def call():
                err = fn_c(xb.data_ptr(), dp.data_ptr(), dx.data_ptr(),
                           part.data_ptr(), b, NV, blocks, warps, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: cudaError {err}")
            out[f"{name}_B{b}_warm_ms"] = event_ms(call, reps)
            out[f"{name}_B{b}_cold_ms"] = event_ms(call, reps, flush)
        out[f"torch_sum_B{b}_warm_ms"] = event_ms(lambda: torch.sum(dp),
                                                  reps)
        out[f"torch_sum_B{b}_cold_ms"] = event_ms(lambda: torch.sum(dp),
                                                  reps, flush)
        del dp, part
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
