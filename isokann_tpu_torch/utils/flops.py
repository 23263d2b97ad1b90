"""Operation counts of the port's kernels and their share of the H100's
peak rates; counterpart of ``isokann_tpu/utils/flops.py`` with the same
function names.

The counts are those of each kernel module's own ``step_ops`` (the
operations the function needs, each transcendental, division and
comparison counted as one), so a piece of work is counted one way only:
``md/langevin_kernel.py`` (kernel A), ``md/gb_kernel.py`` (D),
``md/neighbor_kernel.py`` (E).  Matmul flops are 2 m k n for an
(m, k) @ (k, n) product.

Peaks of one H100 SXM (700 W): 989 TFLOP/s bf16 dense on the tensor
cores, 495 TFLOP/s TF32 on the tensor cores, 67 TFLOP/s FP32 without
them, 3.35 TB/s of HBM3.  The port runs float32 with TF32 off, so its
matmuls as well as its vector work run at the FP32 rate.
"""

from __future__ import annotations

from types import SimpleNamespace

from ..md import gb_kernel as GB
from ..md import langevin_kernel as LK
from ..md import neighbor_kernel as NBK

H100_PEAK_BF16_TENSOR = 989e12
H100_PEAK_TF32_TENSOR = 495e12
H100_PEAK_FP32 = LK.H100_FP32_PEAK
H100_HBM_BYTES_PER_S = LK.H100_HBM_BYTES_PER_S


def fused_md_flops(plan) -> dict:
    """Operations per walker per MD step of kernel A's trajectories
    (``plan``: an ``md.langevin_kernel.LangevinPlan``): ``LK.step_ops``,
    all vector work (the kernel takes its pairs from a table, no matmul)."""
    return {"matmul_flops": 0.0, "vector_flops": LK.step_ops(plan)}


def gb_md_flops(natoms) -> dict:
    """Operations per walker per force evaluation of kernel D: an
    ``md.gb_kernel.GBPlan``, or for an int the count of ``natoms`` atoms
    with OBC2 and no box (227 an unordered pair; ``GB.step_ops``)."""
    plan = natoms
    if isinstance(natoms, int):
        plan = SimpleNamespace(A=natoms, box=None, use_rf=False, use_gb=True)
    return {"matmul_flops": 0.0, "vector_flops": GB.step_ops(plan)}


def neighbor_sweep_flops(natoms: int, candidates_per_atom: float,
                         alpha=None, beta=None) -> dict:
    """Operations per walker per sweep of kernel E with
    ``candidates_per_atom`` partners within the cutoff of each of
    ``natoms`` atoms (natoms x candidates / 2 unordered pairs;
    ``NBK.step_ops``: 63 a pair with the reaction field, more with erfc
    (``alpha``) or the LJPME branch (``beta``))."""
    in_range = float(natoms) * float(candidates_per_atom) / 2.0
    return {"matmul_flops": 0.0,
            "vector_flops": NBK.step_ops(in_range, alpha, beta)}


def mlp_train_flops(sizes, n_samples: int) -> dict:
    """Operations of one SGD step of an MLP with layer ``sizes`` (e.g.
    [231, 38, 6, 1]) over ``n_samples`` rows: the forward products
    2 m k n a layer, the backward ~2x them (the inputs' and the weights'
    gradients); ~10 vector operations an output unit a row."""
    per_row = sum(2.0 * a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return {"matmul_flops": 3.0 * per_row * n_samples,
            "vector_flops": 10.0 * sum(sizes[1:]) * n_samples}


def mfu(counts: dict, rate_per_s: float) -> dict:
    """The share of the H100's peaks that ``counts`` (per invocation:
    "matmul_flops", "vector_flops" and, optionally, "bytes") take at
    ``rate_per_s`` invocations a second.  The port runs float32 with TF32
    off, so its matmuls and its vector work share the FP32 rate
    (``pct_fp32``); ``pct_hbm`` is the bytes' share of the memory rate.
    ``bound`` names the larger, "fp32" or "hbm", and ``pct_of_bound`` is
    its share.  ``pct_tf32_tensor`` / ``pct_bf16_tensor`` are the shares
    the same matmuls would take on the tensor cores."""
    mm = counts["matmul_flops"] * rate_per_s
    vec = counts["vector_flops"] * rate_per_s
    pct = {"fp32": (mm + vec) / H100_PEAK_FP32}
    if "bytes" in counts:
        pct["hbm"] = counts["bytes"] * rate_per_s / H100_HBM_BYTES_PER_S
    bound = max(pct, key=pct.get)
    return {
        "matmul_flops_per_s": mm,
        "vector_flops_per_s": vec,
        **{f"pct_{k}": v for k, v in pct.items()},
        "pct_tf32_tensor": mm / H100_PEAK_TF32_TENSOR,
        "pct_bf16_tensor": mm / H100_PEAK_BF16_TENSOR,
        "bound": bound,
        "pct_of_bound": pct[bound],
    }
