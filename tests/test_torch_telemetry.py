"""The port's telemetry and op counts: the phase timers and the
throughput logger as ``tests/test_utils_extra.py:28-45`` drives the JAX
package's, a ``torch.profiler`` Chrome trace, and ``utils/flops.py``: each
count from the kernel module's own ``step_ops``, the shares of the H100's
peaks, the unit that bounds, and no TPU figure in the file."""

import json
import os
import re
import time

import numpy as np
import pytest
import torch

from isokann_tpu.utils import flops as JF

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import gb_kernel as GB
from isokann_tpu_torch.md import langevin_kernel as LK
from isokann_tpu_torch.md import neighbor_kernel as NBK
from isokann_tpu_torch.utils import flops as F
from isokann_tpu_torch.utils import telemetry as T

torch.set_num_threads(1)


def test_timers():
    t = itt.utils.Timers()
    with t("phase", work=100):
        time.sleep(0.01)
    with t("phase"):
        pass
    assert t.total["phase"] >= 0.01 and t.count["phase"] == 2
    assert t.rate("phase") > 0 and np.isnan(t.rate("other"))
    assert "phase" in t.report() and "over 2 calls" in repr(t)
    assert repr(T.Timers()) == "Timers()"


def test_throughput_logger():
    iso = itt.Iso(sim=itt.Doublewell(device="cpu"), nx=16, nk=2, gen=1,
                  minibatch=0, opt=itt.AdamRegularized())
    tl = itt.utils.ThroughputLogger(logevery=5)
    iso.loggers.append(tl)
    iso.run(20)
    assert len(tl.rates) >= 1 and tl.iters[0] % 5 == 0
    assert tl.diagnostic()[0] == "iters/s" and tl.diagnostic()[1] > 0


def test_profile_writes_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with itt.utils.profile(d) as logdir:
        torch.ones(8, 8).sum()
    assert logdir == d
    trace = json.loads(open(os.path.join(d, "trace.json")).read())
    assert any("aten::" in e.get("name", "")
               for e in trace["traceEvents"])


# ---- op counts ------------------------------------------------------------------

def test_fused_md_flops_from_step_ops():
    """Kernel A's count for the alanine plan is ``LK.step_ops``: the
    vector part of the JAX package's count of the same force field (its
    incidence matmuls have no counterpart in the port's kernel)."""
    from isokann_tpu.md.pallas_md import PallasMDPlan
    import isokann_tpu as itk

    sim = itt.MDSimulation(steps=1, device="cpu")
    c = F.fused_md_flops(sim.plan)
    assert c == {"matmul_flops": 0.0, "vector_flops": LK.step_ops(sim.plan)}
    assert c["vector_flops"] == 18709.0
    jplan = PallasMDPlan(itk.MDSimulation(steps=1).system)
    j = JF.fused_md_flops(jplan)
    # the same per-row tallies; the integrator's 20 a coordinate row over
    # 3N padded to 8 here and to the JAX plan's R3 there
    r3 = ((sim.dim + 7) // 8) * 8
    assert j["vector_flops"] - c["vector_flops"] == 20 * (jplan.R3 - r3)


def test_gb_and_neighbor_flops_from_step_ops():
    assert F.gb_md_flops(313)["vector_flops"] == GB.step_ops(
        type("P", (), dict(A=313, box=None, use_rf=False, use_gb=True))())
    assert F.gb_md_flops(313)["vector_flops"] == 313 * 312 // 2 * 227 \
        + 313 * 40
    plan = type("P", (), dict(A=100, box=None, use_rf=True, use_gb=False))()
    assert F.gb_md_flops(plan)["vector_flops"] == 100 * 99 // 2 * 52
    a = F.neighbor_sweep_flops(1000, 500)["vector_flops"]
    assert a == NBK.step_ops(250000) == 250000 * 63.0
    assert F.neighbor_sweep_flops(1000, 500, alpha=3.0)["vector_flops"] > a
    m = F.mlp_train_flops([10, 8, 1], 100)
    assert m == JF.mlp_train_flops([10, 8, 1], 100)
    assert m["matmul_flops"] == pytest.approx(3.0 * (2 * 10 * 8 + 2 * 8) * 100)


def test_mfu_shares_and_bound():
    counts = {"matmul_flops": 1e6, "vector_flops": 1e4}
    u = F.mfu(counts, 1e5)
    assert u["matmul_flops_per_s"] == pytest.approx(1e11)
    assert u["vector_flops_per_s"] == pytest.approx(1e9)
    assert u["pct_fp32"] == pytest.approx((1e11 + 1e9) / 67e12)
    assert u["bound"] == "fp32" and u["pct_of_bound"] == u["pct_fp32"]
    assert "pct_hbm" not in u
    assert u["pct_bf16_tensor"] == pytest.approx(1e11 / 989e12)
    assert u["pct_tf32_tensor"] == pytest.approx(1e11 / 495e12)
    h = F.mfu({"matmul_flops": 0.0, "vector_flops": 1.0, "bytes": 1e3}, 1e9)
    assert h["bound"] == "hbm" and h["pct_hbm"] == pytest.approx(1e12 / 3.35e12)
    assert h["pct_of_bound"] == h["pct_hbm"]


def test_mfu_of_kernel_a_equals_its_bound_share():
    """At an operations-bound shape the FP32 share of ``mfu`` is
    ``bound_ms`` over the time, as ``chip_smoke.py`` holds it on the card
    (here at a made-up time)."""
    sim = itt.MDSimulation(steps=1, device="cpu")
    bms, by = LK.bound_ms(sim.plan, 16384, 1000)
    assert by == "operations"
    ms = 55.0
    u = F.mfu(F.fused_md_flops(sim.plan), 16384 * 1000 / (ms * 1e-3))
    assert u["bound"] == "fp32"
    assert abs(u["pct_of_bound"] - bms / ms) <= 1e-12 * bms / ms


def test_flops_file_holds_no_tpu_figure():
    src = open(F.__file__).read().lower()
    for word in (r"\btpu\b", "v5e", "mxu", "vpu", r"1\.97e14", r"1\.9e12"):
        assert not re.search(word, src), word
