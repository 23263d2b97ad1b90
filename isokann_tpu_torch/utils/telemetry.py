"""Profiling and throughput telemetry; counterpart of
``isokann_tpu/utils/telemetry.py``: a ``torch.profiler`` trace, named
phase timers and an iterations-per-second logger."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict


@contextlib.contextmanager
def profile(logdir: str = None):
    """Profile the block with ``torch.profiler`` (the CPU, and the card's
    kernels when a GPU is present) and write a Chrome trace,
    ``<logdir>/trace.json`` (default logdir ``isokann_profile`` under the
    temporary directory).  Yields ``logdir``."""
    import torch
    from torch.profiler import ProfilerActivity

    logdir = logdir or os.path.join(tempfile.gettempdir(), "isokann_profile")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timers:
    """Named accumulating phase timers with rate reporting.

    >>> t = Timers()
    >>> with t("md", work=5000):   # 5000 walker-steps
    ...     run_md()
    >>> t.report()
    """

    def __init__(self):
        self.total = defaultdict(float)
        self.work = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, work: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.work[name] += work
            self.count[name] += 1

    def rate(self, name: str):
        t = self.total.get(name, 0.0)
        return self.work.get(name, 0.0) / t if t > 0 else float("nan")

    def report(self):
        lines = []
        for name in self.total:
            line = (f"{name}: {self.total[name]:.2f}s over "
                    f"{self.count[name]} calls")
            if self.work[name]:
                line += f", {self.rate(name):.3g} units/s"
            lines.append(line)
        return "\n".join(lines)

    def __repr__(self):
        return self.report() or "Timers()"


class ThroughputLogger:
    """Iso logger of training iterations per second (add it to
    ``iso.loggers``; ``Iso.run`` then brings the losses to the host every
    ``logevery`` iterations)."""

    def __init__(self, logevery: int = 50):
        self.logevery = logevery
        self.t0 = None
        self.iters = []
        self.rates = []

    def log(self, iso):
        now = time.perf_counter()
        n = len(iso.losses)
        if self.t0 is None:
            self.t0 = now
            self._last = (now, n)
            return
        lt, ln = self._last
        if n - ln >= self.logevery:
            self.rates.append((n - ln) / (now - lt))
            self.iters.append(n)
            self._last = (now, n)

    def diagnostic(self):
        return ("iters/s", round(self.rates[-1], 1) if self.rates else None)
