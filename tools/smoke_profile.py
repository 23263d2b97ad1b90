#!/usr/bin/env python3
"""Where the wall time of ``chip_smoke.py`` goes, line by line.

    python3 tools/smoke_profile.py [OUT]

Runs ``chip_smoke.main()`` from the repository root under a wall-clock
stack sampler: a thread wakes every 2 ms and gives the time since its
last wake to the lines on the main thread's stack.  A C call that holds
the GIL (an import's module body, a CUDA module loaded on first use)
delays the next wake, and its time still goes to the line that made it.
Writes OUT (default ``chiprun_out/smoke_profile.txt``): the seconds of
each line of ``main``, of the innermost ``chip_smoke.py`` line, of each
function including its callees, and of the innermost line.  The sampler
costs the run ~10%; the watchdog is set to 900 s.  Needs a CUDA device,
as ``chip_smoke.py`` does.  Imports nothing of JAX.
"""

import collections
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

TICK_S = 0.002


def main(out):
    chip_smoke.LIMIT_S = 900
    main_id = threading.get_ident()
    stop = threading.Event()
    by = {k: collections.Counter()
          for k in ("main", "chip_smoke", "function", "line")}

    def sample():
        last = time.perf_counter()
        while not stop.is_set():
            time.sleep(TICK_S)
            frame = sys._current_frames().get(main_id)
            now = time.perf_counter()
            dt, last = now - last, now
            if frame is None:
                continue
            code = frame.f_code
            by["line"][(os.path.basename(code.co_filename), code.co_name,
                        frame.f_lineno)] += dt
            seen, inner = set(), None
            while frame is not None:
                code = frame.f_code
                key = (os.path.basename(code.co_filename), code.co_name)
                if key not in seen:
                    seen.add(key)
                    by["function"][key] += dt
                if code.co_filename.endswith("chip_smoke.py"):
                    inner = inner or (code.co_name, frame.f_lineno)
                    if code.co_name == "main":
                        by["main"][frame.f_lineno] += dt
                frame = frame.f_back
            if inner:
                by["chip_smoke"][inner] += dt

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        rc = chip_smoke.main()
    finally:
        stop.set()
        sampler.join()
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write("== lines of main (>= 0.05 s), in order\n")
            for line, s in sorted(by["main"].items()):
                if s >= 0.05:
                    f.write(f"{s:8.3f}s main:{line}\n")
            for title, key, n in (("innermost chip_smoke.py lines",
                                   "chip_smoke", 120),
                                  ("functions, callees included",
                                   "function", 250),
                                  ("innermost lines", "line", 150)):
                f.write(f"== {title}\n")
                for k, s in by[key].most_common(n):
                    f.write(f"{s:8.3f}s {k}\n")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1
                  else os.path.join(ROOT, "chiprun_out",
                                    "smoke_profile.txt")))
