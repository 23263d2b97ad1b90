"""Build hand-written sources into a shared library at first use.

Route: plain ``nvcc`` (CUDA kernels) or ``g++`` (the host library,
``csrc/host_ops.cpp``) into a C-ABI ``.so`` loaded with ``ctypes`` (a few
seconds per source; no PyTorch headers, no ``torch.utils.cpp_extension``).
The library lands in ``build/torch_kernels/`` at the repository root,
named by a hash of its source, the ``csrc`` headers it includes and the
flags, so an edit of any of them forces a rebuild.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# no -march=native: the library is built where it runs, on any x86-64 host
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_loaded: dict = {}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host library builds with g++")
    return path


def _sources(src: str) -> list:
    """``src`` and every file it includes by ``#include "..."`` from its
    own directory, recursively, in first-seen order."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            names = _INCLUDE.findall(f.read())
        todo += [os.path.join(os.path.dirname(path), n.decode())
                 for n in names]
    return seen


def digest(src: str, flags=NVCC_FLAGS) -> str:
    """16 hex digits of the hash of the flags, ``src`` and its includes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in _sources(src):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build_and_load(name: str, source: str, compiler: str, flags):
    """Build ``csrc/<source>`` with ``compiler`` and ``flags`` (once per
    content hash; a pid-named temporary renamed into place, so parallel
    builders never load a half-written file) and load it.  Returns
    ``(lib, seconds)``; a failed build raises with the compiler's stderr."""
    src = os.path.join(_PKG, "csrc", source)
    out = os.path.join(BUILD_DIR, f"{name}-{digest(src, flags)}.so")
    if out in _loaded:
        return _loaded[out], 0.0
    seconds = 0.0
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([compiler, *flags, "-o", tmp, src],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed on "
                               f"{source}:\n{proc.stderr}")
        with open(out + ".log", "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    _loaded[out] = lib
    return lib, seconds


def load_library(name: str, source: str):
    """Build the CUDA source ``csrc/<source>`` with nvcc and load it.

    Returns ``(lib, seconds)``: the ``ctypes.CDLL`` and the seconds spent
    in ``nvcc`` by this call (0.0 when the library was already built)."""
    return _build_and_load(name, source, _nvcc(), NVCC_FLAGS)


def load_host_library(name: str, source: str):
    """Build the C++ source ``csrc/<source>`` with g++ and load it;
    ``(lib, seconds)`` as ``load_library``."""
    return _build_and_load(name, source, _gxx(), GXX_FLAGS)
