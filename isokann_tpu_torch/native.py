"""ctypes bindings to the port's host library (``csrc/host_ops.cpp``).

The library is built with g++ at first use into ``build/torch_kernels/``
(``_build.load_host_library``); a failed build raises with g++'s stderr.
Nothing here touches the card: the routines take and return numpy arrays.
"""

from __future__ import annotations

import ctypes

import numpy as np

_LIB = None
build_seconds = 0.0     # g++ seconds of the build this process made


def lib():
    """The host library, built and bound at the first call."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    from ._build import load_host_library
    so, build_seconds = load_host_library("host_ops", "host_ops.cpp")

    i64 = ctypes.c_int64
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    cs = ctypes.c_char_p

    so.pickclosest_sorted.restype = i64
    so.pickclosest_sorted.argtypes = [pd, i64, pd, i64, pi]
    so.ash_greedy.restype = None
    so.ash_greedy.argtypes = [pd, pd, i64, pd, i64, ctypes.c_double,
                              ctypes.c_double, i64, ctypes.c_double, i64, pi]
    so.bellman_ford_csr.restype = None
    so.bellman_ford_csr.argtypes = [pi, pi, pd, i64, pi, i64, pd, pi]
    so.picking_maxmin.restype = None
    so.picking_maxmin.argtypes = [pd, i64, i64, i64, pi, pd]
    so.dcd_write.restype = i64
    so.dcd_write.argtypes = [cs, pf, i64, i64,
                             ctypes.POINTER(ctypes.c_double), ctypes.c_double]
    so.dcd_info.restype = i64
    so.dcd_info.argtypes = [cs, ctypes.POINTER(i64), ctypes.POINTER(i64),
                            ctypes.POINTER(i64)]
    so.dcd_read.restype = i64
    so.dcd_read.argtypes = [cs, pf, pd, i64]
    _LIB = so
    return so


def pickclosest_native(hs_sorted, ns_sorted):
    """Sorted-sweep closest matching of needles to unique haystack
    entries; returns the picked haystack indices."""
    hs = np.ascontiguousarray(hs_sorted, np.float64)
    ns = np.ascontiguousarray(ns_sorted, np.float64)
    out = np.empty(len(ns), np.int64)
    k = lib().pickclosest_sorted(hs, len(hs), ns, len(ns), out)
    return out[:k]


def ash_resample_native(ys, p, counts, lo, step, window, n0, npick):
    """Greedy ASH gap filling; returns ``npick`` indices into ``ys``."""
    ys = np.ascontiguousarray(ys, np.float64)
    p = np.ascontiguousarray(p, np.float64)
    counts = np.ascontiguousarray(counts, np.float64)
    out = np.empty(npick, np.int64)
    lib().ash_greedy(ys, p, len(ys), counts, len(counts), float(lo),
                     float(step), int(window), float(n0), int(npick), out)
    return out


def bellman_ford_csr_native(indptr, indices, weights, n, sources):
    """Bellman-Ford over a CSR graph from several sources; returns
    (dist (n,), parent (n,), -1 where none)."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    weights = np.ascontiguousarray(weights, np.float64)
    sources = np.ascontiguousarray(sources, np.int64)
    dist = np.empty(n, np.float64)
    parent = np.empty(n, np.int64)
    lib().bellman_ford_csr(indptr, indices, weights, n, sources,
                           len(sources), dist, parent)
    return dist, parent


def picking_native(X, npick):
    """Greedy farthest-point picking; returns (indices, min squared
    distance of every point to the picks)."""
    X = np.ascontiguousarray(X, np.float64)
    npts, d = X.shape
    out = np.empty(npick, np.int64)
    mins = np.empty(npts, np.float64)
    lib().picking_maxmin(X, npts, d, npick, out, mins)
    return out, mins


def dcd_write_native(path, xyz, box=None, dt_ps=0.002):
    """Write a CHARMM/NAMD DCD trajectory.  ``xyz``: (nframes, natoms, 3)
    [nm]; ``box``: optional (3,) [nm] orthorhombic cell."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    bptr = None
    if box is not None:
        b = np.ascontiguousarray(np.asarray(box, np.float64).ravel()[:3])
        bptr = b.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib().dcd_write(str(path).encode(), xyz, xyz.shape[0], xyz.shape[1],
                         bptr, float(dt_ps))
    if rc != 0:
        raise IOError(f"dcd_write failed (code {rc}) for {path}")
    return path


def dcd_read_native(path):
    """Read a DCD trajectory (either byte order) -> (xyz (nframes, natoms,
    3) [nm] float32, boxes (nframes, 3) [nm] or None)."""
    so = lib()
    na, nf, hc = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = so.dcd_info(str(path).encode(), ctypes.byref(na), ctypes.byref(nf),
                     ctypes.byref(hc))
    if rc != 0:
        raise IOError(f"not a readable DCD file: {path} (code {rc})")
    xyz = np.empty((nf.value, na.value, 3), np.float32)
    boxes = np.zeros((nf.value, 3), np.float64)
    rc = so.dcd_read(str(path).encode(), xyz, boxes, nf.value)
    if rc != 0:
        raise IOError(f"dcd_read failed (code {rc}) for {path}")
    return xyz, (boxes if hc.value else None)
