"""The port's host library (``isokann_tpu_torch/native.py`` over
``csrc/host_ops.cpp``, built with g++ at first use) against the JAX
package's: DCD files byte for byte and read across packages, the
big-endian read, the sparse Bellman-Ford and the selection sweeps with the
same outputs; the build's naming, its failure and the committed library it
never loads."""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import isokann_tpu.analysis.reactivepath as JR
import isokann_tpu.native as JN
from isokann_tpu.utils import save as JS

import isokann_tpu_torch as itt
from isokann_tpu_torch import _build
from isokann_tpu_torch import native as TN
from isokann_tpu_torch.analysis import reactivepath as TR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _traj(seed, frames=7, dim=66):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.5, size=(frames, dim)) + 2.0).astype(
        np.float32)


# ---- DCD --------------------------------------------------------------------

@pytest.mark.parametrize("box", [None, (2.5, 2.5, 3.0)])
def test_dcd_bytes_equal_jax_and_read_across(tmp_path, box):
    """The same frames written by both packages give the same bytes; each
    package reads the other's file back to the frames within 1e-5 nm."""
    traj = _traj(0)
    pt, pj = str(tmp_path / "t.dcd"), str(tmp_path / "j.dcd")
    itt.save_trajectory(pt, traj, box=box)
    JS.save_trajectory(pj, traj, box=box)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    xt, bt = TN.dcd_read_native(pj)
    xj, bj = JN.dcd_read_native(pt)
    assert np.array_equal(xt, xj)
    assert np.abs(xt.reshape(7, -1) - traj).max() < 1e-5
    assert (bt is None) == (box is None) == (bj is None)
    if box is not None:
        np.testing.assert_allclose(bt[0], box)
        np.testing.assert_allclose(bj, bt)
    np.testing.assert_array_equal(itt.load_trajectory(pj),
                                  JS.load_trajectory(pt))


def test_dcd_bigendian_read(tmp_path):
    """``tests/test_utils_extra.py:224`` on the port: a byte-swapped file
    reads to the same frames and cell as the little-endian one."""
    traj = _traj(3, frames=3, dim=30) - 1.0
    p = str(tmp_path / "le.dcd")
    itt.save_trajectory(p, traj, box=(2.0, 2.5, 3.0))
    raw = open(p, "rb").read()

    def swap4(b):
        return np.frombuffer(b, "<u4").astype(">u4").tobytes()

    def swap8(b):
        return np.frombuffer(b, "<u8").astype(">u8").tobytes()

    out, off, rec = bytearray(), 0, 0
    while off < len(raw):
        n = struct.unpack_from("<i", raw, off)[0]
        payload = raw[off + 4:off + 4 + n]
        if rec == 0:                       # header: magic + 20 i32
            payload = payload[:4] + swap4(payload[4:])
        elif rec == 1:                     # title: i32 count + text
            payload = swap4(payload[:4]) + payload[4:]
        elif n == 48:                      # unit cell: 6 f64
            payload = swap8(payload)
        else:                              # natoms / coordinate blocks
            payload = swap4(payload)
        m = struct.pack(">i", n)
        out += m + payload + m
        off += 4 + n + 4
        rec += 1
    pbe = str(tmp_path / "be.dcd")
    open(pbe, "wb").write(bytes(out))
    xyz_le, box_le = TN.dcd_read_native(p)
    xyz_be, box_be = TN.dcd_read_native(pbe)
    assert np.abs(xyz_be - xyz_le).max() == 0.0
    np.testing.assert_allclose(box_be, box_le)
    np.testing.assert_array_equal(xyz_be, JN.dcd_read_native(pbe)[0])


def test_dcd_unreadable_raises(tmp_path):
    p = tmp_path / "bad.dcd"
    p.write_bytes(b"not a dcd file at all")
    with pytest.raises(IOError, match="not a readable DCD"):
        TN.dcd_read_native(str(p))


# ---- graph and selection routines ---------------------------------------------

def test_bellman_ford_native_matches_jax():
    """The JAX test's 3-node CSR graph (``tests/test_forcefield_ext.py:
    125-133``): the same distances and parents."""
    indptr = np.array([0, 2, 3, 3])
    indices = np.array([1, 2, 2])
    w = np.array([1.0, 5.0, 1.0])
    d, p = TN.bellman_ford_csr_native(indptr, indices, w, 3, [0])
    assert d.tolist() == [0.0, 1.0, 2.0] and p.tolist() == [-1, 0, 1]
    dj, pj = JN.bellman_ford_csr_native(indptr, indices, w, 3, [0])
    assert np.array_equal(d, dj) and np.array_equal(p, pj)


def _dag(n, seed):
    rng = np.random.default_rng(seed)
    A = np.full((n, n), np.inf)
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < 0.3:
                A[i, j] = rng.normal(0.2, 0.5)
    return A


@pytest.mark.parametrize("graph", ["jax_test", "dag0", "dag1"])
def test_shortestpath_sparse_native_scipy_jax(graph):
    """The host library's route, the scipy route and the JAX package's
    ``shortestpath_sparse`` give the same path ids: on the JAX test's
    3-node graph (``tests/test_analysis.py:50-58``) and on random 40-node
    DAGs with negative costs from two sources."""
    if graph == "jax_test":
        A = np.array([[np.inf, 1.0, 10.0],
                      [np.inf, np.inf, 1.0],
                      [np.inf, np.inf, np.inf]])
        src, tgt = [0], [2]
    else:
        A = _dag(40, int(graph[-1]))
        src, tgt = [0, 3], [37, 38, 39]
    n = len(A)
    i, j = np.nonzero(np.isfinite(A))
    w = A[i, j]
    native = TR.shortestpath_sparse(n, i, j, w, src, tgt)
    assert len(native) >= 2
    assert native == TR._shortestpath_scipy(n, i, j, w, src, tgt)
    assert native == JR.shortestpath_sparse(n, i, j, w, src, tgt)
    if graph == "jax_test":
        assert native == [0, 1, 2]


def test_shortestpath_sparse_no_path():
    """No edge into the targets, no source or no target: empty."""
    i, j, w = np.array([0]), np.array([1]), np.array([1.0])
    for src, tgt in (([0], [2]), ([], [1]), ([0], [])):
        assert TR.shortestpath_sparse(3, i, j, w, src, tgt) == []
        assert TR._shortestpath_scipy(3, i, j, w, src, tgt) == []


def test_pickclosest_picking_ash_match_jax():
    """The selection sweeps of both libraries give the same indices."""
    rng = np.random.default_rng(0)
    hs = np.sort(rng.random(500))
    ns = np.sort(np.random.default_rng(1).random(40))
    assert np.array_equal(TN.pickclosest_native(hs, ns),
                          JN.pickclosest_native(hs, ns))
    X = np.random.default_rng(3).normal(size=(60, 4))
    qt, mt = TN.picking_native(X, 6)
    qj, mj = JN.picking_native(X, 6)
    assert np.array_equal(qt, qj) and np.array_equal(mt, mj)
    ys = np.sort(rng.random(200))
    counts = np.histogram(rng.random(30), bins=20, range=(0, 1))[0]
    # ash_greedy updates p and counts in place: each call its own copies
    a = TN.ash_resample_native(ys, np.ones(200) / 200,
                               counts.astype(np.float64), 0.0, 0.05, 2, 1.0,
                               10)
    b = JN.ash_resample_native(ys, np.ones(200) / 200,
                               counts.astype(np.float64), 0.0, 0.05, 2, 1.0,
                               10)
    assert len(a) == 10 and np.array_equal(a, b)


# ---- the build ----------------------------------------------------------------

def test_host_library_built_by_gxx_into_build_dir():
    """The library is ``build/torch_kernels/host_ops-<hash>.so``, the
    hash over the g++ flags (no -march=native) and the source; in a fresh
    interpreter the port maps it and never the committed
    ``native/libisokann_host.so``."""
    assert "-march=native" not in _build.GXX_FLAGS
    src = os.path.join(_build._PKG, "csrc", "host_ops.cpp")
    name = f"host_ops-{_build.digest(src, _build.GXX_FLAGS)}.so"
    assert _build.digest(src, _build.GXX_FLAGS) != _build.digest(src)
    TN.lib()
    assert os.path.exists(os.path.join(_build.BUILD_DIR, name))
    code = ("import isokann_tpu_torch as itt, numpy as np\n"
            "from isokann_tpu_torch import native\n"
            "native.bellman_ford_csr_native(np.array([0, 1, 1]), "
            "np.array([1]), np.array([1.0]), 2, [0])\n"
            "maps = open('/proc/self/maps').read()\n"
            "print('host_ops-' in maps, 'libisokann_host' in maps)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False"]


def test_failed_build_raises_with_gxx_stderr(tmp_path, monkeypatch):
    """A source that does not compile raises, with g++'s message; no
    library is left behind."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "bad.cpp").write_text(
        'extern "C" int f() { return undefined_name; }\n')
    monkeypatch.setattr(_build, "_PKG", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on bad.cpp"
                       ) as e:
        _build.load_host_library("bad", "bad.cpp")
    assert "undefined_name" in str(e.value)
    assert not [p for p in os.listdir(tmp_path / "out")
                if p.endswith(".so")]
