"""The port's plots against the JAX package's on the same inputs: the
line, scatter, mesh and band data of every figure equal within 1e-5, each
file a PNG; and the package imports without matplotlib (a subprocess that
hides it, JAX and the JAX package), a plot then raising ``ImportError``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import isokann_tpu as itk  # noqa: E402
import isokann_tpu.data as JD  # noqa: E402
from isokann_tpu.models import densenet as jax_densenet  # noqa: E402
from isokann_tpu.models import pairnet as jax_pairnet  # noqa: E402
from isokann_tpu.utils import plots as JP  # noqa: E402

import isokann_tpu_torch as itt  # noqa: E402
from isokann_tpu_torch.utils import plots as TP  # noqa: E402
from isokann_tpu_torch.weights import load_jax_params  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALA = itt.alanine_dipeptide_pdb()
PNG = b"\x89PNG\r\n\x1a\n"


def _fig_data(fig):
    """Every drawn number of ``fig``, axes by axes: line data, each
    collection's offsets, colour values and path vertices (scatter,
    ``fill_between`` bands, meshes), image arrays."""
    out = []
    for ax in fig.axes:
        for ln in ax.get_lines():
            out.append(np.asarray(ln.get_xydata(), float))
        for c in ax.collections:
            out.append(np.asarray(c.get_offsets(), float))
            a = c.get_array()
            if a is not None:
                out.append(np.asarray(a, float).ravel())
            out += [np.asarray(p.vertices, float) for p in c.get_paths()]
        for im in ax.get_images():
            out.append(np.asarray(im.get_array(), float))
    return out


def _assert_same(tfig, jfig, atol=1e-5):
    t, j = _fig_data(tfig), _fig_data(jfig)
    assert len(t) == len(j) and len(t) > 0
    for a, b in zip(t, j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    plt.close(tfig)
    plt.close(jfig)


def _png(path):
    data = open(path, "rb").read()
    assert data[:8] == PNG and len(data) > 1000
    return data


class _Stub:
    """The attributes the plots read of a learner: host arrays for the
    JAX package, tensors for the port."""

    def __init__(self, chi, kchi, coords, torch_):
        conv = torch.tensor if torch_ else np.asarray
        self._chi, self._kchi = conv(chi), conv(kchi)
        self.losses = list(np.linspace(1.0, 0.1, 20))
        self.loggers = [type("V", (), {"losses": [0.5, 0.3],
                                       "iters": [5, 15]})()]
        self.data = type("D", (), {"coords": conv(coords),
                                   "pdbfile": ALA})()

    def chis(self):
        return self._chi

    def koopman(self):
        return self._kchi


def _stubs(d=1, n=24, seed=0):
    rng = np.random.default_rng(seed)
    chi = rng.random((n, d)).astype(np.float32)
    kchi = (chi * 0.9 + 0.05).astype(np.float32)
    x0 = itt.md.pdbio.read_pdb(ALA).coords.reshape(-1)
    coords = (x0[None] + rng.normal(scale=0.05, size=(n, 66))).astype(
        np.float32)
    return _Stub(chi, kchi, coords, True), _Stub(chi, kchi, coords, False)


@pytest.mark.parametrize("name,d", [("plot_training", 1),
                                    ("plot_training", 2),
                                    ("plot_chi", 2), ("scatter_chifix", 1),
                                    ("scatter_ramachandran", 1),
                                    ("scatter_ramachandran", 2),
                                    ("scatter_chi_simplex", 3)])
def test_learner_plots_match_jax(tmp_path, name, d):
    t, j = _stubs(d)
    out = str(tmp_path / "sub" / f"{name}.png")
    tfig = getattr(TP, name)(t, out=out)
    _png(out)
    _assert_same(tfig, getattr(JP, name)(j))


def test_scatter_ramachandran_on_frames_matches_jax():
    """Frames given directly (tensors and numpy arrays to the port, JAX
    arrays to the JAX package, whose test for a learner is ``.data``)."""
    t, j = _stubs(1)
    jx = jnp.asarray(j.data.coords)
    for x in (t.data.coords, t.data.coords.numpy()):
        _assert_same(TP.scatter_ramachandran(x, pdb=ALA),
                     JP.scatter_ramachandran(jx, pdb=ALA))
    _assert_same(TP.scatter_ramachandran(t.data.coords, chi=t.chis(),
                                         pdb=ALA),
                 JP.scatter_ramachandran(jx, chi=j.chis(), pdb=ALA))


def test_plot_reactive_path_matches_jax(tmp_path):
    xi = np.random.default_rng(1).random(30)
    ids = [2, 7, 11, 20]
    tfig = TP.plot_reactive_path(ids, torch.tensor(xi),
                                 out=str(tmp_path / "rp.png"))
    _png(str(tmp_path / "rp.png"))
    _assert_same(tfig, JP.plot_reactive_path(ids, xi))


def test_vismodel_matches_jax(tmp_path):
    jm = jax_densenet([2, 8, 1], key=jax.random.PRNGKey(2))
    tm = load_jax_params(itt.densenet([2, 8, 1]), jax.tree_util.tree_map(
        np.asarray, jm.params))
    tfig = TP.vismodel(tm, grid=12, out=str(tmp_path / "m.png"))
    _png(str(tmp_path / "m.png"))
    _assert_same(tfig, JP.vismodel(jm, grid=12))


@pytest.mark.parametrize("name", ["Doublewell", "MuellerBrown",
                                  "Triplewell"])
def test_plot_potential_matches_jax(tmp_path, name):
    """1-D, 2-D systems; relative 1e-5 of the potential's range."""
    tsim = getattr(itt, name)(device="cpu")
    jsim = getattr(itk, name)()
    tfig = TP.plot_potential(tsim, grid=20, out=str(tmp_path / "v.png"))
    _png(str(tmp_path / "v.png"))
    jfig = JP.plot_potential(jsim, grid=20)
    scale = max(float(np.abs(a).max()) for a in _fig_data(jfig))
    _assert_same(tfig, jfig, atol=1e-5 * scale)


def test_plot_targets_matches_jax(tmp_path):
    """A learner in each package with the same pairnet weights and data:
    chi and the shift-scale target, sorted."""
    jm = jax_pairnet(n=231, key=jax.random.PRNGKey(3))
    tm = load_jax_params(itt.pairnet(231), jax.tree_util.tree_map(
        np.asarray, jm.params))
    tsim = itt.MDSimulation(steps=2, device="cpu")
    xs = tsim.coords[None] + 0.1 * torch.randn(
        (10, 66), generator=torch.Generator().manual_seed(0))
    ys = xs[:, None] + 0.05 * torch.randn(
        (10, 3, 66), generator=torch.Generator().manual_seed(1))
    jiso = itk.Iso(data=JD.SimulationData.from_coords(
        itk.MDSimulation(steps=2), xs.numpy(), ys.numpy()), model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(tsim, xs, ys),
                   model=tm, gen=0)
    # the target divides by Kchi's spread (ROADMAP Queue 3 (h)): frames
    # spread by 0.1 nm give it ~0.05
    assert float(tiso.koopman().max() - tiso.koopman().min()) > 0.03
    tfig = TP.plot_targets(tiso, out=str(tmp_path / "t.png"))
    _png(str(tmp_path / "t.png"))
    _assert_same(tfig, JP.plot_targets(jiso))


def _sweep_rows():
    return [dict(lag=10, timescale=5.0, resolved_frac=0.9, resolved=True,
                 exit_rates_lo=[0.1, 0.15], exit_rates_hi=[0.3, 0.25]),
            dict(lag=20, timescale=9.0, resolved_frac=0.95, resolved=True,
                 exit_rates_lo=[0.08, 0.1], exit_rates_hi=[0.2, 0.18]),
            dict(lag=40, timescale=float("nan"), resolved_frac=0.2,
                 resolved=False)]


def _ck_rows():
    rng = np.random.default_rng(4)
    rows = []
    for k, lag in ((2, 20), (4, 40)):
        est = rng.random((2, 2))
        rows.append(dict(lag=lag, K_est=est.tolist(),
                         K_pred=(est + 0.01).tolist(),
                         dev_lo=(-0.05 * np.ones((2, 2))).tolist(),
                         dev_hi=(0.04 * np.ones((2, 2))).tolist()))
    return rows


@pytest.mark.parametrize("name,rows", [("plot_lag_sweep", _sweep_rows),
                                       ("plot_cktest", _ck_rows)])
def test_lag_plots_match_jax(tmp_path, name, rows):
    """The JAX functions return nothing: their figure is pyplot's current
    one after the call; the port returns its figure."""
    tfig = getattr(TP, name)(rows(), out=str(tmp_path / "t.png"))
    _png(str(tmp_path / "t.png"))
    getattr(JP, name)(rows(), out=str(tmp_path / "j.png"))
    _assert_same(tfig, plt.gcf())


def test_autoplot_throttles(tmp_path):
    t, _ = _stubs(1)
    out = str(tmp_path / "a" / "training.png")
    ap = itt.autoplot(secs=3600, out=out)
    n0 = len(plt.get_fignums())
    ap.log(t)
    first = _png(out)
    os.remove(out)
    ap.log(t)                      # within secs: nothing drawn
    assert not os.path.exists(out)
    assert ap.diagnostic() == ("autoplot", out) and ap.logevery == 1
    assert len(plt.get_fignums()) == n0 and len(first) > 1000


def test_simplex_needs_three_dims():
    t, _ = _stubs(2)
    with pytest.raises(ValueError, match=">= 3"):
        TP.scatter_chi_simplex(t)


def test_imports_without_matplotlib_jax_or_the_jax_package():
    """A fresh interpreter in which matplotlib, jax and ``isokann_tpu``
    cannot be imported still imports the port and its utilities; a plot
    then raises ``ImportError``, and nothing else does."""
    code = (
        "import sys\n"
        "for m in ('matplotlib', 'jax', 'isokann_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import isokann_tpu_torch as itt\n"
        "import isokann_tpu_torch.utils, isokann_tpu_torch.workflows\n"
        "from isokann_tpu_torch.utils import flops, gui, telemetry\n"
        "try:\n"
        "    itt.plot_chi(None)\n"
        "    sys.exit(3)\n"
        "except ImportError as e:\n"
        "    print('ImportError', 'matplotlib' in str(e))\n"
        "t = itt.utils.Timers()\n"
        "with t('x'):\n"
        "    pass\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'jax', 'isokann_tpu') and sys.modules[m]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split("\n")[:2] == ["ImportError True", "[]"]
