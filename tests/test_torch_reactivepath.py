"""The port's reactive paths (``analysis/reactivepath.py``) against the
JAX package's on the CPU: the same pair masks and endpoint selections,
the Onsager-Machlup costs at 1e-5 relative, the dense min-plus distances
at 1e-5 relative and the same path ids on both of the port's routes (the
host's scipy Bellman-Ford and the dense min-plus iterations), the
written path at 1e-5 nm.  Alanine frames are committed golden frames,
chi the same pairnet weights in both packages
(``weights.load_jax_params``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
import isokann_tpu.analysis.reactivepath as JR
from isokann_tpu.models import pairnet as jax_pairnet
from isokann_tpu.ops.align import aligned_rmsd as jax_aligned_rmsd
from isokann_tpu.ops.align import aligntrajectory as jax_aligntrajectory

import isokann_tpu_torch as itt
import isokann_tpu_torch.analysis.reactivepath as TR
from isokann_tpu_torch.md.pdbio import read_pdb_traj
from isokann_tpu_torch.weights import load_jax_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "golden",
                      "ala2_vacuum_msm.npz")
NPAIRS = 231


def _center(x):
    s = x.reshape(x.shape[:-1] + (-1, 3))
    return (s - s.mean(axis=-2, keepdims=True)).reshape(x.shape)


@pytest.fixture(scope="module")
def isos():
    """24 committed alanine frames x 2 bursts (centered) in both
    packages, chi the same pairnet(231) weights (seed 5)."""
    z = np.load(GOLDEN)
    sub = np.random.default_rng(6).choice(len(z["xs"]), 24, replace=False)
    xs = _center(z["xs"][sub]).astype(np.float32)
    ys = _center(z["ys"][sub][:, :2]).astype(np.float32)
    jsim = itk.MDSimulation(steps=10)
    tsim = itt.MDSimulation(steps=10, device="cpu")
    jm = jax_pairnet(n=NPAIRS, key=jax.random.PRNGKey(5))
    tm = load_jax_params(itt.pairnet(NPAIRS), jax.tree_util.tree_map(
        np.asarray, jm.params))
    jiso = itk.Iso(data=itk.SimulationData.from_coords(jsim, xs, ys),
                   model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(
        tsim, torch.tensor(xs), torch.tensor(ys)), model=tm, gen=0)
    return jiso, tiso


def _dag(n, seed):
    """A random DAG (edges i -> j, i < j, some negative) as a dense cost
    matrix with inf for no edge."""
    rng = np.random.default_rng(seed)
    A = np.full((n, n), np.inf)
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < 0.3:
                A[i, j] = rng.normal(0.2, 0.5)
    return A


# ---- host selections --------------------------------------------------------

@pytest.mark.parametrize("minjump,maxjump", [(0.0, 0.4), (0.1, 0.5),
                                             (0.0, 1.0)])
def test_dtmask_matches_jax(minjump, maxjump):
    xi = np.random.default_rng(0).random(40)
    got = TR.dtmask(xi, minjump, maxjump)
    ref = JR.dtmask(xi, minjump, maxjump)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)
    i, j, v = TR.dtmask(np.array([0.0, 0.5, 0.9, 0.2]), 0.0, 0.4)
    pairs = set(zip(i.tolist(), j.tolist()))
    assert (0, 3) in pairs and (3, 1) in pairs and (0, 1) not in pairs


@pytest.mark.parametrize("method", [
    TR.QuantilePath(0.1), TR.FullPath(), TR.MaxPath(), TR.FromToPath(5, 7)])
def test_fromto_matches_jax(method):
    xi = np.linspace(0, 1, 100)
    jmethod = getattr(JR, type(method).__name__)(**method.__dict__)
    f, t = TR.fromto(method, xi)
    jf, jt = JR.fromto(jmethod, xi)
    assert np.array_equal(f, jf) and np.array_equal(t, jt)
    if isinstance(method, TR.QuantilePath):
        assert np.all(xi[f] < 0.1) and np.all(xi[t] > 0.9)
    else:
        assert (f[0], t[0]) == {TR.FullPath: (0, 99), TR.MaxPath: (0, 99),
                                TR.FromToPath: (5, 7)}[type(method)]
    with pytest.raises(TypeError):
        TR.fromto("nope", xi)


def test_fin_dim_loglikelihood():
    dx = np.array([0.1, 1.0, 0.3])
    dt = np.array([0.5, 0.5, 0.2])
    np.testing.assert_array_equal(TR.fin_dim_loglikelihood(dx, dt, 0.7, 66),
                                  JR.fin_dim_loglikelihood(dx, dt, 0.7, 66))
    assert (TR.fin_dim_loglikelihood(0.1, 0.5, 1.0, 3)
            > TR.fin_dim_loglikelihood(1.0, 0.5, 1.0, 3))


# ---- Bellman-Ford -----------------------------------------------------------

def test_bellman_ford_dense_simple():
    inf = np.inf
    A = torch.tensor([[inf, 1.0, 10.0], [inf, inf, 1.0], [inf, inf, inf]])
    d, par = TR.bellman_ford_dense(A, [0])
    assert float(d[2]) == pytest.approx(2.0)
    assert par.tolist() == [-1, 0, 1]
    assert TR.shortestpath(A, 0, 2) == [0, 1, 2]


@pytest.mark.parametrize("seed", [0, 1])
def test_bellman_ford_dense_matches_jax(seed):
    """A random 40-node DAG with negative costs from two sources: the
    distances at 1e-5 relative, the same parents and paths; the host
    route's path equals the dense one."""
    A = _dag(40, seed)
    src = [0, 3]
    d, par = TR.bellman_ford_dense(torch.tensor(A, dtype=torch.float32),
                                   src)
    jd, jpar = JR.bellman_ford_dense(A, src)
    jd = np.asarray(jd)
    fin = np.isfinite(jd)
    assert np.array_equal(np.isfinite(d.numpy()), fin)
    np.testing.assert_allclose(d.numpy()[fin], jd[fin], rtol=1e-5,
                               atol=1e-5 * np.abs(jd[fin]).max())
    assert np.array_equal(par.numpy(), np.asarray(jpar))
    tgt = [37, 38, 39]
    path = TR.shortestpath_dense_device(torch.tensor(A, dtype=torch.float32),
                                        src, tgt)
    assert path == JR.shortestpath_dense_device(A, src, tgt)
    i, j = np.nonzero(np.isfinite(A))
    assert TR.shortestpath_sparse(40, i, j, A[i, j], src, tgt) == path


# ---- reactive paths ---------------------------------------------------------

@pytest.mark.parametrize("device", [False, True])
def test_reactive_path_1d(device):
    """Points on a line with chi = position: a monotone chain of >= 3
    frames, the JAX package's ids."""
    rng = np.random.default_rng(0)
    n = 50
    chi = rng.random(n)
    coords = np.zeros((n, 3))
    coords[:, 0] = chi
    kw = dict(sigma=0.3, maxjump=0.4)
    ids = TR.reactive_path(chi, torch.tensor(coords, dtype=torch.float32),
                           method=TR.QuantilePath(0.1), device=device, **kw)
    assert len(ids) >= 3
    assert np.all(np.diff(chi[ids]) > 0)
    assert ids == JR.reactive_path(chi, coords.astype(np.float32),
                                   method=JR.QuantilePath(0.1), **kw)


@pytest.mark.parametrize("device", [False, True])
def test_reactive_path_not_edge_count_biased(device):
    """The raw (unshifted) costs thread the samples of a smooth
    transition (the JAX package's test)."""
    n = 21
    chi = np.linspace(0.0, 1.0, n)
    coords = np.zeros((n, 6))
    coords[:, 0] = np.linspace(0.5, 1.5, n)
    coords[:, 1] = 0.01 * np.random.default_rng(1).standard_normal(n)
    ids = TR.reactive_path(chi, torch.tensor(coords, dtype=torch.float32),
                           sigma=0.5, maxjump=1.0,
                           method=TR.QuantilePath(0.1), device=device)
    assert len(ids) >= n // 2
    assert np.all(np.diff(chi[ids]) > 0)


def test_pair_costs_match_jax(isos):
    """The masked pairs' aligned RMSDs and -log p on alanine frames, with
    mass weights, at 1e-5 relative."""
    _, tiso = isos
    xs = tiso.data.coords
    chi = tiso.chis()[:, 0].numpy()
    w = tiso.data.sim.masses()
    i, j, cost = TR.pair_costs(xs, chi, sigma=1.0, maxjump=0.5, weights=w)
    ji, jj, dts = JR.dtmask(chi, 0.0, 0.5)
    assert np.array_equal(i, ji) and np.array_equal(j, jj) and len(i) > 50
    x = xs.numpy()
    dx = np.asarray(jax_aligned_rmsd(
        jnp.asarray(x[i].reshape(-1, 22, 3)),
        jnp.asarray(x[j].reshape(-1, 22, 3)),
        weights=jnp.asarray(w.numpy()), flat=False))
    ref = -JR.fin_dim_loglikelihood(dx, dts, 1.0, 66)
    np.testing.assert_allclose(cost, ref, rtol=1e-5)


def test_save_reactive_path_matches_jax(isos, tmp_path):
    """``save_reactive_path`` on alanine: the JAX package's ids, the same
    ids from the dense route, the written frames at 1e-5 nm, read back."""
    jiso, tiso = isos
    out, jout = str(tmp_path / "rp.pdb"), str(tmp_path / "jrp.pdb")
    ids = TR.save_reactive_path(tiso, sigma=1.0, maxjump=1.0, out=out)
    jids = JR.save_reactive_path(jiso, sigma=1.0, maxjump=1.0, out=jout)
    assert ids == list(jids) and len(ids) >= 2
    chi = tiso.chis()[:, 0]
    dense = TR.reactive_path(chi, tiso.data.coords, sigma=1.0, maxjump=1.0,
                             weights=tiso.data.sim.masses(), device=True)
    assert dense == ids
    # the path as aligned for writing, mass-weighted, at 1e-5 nm
    w = tiso.data.sim.masses()
    path = itt.aligntrajectory(tiso.data.coords[ids], weights=w)
    jpath = jax_aligntrajectory(jiso.data.coords[np.asarray(ids)],
                                weights=jnp.asarray(w.numpy()))
    np.testing.assert_allclose(path.numpy(), np.asarray(jpath), atol=1e-5)
    # the files: that path, rounded to the PDB's 1e-4 nm
    got, ref = read_pdb_traj(out), read_pdb_traj(jout)
    assert got.shape == (len(ids), 66)
    np.testing.assert_allclose(got, path.numpy(), atol=0.51e-4)
    np.testing.assert_allclose(got, ref, atol=1.01e-4)


@pytest.mark.parametrize("device", [False, True])
def test_tied_minimum_gives_an_empty_path(device):
    """chi tied at its minimum (a start point twice in the data): the
    5% quantile path has no source, and the path is empty on both
    routes, as the JAX package's native route returns it."""
    chi = np.array([0.3, 0.1, 0.5, 0.1, 0.9, 0.7])
    coords = np.random.default_rng(2).normal(size=(6, 6)).astype(np.float32)
    assert len(TR.fromto(TR.QuantilePath(0.05), chi)[0]) == 0
    assert TR.reactive_path(chi, torch.tensor(coords), device=device) == []
    assert JR.reactive_path(chi, coords) == []


def test_save_reactive_path_empty_warns(isos, tmp_path):
    _, tiso = isos
    out = tmp_path / "none.pdb"
    with pytest.warns(UserWarning, match="reactive path is empty"):
        ids = TR.save_reactive_path(tiso, maxjump=0.0, out=str(out))
    assert ids == [] and not out.exists()


def test_workflow_reactive_path(tmp_path):
    """The JAX workflow test's end (``tests/test_workflow.py:37-42``) on
    the port: bursts, training, the reactive path written."""
    sim = itt.MDSimulation(steps=10, device="cpu")
    data = itt.trajectorydata_bursts(sim, 12, 2, gen=0)
    iso = itt.Iso(data=data, gen=1, minibatch=0, opt=itt.AdamRegularized())
    iso.run(5)
    iso.run_kde(generations=1, iter=5, kde=2)
    out = str(tmp_path / "rp.pdb")
    ids = itt.save_reactive_path(iso, sigma=1.0, maxjump=1.0, out=out,
                                 method=itt.analysis.QuantilePath(0.2))
    assert len(ids) >= 2 and os.path.exists(out)
    assert read_pdb_traj(out).shape == (len(ids), sim.dim)
    assert np.all(np.isfinite(iso.rates()))


def test_arrays_go_to_the_card():
    """Coordinates given as numpy go to the card; with no GPU that
    raises (tensors stay on their device)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.reactive_path(np.linspace(0, 1, 5), np.zeros((5, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.bellman_ford_dense(np.zeros((3, 3)), [0])
