"""The rest of the port's data layer against the JAX package's on the CPU:
trajectory pairs, subsampling, trajectory-built datasets and
``Iso.addcoords(n)`` (noiseless, T = 0, against the JAX package's
deterministic path at 1e-5 nm, as ``test_torch_bootstrap.py`` holds the
bootstrap), PDB trajectories byte for byte, the chi-sorted export,
``ExternalSimulation``, ``run_kde_dash`` and the package's public
names."""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
import isokann_tpu.data as JD
import isokann_tpu.md.pdbio as JP
from isokann_tpu.models import pairnet as jax_pairnet

import isokann_tpu_torch as itt
import isokann_tpu_torch.data as TD
import isokann_tpu_torch.md.pdbio as TP
from isokann_tpu_torch import workflows as W
from isokann_tpu_torch.weights import load_jax_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

NPAIRS = 231


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


# --------------------------------------------------------------------------
# trajectory pairs and small utilities
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reverse,stride,lag", [
    (True, 1, 1), (True, 2, 1), (True, 1, 3), (False, 1, 1), (False, 3, 2)])
def test_data_from_trajectory_matches_jax(reverse, stride, lag):
    traj = np.random.default_rng(0).normal(size=(17, 4)).astype(np.float32)
    x, y = TD.data_from_trajectory(torch.tensor(traj), reverse=reverse,
                                   stride=stride, lag=lag)
    jx, jy = JD.data_from_trajectory(jnp.asarray(traj), reverse=reverse,
                                     stride=stride, lag=lag)
    assert np.array_equal(x.numpy(), np.asarray(jx))
    assert np.array_equal(y.numpy(), np.asarray(jy))


def test_data_from_trajectories_matches_jax():
    rng = np.random.default_rng(1)
    trajs = [rng.normal(size=(n, 3)).astype(np.float32) for n in (6, 9, 4)]
    x, y = TD.data_from_trajectories([torch.tensor(t) for t in trajs],
                                     lag=1)
    jx, jy = JD.data_from_trajectories([jnp.asarray(t) for t in trajs],
                                       lag=1)
    assert x.shape == (4 + 7 + 2, 3) and y.shape == (13, 2, 3)
    assert np.array_equal(x.numpy(), np.asarray(jx))
    assert np.array_equal(y.numpy(), np.asarray(jy))


def test_flattenlast_getobs_and_to_device():
    a = torch.arange(24.0).reshape(2, 3, 4)
    ws = itt.WeightedSamples(a, torch.ones(2, 3))
    assert torch.equal(itt.flattenlast(a), a.reshape(2, 12))
    assert torch.equal(itt.flattenlast(ws), a.reshape(2, 12))
    np.testing.assert_array_equal(itt.flattenlast(a).numpy(),
                                  np.asarray(JD.flattenlast(a.numpy())))
    idx = torch.tensor([1])
    x, y = TD.getobs((a[:, 0], ws), idx)
    assert torch.equal(x, a[1:, 0]) and torch.equal(y.values, a[1:])
    tree = {"a": a, "l": [ws, 3], "t": (a,)}
    back = itt.cpu(tree)
    assert back["l"][1] == 3 and torch.equal(back["l"][0].weights,
                                             ws.weights)
    assert itt.device(tree, "cpu")["t"][0].device.type == "cpu"
    assert itt.gpu is itt.device


# --------------------------------------------------------------------------
# subsampling
# --------------------------------------------------------------------------

def _linear_model(xs):
    return xs[..., :1]


def test_subsample_random():
    xs = torch.arange(40.0).reshape(20, 2)
    ys = torch.arange(120.0).reshape(20, 3, 2)
    a = itt.subsample_random(xs, 7, gen=3)
    assert a.shape == (7, 2) and len(set(a[:, 0].tolist())) == 7
    assert torch.equal(a, itt.subsample_random(xs, 7, gen=3))
    assert not torch.equal(a, itt.subsample_random(xs, 7, gen=4))
    x, y = itt.subsample_random((xs, ys), 5, gen=5)
    assert torch.equal(y[:, 0, 0] / 6, x[:, 0] / 2)      # rows paired
    w = itt.subsample_random(itt.WeightedSamples(ys, torch.ones(20, 3)), 4,
                             gen=6)
    assert w.values.shape == (4, 3, 2) and w.weights.shape == (4, 3)
    with pytest.raises(ValueError, match="cannot draw"):
        itt.subsample_random(xs, 21, gen=0)


def test_subsample_uniform_in_chi():
    xs = torch.linspace(0, 1, 101)[:, None]
    a = itt.subsample(_linear_model, xs, 11, gen=7)
    assert a.shape == (11, 1) and len(set(a[:, 0].tolist())) == 11
    assert torch.equal(a, itt.subsample(_linear_model, xs, 11, gen=7))
    # stratified with the edges kept: one point in each eleventh
    assert float(a.min()) == 0.0 and float(a.max()) == 1.0
    ys = xs.reshape(101, 1, 1).repeat(1, 2, 1)
    b = itt.subsample(_linear_model, ys, 5, gen=8)
    assert b.shape == (5, 1)
    x, y = itt.subsample(_linear_model, (xs, ys), 6, gen=9)
    assert torch.equal(x[:, 0], y[:, 0, 0])
    np.testing.assert_array_equal(TD.model_bucketed(_linear_model, xs),
                                  xs.numpy())


# --------------------------------------------------------------------------
# noiseless trajectories against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sims():
    """Both packages' alanine at T = 0: no velocities, no noise, so both
    run the same deterministic lags and bursts (3 steps a lag)."""
    return (itk.MDSimulation(steps=3, temp=0.0),
            itt.MDSimulation(steps=3, temp=0.0, device="cpu"))


def _assert_data_close(t, j):
    for name in ("coords", "propcoords", "features", "propfeatures"):
        a, b = getattr(t, name), getattr(j, name)
        assert tuple(a.shape) == tuple(np.shape(b)), name
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_trajectorydata_linear_matches_jax(sims, reverse):
    jsim, tsim = sims
    t = itt.trajectorydata_linear(tsim, 6, reverse=reverse, gen=0)
    j = JD.trajectorydata_linear(jsim, 6, reverse=reverse, key=0)
    assert len(t) == (4 if reverse else 5) and t.nk == (2 if reverse else 1)
    _assert_data_close(t, j)
    assert float((t.coords[-1] - tsim.coords).abs().max()) > 1e-3


def test_trajectorydata_bursts_matches_jax(sims):
    jsim, tsim = sims
    x0 = tsim.coords.numpy() + np.random.default_rng(2).normal(
        scale=0.003, size=66).astype(np.float32)
    t = itt.trajectorydata_bursts(tsim, 4, 2, x0=torch.tensor(x0), gen=0)
    j = JD.trajectorydata_bursts(jsim, 4, 2, x0=jnp.asarray(x0), key=0)
    assert len(t) == 4 and t.nk == 2
    _assert_data_close(t, j)
    # the default start is the simulation's
    d = itt.trajectorydata_bursts(tsim, 2, 1, gen=0)
    assert len(d) == 2


def test_iso_addcoords_int_matches_jax(sims):
    """``Iso.addcoords(3)``: 3 lagged frames from the last start point,
    then their bursts, appended; the JAX package's at 1e-5 nm."""
    jsim, tsim = sims
    rng = np.random.default_rng(3)
    xs = (tsim.coords.numpy() + rng.normal(scale=0.003, size=(4, 66))
          ).astype(np.float32)
    ys = np.repeat(xs[:, None], 2, axis=1)
    jm = jax_pairnet(n=NPAIRS, key=jax.random.PRNGKey(0))
    tm = load_jax_params(itt.pairnet(NPAIRS), jax.tree_util.tree_map(
        np.asarray, jm.params))
    jiso = itk.Iso(data=JD.SimulationData.from_coords(jsim, xs, ys),
                   model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(
        tsim, torch.tensor(xs), torch.tensor(ys)), model=tm, gen=0)
    jiso.addcoords(3)
    tiso.addcoords(3)
    assert len(tiso.data) == 7
    _assert_data_close(tiso.data, jiso.data)
    # the new start points continue from the old last one
    lag = tiso.data.laggedtrajectory(1, gen=0)
    assert lag.shape == (1, 66)
    tiso.addcoords(np.int64(1))
    assert len(tiso.data) == 8
    # coordinates given as a tensor still work
    tiso.addcoords(tiso.data.coords[:2])
    assert len(tiso.data) == 10


# --------------------------------------------------------------------------
# PDB trajectories and the export
# --------------------------------------------------------------------------

def _traj(n):
    s = TP.read_pdb(itt.alanine_dipeptide_pdb())
    rng = np.random.default_rng(4)
    return (s.coords.ravel()[None] + rng.normal(scale=0.05, size=(n, 66))
            ).astype(np.float32)


@pytest.mark.parametrize("template_kind", ["path", "structure"])
def test_pdb_traj_bytes_equal_jax(tmp_path, template_kind):
    pdb = itt.alanine_dipeptide_pdb()
    traj = _traj(5)
    tt = pdb if template_kind == "path" else TP.read_pdb(pdb)
    jt = pdb if template_kind == "path" else JP.read_pdb(pdb)
    TP.write_pdb_traj(str(tmp_path / "t.pdb"), tt, torch.tensor(traj))
    JP.write_pdb_traj(str(tmp_path / "j.pdb"), jt, traj)
    assert (tmp_path / "t.pdb").read_bytes() == (tmp_path / "j.pdb"
                                                  ).read_bytes()
    back = TP.read_pdb_traj(str(tmp_path / "t.pdb"))
    np.testing.assert_array_equal(back, JP.read_pdb_traj(
        str(tmp_path / "j.pdb")))
    assert back.shape == (5, 66)
    np.testing.assert_allclose(back, traj, atol=1e-4)
    # one frame, flat
    TP.write_pdb_traj(str(tmp_path / "t1.pdb"), tt, traj[0])
    JP.write_pdb_traj(str(tmp_path / "j1.pdb"), jt, traj[0])
    assert (tmp_path / "t1.pdb").read_bytes() == (tmp_path / "j1.pdb"
                                                   ).read_bytes()


@pytest.fixture(scope="module")
def export_isos():
    """16 frames and bursts of alanine in both packages with the same chi
    weights (at T = 300 K noise, frames from the port's trajectory)."""
    tsim = itt.MDSimulation(steps=3, device="cpu")
    jsim = itk.MDSimulation(steps=3)
    xs = tsim.laggedtrajectory(16, gen=5)
    ys = tsim.propagate(xs, 2, gen=6)
    jm = jax_pairnet(n=NPAIRS, key=jax.random.PRNGKey(1))
    tm = load_jax_params(itt.pairnet(NPAIRS), jax.tree_util.tree_map(
        np.asarray, jm.params))
    jiso = itk.Iso(data=JD.SimulationData.from_coords(
        jsim, xs.numpy(), ys.numpy()), model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(tsim, xs, ys),
                   model=tm, gen=0)
    return jiso, tiso


def test_exportdata_matches_jax(export_isos, tmp_path):
    jiso, tiso = export_isos
    dd = itt.exportdata(tiso.data.propcoords, tiso.chicoords, tiso.data.sim,
                        str(tmp_path / "t.pdb"))
    jdd = JD.exportdata(np.asarray(jiso.data.propcoords), jiso.chicoords,
                        jiso.data.sim, str(tmp_path / "j.pdb"))
    assert dd.shape == jdd.shape == (32, 66)
    np.testing.assert_allclose(dd, jdd, atol=1e-6)
    back = itt.md.pdbio.read_pdb_traj(str(tmp_path / "t.pdb"))
    np.testing.assert_allclose(back, dd, atol=1e-4)
    chi = tiso.chicoords(torch.tensor(dd))[:, 0].numpy()
    assert np.all(np.diff(chi) >= 0)


def test_exportsorted_matches_jax(export_isos, tmp_path):
    jiso, tiso = export_isos
    p = itt.exportsorted(tiso, str(tmp_path / "t.pdb"))
    JD.exportsorted(jiso, str(tmp_path / "j.pdb"))
    back = TP.read_pdb_traj(p)
    assert back.shape == (len(tiso.data), 66)
    np.testing.assert_allclose(
        back, TP.read_pdb_traj(str(tmp_path / "j.pdb")), atol=1e-4)
    # each frame is its chi-sorted start point, rotated
    order = np.argsort(tiso.chis()[:, 0].numpy())
    raw = tiso.data.coords[torch.as_tensor(order)]
    d = torch.stack([itt.aligned_rmsd(torch.tensor(b, dtype=torch.float32),
                                      r[None])[0]
                     for b, r in zip(back, raw)])
    assert float(d.max()) < 1e-4


# --------------------------------------------------------------------------
# ExternalSimulation, SimulationData helpers, workflows, public names
# --------------------------------------------------------------------------

def test_external_simulation_errors_match_jax():
    t, j = itt.ExternalSimulation(_lagtime=0.5), itk.ExternalSimulation(
        _lagtime=0.5)
    for sim in (t, j):
        assert sim.lagtime == 0.5 and sim.featurizer is None
        with pytest.raises(ValueError, match="no intrinsic dimension"):
            sim.dim
        with pytest.raises(ValueError, match="cannot propagate"):
            sim.propagate(np.zeros((1, 3)), 2)
    assert repr(t) == repr(j)
    assert isinstance(t, itt.IsoSimulation)
    assert itt.simulators.ExternalSimulation is itt.ExternalSimulation


class _NoDim(itt.ExternalSimulation):
    @property
    def dim(self):
        raise AssertionError("sim.dim touched")


def test_iso_on_external_data_never_touches_dim():
    rng = np.random.default_rng(7)
    fx = torch.tensor(rng.uniform(size=(24, 5)).astype(np.float32))
    fy = torch.tensor(rng.uniform(size=(24, 3, 5)).astype(np.float32))
    sim = _NoDim(pdbfile="x.pdb", _lagtime=2.0)
    data = itt.SimulationData.from_coords(sim, fx, fy, features=(fx, fy))
    for model in (itt.smallnet(5, gen=0), None):
        iso = itt.Iso(data=data, model=model, gen=1,
                      opt=itt.AdamRegularized())
        iso.run(3)
        assert np.all(np.isfinite(iso.losses))
        with warnings.catch_warnings():
            # an untrained chi on random features resolves no slow process
            warnings.simplefilter("ignore")
            repr(iso), iso.chis(), iso.koopman(), iso.rates()
        assert iso.simulationtime() == 24 * 3 * 2.0
    assert data.pdbfile == "x.pdb"


def test_from_trajectory_and_features_of():
    traj = torch.tensor(np.random.default_rng(8).normal(size=(12, 6)),
                        dtype=torch.float32)
    d = itt.SimulationData.from_trajectory(traj)
    j = JD.SimulationData.from_trajectory(traj.numpy())
    assert isinstance(d.sim, itt.ExternalSimulation) and d.pdbfile is None
    assert len(d) == 10 and d.nk == 2
    np.testing.assert_array_equal(d.features.numpy(), np.asarray(j.features))
    np.testing.assert_array_equal(d.propfeatures.numpy(),
                                  np.asarray(j.propfeatures))
    d2 = itt.SimulationData.from_trajectory(traj, reverse=False, lag=2,
                                            featurizer=lambda x: 2 * x)
    assert len(d2) == 10 and d2.nk == 1
    assert torch.equal(d2.features_of(traj[:3]), 2 * traj[:3])
    assert d2.features_of(traj[:3].double()).dtype == torch.float32


def test_free_functions_and_run_kde_dash():
    sim = itt.Doublewell(device="cpu")
    iso = itt.Iso(sim=sim, nx=16, nk=4, gen=0, opt=itt.AdamRegularized())
    itt.run(iso, 3)
    assert len(iso.losses) == 3
    assert torch.equal(itt.chis(iso), iso.chis())
    assert torch.equal(itt.koopman(iso), iso.koopman())
    assert torch.equal(itt.chicoords(iso, iso.data.coords), iso.chis())
    assert itt.simulationtime(iso) == iso.simulationtime()
    d = itt.addcoords(iso.data, iso.data.coords[:2], gen=1)
    assert len(d) == 18
    assert len(itt.resample_strat(iso.data, iso.model, 3, gen=2)) == 19
    assert len(itt.resample_kde(iso.data, iso.model, 2, gen=3)) == 18
    itt.run_kde(iso, generations=1, iter=2, kde=2)
    assert len(iso.data) == 18
    assert W.run_kde_dash(iso, generations=2, iter=2, kde=3) is None
    assert len(iso.data) == 24 and len(iso.losses) == 9
    assert itt.run_kde_dash is W.run_kde_dash
    plots = W.run_kde_dash(iso, generations=1, iter=2, kde=1, plots=[])
    assert len(plots) == 1 and len(plots[0].axes) == 3
    import matplotlib.pyplot as plt
    plt.close(plots[0])
    assert len(iso.data) == 25
    traj = itt.trajectory(sim, T=0.5, gen=0)
    assert traj.shape[-1] == 1
    assert itt.laggedtrajectory(iso.data, 2, gen=0).shape == (2, 1)
    assert itt.propagate(sim, iso.data.coords[:2], 3, gen=0).shape \
        == (2, 3, 1)


def test_public_names_resolve():
    """Every name of the port's ``__all__`` resolves, and each one the JAX
    package exports too is there under the same name."""
    missing = [n for n in itt.__all__ if not hasattr(itt, n)]
    assert not missing
    shared = set(itt.__all__) & set(dir(itk))
    for name in ("bootstrap", "data_from_trajectory", "subsample_inds",
                 "exportsorted", "picking_aligned", "aligntrajectory",
                 "ExternalSimulation", "IsoSimulation", "run_kde_dash",
                 "escalate_lag", "alanine_dipeptide_pdb", "atom_indices",
                 "OpenMMSimulation", "residual_ritz", "koopman"):
        assert name in shared, name
    assert itt.OpenMMSimulation is itt.MDSimulation
    pdb = itt.alanine_dipeptide_pdb()
    assert np.array_equal(itt.atom_indices(pdb, "heavy"),
                          itk.atom_indices(pdb, "heavy"))
    assert os.path.exists(pdb)
