"""The port's trajectory I/O and molecular utilities against the JAX
package's on the CPU: ``.npy`` / ``.pdb`` / ``.dcd`` round trips,
``readchemfile`` / ``writechemfile``, ``LazyTrajectory`` and
``LazyMultiTrajectory`` element for element, ``savecoords`` and
``saveextrema`` on a learner whose weights come through ``weights.py``
(1e-5 nm), the dihedrals, the standard form and the RMSD coordinates
(1e-5), ``getpdb`` without the network, and every public name of the JAX
package."""

import ast
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

import isokann_tpu as itk
import isokann_tpu.data as JD
from isokann_tpu.models import pairnet as jax_pairnet
from isokann_tpu.utils import lazytraj as JL
from isokann_tpu.utils import molutils as JM
from isokann_tpu.utils import save as JS

import isokann_tpu_torch as itt
from isokann_tpu_torch.utils import molutils as TM
from isokann_tpu_torch.weights import load_jax_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALA = itt.alanine_dipeptide_pdb()
TRP = os.path.join(ROOT, "out", "trpcage.pdb")      # committed, 313 atoms


def _frames(n, seed=0, scale=0.02, pdb=ALA):
    x0 = itt.md.pdbio.read_pdb(pdb).coords.reshape(-1)
    rng = np.random.default_rng(seed)
    return (x0[None] + rng.normal(scale=scale, size=(n, x0.size))).astype(
        np.float32)


# ---- files ----------------------------------------------------------------------

@pytest.mark.parametrize("ext,tol", [("npy", 0.0), ("pdb", 5.1e-5),
                                     ("dcd", 1e-6)])
def test_round_trip_and_chemfile(tmp_path, ext, tol):
    """A tensor written and read back: exact for .npy, 3 decimals of
    Angstrom for .pdb, float32 for .dcd; ``readchemfile`` /
    ``writechemfile`` and JAX's ``load_trajectory`` give the same frames."""
    traj = torch.tensor(_frames(5))
    p = str(tmp_path / f"t.{ext}")
    assert itt.writechemfile(p, traj, top=ALA) == p
    back = itt.load_trajectory(p)
    assert back.shape == (5, 66)
    assert np.abs(back - traj.numpy()).max() <= tol
    np.testing.assert_array_equal(itt.readchemfile(p), back)
    np.testing.assert_array_equal(itt.readchemfile(p, frame=3), back[3])
    np.testing.assert_array_equal(JS.load_trajectory(p), back)
    np.testing.assert_array_equal(itt.load_trajectory(p, stride=2),
                                  back[::2])


def test_save_errors(tmp_path):
    with pytest.raises(ValueError, match="topology"):
        itt.save_trajectory(str(tmp_path / "a.pdb"), np.zeros((1, 6)))
    for f in (lambda p: itt.save_trajectory(p, np.zeros((1, 6))),
              itt.load_trajectory):
        with pytest.raises(ValueError, match="unsupported"):
            f(str(tmp_path / "a.xyz"))


@pytest.mark.parametrize("ext", ["npy", "pdb"])
def test_lazy_trajectories_equal_jax(tmp_path, ext):
    """Single and concatenated lazy views: shape, rows, negative index,
    slices, index lists and ``np.asarray`` equal JAX's, element for
    element."""
    paths = []
    for k, n in enumerate((4, 3)):
        p = str(tmp_path / f"t{k}.{ext}")
        itt.save_trajectory(p, _frames(n, seed=k), top=ALA)
        paths.append(p)
    t, j = itt.LazyTrajectory(paths[0]), JL.LazyTrajectory(paths[0])
    assert t.shape == j.shape == (4, 66) and len(t) == 4
    for key in (0, 3, -1, slice(1, 3), [2, 0]):
        np.testing.assert_array_equal(t[key], j[key])
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    mt = itt.LazyMultiTrajectory(paths)
    mj = JL.LazyMultiTrajectory(paths)
    assert mt.shape == mj.shape == (7, 66)
    for key in (0, 4, 6, -2, slice(2, 6), [5, 1]):
        np.testing.assert_array_equal(mt[key], mj[key])
    np.testing.assert_array_equal(np.asarray(mt), np.asarray(mj))
    np.testing.assert_array_equal(np.asarray(mt)[4:],
                                  itt.load_trajectory(paths[1]))


def test_lazy_single_model_pdb_and_errors(tmp_path):
    t = itt.LazyTrajectory(ALA)
    assert t.shape == (1, 66)
    np.testing.assert_array_equal(t[0], JL.LazyTrajectory(ALA)[0])
    np.save(tmp_path / "bad.npy", np.zeros((2, 3, 4)))
    with pytest.raises(ValueError, match="frames, 3N"):
        itt.LazyTrajectory(str(tmp_path / "bad.npy"))
    with pytest.raises(ValueError, match="unsupported"):
        itt.LazyTrajectory(str(tmp_path / "a.dcd"))


# ---- savecoords / saveextrema ------------------------------------------------------

@pytest.fixture(scope="module")
def isos():
    """12 alanine frames in both packages with the same pairnet weights,
    the frames spread along chi's gradient so that chi is well separated
    (no tie can reorder the saved frames)."""
    jm = jax_pairnet(n=231, key=jax.random.PRNGKey(3))
    tm = load_jax_params(itt.pairnet(231), jax.tree_util.tree_map(
        np.asarray, jm.params))
    tsim = itt.MDSimulation(steps=2, device="cpu")
    jsim = itk.MDSimulation(steps=2)
    x0 = tsim.coords[None].repeat(12, 1)
    xs = x0 + 0.02 * torch.randn(x0.shape, generator=torch.Generator(
        ).manual_seed(0))
    ys = xs[:, None].repeat(1, 2, 1)
    jiso = itk.Iso(data=JD.SimulationData.from_coords(jsim, xs.numpy(),
                                                      ys.numpy()),
                   model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(tsim, xs, ys),
                   model=tm, gen=0)
    chi = np.sort(tiso.chis()[:, 0].numpy())
    assert np.diff(chi).min() > 1e-5
    return jiso, tiso


@pytest.mark.parametrize("ext", ["pdb", "dcd"])
def test_savecoords_matches_jax(isos, tmp_path, ext):
    jiso, tiso = isos
    pt, pj = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
    itt.savecoords(pt, tiso)
    JS.savecoords(pj, jiso)
    t, j = itt.load_trajectory(pt), itt.load_trajectory(pj)
    assert t.shape == j.shape == (12, 66)
    # within 1e-5 nm; a PDB coordinate within 1e-5 nm of a rounding
    # boundary may land one 0.001 Angstrom step (1e-4 nm) away
    assert np.abs(t - j).max() < 1e-5 + (1e-4 if ext == "pdb" else 0)
    # the port's frames: chi-sorted start points, each aligned onto the
    # one before
    order = torch.argsort(tiso.chis()[:, 0])
    want = itt.aligntrajectory(tiso.data.coords[order]).numpy()
    assert np.abs(t - want).max() <= (5.1e-5 if ext == "pdb" else 1e-6)
    chi = tiso.chicoords(torch.tensor(t, dtype=torch.float32))[:, 0]
    assert bool((torch.diff(chi) >= 0).all())


def test_savecoords_options_match_jax(isos, tmp_path):
    """Unsorted, unaligned, and on given numpy coordinates."""
    jiso, tiso = isos
    xs = tiso.data.coords[:5].numpy()
    for kw in (dict(sorted=False, aligned=False), dict(aligned=False),
               dict(sorted=False)):
        pt, pj = str(tmp_path / "t.dcd"), str(tmp_path / "j.dcd")
        itt.savecoords(pt, tiso, coords=xs, **kw)
        JS.savecoords(pj, jiso, coords=xs, **kw)
        assert np.abs(itt.load_trajectory(pt)
                      - itt.load_trajectory(pj)).max() < 1e-5, kw
    itt.savecoords(pt, tiso, sorted=False, aligned=False)
    np.testing.assert_allclose(itt.load_trajectory(pt),
                               tiso.data.coords.numpy(), rtol=0, atol=1e-6)


def test_saveextrema_matches_jax(isos, tmp_path):
    jiso, tiso = isos
    pt, pj = str(tmp_path / "t.pdb"), str(tmp_path / "j.pdb")
    itt.saveextrema(pt, tiso)
    JS.saveextrema(pj, jiso)
    t = itt.load_trajectory(pt)
    assert t.shape == (2, 66)
    np.testing.assert_allclose(t, itt.load_trajectory(pj), atol=1e-5)
    chi = tiso.chis()[:, 0]
    want = tiso.data.coords[torch.stack([chi.argmin(), chi.argmax()])]
    assert np.abs(t - want.numpy()).max() <= 5.1e-5


# ---- molecular utilities --------------------------------------------------------------

def _rot(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def _moved(x, seed=1):
    n = x.shape[0]
    return ((x.reshape(n, -1, 3) @ _rot(seed).T) + [0.3, -0.2, 0.5]
            ).reshape(n, -1).astype(np.float32)


def test_phi_psi_matches_jax():
    x = _frames(6, scale=0.05)
    phi, psi = itt.phi_psi(torch.tensor(x), ALA)
    jphi, jpsi = JM.phi_psi(x, ALA)
    assert phi.shape == psi.shape == (6, 1)
    np.testing.assert_allclose(phi.numpy(), jphi, atol=1e-5)
    np.testing.assert_allclose(psi.numpy(), jpsi, atol=1e-5)
    # numpy frames go to the card unless a device is named
    phi2, _ = itt.phi_psi(x, ALA, device="cpu")
    assert torch.equal(phi2, phi)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            itt.phi_psi(x, ALA)


def test_standardform_matches_jax():
    """The frames aligned onto the first, centered: equal to JAX's at
    1e-5 nm, and the same for a rotated, shifted copy up to the one
    rotation of its first frame."""
    x = _frames(6, scale=0.05)
    sf = itt.standardform(torch.tensor(x))
    np.testing.assert_allclose(sf.numpy(), np.asarray(JM.standardform(x)),
                               atol=1e-5)
    sf2 = itt.standardform(torch.tensor(_moved(x)))
    assert float((itt.align(sf[0], sf2) - sf).abs().max()) < 1e-5
    assert float(itt.aligned_rmsd(torch.tensor(x), sf).max()) < 1e-5


def test_rmsd_coordinates_match_jax():
    """``aligned_rmsd_to`` (all atoms and a subset), ``ReactionCoordsRMSD``
    and ``ca_rmsd`` against JAX at 1e-5 nm; 0 within 1e-5 for a frame
    against itself and a rotated, shifted copy."""
    x = _frames(6, scale=0.05)
    xt = torch.tensor(x)
    for atoms in (None, [0, 4, 8, 14, 16]):
        a = TM.aligned_rmsd_to(xt[0], xt, atoms=atoms)
        np.testing.assert_allclose(a.numpy(),
                                   JM.aligned_rmsd_to(x[0], x, atoms),
                                   atol=1e-5)
        assert float(a[0]) < 1e-5
    rc = itt.ReactionCoordsRMSD(xt[:2])
    out = rc(xt)
    assert out.shape == (6, 2)
    np.testing.assert_allclose(out.numpy(),
                               JM.ReactionCoordsRMSD(x[:2])(x), atol=1e-5)
    assert float(torch.diagonal(out[:2]).abs().max()) < 1e-5
    assert float((rc(torch.tensor(_moved(x))) - out).abs().max()) < 1e-5
    tx = _frames(5, seed=2, pdb=TRP)
    ca = itt.ca_rmsd(torch.tensor(tx), torch.tensor(tx[0]), TRP, TRP)
    np.testing.assert_allclose(ca.numpy(), JM.ca_rmsd(tx, tx[0], TRP, TRP),
                               atol=1e-5)
    ca2 = itt.ca_rmsd(torch.tensor(_moved(tx)), torch.tensor(tx[0]),
                      TRP, TRP)
    assert float(ca[0]) < 1e-5 and float((ca2 - ca).abs().max()) < 1e-5
    sub = itt.ca_rmsd(torch.tensor(tx), torch.tensor(tx[0]), TRP, TRP,
                      residues=range(1, 11))
    np.testing.assert_allclose(
        sub.numpy(), JM.ca_rmsd(tx, tx[0], TRP, TRP, residues=range(1, 11)),
        atol=1e-5)


def test_getpdb_without_network(tmp_path, monkeypatch):
    """The RCSB URL and the path as JAX's; a failed download raises
    ``RuntimeError``.  ``urlretrieve`` is replaced: no test reaches the
    network."""
    calls = []

    def fake(url, path):
        calls.append((url, path))
        with open(path, "w") as f:
            f.write("END\n")

    monkeypatch.setattr(urllib.request, "urlretrieve", fake)
    p = str(tmp_path / "1l2y.pdb")
    assert itt.utils.getpdb("1L2Y", p) == p
    assert calls == [("https://files.rcsb.org/download/1L2Y.pdb", p)]
    monkeypatch.chdir(tmp_path)
    assert itt.utils.getpdb("2JOF") == "2JOF.pdb"

    def fail(url, path):
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", fail)
    with pytest.raises(RuntimeError, match="could not download 1L2Y"):
        itt.utils.getpdb("1L2Y", p)


# ---- public names ----------------------------------------------------------------

def _jax_public_names():
    """The names ``isokann_tpu/__init__.py`` binds: its imports, aliases,
    functions and assignments (read from the source, not imported)."""
    tree = ast.parse(open(os.path.join(ROOT, "isokann_tpu",
                                       "__init__.py")).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets
                      if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_every_jax_public_name_is_exported():
    names = _jax_public_names()
    assert {"readchemfile", "writechemfile", "OpenMM", "LazyTrajectory",
            "serve_dashboard", "plot_training", "standardform"} <= names
    missing = sorted(n for n in names if n not in itt.__all__
                     or not hasattr(itt, n))
    assert not missing
    assert itt.OpenMM is itt.simulators.mdsim
    assert itt.OpenMM.MDSimulation is itt.MDSimulation
    jutils = ast.parse(open(os.path.join(
        ROOT, "isokann_tpu", "utils", "__init__.py")).read())
    for node in jutils.body:
        for a in node.names:
            assert hasattr(itt.utils, a.asname or a.name), a.name
