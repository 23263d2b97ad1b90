"""Port parity of the Amber prmtop / rst7 importer (``md/amberio.py``) and
of ``MDSimulation.from_system``: every case of the JAX package's
``tests/test_amberio.py`` prmtop part and of ``test_cmap.py``'s prmtop
round trip through the port at the JAX test's bounds; the text the port
writes equals the JAX package's, the tables it reads equal the JAX
package's from the same file (indices exactly, values 1e-6); and
``from_system`` takes the expected route for alanine (fused), trp-cage in
OBC2 (hybrid), the PME box with rigid waters (neighbor) and the AT
dinucleotide with HBonds (plain), each holding 10 noiseless steps against
the JAX package's ``from_system`` run in float64 (CPU)."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md import amberio as JA
from isokann_tpu.md import build_system as jax_build_system
from isokann_tpu.md import integrators as JI
from isokann_tpu.md import pdbio as JP
from isokann_tpu.md.forces import force_flat as jax_force_flat
from isokann_tpu.md.system import system_from_tables as jax_tables

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import amberio as A
from isokann_tpu_torch.md import gb_kernel as GB
from isokann_tpu_torch.md import langevin_kernel as LK
from isokann_tpu_torch.md import neighbor_kernel as NK
from isokann_tpu_torch.md.cmap import has_cmap
from isokann_tpu_torch.md.fixtures import alanine_dipeptide_pdb, build_nucleic
from isokann_tpu_torch.md.forces import (energy_terms, force_flat,
                                         potential_energy_flat)
from isokann_tpu_torch.md.pdbio import read_pdb
from isokann_tpu_torch.md.solvate import water_constraint_pairs
from isokann_tpu_torch.md.system import build_system, system_from_tables

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

TRPCAGE = os.path.join(os.path.dirname(__file__), "..", "out",
                       "trpcage.pdb")
TABLES = ("bond_idx", "bond_k", "bond_r0", "angle_idx", "angle_k",
          "angle_t0", "dih_idx", "dih_pk", "dih_phase", "dih_n", "charges",
          "rmin_half", "eps", "masses", "excl_idx", "excl_qq", "excl_lj",
          "gb_radii", "gb_scales", "cmap_idx", "cmap_type", "cmap_coefs",
          "ewald_kvecs", "ewald_coefs")


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def assert_tables_match(jsys, tsys):
    """The port's system tables against the JAX package's: indices
    exactly, values within 1e-6 (relative to each table's scale), and the
    same method, cutoff, box and dispersion correction."""
    for name in TABLES:
        j, t = getattr(jsys, name), getattr(tsys, name)
        j = np.zeros(0) if j is None else np.asarray(j)
        t = np.zeros(0) if t is None else _np(t)
        assert j.size == t.size, name
        if j.size == 0:
            continue
        assert j.shape == t.shape, name
        if np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            scale = max(1.0, float(np.abs(j).max()))
            np.testing.assert_allclose(t / scale, j / scale, atol=1e-6,
                                       err_msg=name)
    assert tsys.method == jsys.method
    assert tsys.cutoff == pytest.approx(jsys.cutoff, rel=1e-12)
    assert tsys.implicit == jsys.implicit
    assert tsys.use_dispersion == jsys.use_dispersion
    assert tsys.ewald_alpha == pytest.approx(float(jsys.ewald_alpha),
                                             rel=1e-9)
    if jsys.box is None:
        assert tsys.box is None
    else:
        np.testing.assert_allclose(tsys.box, jsys.box, rtol=1e-12)


def compare_terms(sys_a, sys_b, x, rtol=2e-4, atol=2e-3):
    """The JAX test's ``_compare_terms``: per-term energies at (rtol,
    atol) and forces within 5e-4 of max(1, max|f|)."""
    x = torch.as_tensor(np.asarray(x, np.float32)).reshape(-1, 3)
    ta, tb = energy_terms(sys_a, x), energy_terms(sys_b, x)
    assert set(ta) == set(tb)
    for k in ta:
        np.testing.assert_allclose(float(ta[k]), float(tb[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
    fa = force_flat(sys_a, x.reshape(-1)).numpy()
    fb = force_flat(sys_b, x.reshape(-1)).numpy()
    scale = max(1.0, float(np.abs(fa).max()))
    np.testing.assert_allclose(fb / scale, fa / scale, atol=5e-4)


@pytest.fixture(scope="module")
def ala():
    pdb = alanine_dipeptide_pdb()
    x = read_pdb(pdb).coords.astype(np.float32)
    return (build_system(pdb, method="NoCutoff", device="cpu"),
            jax_build_system(pdb, method="NoCutoff"), x)


# ---- prmtop ---------------------------------------------------------------

def test_prmtop_roundtrip_vacuum(ala, tmp_path):
    tsys, jsys, x = ala
    path = str(tmp_path / "ala.prmtop")
    text = A.save_prmtop(tsys, path)
    assert text == JA.save_prmtop(jsys, str(tmp_path / "ala_jax.prmtop"))
    sys2, coords, meta = A.system_from_prmtop(path, method="NoCutoff",
                                              device="cpu")
    assert coords is None and sys2.natoms == tsys.natoms
    np.testing.assert_array_equal(sys2.excl_idx.numpy(),
                                  tsys.excl_idx.numpy())
    np.testing.assert_allclose(sys2.excl_qq.numpy(), tsys.excl_qq.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(sys2.excl_lj.numpy(), tsys.excl_lj.numpy(),
                               atol=1e-6)
    compare_terms(tsys, sys2, x)
    jsys2, _, jmeta = JA.system_from_prmtop(path, method="NoCutoff")
    assert_tables_match(jsys2, sys2)
    assert meta["atom_names"] == jmeta["atom_names"]
    assert meta["amber_types"] == jmeta["amber_types"]


def test_prmtop_roundtrip_gb(tmp_path):
    """OBC2 radii and scales survive the prmtop (RADII / SCREEN); slow in
    the JAX package for its jit, seconds here."""
    pdb = alanine_dipeptide_pdb()
    tsys = build_system(pdb, implicit="obc2", device="cpu")
    jsys = jax_build_system(pdb, implicit="obc2")
    x = read_pdb(pdb).coords.astype(np.float32)
    path = str(tmp_path / "ala_gb.prmtop")
    assert A.save_prmtop(tsys, path) == JA.save_prmtop(
        jsys, str(tmp_path / "jax.prmtop"))
    sys2, _, _ = A.system_from_prmtop(path, implicit="obc2", device="cpu")
    np.testing.assert_allclose(sys2.gb_radii.numpy(),
                               tsys.gb_radii.numpy(), atol=1e-7)
    np.testing.assert_allclose(sys2.gb_scales.numpy(),
                               tsys.gb_scales.numpy(), atol=1e-7)
    compare_terms(tsys, sys2, x)
    assert_tables_match(JA.system_from_prmtop(path, implicit="obc2")[0],
                        sys2)


def test_rst7_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    coords = rng.normal(size=(17, 3)) * 0.5 + 2.0
    box = (2.5, 2.6, 2.7)
    path = tmp_path / "c.rst7"
    A.write_rst7(str(path), coords, box=box)
    JA.write_rst7(str(tmp_path / "j.rst7"), coords, box=box)
    assert path.read_text() == (tmp_path / "j.rst7").read_text()
    c2, v2, b2 = A.read_rst7(str(path))
    np.testing.assert_allclose(c2, coords, atol=1e-7)
    assert v2 is None
    np.testing.assert_allclose(b2, box, atol=1e-7)


def test_rst7_velocities_and_oblique_box(tmp_path):
    """Velocities after the coordinates come back in nm/ps, as in the JAX
    package; a non-rectangular box raises in both."""
    n = 3
    xyz = np.arange(3 * n, dtype=float).reshape(n, 3) * 0.1
    vel = np.ones((n, 3)) * 0.5
    vals = list(xyz.reshape(-1) * 10.0) + list(vel.reshape(-1))
    lines = ["title", "%5d" % n]
    for i in range(0, len(vals), 6):
        lines.append("".join("%12.7f" % v for v in vals[i:i + 6]))
    p = tmp_path / "v.rst7"
    p.write_text("\n".join(lines + ["%12.7f" * 6 % (20, 20, 20, 90, 90,
                                                     90)]) + "\n")
    got, want = A.read_rst7(str(p)), JA.read_rst7(str(p))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[1], vel * 20.455 / 10.0)
    q = tmp_path / "o.rst7"
    q.write_text("\n".join(lines + ["%12.7f" * 6 % (20, 20, 20, 90, 109,
                                                     90)]) + "\n")
    with pytest.raises(ValueError, match="rectangular"):
        A.read_rst7(str(q))


HANDWRITTEN = """%VERSION  VERSION_STAMP = V0001.000
%FLAG TITLE
%FORMAT(20a4)
test
%FLAG POINTERS
%FORMAT(10I8)
       4       2       1       2       0       2       0       2       0       0
       5       1       2       0       2       2       2       2       2       0
       0       0       0       0       0       0       0       0       0       0
       0
%FLAG ATOM_NAME
%FORMAT(20a4)
C1  C2  C3  H1
%FLAG CHARGE
%FORMAT(5E16.8)
  1.82223000D+00 -1.82223000D+00  1.82223000D+00 -1.82223000D+00
%FLAG MASS
%FORMAT(5E16.8)
  1.20100000E+01  1.20100000E+01  1.20100000E+01  1.00800000E+00
%FLAG ATOM_TYPE_INDEX
%FORMAT(10I8)
       1       1       1       2
%FLAG NUMBER_EXCLUDED_ATOMS
%FORMAT(10I8)
       3       2       1       1
%FLAG NONBONDED_PARM_INDEX
%FORMAT(10I8)
       1       2       2       3
%FLAG RESIDUE_LABEL
%FORMAT(20a4)
LIG
%FLAG RESIDUE_POINTER
%FORMAT(10I8)
       1
%FLAG BOND_FORCE_CONSTANT
%FORMAT(5E16.8)
  3.00000000E+02  3.40000000E+02
%FLAG BOND_EQUIL_VALUE
%FORMAT(5E16.8)
  1.50000000E+00  1.09000000E+00
%FLAG ANGLE_FORCE_CONSTANT
%FORMAT(5E16.8)
  5.00000000E+01  4.00000000E+01
%FLAG ANGLE_EQUIL_VALUE
%FORMAT(5E16.8)
  1.91113553E+00  2.00000000E+00
%FLAG DIHEDRAL_FORCE_CONSTANT
%FORMAT(5E16.8)
  1.40000000E+00  2.00000000E-01
%FLAG DIHEDRAL_PERIODICITY
%FORMAT(5E16.8)
  3.00000000E+00  2.00000000E+00
%FLAG DIHEDRAL_PHASE
%FORMAT(5E16.8)
  0.00000000E+00  3.14159265E+00
%FLAG LENNARD_JONES_ACOEF
%FORMAT(5E16.8)
  1.04308023E+06  1.00000000E+04  1.00000000E+02
%FLAG LENNARD_JONES_BCOEF
%FORMAT(5E16.8)
  6.75612247E+02  2.00000000E+01  5.00000000E+00
%FLAG BONDS_INC_HYDROGEN
%FORMAT(10I8)
       6       9       2
%FLAG BONDS_WITHOUT_HYDROGEN
%FORMAT(10I8)
       0       3       1       3       6       1
%FLAG ANGLES_INC_HYDROGEN
%FORMAT(10I8)
%FLAG ANGLES_WITHOUT_HYDROGEN
%FORMAT(10I8)
       0       3       6       1       3       6       9       2
%FLAG DIHEDRALS_INC_HYDROGEN
%FORMAT(10I8)
%FLAG DIHEDRALS_WITHOUT_HYDROGEN
%FORMAT(10I8)
       0       3       6       9       1       0       3      -6       9       2
%FLAG EXCLUDED_ATOMS_LIST
%FORMAT(10I8)
       2       3       4       3       4       4
%FLAG AMBER_ATOM_TYPE
%FORMAT(20a4)
CT  CT  CT  HC
"""


def test_prmtop_handwritten_fixture(tmp_path):
    """The JAX test's 4-atom chain: D exponents, a two-term dihedral with
    a negative third index on the second term, no SCEE / SCNB sections
    (defaults 1.2 / 2.0) and 1-4 exclusions; the tables equal the JAX
    package's and its section parse is the same."""
    path = tmp_path / "tiny.prmtop"
    path.write_text(HANDWRITTEN)
    assert A.load_prmtop(str(path)) == JA.load_prmtop(str(path))
    sys, coords, meta = A.system_from_prmtop(str(path), method="NoCutoff",
                                             device="cpu")
    assert sys.natoms == 4
    np.testing.assert_allclose(sys.charges.numpy(), [0.1, -0.1, 0.1, -0.1],
                               atol=1e-6)
    assert meta["atom_names"] == ["C1", "C2", "C3", "H1"]
    assert tuple(sys.bond_idx.shape) == (3, 2)
    np.testing.assert_allclose(
        sorted(float(k) for k in sys.bond_k),
        sorted([300 * 4.184 * 100] * 2 + [340 * 4.184 * 100]), rtol=1e-6)
    assert tuple(sys.dih_idx.shape) == (2, 4)
    np.testing.assert_allclose(sys.dih_n.numpy(), [3.0, 2.0])
    ex = {tuple(p): (float(q), float(l)) for p, q, l in
          zip(sys.excl_idx.numpy().tolist(), sys.excl_qq, sys.excl_lj)}
    assert ex[(0, 3)] == pytest.approx((1 / 1.2, 0.5), abs=1e-6)
    assert ex[(0, 1)] == (0.0, 0.0)
    assert ex[(1, 2)] == (0.0, 0.0)
    rmin_t1 = (2 * 1.04308023e6 / 6.75612247e2) ** (1 / 6)
    np.testing.assert_allclose(float(sys.rmin_half[0]), rmin_t1 / 2 / 10,
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(sys.eps[0]), (6.75612247e2 ** 2 / (4 * 1.04308023e6)) * 4.184,
        rtol=1e-6)
    assert_tables_match(
        JA.system_from_prmtop(str(path), method="NoCutoff")[0], sys)


def test_prmtop_lj_off_diagonal_warns(tmp_path):
    """The fixture's type-pair A/B coefficients leave Lorentz-Berthelot:
    both packages warn (LJEDIT / NBFIX tables are not representable) and
    keep the per-type LJ of the diagonal."""
    path = tmp_path / "edit.prmtop"
    path.write_text(HANDWRITTEN)
    with pytest.warns(UserWarning, match="Lorentz-Berthelot"):
        sys, _, _ = A.system_from_prmtop(str(path), device="cpu")
    with pytest.warns(UserWarning, match="Lorentz-Berthelot"):
        jsys, _, _ = JA.system_from_prmtop(str(path))
    assert_tables_match(jsys, sys)


def _cmap_grid(fn, R=24):
    ang = -np.pi + 2 * np.pi * np.arange(R) / R
    P, S = np.meshgrid(ang, ang, indexing="ij")
    return fn(P, S)


def _cmap_chain(grids):
    """The JAX CMAP test's 5-atom chain with CMAP terms over (0123,
    1234)."""
    return dict(
        masses=[12.0] * 5, charges=[0.0] * 5, rmin_half=[0.0] * 5,
        eps=[0.0] * 5, bond_idx=[(i, i + 1) for i in range(4)],
        bond_k=[1e4] * 4, bond_r0=[0.15] * 4,
        excl_idx=[(i, j) for i in range(5) for j in range(i + 1, 5)],
        excl_qq=[0.0] * 10, excl_lj=[0.0] * 10,
        cmap_idx=[[0, 1, 2, 3, 1, 2, 3, 4]] * len(grids),
        cmap_type=list(range(len(grids))), cmap_grids=grids,
        method="NoCutoff")


def _chain_coords(phi, psi):
    """5 atoms with torsion(0123) = phi and torsion(1234) = psi."""
    b, theta = 0.15, math.radians(109.5)
    pts = [np.array([0.0, 0.0, 0.0]), np.array([b, 0.0, 0.0]),
           np.array([b + b * math.cos(math.pi - theta),
                     b * math.sin(math.pi - theta), 0.0])]
    for tor in (phi, psi):
        p1, p2, p3 = pts[-3], pts[-2], pts[-1]
        e1 = (p3 - p2) / np.linalg.norm(p3 - p2)
        nrm = np.cross(p2 - p1, e1)
        nrm /= np.linalg.norm(nrm)
        m = np.cross(nrm, e1)
        pts.append(p3 - b * math.cos(theta) * e1
                   + b * math.sin(theta) * (math.cos(tor) * m
                                            - math.sin(tor) * nrm))
    return np.stack(pts).astype(np.float32)


def test_cmap_prmtop_roundtrip(tmp_path):
    """Two CMAP maps through CMAP_COUNT / CMAP_PARAMETER_nn / CMAP_INDEX:
    the indices exact, the energy within 1e-3 kJ/mol (the grid values
    pass through kcal at %9.5f), the text and the re-read tables equal to
    the JAX package's."""
    g1 = _cmap_grid(lambda p, s: np.cos(p) + 0.5 * np.sin(2 * s))
    g2 = _cmap_grid(lambda p, s: 0.3 * np.sin(p - s))
    tab = _cmap_chain([g1, g2])
    sys = system_from_tables(device="cpu", **tab)
    path = tmp_path / "cmap.prmtop"
    text = A.save_prmtop(sys, str(path))
    assert text == JA.save_prmtop(jax_tables(**tab), str(tmp_path / "j"))
    assert "CMAP_COUNT" in text and "CMAP_PARAMETER_02" in text
    sys2, _, _ = A.system_from_prmtop(str(path), method="NoCutoff",
                                      device="cpu")
    assert has_cmap(sys2)
    np.testing.assert_array_equal(sys2.cmap_idx.numpy(),
                                  sys.cmap_idx.numpy())
    x = torch.as_tensor(_chain_coords(-2.2, 1.3).reshape(-1))
    np.testing.assert_allclose(float(potential_energy_flat(sys2, x)),
                               float(potential_energy_flat(sys, x)),
                               atol=1e-3)
    assert_tables_match(
        JA.system_from_prmtop(str(path), method="NoCutoff")[0], sys2)


def test_save_prmtop_carries_orphan_exceptions(tmp_path):
    """A 1-4 pair with no torsion row (all its terms had zero force
    constant) rides a synthetic zero-k torsion; the round trip keeps its
    scales, and the text equals the JAX package's."""
    tab = dict(masses=[12.0] * 4, charges=[0.2, -0.1, -0.1, 0.0],
               rmin_half=[0.19] * 4, eps=[0.4] * 4,
               bond_idx=[(0, 1), (1, 2), (2, 3)], bond_k=[2e5] * 3,
               bond_r0=[0.15] * 3, angle_idx=[(0, 1, 2), (1, 2, 3)],
               angle_k=[400.0] * 2, angle_t0=[1.9] * 2,
               excl_idx=[(0, 1), (1, 2), (2, 3), (0, 2), (1, 3), (0, 3)],
               excl_qq=[0, 0, 0, 0, 0, 1 / 1.2],
               excl_lj=[0, 0, 0, 0, 0, 0.5], method="NoCutoff")
    sys = system_from_tables(device="cpu", **tab)
    p = str(tmp_path / "o.prmtop")
    assert A.save_prmtop(sys, p) == JA.save_prmtop(jax_tables(**tab),
                                                   str(tmp_path / "j"))
    sys2, _, _ = A.system_from_prmtop(p, device="cpu")

    def scales(s):
        return {tuple(ij): (q, l) for ij, q, l in zip(
            s.excl_idx.tolist(), s.excl_qq.tolist(), s.excl_lj.tolist())}
    got, want = scales(sys2), scales(sys)
    assert set(got) == set(want)
    for ij in want:
        np.testing.assert_allclose(got[ij], want[ij], atol=1e-6)


# ---- from_system ------------------------------------------------------------

def test_from_system_simulation(ala, tmp_path):
    """The JAX test's imported alanine with two explicit distance
    constraints: propagate and featurize, the constraints held to 1e-3."""
    tsys, _, x = ala
    path = tmp_path / "ala.prmtop"
    A.save_prmtop(tsys, str(path))
    A.write_rst7(str(tmp_path / "ala.rst7"), x)
    sys2, coords, meta = A.system_from_prmtop(
        str(path), str(tmp_path / "ala.rst7"), method="NoCutoff",
        device="cpu")
    cons = [(int(i), int(j), float(d)) for (i, j), d in
            zip(sys2.bond_idx[:2].tolist(), sys2.bond_r0[:2].tolist())]
    sim = itt.MDSimulation.from_system(sys2, coords, steps=5,
                                       constraint_pairs=cons,
                                       source=str(path), device="cpu")
    assert sim.route == "plain" and sim.pdbfile == str(path)
    assert sim.constructor["from_system"] is True
    assert sim.constructor["constraint_pairs"] == cons
    x0 = torch.as_tensor(coords.reshape(-1), dtype=torch.float32)
    ys = sim.propagate(torch.stack([x0] * 2), 2, gen=0)
    assert tuple(ys.shape) == (2, 2, sys2.dim)
    assert bool(torch.isfinite(ys).all())
    y = ys.reshape(-1, sys2.natoms, 3)
    for (i, j, d) in cons:
        r = torch.linalg.norm(y[:, i] - y[:, j], dim=-1).numpy()
        np.testing.assert_allclose(r, d, atol=1e-3)
    feats = sim.featurizer(ys.reshape(4, -1))
    assert bool(torch.isfinite(feats).all())


def test_from_system_matches_init(ala):
    """``from_system`` on the system ``__init__`` builds gives the same
    route, plans, masses, constraints, start state and featurizer as
    ``__init__`` (one set-up shared by both)."""
    init = itt.MDSimulation(steps=7, constraints="HBonds", device="cpu")
    fs = itt.MDSimulation.from_system(init.system, init.coords, steps=7,
                                      constraints="HBonds", device="cpu")
    assert fs.route == init.route == "plain"
    assert torch.equal(fs.masses3, init.masses3)
    assert torch.equal(fs.coords, init.coords)
    assert fs.constraint_set.ncons == init.constraint_set.ncons
    assert type(fs.featurizer) is type(init.featurizer)
    assert fs.lagtime == init.lagtime and fs.structure is None
    unc = itt.MDSimulation.from_system(init.system, init.coords,
                                       device="cpu")
    assert unc.route == "fused" and unc.plan is not None
    with pytest.raises(ValueError, match="needs a PDB"):
        itt.MDSimulation.from_system(init.system, init.coords,
                                     features=0.5, device="cpu")
    with pytest.raises(ValueError, match="langevin"):
        itt.MDSimulation.from_system(init.system, init.coords,
                                     integrator="brownian",
                                     constraints="HBonds", device="cpu")
    with pytest.raises(ValueError, match="tensors are on cpu"):
        itt.MDSimulation.from_system(init.system, init.coords,
                                     device="meta")


def _jax_steps(jsim, xs, v0, x64):
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        run = jax.jit(lambda x, v: JI.langevin_middle(
            lambda z: jax_force_flat(jsim.system, z), x, v, jsim.masses3,
            0.0, 1.0, 0.002, 10, jax.random.PRNGKey(0),
            constraints=jsim.constraint_set))
        x, v = run(jnp.asarray(xs, dt), jnp.asarray(v0, dt))
        return np.asarray(x, np.float64), np.asarray(v, np.float64)


def _rel(a, b):
    return np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()


def _noiseless(jsim, sim, xs, v0, xtol, vtol):
    """10 noiseless LangevinMiddle steps: the JAX package in float64 over
    its ``force_flat`` with its ``from_system``'s masses and constraints,
    the port by its route (kernel plain versions on the CPU); x within
    ``xtol`` and v within ``vtol`` of the largest value.  Unconstrained
    (``vtol=None``), v is held as close to the float64 result as the JAX
    package's own float32 run (within 1.5x, or 1e-4): that run itself
    lies ~2e-4 away after 10 steps of alanine's methyl hydrogens, so no
    float32 implementation meets a fixed 1e-5 there."""
    x, v = _jax_steps(jsim, xs, v0, True)
    if vtol is None:
        vtol = max(1e-4, 1.5 * _rel(_jax_steps(jsim, xs, v0, False)[1], v))
    xt, vt = torch.as_tensor(xs), torch.as_tensor(v0)
    if sim.route == "fused":
        xt, vt = LK.langevin_middle_plain(sim.plan, xt, vt, 10, noise=False)
    else:
        xt, vt = sim._integrate(xt, vt, 10, None)
    assert _rel(xt.numpy(), x) < xtol
    assert _rel(vt.numpy(), v) < vtol
    return xt


def _v0(n, dim, seed):
    return np.random.default_rng(seed).normal(scale=0.3, size=(n, dim)
                                              ).astype(np.float32)


def test_from_system_fused_alanine_matches_jax(ala, tmp_path):
    tsys, jsys, x = ala
    p = str(tmp_path / "a.prmtop")
    A.save_prmtop(tsys, p)
    sim = itt.MDSimulation.from_system(
        A.system_from_prmtop(p, method="NoCutoff", device="cpu")[0], x,
        device="cpu")
    jsim = itk.MDSimulation.from_system(
        JA.system_from_prmtop(p, method="NoCutoff")[0], x)
    assert sim.route == "fused"
    xs = np.tile(x.reshape(1, -1), (2, 1))
    n0 = LK.langevin_middle.launches
    _noiseless(jsim, sim, xs, _v0(2, sim.dim, 1), 1e-5, None)
    assert LK.langevin_middle.launches == n0


def test_from_system_hybrid_trpcage_matches_jax(tmp_path):
    """Trp-cage in OBC2 through its prmtop (RADII / SCREEN): the hybrid
    route, kernel D's plain version on the CPU (no launch)."""
    tsys = build_system(TRPCAGE, implicit="obc2", device="cpu")
    p = str(tmp_path / "t.prmtop")
    A.save_prmtop(tsys, p)
    x = read_pdb(TRPCAGE).coords.astype(np.float32)
    isys = A.system_from_prmtop(p, implicit="obc2", device="cpu")[0]
    compare_terms(tsys, isys, x)
    sim = itt.MDSimulation.from_system(isys, x, device="cpu")
    jsim = itk.MDSimulation.from_system(
        JA.system_from_prmtop(p, implicit="obc2")[0], x)
    assert sim.route == "hybrid" and sim.natoms == 313
    xs = np.tile(x.reshape(1, -1), (2, 1))
    n0 = GB.gb_force.launches
    _noiseless(jsim, sim, xs, _v0(2, sim.dim, 2), 1e-5, None)
    assert GB.gb_force.launches == n0


def test_from_system_neighbor_pme_box_matches_jax(tmp_path):
    """The PME box (alanine, 0.9 nm of rigid TIP3P, 1,012 atoms: the JAX
    ``tests/test_ewald.py`` box) through its prmtop with
    ``dense_pairs=False`` and the waters as explicit constraint pairs:
    the neighbor route (kernel E's plain version), 10 noiseless
    constrained steps against float64 JAX at 1e-5 / 1e-4 (x / v), the
    waters held to 1e-5 nm."""
    built = itt.MDSimulation(addwater=True, padding=0.9, steps=3,
                             method="PME", dense_pairs=False, device="cpu")
    assert built.natoms == 1012
    cons = water_constraint_pairs(built.structure)
    p = str(tmp_path / "box.prmtop")
    A.save_prmtop(built.system, p)
    x = built.coords.numpy()
    isys = A.system_from_prmtop(p, dense_pairs=False, device="cpu")[0]
    assert isys.method == "PME" and not isys.dense_pairs
    sim = itt.MDSimulation.from_system(isys, x, constraint_pairs=cons,
                                       device="cpu")
    jsys = JA.system_from_prmtop(p, dense_pairs=False)[0]
    assert_tables_match(jsys, isys)
    jsim = itk.MDSimulation.from_system(jsys, x, constraint_pairs=cons)
    assert sim.route == "neighbor"
    from isokann_tpu.md import neighbor as JN
    jp = JN.NeighborPlan(jsys, x0=x.reshape(-1, 3))

    def jf(z):
        return jax.vmap(lambda xi: JN.force_neighbor(
            jsys, xi.reshape(-1, 3), jp).reshape(-1))(z)

    xs = np.tile(x[None], (2, 1))
    v0 = sim.constraint_set.rattle(torch.as_tensor(xs), torch.as_tensor(
        _v0(2, sim.dim, 3))).numpy()
    with jax.enable_x64():
        run = jax.jit(lambda a, b: JI.langevin_middle(
            jf, a, b, jsim.masses3, 0.0, 1.0, 0.002, 10,
            jax.random.PRNGKey(0), constraints=jsim.constraint_set))
        xj, vj = run(jnp.asarray(xs, jnp.float64),
                     jnp.asarray(v0, jnp.float64))
        xj, vj = np.asarray(xj), np.asarray(vj)
    n0 = NK.neighbor_sweep.launches
    xt, vt = sim._integrate(torch.as_tensor(xs), torch.as_tensor(v0), 10,
                            None)
    assert NK.neighbor_sweep.launches == n0
    assert np.abs(xt.numpy() - xj).max() / np.abs(xj).max() < 1e-5
    assert np.abs(vt.numpy() - vj).max() / np.abs(vj).max() < 1e-4
    assert sim.constraint_set.max_violation(xt) < 1e-5


def test_from_system_plain_dna_matches_jax():
    """The AT dinucleotide in OBC2 with HBonds (63 atoms): the plain
    route, 10 noiseless constrained steps from a FIRE-minimized start
    against float64 JAX at 1e-5 / 1e-4 (x / v), HBonds held."""
    from isokann_tpu_torch.md.minimize import minimize_energy
    struct = build_nucleic("AT")
    tsys = build_system(struct, implicit="obc2", device="cpu")
    jsys = jax_build_system(JP.PDBStructure(**vars(struct)),
                            implicit="obc2")
    x0 = torch.as_tensor(struct.coords.reshape(-1), dtype=torch.float32)
    x = minimize_energy(lambda z: potential_energy_flat(tsys, z), x0,
                        maxiter=300).detach().numpy()
    sim = itt.MDSimulation.from_system(tsys, x, constraints="HBonds",
                                       device="cpu")
    jsim = itk.MDSimulation.from_system(jsys, x, constraints="HBonds")
    assert sim.route == "plain" and sim.natoms == 63
    xs = np.tile(x[None], (2, 1)).astype(np.float32)
    v0 = sim.constraint_set.rattle(torch.as_tensor(xs), torch.as_tensor(
        _v0(2, sim.dim, 4))).numpy()
    xt = _noiseless(jsim, sim, xs, v0, 1e-5, 1e-4)
    assert sim.constraint_set.max_violation(xt) < 1e-5
