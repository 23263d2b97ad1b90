"""Port parity of the explicit-solvent build: the TIP3P box and ions of
``md.solvate``, the water triplets, the water and ion tables of the
topology, and the sparse pair layout of ``build_system`` (the exception
list, no dense scale matrices), against the JAX package on the same
inputs (CPU)."""

import numpy as np
import pytest
import torch

from isokann_tpu.md import system as jax_system_mod
from isokann_tpu.md.pdbio import read_pdb as jax_read_pdb
from isokann_tpu.md.solvate import solvate as jax_solvate
from isokann_tpu.md.solvate import water_triplets as jax_water_triplets
from isokann_tpu.md.system import build_system as jax_build_system

from isokann_tpu_torch.md import system as S
from isokann_tpu_torch.md.fixtures import alanine_dipeptide_pdb
from isokann_tpu_torch.md.pdbio import read_pdb
from isokann_tpu_torch.md.solvate import solvate, water_triplets

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

ALA = alanine_dipeptide_pdb()


def _same_structure(a, b):
    for f in ("atom_names", "res_names", "res_ids", "chain_ids",
              "elements"):
        assert list(getattr(a, f)) == list(getattr(b, f)), f
    np.testing.assert_array_equal(np.asarray(a.coords), np.asarray(b.coords))
    np.testing.assert_array_equal(np.asarray(a.box), np.asarray(b.box))


@pytest.mark.parametrize("kw", [dict(padding=0.55), dict(padding=0.9),
                                dict(padding=0.7, ionic_strength=0.3,
                                     seed=5),
                                dict(box=(2.0, 2.1, 2.2), seed=1)])
def test_solvate_matches_jax(kw):
    """Coordinates exact, names, residues, chains, elements and box equal,
    ions included."""
    out = solvate(read_pdb(ALA), **kw)
    ref = jax_solvate(jax_read_pdb(ALA), **kw)
    _same_structure(out, ref)
    if kw.get("ionic_strength"):
        assert {"NA", "CL"} <= set(out.res_names)
    np.testing.assert_array_equal(water_triplets(out),
                                  jax_water_triplets(ref))


def test_water_triplets_layout():
    out = solvate(read_pdb(ALA), padding=0.55)
    trip = water_triplets(out)
    assert trip.shape == (out.res_names.count("HOH") // 3, 3)
    assert np.all(np.diff(trip[:, 0]) == 3)
    assert [out.atom_names[i] for i in trip[0]] == ["O", "H1", "H2"]


def test_tip4p_is_not_ported():
    """The 4-site model, once refused, builds the JAX package's structure
    (O, H1, H2, M blocks); an unknown model is refused."""
    got = solvate(read_pdb(ALA), padding=0.55, model="tip4pew")
    want = jax_solvate(jax_read_pdb(ALA), padding=0.55, model="tip4pew")
    assert got.atom_names == want.atom_names
    assert got.elements == want.elements and "EP" in got.elements
    np.testing.assert_allclose(got.coords, want.coords, atol=1e-12)
    with pytest.raises(ValueError, match="water model"):
        solvate(read_pdb(ALA), padding=0.55, model="tip5p")


@pytest.fixture(scope="module")
def salty():
    """Solvated alanine with NaCl: (port structure, JAX structure)."""
    kw = dict(padding=0.6, ionic_strength=0.5)
    return (solvate(read_pdb(ALA), **kw),
            jax_solvate(jax_read_pdb(ALA), **kw))


def test_water_and_ion_parameters_match_jax(salty):
    """HOH, Na+ and Cl- resolve to the same types, charges, masses and LJ
    parameters as in the JAX package (TIP3P OW/HW, parm99 IP/IM)."""
    out, ref = salty
    s = S.build_system(out, dense_pairs=False, device="cpu")
    j = jax_build_system(ref, dense_pairs=False)
    for f in ("charges", "masses", "rmin_half", "eps", "bond_idx", "bond_k",
              "bond_r0", "angle_idx", "angle_k", "angle_t0"):
        np.testing.assert_allclose(getattr(s, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6,
                                   err_msg=f)
    na = out.res_names.index("NA")
    cl = out.res_names.index("CL")
    ow = out.res_names.index("HOH")
    q = s.charges.numpy()
    np.testing.assert_allclose(q[[na, cl, ow, ow + 1]],
                               [1.0, -1.0, -0.834, 0.417], atol=1e-6)
    assert abs(float(q.sum())) < 1e-3


@pytest.mark.parametrize("dense", [True, False])
def test_exception_list_matches_jax(salty, dense):
    """The sparse exception list (pairs, target Coulomb and LJ scales) of
    both layouts equals the JAX package's; only the dense layout builds
    the (n, n) scale matrices."""
    out, ref = salty
    s = S.build_system(out, dense_pairs=dense, device="cpu")
    j = jax_build_system(ref, dense_pairs=dense)
    assert s.dense_pairs is dense and j.dense_pairs is dense
    np.testing.assert_array_equal(s.excl_idx.numpy(), np.asarray(j.excl_idx))
    np.testing.assert_array_equal(s.excl_qq.numpy(), np.asarray(j.excl_qq))
    np.testing.assert_array_equal(s.excl_lj.numpy(), np.asarray(j.excl_lj))
    n = s.natoms
    assert s.qq_scale.shape == ((n, n) if dense else (0, 0))
    if dense:
        np.testing.assert_array_equal(s.qq_scale.numpy(),
                                      np.asarray(j.qq_scale))


def test_dense_pairs_auto_switch(monkeypatch):
    assert S.DENSE_PAIRS_MAX == jax_system_mod.DENSE_PAIRS_MAX
    out = solvate(read_pdb(ALA), padding=0.55)
    assert S.build_system(out, device="cpu").dense_pairs
    monkeypatch.setattr(S, "DENSE_PAIRS_MAX", 100)
    s = S.build_system(out, device="cpu")
    assert not s.dense_pairs and s.lj_scale.shape == (0, 0)
    dense = S.build_system(out, dense_pairs=True, device="cpu")
    assert s.excl_idx.shape == dense.excl_idx.shape
