"""Port parity of the nucleic-acid force field and builders
(``md/amber.py`` nucleotide templates, the 5'/3'/nucleoside candidate
search of ``md/topology.py``, ``md/fixtures.py``'s ``build_nucleic`` and
``build_alanine_dipeptide``): every case of the JAX package's
``tests/test_nucleic.py`` through the port at the JAX test's bounds, the
port's residue tables equal to the JAX package's, the builders'
coordinates within 1e-6 nm of the JAX package's, and the topologies
(residues, types, charges, bonds, angles, torsions, impropers) equal
(CPU)."""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "data"))
import parm_fixture as fx                                  # noqa: E402

from isokann_tpu.md import fixtures as JF                  # noqa: E402
from isokann_tpu.md import topology as JT                  # noqa: E402

from isokann_tpu_torch.md import amber                     # noqa: E402
from isokann_tpu_torch.md.fixtures import (                # noqa: E402
    build_alanine_dipeptide, build_nucleic)
from isokann_tpu_torch.md.forces import potential_energy_flat  # noqa: E402
from isokann_tpu_torch.md.pdbio import read_pdb, write_pdb  # noqa: E402
from isokann_tpu_torch.md.system import build_system       # noqa: E402
from isokann_tpu_torch.md.topology import build_topology   # noqa: E402

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)


# ---- templates & charges ----------------------------------------------------

def test_residue_tables_match_jax():
    """Every template (protein, nucleic and their variants) and every
    parameter table equals the JAX package's, charges to the bit; in a
    fresh interpreter, so no registration another test file made in this
    worker (the JAX package's own tests leave some) enters the
    comparison."""
    code = (
        "import isokann_tpu.md.amber as J, isokann_tpu_torch.md.amber as P\n"
        "names = ('ATOM_TYPES', 'BONDS', 'ANGLES', 'DIHEDRALS', "
        "'IMPROPERS', 'RESIDUES', 'NUCLEIC_RESIDUES')\n"
        "bad = [n for n in names if getattr(J, n) != getattr(P, n)]\n"
        "print(len(P.RESIDUES), bad)\n"
        "raise SystemExit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
    assert out.stdout.split()[0] == "109"


def test_templates_registered():
    for n in ("DA", "DC", "DG", "DT", "RA", "RC", "RG", "RU"):
        for suffix in ("", "5", "3", "N"):
            assert n + suffix in amber.RESIDUES, n + suffix


def test_interior_charge_sums_exact():
    for n in sorted(amber.NUCLEIC_RESIDUES):
        t = amber.RESIDUES[n]
        s = sum(q for _, q in t["atoms"].values())
        assert abs(s - t["formal_charge"]) < 1e-9, (n, s)


def test_spot_charges_survive_normalization():
    for (res, atom), q in fx.NUCLEIC_CHARGE_SPOTS.items():
        t, got = amber.RESIDUES[res]["atoms"][atom]
        assert abs(got - q) < 1e-9, (res, atom, got, q)


def test_terminal_variants_close_and_keep_base_charges():
    for n in sorted(amber.NUCLEIC_RESIDUES):
        base = amber.RESIDUES[n]["atoms"]
        for suffix, formal in (("5", 0), ("3", -1), ("N", 0)):
            t = amber.RESIDUES[n + suffix]
            s = sum(q for _, q in t["atoms"].values())
            assert abs(s - formal) < 1e-9, (n + suffix, s)
            assert t["formal_charge"] == formal
            for a, (ty, q) in t["atoms"].items():
                if "'" in a or a in ("P", "OP1", "OP2"):
                    continue
                assert abs(q - base[a][1]) < 1e-9, (n + suffix, a)


# ---- builders ---------------------------------------------------------------

@pytest.mark.parametrize("seq,rna,chi", [
    ("AT", False, 60.0), ("ACGT", False, 60.0), ("GC", True, 60.0),
    ("ACGU", True, -120.0), ("A", True, 60.0)])
def test_build_nucleic_matches_jax(seq, rna, chi):
    got = build_nucleic(seq, rna=rna, chi=chi)
    want = JF.build_nucleic(seq, rna=rna, chi=chi)
    for f in ("atom_names", "res_names", "res_ids", "chain_ids",
              "elements"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.box is None and want.box is None
    np.testing.assert_allclose(got.coords, want.coords, rtol=0, atol=1e-6)


def test_nucleotide_atom_counts():
    """AT (DNA) is 63 atoms and GC (RNA) 64, as in the JAX package."""
    assert build_nucleic("AT").natoms == 63
    assert build_nucleic("GC", rna=True).natoms == 64


@pytest.mark.parametrize("phi,psi", [(-80.0, 75.0), (60.0, -60.0)])
def test_build_alanine_dipeptide_matches_jax(phi, psi):
    got = build_alanine_dipeptide(phi, psi)
    want = JF.build_alanine_dipeptide(phi, psi)
    assert got.atom_names == want.atom_names
    assert got.res_names == want.res_names
    np.testing.assert_array_equal(got.box, want.box)
    np.testing.assert_allclose(got.coords, want.coords, rtol=0, atol=1e-6)


def _jax_struct(struct):
    from isokann_tpu.md.pdbio import PDBStructure
    return PDBStructure(**vars(struct))


@pytest.mark.parametrize("seq,rna", [("ACGT", False), ("ACGU", True),
                                     ("A", True), ("TA", False)])
def test_topology_matches_jax(seq, rna):
    struct = build_nucleic(seq, rna=rna)
    top = build_topology(struct)
    jtop = JT.build_topology(_jax_struct(struct))
    assert [r.name for r in top.residues] == [r.name for r in
                                             jtop.residues]
    assert top.atom_types == jtop.atom_types
    np.testing.assert_array_equal(top.charges, jtop.charges)
    for f in ("bonds", "angles", "propers", "impropers"):
        assert [tuple(b) for b in getattr(top, f)] == \
            [tuple(b) for b in getattr(jtop, f)], f


# ---- topology: matching, linking, impropers ----------------------------------

def test_strand_matching_and_linkage():
    s = build_nucleic("ACGT")
    top = build_topology(s)
    assert [r.name for r in top.residues] == ["DA5", "DC", "DG", "DT3"]
    assert abs(top.charges.sum() + 3.0) < 1e-6
    links = 0
    for (i, j) in top.bonds:
        pair = {top.atom_names[i], top.atom_names[j]}
        ri, rj = None, None
        for r in top.residues:
            if i in r.atom_indices:
                ri = r.resid
            if j in r.atom_indices:
                rj = r.resid
        if pair == {"O3'", "P"} and ri != rj:
            links += 1
    assert links == 3


def test_rna_single_letter_names_and_nucleoside():
    s = build_nucleic("A", rna=True)
    assert s.res_names[0] == "A"
    top = build_topology(s)
    assert top.residues[0].name == "RAN"
    assert "HO2'" in top.atom_names and "HO5'" in top.atom_names
    assert abs(top.charges.sum()) < 1e-6


def test_v2_atom_name_aliases():
    s = build_nucleic("TA")
    v3_to_v2 = {"OP1": "O1P", "OP2": "O2P", "H5'": "H5'1", "H5''": "H5'2",
                "H2'": "H2'1", "H2''": "H2'2", "C7": "C5M",
                "H71": "H51", "H72": "H52", "H73": "H53",
                "HO5'": "H5T", "HO3'": "H3T",
                "O5'": "O5*", "C5'": "C5*", "C4'": "C4*", "O4'": "O4*",
                "C1'": "C1*", "C2'": "C2*", "C3'": "C3*", "O3'": "O3*",
                "H1'": "H1*", "H3'": "H3*", "H4'": "H4*"}
    s.atom_names = [v3_to_v2.get(a, a) for a in s.atom_names]
    top = build_topology(s)
    assert [r.name for r in top.residues] == ["DT5", "DA3"]


def test_base_impropers_generated():
    top = build_topology(build_nucleic("ACGT"))
    t = top.atom_types
    imps = [((t[i], t[j], t[c], t[l]),
             amber.lookup_improper(t[i], t[j], t[c], t[l]))
            for (i, j, c, l) in top.impropers]
    glyc = [k for k, p in imps if k[2] == "N*" and k[3] == "CT"
            and p == (1.0, 180.0, 2)]
    assert len(glyc) == 4
    amine = [k for k, p in imps if k[2] == "CA" and k[3] == "N2"
             and p == (1.1, 180.0, 2)]
    assert len(amine) == 3
    thy = [k for k, p in imps if k[2] == "CM" and k[3] == "CT"
           and p == (1.1, 180.0, 2)]
    assert len(thy) == 1
    carb = [k for k, p in imps if k[2] == "C" and p == (10.5, 180.0, 2)]
    assert len(carb) == 4


# ---- parameter coverage -------------------------------------------------------

@pytest.mark.parametrize("seq,rna", [
    ("AAA", False), ("CCC", False), ("GGG", False), ("TTT", False),
    ("AAA", True), ("CCC", True), ("GGG", True), ("UUU", True),
])
def test_no_fallback_trinucleotide(seq, rna):
    """5'-terminal, interior and 3'-terminal templates of every base build
    with no parameter-lookup fallback; two phosphates."""
    struct = build_nucleic(seq, rna=rna)
    amber._warned.clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sys_ = build_system(struct, method="NoCutoff", device="cpu")
    msgs = [str(x.message) for x in w
            if "parameters for" in str(x.message)
            or "fallback" in str(x.message)]
    assert not msgs, f"fallback parameters hit for {seq}: {msgs}"
    assert abs(float(sys_.charges.sum()) + 2.0) < 1e-4


# ---- end to end -----------------------------------------------------------------

@pytest.mark.parametrize("seq,rna", [("AT", False), ("GC", True)])
def test_minimize_dinucleotide(seq, rna):
    """FIRE closes the NeRF ring seams: negative energy, every bond within
    0.1 A of its r0 (slow in the JAX package for its jit; seconds
    here)."""
    from isokann_tpu_torch.md.minimize import minimize_energy
    struct = build_nucleic(seq, rna=rna)
    sysm = build_system(struct, method="NoCutoff", device="cpu")
    x0 = torch.as_tensor(struct.coords.reshape(-1), dtype=torch.float32)
    x = minimize_energy(lambda z: potential_energy_flat(sysm, z), x0,
                        maxiter=1500)
    e = float(potential_energy_flat(sysm, x))
    assert np.isfinite(e) and e < 0.0
    top = build_topology(struct)
    xyz = x.detach().numpy().reshape(-1, 3)
    devs = []
    for (i, j) in top.bonds:
        r = np.linalg.norm(xyz[i] - xyz[j])
        _, r0 = amber.lookup_bond(top.atom_types[i], top.atom_types[j])
        devs.append(abs(r - r0 * 0.1))
    assert max(devs) < 0.01, f"max bond deviation {max(devs)*10:.3f} A"


def test_solvated_dna_pme_neutralized():
    """solvate() neutralizes the phosphate with one Na+ and the PME
    system builds with a finite energy and a net charge below 1e-4."""
    from isokann_tpu_torch.md.solvate import solvate
    solv = solvate(build_nucleic("AT"), padding=0.7)
    assert sum(1 for r in solv.res_names if r == "NA") == 1
    sysm = build_system(solv, method="PME", device="cpu")
    assert abs(float(sysm.charges.double().sum())) < 1e-4
    e = float(potential_energy_flat(sysm, torch.as_tensor(
        solv.coords.reshape(-1), dtype=torch.float32)))
    assert np.isfinite(e)


def test_pdb_roundtrip(tmp_path):
    struct = build_nucleic("ACGU", rna=True)
    path = str(tmp_path / "rna.pdb")
    write_pdb(path, struct)
    back = read_pdb(path)
    top = build_topology(back)
    assert [r.name for r in top.residues] == ["RA5", "RC", "RG", "RU3"]
    assert np.allclose(back.coords, struct.coords, atol=1e-3)
