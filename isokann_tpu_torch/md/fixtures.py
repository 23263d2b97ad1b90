"""Bundled test systems and the structure builders; counterpart of
``isokann_tpu/md/fixtures.py`` (``_nerf``, ``build_alanine_dipeptide``,
``build_peptide``, ``build_nucleic``, ``peptide_pdb`` and the bundled
alanine dipeptide).

The builders place atoms by NeRF on the host from standard internal
coordinates: ``build_alanine_dipeptide`` at given (phi, psi),
``build_peptide`` an extended chain with template-driven side chains,
``build_nucleic`` a single DNA / RNA strand with planar bases (crude
geometry, meant to be minimized); ``peptide_pdb`` writes a peptide,
minimizes it with FIRE on the port's own force field and writes it again.
"""

from __future__ import annotations

import os

import numpy as np

from . import amber
from .pdbio import PDBStructure, write_pdb

_FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "data")


def alanine_dipeptide_pdb(minimized=True) -> str:
    """Path to the bundled, energy-minimised alanine-dipeptide PDB
    (``data/alanine-dipeptide.pdb`` at the repository root).  The JAX
    package returns the bundled file whenever it exists, whatever
    ``minimized`` says; so does this one, and it does not build the
    structure anew."""
    path = os.path.abspath(os.path.join(_FIXTURE_DIR,
                                        "alanine-dipeptide.pdb"))
    if not os.path.exists(path):
        raise FileNotFoundError(f"bundled alanine dipeptide missing: {path}")
    return path


def _nerf(a, b, c, r, theta_deg, phi_deg):
    """Place atom D given reference atoms (a, b, c): |DC|=r, angle(D,C,B)=theta,
    dihedral(D,C,B,A)=phi.  Natural extension reference frame."""
    theta = np.deg2rad(theta_deg)
    phi = np.deg2rad(phi_deg)
    bc = c - b
    bc /= np.linalg.norm(bc)
    ab = b - a
    n = np.cross(ab, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    d2 = np.array([-r * np.cos(theta),
                   r * np.sin(theta) * np.cos(phi),
                   r * np.sin(theta) * np.sin(phi)])
    return c + d2[0] * bc + d2[1] * m + d2[2] * n


def build_alanine_dipeptide(phi=-80.0, psi=75.0):
    """ACE-ALA-NME coordinates (nm), atom order matching the reference PDB
    (``data/systems/alanine dipeptide.pdb``: HH31 CH3 HH32 HH33 C O | N H CA
    HA CB HB1 HB2 HB3 C O | N H CH3 HH31 HH32 HH33)."""
    # scaffold in Angstrom-free nm units
    CH3 = np.zeros(3)
    C = CH3 + np.array([0.1522, 0.0, 0.0])
    O = _nerf(CH3 + np.array([0.0, 0.1, 0.0]), CH3, C, 0.1229, 120.4, 90.0)

    N = _nerf(O, CH3, C, 0.1335, 116.6, 180.0)
    H = _nerf(O, C, N, 0.1010, 119.8, 0.0)
    CA = _nerf(O, C, N, 0.1449, 121.9, 180.0)
    C2 = _nerf(C, N, CA, 0.1522, 110.1, phi)
    CB = _nerf(C, N, CA, 0.1526, 109.7, phi + 122.0)
    HA = _nerf(C, N, CA, 0.1090, 109.5, phi - 118.0)
    O2 = _nerf(N, CA, C2, 0.1229, 120.4, psi + 180.0)
    N2 = _nerf(N, CA, C2, 0.1335, 116.6, psi)
    H2 = _nerf(O2, C2, N2, 0.1010, 119.8, 0.0)
    CH3b = _nerf(O2, C2, N2, 0.1449, 121.9, 180.0)

    HH31 = _nerf(O, C, CH3, 0.1090, 109.5, 60.0)
    HH32 = _nerf(O, C, CH3, 0.1090, 109.5, 180.0)
    HH33 = _nerf(O, C, CH3, 0.1090, 109.5, 300.0)
    HB1 = _nerf(N, CA, CB, 0.1090, 109.5, 60.0)
    HB2 = _nerf(N, CA, CB, 0.1090, 109.5, 180.0)
    HB3 = _nerf(N, CA, CB, 0.1090, 109.5, 300.0)
    HH31b = _nerf(C2, N2, CH3b, 0.1090, 109.5, 60.0)
    HH32b = _nerf(C2, N2, CH3b, 0.1090, 109.5, 180.0)
    HH33b = _nerf(C2, N2, CH3b, 0.1090, 109.5, 300.0)

    coords = np.stack([HH31, CH3, HH32, HH33, C, O,
                       N, H, CA, HA, CB, HB1, HB2, HB3, C2, O2,
                       N2, H2, CH3b, HH31b, HH32b, HH33b])
    names = ["HH31", "CH3", "HH32", "HH33", "C", "O",
             "N", "H", "CA", "HA", "CB", "HB1", "HB2", "HB3", "C", "O",
             "N", "H", "CH3", "HH31", "HH32", "HH33"]
    resn = ["ACE"] * 6 + ["ALA"] * 10 + ["NME"] * 6
    resi = [1] * 6 + [2] * 10 + [3] * 6
    elements = [n[0] if not n[0].isdigit() else "H" for n in names]
    # center in a 2.7222 nm box (same setup box as the reference fixture)
    box = np.array([2.7222, 2.7222, 2.7222])
    coords = coords - coords.mean(axis=0) + box / 2
    return PDBStructure(names, resn, resi, ["X"] * 22, elements, coords, box)


def build_peptide(sequence, phi=-120.0, psi=120.0, capped=True):
    """Generic peptide builder: extended-chain backbone via NeRF with
    template-driven sidechain placement (crude geometry, intended to be
    followed by energy minimization).

    ``sequence``: str of one-letter codes or list of three-letter residue
    names.  ``capped=True`` adds ACE/NME caps; otherwise charged termini
    (N.../C... templates) are used by the topology builder.
    Returns a PDBStructure (coordinates in nm, no box).
    """
    one2three = {"A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
                 "Q": "GLN", "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE",
                 "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
                 "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL"}
    if isinstance(sequence, str):
        seq = [one2three[c] for c in sequence.upper()]
    else:
        seq = list(sequence)
    if capped:
        seq = ["ACE"] + seq + ["NME"]
    else:
        # zwitterionic termini (NH3+ / COO-) via the terminal templates
        seq = ["N" + seq[0]] + seq[1:]
        seq = seq[:-1] + ["C" + seq[-1]]

    names, resn, resi, elements = [], [], [], []
    pos = {}           # (ri, atomname) -> xyz
    coords_list = []

    # backbone scaffold first: N, CA, C per residue (ACE: CH3 as CA-like)
    prev = {}
    for ri, res in enumerate(seq):
        tmpl = amber.RESIDUES[res]
        omega = 180.0
        if ri == 0:
            # seed triad
            if res == "ACE":
                pos[(0, "CH3")] = np.array([0.0, 0.0, 0.0])
                pos[(0, "C")] = np.array([0.1522, 0.0, 0.0])
                pos[(0, "O")] = _nerf(np.array([0.0, 0.1, 0.0]),
                                      pos[(0, "CH3")], pos[(0, "C")],
                                      0.1229, 120.4, 90.0)
                prev = dict(C=pos[(0, "C")], CA=pos[(0, "CH3")],
                            O=pos[(0, "O")])
            else:
                pos[(0, "N")] = np.array([0.0, 0.0, 0.0])
                pos[(0, "CA")] = np.array([0.1449, 0.0, 0.0])
                pos[(0, "C")] = _nerf(np.array([0.0, 0.1, 0.0]),
                                      pos[(0, "N")], pos[(0, "CA")],
                                      0.1522, 110.1, phi)
                prev = dict(C=pos[(0, "C")], CA=pos[(0, "CA")],
                            O=pos[(0, "N")])
            continue
        # place N from prev C
        N = _nerf(prev["O"], prev["CA"], prev["C"], 0.1335, 116.6, 180.0)
        pos[(ri, "N")] = N
        if res == "NME":
            CH3 = _nerf(prev["CA"], prev["C"], N, 0.1449, 121.9, omega)
            pos[(ri, "CH3")] = CH3
            prev = dict(C=CH3, CA=N, O=prev["C"])
            continue
        CA = _nerf(prev["CA"], prev["C"], N, 0.1449, 121.9, omega)
        pos[(ri, "CA")] = CA
        C = _nerf(prev["C"], N, CA, 0.1522, 110.1, phi)
        pos[(ri, "C")] = C
        O = _nerf(N, CA, C, 0.1229, 120.4, psi + 180.0)
        pos[(ri, "O")] = O
        prev = dict(C=C, CA=CA, O=O)

    # remaining atoms via BFS over template bonds with generic geometry
    for ri, res in enumerate(seq):
        tmpl = amber.RESIDUES[res]
        adj = {}
        for a, b in tmpl["bonds"]:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
        placed = {a for a in tmpl["atoms"] if (ri, a) in pos}
        guard = 0
        while len(placed) < len(tmpl["atoms"]) and guard < 200:
            guard += 1
            for a in list(tmpl["atoms"]):
                if a in placed:
                    continue
                anchors = [b for b in adj.get(a, []) if b in placed]
                if not anchors:
                    continue
                c = anchors[0]
                # find angle/dihedral references near the anchor
                bnd = [b for b in adj.get(c, []) if b in placed and b != a]
                if not bnd:
                    continue
                b = bnd[0]
                dihrefs = [d for d in adj.get(b, []) if d in placed
                           and d not in (a, c)]
                aref = (pos[(ri, dihrefs[0])] if dihrefs
                        else pos[(ri, b)] + np.array([0.07, 0.11, 0.05]))
                t_a = tmpl["atoms"][a][0]
                r = 0.109 if t_a.startswith("H") else 0.151
                # stagger siblings
                siblings = [s for s in adj.get(c, []) if s in placed
                            and s not in (b,)]
                dih = 60.0 + 120.0 * len(siblings)
                pos[(ri, a)] = _nerf(aref, pos[(ri, b)], pos[(ri, c)],
                                     r, 109.5, dih)
                placed.add(a)

    # assemble in template order per residue; terminal variants keep the
    # base PDB residue name (PDB resname is 3 chars; the topology builder
    # re-detects terminals from the present atoms)
    for ri, res in enumerate(seq):
        tmpl = amber.RESIDUES[res]
        pdbname = res[1:] if (len(res) == 4 and res[0] in "NC") else res
        for a in tmpl["atoms"]:
            names.append(a)
            resn.append(pdbname)
            resi.append(ri + 1)
            elements.append("H" if tmpl["atoms"][a][0].startswith("H")
                            else tmpl["atoms"][a][0][0])
            coords_list.append(pos[(ri, a)])

    coords = np.stack(coords_list)
    coords -= coords.mean(axis=0)
    return PDBStructure(names, resn, resi, ["A"] * len(names), elements,
                        coords, None)


def build_nucleic(sequence, rna=False, chi=60.0):
    """Single-stranded DNA/RNA builder: B-form-ish backbone + planar bases
    via NeRF, generic staggered placement for the rest (crude geometry,
    intended to be followed by energy minimization).

    ``sequence``: string of one-letter codes (ACGT for DNA, ACGU for RNA).
    The first residue gets the 5'-OH template (<res>5), the last the 3'-OH
    template (<res>3), a single residue the nucleoside (<res>N).
    Returns a PDBStructure (coordinates in nm, no box).
    """
    one2nuc = ({"A": "RA", "C": "RC", "G": "RG", "U": "RU"} if rna
               else {"A": "DA", "C": "DC", "G": "DG", "T": "DT"})
    base_names = [one2nuc[c] for c in sequence.upper()]
    seq = []
    for i, b in enumerate(base_names):
        suffix = ""
        if len(base_names) == 1:
            suffix = "N"
        elif i == 0:
            suffix = "5"
        elif i == len(base_names) - 1:
            suffix = "3"
        seq.append(b + suffix)

    pos = {}
    prev = None        # dict with C4', C3', O3' of the previous residue
    for ri, res in enumerate(seq):
        tmpl = amber.RESIDUES[res]
        if ri == 0:
            O5 = np.array([0.0, 0.0, 0.0])
            C5 = np.array([0.141, 0.0, 0.0])
            C4 = _nerf(np.array([0.0, 0.1, 0.0]), O5, C5, 0.152, 109.5, 60.0)
        else:
            # phosphodiester linkage: epsilon/zeta/alpha/beta/gamma torsions
            P = _nerf(prev["C4'"], prev["C3'"], prev["O3'"], 0.161, 120.5, 180.0)
            O5 = _nerf(prev["C3'"], prev["O3'"], P, 0.161, 102.6, -90.0)
            C5 = _nerf(prev["O3'"], P, O5, 0.141, 120.5, -60.0)
            C4 = _nerf(P, O5, C5, 0.152, 109.5, 180.0)
            pos[(ri, "P")] = P
        C3 = _nerf(O5, C5, C4, 0.152, 109.5, 60.0)
        O3 = _nerf(C5, C4, C3, 0.141, 109.5, 120.0)
        pos[(ri, "O5'")], pos[(ri, "C5'")] = O5, C5
        pos[(ri, "C4'")], pos[(ri, "C3'")], pos[(ri, "O3'")] = C4, C3, O3
        # sugar ring walk C4' -> O4' -> C1' -> C2' (C2'-C3' closes under
        # minimization)
        O4 = _nerf(O3, C3, C4, 0.142, 105.0, -119.0)
        C1 = _nerf(C3, C4, O4, 0.141, 109.0, 25.0)
        C2 = _nerf(C4, O4, C1, 0.152, 106.0, -30.0)
        pos[(ri, "O4'")], pos[(ri, "C1'")], pos[(ri, "C2'")] = O4, C1, C2
        # glycosidic N + planar base ring
        purine = "N9" in tmpl["atoms"]
        N = _nerf(C2, O4, C1, 0.147, 108.2, -120.0)
        if purine:
            pos[(ri, "N9")] = N
            C8 = _nerf(O4, C1, N, 0.137, 128.8, chi)
            N7 = _nerf(C1, N, C8, 0.130, 113.9, 180.0)
            Cb5 = _nerf(N, C8, N7, 0.139, 103.8, 0.0)
            Cb4 = _nerf(C8, N7, Cb5, 0.137, 110.4, 0.0)
            Cb6 = _nerf(C8, N7, Cb5, 0.141, 132.4, 180.0)
            N1 = _nerf(N7, Cb5, Cb6, 0.134, 117.3, 180.0)
            Cb2 = _nerf(Cb5, Cb6, N1, 0.133, 118.6, 0.0)
            N3 = _nerf(Cb6, N1, Cb2, 0.133, 129.1, 0.0)
            pos.update({(ri, "C8"): C8, (ri, "N7"): N7, (ri, "C5"): Cb5,
                        (ri, "C4"): Cb4, (ri, "C6"): Cb6, (ri, "N1"): N1,
                        (ri, "C2"): Cb2, (ri, "N3"): N3})
            pos[(ri, "H8")] = _nerf(Cb5, N7, C8, 0.108, 123.0, 180.0)
            # C6 substituent (adenine N6 / guanine O6) opposite N1
            sub6 = "N6" if (ri, "N6") not in pos and "N6" in tmpl["atoms"] \
                else "O6"
            pos[(ri, sub6)] = _nerf(N7, Cb5, Cb6,
                                    0.134 if sub6 == "N6" else 0.123,
                                    120.0, 0.0)
            # C2 substituent (adenine H2 / guanine N2) opposite N3
            sub2 = "H2" if "H2" in tmpl["atoms"] else "N2"
            pos[(ri, sub2)] = _nerf(Cb6, N1, Cb2,
                                    0.108 if sub2 == "H2" else 0.134,
                                    120.0, 180.0)
            if "H1" in tmpl["atoms"]:      # guanine N1-H
                pos[(ri, "H1")] = _nerf(Cb5, Cb6, N1, 0.101, 125.0, 180.0)
        else:
            pos[(ri, "N1")] = N
            Cb2 = _nerf(O4, C1, N, 0.138, 117.6, chi)
            N3 = _nerf(C1, N, Cb2, 0.137, 118.6, 180.0)
            Cb4 = _nerf(N, Cb2, N3, 0.135, 120.5, 0.0)
            Cb5 = _nerf(Cb2, N3, Cb4, 0.143, 121.5, 0.0)
            Cb6 = _nerf(N3, Cb4, Cb5, 0.135, 117.0, 0.0)
            pos.update({(ri, "C2"): Cb2, (ri, "N3"): N3, (ri, "C4"): Cb4,
                        (ri, "C5"): Cb5, (ri, "C6"): Cb6})
            pos[(ri, "O2")] = _nerf(C1, N, Cb2, 0.123, 120.9, 0.0)
            sub4 = "N4" if "N4" in tmpl["atoms"] else "O4"
            pos[(ri, sub4)] = _nerf(Cb2, N3, Cb4,
                                    0.134 if sub4 == "N4" else 0.123,
                                    120.0, 180.0)
            if "H3" in tmpl["atoms"]:      # thymine/uracil N3-H
                pos[(ri, "H3")] = _nerf(N, Cb2, N3, 0.101, 116.8, 180.0)
            sub5 = "C7" if "C7" in tmpl["atoms"] else "H5"
            pos[(ri, sub5)] = _nerf(N3, Cb4, Cb5,
                                    0.151 if sub5 == "C7" else 0.108,
                                    120.0, 180.0)
            pos[(ri, "H6")] = _nerf(Cb4, Cb5, Cb6, 0.108, 120.0, 180.0)
        prev = {"C4'": C4, "C3'": C3, "O3'": O3}

        # everything else (hydrogens, OP1/OP2, 2'-OH, terminal OH hydrogens)
        # by staggered BFS over the template bond graph
        adj = {}
        for a, b in tmpl["bonds"]:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
        placed = {a for a in tmpl["atoms"] if (ri, a) in pos}
        guard = 0
        while len(placed) < len(tmpl["atoms"]) and guard < 200:
            guard += 1
            for a in list(tmpl["atoms"]):
                if a in placed:
                    continue
                anchors = [b for b in adj.get(a, []) if b in placed]
                if not anchors:
                    continue
                c = anchors[0]
                bnd = [b for b in adj.get(c, []) if b in placed and b != a]
                if not bnd:
                    continue
                b = bnd[0]
                dihrefs = [d for d in adj.get(b, []) if d in placed
                           and d not in (a, c)]
                aref = (pos[(ri, dihrefs[0])] if dihrefs
                        else pos[(ri, b)] + np.array([0.07, 0.11, 0.05]))
                t_a = tmpl["atoms"][a][0]
                r = 0.101 if t_a == "HO" else \
                    0.109 if t_a.startswith("H") else 0.148
                siblings = [s for s in adj.get(c, []) if s in placed
                            and s not in (b,)]
                dih = 60.0 + 120.0 * len(siblings)
                pos[(ri, a)] = _nerf(aref, pos[(ri, b)], pos[(ri, c)],
                                     r, 109.5, dih)
                placed.add(a)

    names, resn, resi, elements, coords_list = [], [], [], [], []
    for ri, res in enumerate(seq):
        tmpl = amber.RESIDUES[res]
        base = res[:-1] if res[-1] in "53N" else res
        pdbname = base[1:] if (rna and base.startswith("R")) else base
        for a in tmpl["atoms"]:
            names.append(a)
            resn.append(pdbname)
            resi.append(ri + 1)
            t = tmpl["atoms"][a][0]
            elements.append("H" if t.startswith("H") else t[0])
            coords_list.append(pos[(ri, a)])
    coords = np.stack(coords_list)
    coords -= coords.mean(axis=0)
    return PDBStructure(names, resn, resi, ["A"] * len(names), elements,
                        coords, None)


def peptide_pdb(sequence, path, minimize=True, maxiter=800, implicit=None,
                device=None):
    """Build a peptide, minimize it (FIRE, ``maxiter`` steps, with OBC2
    solvent when ``implicit="obc2"``) and write it to ``path``.  The
    minimization runs on ``device`` (default: the GPU, raising without
    one; there its steps replay from a CUDA graph)."""
    import torch

    from .._device import resolve_device
    from .forces import potential_energy_flat
    from .minimize import minimize_energy
    from .system import build_system

    struct = build_peptide(sequence)
    write_pdb(path, struct)
    if minimize:
        device = resolve_device(device)
        sys = build_system(path, implicit=implicit, device=device)
        x0 = torch.as_tensor(struct.coords.reshape(-1), dtype=torch.float32,
                             device=device)
        x = minimize_energy(lambda z: potential_energy_flat(sys, z), x0,
                            maxiter=maxiter, graph=True)
        struct.coords = x.detach().cpu().double().numpy().reshape(-1, 3)
        write_pdb(path, struct)
    return path
