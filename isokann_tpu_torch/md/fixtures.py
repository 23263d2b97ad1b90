"""Bundled test systems and the peptide builder; counterpart of
``isokann_tpu/md/fixtures.py`` (``_nerf``, ``build_peptide``,
``peptide_pdb`` and the bundled alanine dipeptide).

``build_peptide`` places an extended chain by NeRF from standard internal
coordinates, with template-driven side chains (crude geometry, meant to
be minimized); ``peptide_pdb`` writes it, minimizes it with FIRE on the
port's own force field and writes it again.
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
