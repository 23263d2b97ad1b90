"""Amber ff14SB-class parameters for the capped alanine dipeptide.

A copy of the part of ``isokann_tpu/md/amber.py`` that ``build_system``
reads for ACE-ALA-NME: the residue templates (after the reference's charge
normalisation), every bond/angle/dihedral/improper entry whose atom types
all occur in them (wildcard ``X`` entries included), and the same lookup
rules; a bond or angle with no entry raises instead of taking the
reference's generic fallback.  Units are those of the Amber parameter
files (kcal/mol, Angstrom, degrees); ``system.build_system`` converts to
kJ/mol and nm.
"""

from __future__ import annotations

ATOM_TYPES = {
    'C': (12.01, 1.908, 0.086),
    'CT': (12.01, 1.908, 0.1094),
    'H': (1.008, 0.6, 0.0157),
    'H1': (1.008, 1.387, 0.0157),
    'HC': (1.008, 1.487, 0.0157),
    'N': (14.01, 1.824, 0.17),
    'O': (16.0, 1.6612, 0.21),
}

BONDS = {
    ('C', 'N'): (490.0, 1.335),
    ('C', 'O'): (570.0, 1.229),
    ('C', 'CT'): (317.0, 1.522),
    ('CT', 'CT'): (310.0, 1.526),
    ('CT', 'HC'): (340.0, 1.09),
    ('CT', 'H1'): (340.0, 1.09),
    ('CT', 'N'): (337.0, 1.449),
    ('N', 'H'): (434.0, 1.01),
}

ANGLES = {
    ('C', 'N', 'CT'): (50.0, 121.9),
    ('C', 'N', 'H'): (30.0, 120.0),
    ('CT', 'C', 'N'): (70.0, 116.6),
    ('CT', 'C', 'O'): (80.0, 120.4),
    ('N', 'C', 'O'): (80.0, 122.9),
    ('CT', 'CT', 'C'): (63.0, 111.1),
    ('CT', 'CT', 'N'): (80.0, 109.7),
    ('CT', 'CT', 'CT'): (40.0, 109.5),
    ('CT', 'CT', 'HC'): (50.0, 109.5),
    ('CT', 'CT', 'H1'): (50.0, 109.5),
    ('HC', 'CT', 'HC'): (35.0, 109.5),
    ('H1', 'CT', 'H1'): (35.0, 109.5),
    ('C', 'CT', 'HC'): (50.0, 109.5),
    ('C', 'CT', 'H1'): (50.0, 109.5),
    ('C', 'CT', 'N'): (63.0, 110.1),
    ('C', 'CT', 'CT'): (63.0, 111.1),
    ('H1', 'CT', 'N'): (50.0, 109.5),
    ('CT', 'N', 'H'): (38.0, 118.04),
    ('CT', 'N', 'CT'): (50.0, 118.0),
    ('H', 'N', 'H'): (35.0, 120.0),
}

DIHEDRALS = {
    ('X', 'C', 'N', 'X'): [(2.5, 180.0, 2)],
    ('X', 'CT', 'N', 'X'): [(0.0, 0.0, 2)],
    ('X', 'C', 'CT', 'X'): [(0.0, 0.0, 2)],
    ('X', 'CT', 'CT', 'X'): [(0.15555555555555556, 0.0, 3)],
    ('H', 'N', 'C', 'O'): [(2.5, 180.0, 2), (2.0, 0.0, 1)],
    ('C', 'N', 'CT', 'C'): [(0.0, 0.0, 4), (0.42, 0.0, 3), (0.27, 0.0, 2),
                            (0.0, 0.0, 1)],
    ('N', 'CT', 'C', 'N'): [(0.0, 0.0, 4), (0.55, 180.0, 3), (1.58, 180.0, 2),
                            (0.45, 180.0, 1)],
    ('CT', 'CT', 'N', 'C'): [(0.0, 0.0, 4), (0.4, 0.0, 3), (2.0, 0.0, 2),
                             (2.0, 0.0, 1)],
    ('CT', 'CT', 'C', 'N'): [(0.0, 0.0, 4), (0.4, 0.0, 3), (0.2, 0.0, 2),
                             (0.2, 0.0, 1)],
}

IMPROPERS = {
    ('X', 'X', 'C', 'O'): (10.5, 180.0, 2),
    ('X', 'X', 'N', 'H'): (1.0, 180.0, 2),
    ('X', 'CT', 'N', 'CT'): (1.0, 180.0, 2),
}

RESIDUES = {
    'ACE': {
        "atoms": {
            'HH31': ('HC', 0.1123),
            'CH3': ('CT', -0.3662),
            'HH32': ('HC', 0.1123),
            'HH33': ('HC', 0.1123),
            'C': ('C', 0.5972),
            'O': ('O', -0.5679),
        },
        "bonds": [('CH3', 'HH31'), ('CH3', 'HH32'), ('CH3', 'HH33'),
                  ('CH3', 'C'), ('C', 'O')],
    },
    'ALA': {
        "atoms": {
            'N': ('N', -0.4157),
            'H': ('H', 0.2719),
            'CA': ('CT', 0.0337),
            'HA': ('H1', 0.0823),
            'CB': ('CT', -0.1825),
            'HB1': ('HC', 0.0603),
            'HB2': ('HC', 0.0603),
            'HB3': ('HC', 0.0603),
            'C': ('C', 0.5973),
            'O': ('O', -0.5679),
        },
        "bonds": [('N', 'H'), ('N', 'CA'), ('CA', 'HA'), ('CA', 'CB'),
                  ('CB', 'HB1'), ('CB', 'HB2'), ('CB', 'HB3'), ('CA', 'C'),
                  ('C', 'O')],
    },
    'NME': {
        "atoms": {
            'N': ('N', -0.4157),
            'H': ('H', 0.2719),
            'CH3': ('CT', -0.149),
            'HH31': ('H1', 0.0976),
            'HH32': ('H1', 0.0976),
            'HH33': ('H1', 0.0976),
        },
        "bonds": [('N', 'H'), ('N', 'CH3'), ('CH3', 'HH31'), ('CH3', 'HH32'),
                  ('CH3', 'HH33')],
    },
}

SCEE = 1.0 / 1.2      # electrostatic 1-4 scale
SCNB = 1.0 / 2.0      # LJ 1-4 scale


def lj_params(atom_type: str):
    """(rmin_half [A], eps [kcal/mol])."""
    _, r, e = ATOM_TYPES[atom_type]
    return r, e


def mass(atom_type: str):
    return ATOM_TYPES[atom_type][0]


def lookup_bond(t1, t2):
    k = BONDS.get((t1, t2)) or BONDS.get((t2, t1))
    if k is None:
        raise KeyError(f"no bond parameters for {t1}-{t2}")
    return k


def lookup_angle(t1, t2, t3):
    k = ANGLES.get((t1, t2, t3)) or ANGLES.get((t3, t2, t1))
    if k is None:
        raise KeyError(f"no angle parameters for {t1}-{t2}-{t3}")
    return k


def lookup_dihedral(t1, t2, t3, t4):
    """Most-specific-match proper dihedral lookup."""
    for key in [(t1, t2, t3, t4), (t4, t3, t2, t1)]:
        if key in DIHEDRALS:
            return DIHEDRALS[key]
    for key in [("X", t2, t3, "X"), ("X", t3, t2, "X")]:
        if key in DIHEDRALS:
            return DIHEDRALS[key]
    return [(0.0, 0.0, 2)]


def lookup_improper(t1, t2, tc, t4):
    """Improper lookup with the central atom third; the two peripheral
    slots match in either order and exact matches win over wildcards."""
    for key in ((t1, t2, tc, t4), (t2, t1, tc, t4)):
        if key in IMPROPERS:
            return IMPROPERS[key]
    for key, val in IMPROPERS.items():
        k1, k2, kc, k4 = key
        if kc != tc or k4 not in ("X", t4):
            continue
        if ((k1 in ("X", t1) and k2 in ("X", t2))
                or (k1 in ("X", t2) and k2 in ("X", t1))):
            return val
    return None
