"""Bundled test systems."""

from __future__ import annotations

import os

_FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "data")


def alanine_dipeptide_pdb() -> str:
    """Path to the bundled, energy-minimised alanine-dipeptide PDB
    (``data/alanine-dipeptide.pdb`` at the repository root)."""
    path = os.path.abspath(os.path.join(_FIXTURE_DIR,
                                        "alanine-dipeptide.pdb"))
    if not os.path.exists(path):
        raise FileNotFoundError(f"bundled alanine dipeptide missing: {path}")
    return path
