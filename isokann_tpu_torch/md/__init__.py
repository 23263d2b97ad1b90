"""Molecular dynamics engine of the port: system build (peptide and
nucleic-acid builders, Amber tables, topology, OBC2, TIP3P / TIP4P-Ew
solvation, virtual sites, CMAP, tables from resolved parameters), the
importers (Amber prmtop / rst7, OpenMM System XML, frcmod / mol2 / ffxml,
ligand perception), forces (all pairs, the O(n) cell-list engine and
Verlet lists for large periodic systems, Ewald / PME / LJPME), constraints, FIRE minimization, integrators, the Monte Carlo
barostat and the hand-written CUDA kernels (LangevinMiddle, Girsanov
ABOBA, nonbonded + GBSA forces, the cell-list pair sweep)."""
from .pdbio import read_pdb, write_pdb, write_pdb_traj, PDBStructure
from .topology import Topology, Residue, build_topology
from .system import MDSystem, build_system, system_from_tables
from . import forces, integrators, amber
from .minimize import minimize_energy
from .barostat import MonteCarloBarostat, npt_langevin, molecule_map
from .ligand import parameterize_ligand
from .importers import (load_frcmod, load_mol2, load_ffxml,
                        register_ligand_frcmod, register_ligand_ffxml,
                        register_forcefield_ffxml)
from .amberio import (load_prmtop, read_rst7, write_rst7,
                      system_from_prmtop, save_prmtop)
from .openmm_xml import load_system_xml, save_system_xml, load_state_xml
from .vsites import attach_vsites, place_vsites, place_vsites_flat
