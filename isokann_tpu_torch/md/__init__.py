"""Molecular dynamics engine of the port: system build (peptide builder,
Amber tables, topology, OBC2, TIP3P / TIP4P-Ew solvation, virtual sites,
CMAP, tables from resolved parameters), forces (all pairs, the O(n)
cell-list engine and Verlet lists for large periodic systems, Ewald / PME
/ LJPME), constraints, FIRE minimization, integrators, the Monte Carlo
barostat and the hand-written CUDA kernels (LangevinMiddle, Girsanov
ABOBA, nonbonded + GBSA forces, the cell-list pair sweep)."""
from .pdbio import read_pdb, write_pdb, write_pdb_traj, PDBStructure
from .topology import Topology, Residue, build_topology
from .system import MDSystem, build_system, system_from_tables
from . import forces, integrators, amber
from .minimize import minimize_energy
from .barostat import MonteCarloBarostat, npt_langevin, molecule_map
from .vsites import attach_vsites, place_vsites, place_vsites_flat
