"""Molecular dynamics engine of the port: system build (peptide builder,
Amber tables, topology, OBC2, TIP3P solvation), forces (all pairs, and
the O(n) cell-list engine for large periodic systems), rigid-water
constraints, FIRE minimization, integrators and the hand-written CUDA
kernels (LangevinMiddle, Girsanov ABOBA, nonbonded + GBSA forces, the
cell-list pair sweep)."""
