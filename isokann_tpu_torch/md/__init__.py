"""Molecular dynamics engine of the port: system build (peptide builder,
Amber tables, topology, OBC2), forces, FIRE minimization, integrators and
the hand-written CUDA kernels (LangevinMiddle, Girsanov ABOBA, nonbonded
+ GBSA forces)."""
