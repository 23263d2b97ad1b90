"""Molecular dynamics engine of the port: system build, forces,
integrators and the hand-written LangevinMiddle CUDA kernel."""
