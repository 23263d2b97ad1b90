"""Kinetic temperature of a solvated peptide relaxing from the water
lattice, in the PyTorch port and in the JAX package, side by side.

    JAX_PLATFORMS=cpu python tools/solvated_relaxation.py [--padding 0.7]
        [--walkers 4] [--chunks 30]

Both packages build the bundled alanine dipeptide in a TIP3P box
(``MDSimulation(addwater=True, dense_pairs=False)``: rigid water, the
cell-list engine) and run the constrained LangevinMiddle recursion at
310 K, friction 1/ps, 2 fs from the same start with zero velocities and
independent noise, on the CPU (the port through its plain sweep).  Every
100 steps it prints each package's kinetic temperature over 3N - 3 nwater
degrees of freedom, averaged over the walkers: the lattice start releases
potential energy as the waters orient, and the check is that both
packages relax alike.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import isokann_tpu as itk  # noqa: E402
from isokann_tpu.md import integrators as JI  # noqa: E402
from isokann_tpu.md import neighbor as JN  # noqa: E402
import isokann_tpu_torch as itt  # noqa: E402
from isokann_tpu_torch.md import integrators as I  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--padding", type=float, default=0.7)
    ap.add_argument("--walkers", type=int, default=4)
    ap.add_argument("--chunks", type=int, default=30)
    args = ap.parse_args()
    kw = dict(addwater=True, padding=args.padding, steps=3,
              dense_pairs=False)
    js = itk.MDSimulation(**kw)
    ts = itt.MDSimulation(device="cpu", **kw)
    steps, dt, temp, gamma = 100, 0.002, 310.0, 1.0
    dof = ts.dim - 3 * ts.constraint_set.nwater
    m3 = ts.masses3
    jm3 = np.asarray(js.masses3)
    print(f"{ts.natoms} atoms, {ts.constraint_set.nwater} rigid waters, "
          f"{dof} degrees of freedom, {args.walkers} walkers", flush=True)

    x = ts.coords[None].repeat(args.walkers, 1)
    v = torch.zeros_like(x)
    gen = torch.Generator().manual_seed(0)
    plan = JN.NeighborPlan(js.system,
                           x0=np.asarray(js.coords).reshape(-1, 3))

    def jforce(z):
        return jax.vmap(lambda xi: JN.force_neighbor(
            js.system, xi.reshape(-1, 3), plan).reshape(-1))(z)

    run = jax.jit(lambda x, v, k: JI.langevin_middle(
        jforce, x, v, js.masses3, temp, gamma, dt, steps, k,
        constraints=js.constraint_set))
    jx, jv = jax.numpy.asarray(x.numpy()), jax.numpy.zeros(x.shape)
    key = jax.random.PRNGKey(0)
    for c in range(args.chunks):
        t0 = time.time()
        x, v = I.langevin_middle(ts.force, x, v, m3, temp, gamma, dt, steps,
                                 gen, ts.constraint_set)
        key, sub = jax.random.split(key)
        jx, jv = run(jx, jv, sub)
        t_port = float((m3 * v * v).sum(1).mean() / (dof * I.KB))
        t_jax = float((jm3 * np.asarray(jv) ** 2).sum(1).mean()
                      / (dof * I.KB))
        print(f"t={(c + 1) * steps * dt:.1f} ps  port {t_port:.1f} K  "
              f"jax {t_jax:.1f} K  ({time.time() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
