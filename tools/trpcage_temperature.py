"""Kinetic temperature of trp-cage in OBC2 at 310 K and 2 fs, in the JAX
package and in the PyTorch port, from the same start.

    JAX_PLATFORMS=cpu python tools/trpcage_temperature.py [--walkers 8]
        [--steps 5000] [--burn 1000] [--block 500] [--pdb PATH]
        [--redraw STEP]

Both packages build TC5B (313 atoms; ``out/trpcage.pdb`` unless ``--pdb``
names another start) in OBC2 implicit solvent and run noisy
LangevinMiddle (friction 1/ps, no constraints) on the CPU from the PDB's
coordinates with the same Maxwell-Boltzmann velocities (numpy, seed 0)
and independent noise: the JAX package through its plain XLA route
(``force_flat``), the port through its plain route
(``MDSimulation.force`` on the CPU: ``gb_force_plain`` plus the bonded
terms by autograd).  Every 10 steps each walker's kinetic temperature over
3N degrees of freedom is sampled; after ``--burn`` steps the samples are
averaged in blocks of ``--block`` steps per walker, and each package's
mean is printed with its standard error over those (walker, block) means.
With ``--redraw STEP`` both packages draw the same fresh velocities again
at that step (numpy, seed 1), as ``chip_smoke.py``'s temperature witness
does on frames taken from short trajectories.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import isokann_tpu as itk  # noqa: E402
from isokann_tpu.md import integrators as JI  # noqa: E402
from isokann_tpu.md.forces import force_flat as jax_force_flat  # noqa: E402
import isokann_tpu_torch as itt  # noqa: E402
from isokann_tpu_torch.md import integrators as I  # noqa: E402

PDB = os.path.join(os.path.dirname(__file__), "..", "out", "trpcage.pdb")
EVERY = 10


def summary(samples, burn, block):
    """Mean and its standard error over (walker, block) means of the
    temperature samples (n_samples, walkers) taken every EVERY steps."""
    s = samples[burn // EVERY:]
    per = block // EVERY
    nb = s.shape[0] // per
    means = s[:nb * per].reshape(nb, per, -1).mean(axis=1).ravel()
    return float(means.mean()), float(means.std(ddof=1) / np.sqrt(means.size))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--walkers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--burn", type=int, default=1000)
    ap.add_argument("--block", type=int, default=500)
    ap.add_argument("--pdb", default=PDB)
    ap.add_argument("--redraw", type=int, default=None)
    args = ap.parse_args()
    temp, gamma, dt = 310.0, 1.0, 0.002
    js = itk.MDSimulation(pdb=args.pdb, steps=EVERY, implicit="obc2")
    ts = itt.MDSimulation(pdb=args.pdb, steps=EVERY, implicit="obc2",
                          device="cpu")
    m3 = ts.masses3.double().numpy()
    dof = ts.dim
    x0 = np.tile(ts.coords.numpy()[None], (args.walkers, 1))

    def maxwell(seed):
        rng = np.random.default_rng(seed)
        return (rng.normal(size=x0.shape) * np.sqrt(I.KB * temp / m3)
                ).astype(np.float32)

    v0 = maxwell(0)
    print(f"trp-cage: {ts.natoms} atoms, route {ts.route}, {dof} degrees of "
          f"freedom, {args.walkers} walkers, {args.steps} steps of {dt} ps "
          f"at {temp} K", flush=True)

    run = jax.jit(lambda x, v, k: JI.langevin_middle(
        lambda z: jax_force_flat(js.system, z), x, v, js.masses3, temp,
        gamma, dt, EVERY, k))
    jx, jv = jnp.asarray(x0), jnp.asarray(v0)
    tx, tv = torch.as_tensor(x0), torch.as_tensor(v0)
    gen = torch.Generator().manual_seed(1)
    key = jax.random.PRNGKey(1)
    jt, tt = [], []
    t0 = time.time()
    for k in range(args.steps // EVERY):
        if args.redraw is not None and k * EVERY == args.redraw:
            jv, tv = jnp.asarray(maxwell(1)), torch.as_tensor(maxwell(1))
        key, sub = jax.random.split(key)
        jx, jv = run(jx, jv, sub)
        tx, tv = I.langevin_middle(ts.force, tx, tv, ts.masses3, temp,
                                   gamma, dt, EVERY, gen)
        jt.append((m3 * np.asarray(jv, np.float64) ** 2).sum(1)
                  / (dof * I.KB))
        tt.append((m3 * tv.double().numpy() ** 2).sum(1) / (dof * I.KB))
        if (k + 1) % (500 // EVERY) == 0:
            print(f"  step {(k + 1) * EVERY}: jax {np.mean(jt[-50:]):.1f} K, "
                  f"port {np.mean(tt[-50:]):.1f} K over the last 500 steps "
                  f"({time.time() - t0:.0f} s)", flush=True)
    jm, je = summary(np.asarray(jt), args.burn, args.block)
    tm, te = summary(np.asarray(tt), args.burn, args.block)
    diff, err = tm - jm, float(np.hypot(je, te))
    print(f"mean kinetic temperature after {args.burn} steps: jax {jm:.2f} "
          f"+- {je:.2f} K, port {tm:.2f} +- {te:.2f} K; port - jax "
          f"{diff:+.2f} +- {err:.2f} K ({abs(diff) / err:.1f} standard "
          f"errors)", flush=True)


if __name__ == "__main__":
    main()
