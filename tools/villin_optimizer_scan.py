"""Which optimizer settings train the default chi model on villin's
all-pairs features, on one GPU.

    python3 tools/villin_optimizer_scan.py

Builds HP35 from sequence and minimizes it in OBC2 (800 FIRE steps, as
``examples/villin.py``), makes ``MDSimulation(steps=100, implicit="obc2",
features=FeaturesAll())`` (588 atoms, 172,578 features) and one dataset
``from_sim(nx=8, nk=4)``; then, for each setting, a fresh default chi
model (``autonet``: 172578 -> 3100 -> 56 -> 1, 535.5 M parameters, the
same seed) trains ``Iso.run(n)`` on that dataset.  Prints per setting the
seconds, the losses (first, middle, last), the fitted Koopman
contraction lambda that ``optcontrol`` needs in (0, 1], and the ranges of
chi and K chi; or the ``DomainError`` that training raised.  Needs a
CUDA device.
"""

import gc
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import isokann_tpu_torch as itt  # noqa: E402
from isokann_tpu_torch.md.fixtures import peptide_pdb  # noqa: E402
from isokann_tpu_torch.md.integrators import shift_and_scale  # noqa: E402

HP35 = "LSDEDFKAVFGMTRSAFANLPLWKQQNLKKEKGLF"
SETTINGS = [
    ("Adam lr 1e-3", itt.AdamRegularized(), 100),
    ("Adam lr 1e-4", itt.AdamRegularized(adam=1e-4), 100),
    ("Adam lr 1e-5", itt.AdamRegularized(adam=1e-5), 100),
    ("Adam lr 1e-6", itt.AdamRegularized(adam=1e-6), 100),
    ("Adam lr 1e-6", itt.AdamRegularized(adam=1e-6), 300),
    ("Nesterov lr 1e-3", itt.NesterovRegularized(), 100),
    ("Nesterov lr 1e-5", itt.NesterovRegularized(lr=1e-5), 100),
    ("Nesterov lr 1e-6", itt.NesterovRegularized(lr=1e-6), 100),
]


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    pdb = os.path.join(ROOT, "build", "villin_scan", "villin.pdb")
    os.makedirs(os.path.dirname(pdb), exist_ok=True)
    peptide_pdb(HP35, pdb, minimize=True, maxiter=800, implicit="obc2")
    sim = itt.MDSimulation(pdb=pdb, steps=100, implicit="obc2",
                           features=itt.FeaturesAll())
    data = itt.SimulationData.from_sim(sim, nx=8, nk=4,
                                       gen=itt.make_generator(60))
    for name, opt, n in SETTINGS:
        model = sim.defaultmodel(n=data.featuredim,
                                 gen=itt.make_generator(61))
        iso = itt.Iso(data=data, model=model, opt=opt, gen=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            iso.run(n)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            chi = iso.chis().cpu().numpy().ravel()
            kchi = iso.koopman().cpu().numpy().ravel()
            _, lam, _ = shift_and_scale(chi, kchi)
            loss = np.asarray(iso.losses)
            print(f"{name}, run({n}): {dt:.3f} s, loss {loss[0]:.4f} -> "
                  f"{loss[n // 2]:.4f} -> {loss[-1]:.4f}, lambda "
                  f"{lam:.4f}, chi [{chi.min():.4f}, {chi.max():.4f}], "
                  f"K chi [{kchi.min():.4f}, {kchi.max():.4f}]", flush=True)
        except itt.DomainError as e:
            print(f"{name}, run({n}): DomainError after {len(iso.losses)} "
                  f"losses ({str(e)[:60]}...)", flush=True)
        del iso, model
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
