"""Entry points of the port: the device rule, import isolation from JAX,
and the MDSimulation data path at a small size on the CPU."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import isokann_tpu_torch as itt


# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)


def test_no_device_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        itt.MDSimulation()


def test_build_system_no_device_and_no_gpu_raises(monkeypatch):
    """``build_system`` runs on the card unless the caller names a device;
    with no GPU and no device it raises, as the other entry points do."""
    from isokann_tpu_torch.md.fixtures import alanine_dipeptide_pdb
    from isokann_tpu_torch.md.system import build_system
    pdb = alanine_dipeptide_pdb()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_system(pdb)
    assert build_system(pdb, device="cpu").charges.device.type == "cpu"


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, pulls in
    neither jax, optax nor the JAX package; the walk covers the modules of
    every slice so far."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import isokann_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'isokann_tpu'))\n"
        "print(' '.join(names))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    root = __file__.rsplit("/tests/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    walked = set(out.stdout.split("\n")[0].split())
    assert {f"isokann_tpu_torch.{m}" for m in (
        "md.gb_kernel", "md.minimize", "md.fixtures", "md.amber",
        "md.topology", "md.langevin_kernel", "md.girsanov_kernel",
        "md.neighbor", "md.neighbor_kernel", "md.solvate",
        "md.constraints", "ops.pairdists", "ops.pairdists_kernel",
        "ops.dihedrals", "features", "sample", "data", "iso",
        "simulators.mdsim", "simulators.langevin", "targets", "models",
        "analysis.msm", "goldens", "workflows")} <= walked, out.stdout


def test_propagate_and_randx0_shapes():
    sim = itt.MDSimulation(steps=5, device="cpu")
    gen = itt.make_generator(0)
    xs = sim.randx0(3, gen=gen)
    assert xs.shape == (3, 66) and bool(torch.isfinite(xs).all())
    ys = sim.propagate(xs, 2, gen=gen)
    assert ys.shape == (3, 2, 66) and bool(torch.isfinite(ys).all())
    assert not torch.equal(ys[:, 0], ys[:, 1])
    data = itt.SimulationData.from_sim(sim, nx=3, nk=2, gen=1)
    assert data.features.shape == (3, 231)
    assert data.propfeatures.shape == (3, 2, 231)


def test_diverged_walkers_fall_back_to_start():
    sim = itt.MDSimulation(steps=2, device="cpu")
    x0 = sim.coords[None, :].repeat(2, 1)
    x0[1, :3] = float("nan")
    with pytest.warns(UserWarning, match="diverged"):
        ys = sim.propagate(x0, 1, gen=0)
    assert bool(torch.isfinite(ys[0]).all())
    assert torch.equal(torch.isnan(ys[1]), torch.isnan(x0[1:2]))


def test_iso_from_sim_runs():
    sim = itt.MDSimulation(steps=5, device="cpu")
    iso = itt.Iso(sim=sim, nx=4, nk=2, opt=itt.AdamRegularized(), gen=0)
    iso.run(3)
    assert len(iso.losses) == 3 and np.all(np.isfinite(iso.losses))
    assert iso.chis().shape == (4, 1)
