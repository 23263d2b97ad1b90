"""All-pairs distance features of villin HP35 in the PyTorch port and in the
JAX package, against float64, and what all-pairs features do to the
default training step, on the CPU.

    JAX_PLATFORMS=cpu python tools/pairdist_accuracy.py

1. Accuracy: 4 walkers at ``out/villin.pdb`` + 0.01 nm noise (588 atoms,
   |x| <= 5.05 nm).  Prints the largest error against float64 distances
   of the Gram trick (each package) and of the direct-difference fused
   route (the port's plain version of kernel C, the JAX package's TPU
   kernel in Pallas interpret mode), the gap between the two packages'
   fused routes and between the plain versions of C and C′ and the TPU
   kernels, and the gradient of sum(sin(d)) on the two fused routes.
2. Model set-up: seconds to build and draw the default chi model's first
   layer on the host at 1/8 of its 172,578 inputs (the full layer holds
   535 M weights, 2.14 GB).
3. Training: ``Iso.run`` of a narrow LayerNorm chi model
   (172578 -> 8 -> 1) on 4 start points with 2 bursts of 10 steps each,
   under ``AdamRegularized`` at lr 1e-3 and 1e-6, in both packages on the
   same coordinates: whether training raises ``DomainError``.
"""

import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.experimental.pallas as jax_pallas  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import isokann_tpu as itk  # noqa: E402
from isokann_tpu.data import SimulationData as JaxData  # noqa: E402
from isokann_tpu.models import densenet as jax_densenet  # noqa: E402
from isokann_tpu.ops import pairdists as JP  # noqa: E402
import isokann_tpu_torch as itt  # noqa: E402
from isokann_tpu_torch.md.pdbio import read_pdb  # noqa: E402
from isokann_tpu_torch.models import MLP, densenet  # noqa: E402
from isokann_tpu_torch.ops import pairdists as P  # noqa: E402
from isokann_tpu_torch.ops import pairdists_kernel as PK  # noqa: E402

VILLIN = os.path.join(os.path.dirname(__file__), "..", "out", "villin.pdb")


def accuracy():
    x0 = read_pdb(VILLIN).coords
    rng = np.random.default_rng(0)
    x = (x0[None] + rng.normal(scale=0.01, size=(4,) + x0.shape)
         ).astype(np.float32)
    flat = x.reshape(4, -1)
    i, j = np.triu_indices(x.shape[1], k=1)
    x64 = x.astype(np.float64)
    d64 = np.sqrt(((x64[:, i] - x64[:, j]) ** 2).sum(-1))
    jax_pallas.pallas_call = functools.partial(jax_pallas.pallas_call,
                                               interpret=True)
    routes = {
        "port Gram": P.flatpairdists(torch.as_tensor(flat),
                                     use_kernel=False).numpy(),
        "port fused": P.flatpairdists(torch.as_tensor(flat)).numpy(),
        "JAX Gram": np.asarray(JP.flatpairdists(jnp.asarray(flat))),
        "JAX fused": np.asarray(JP.flatpairdists(jnp.asarray(flat),
                                                 use_pallas=True)),
    }
    print(f"villin, 4 walkers, max |x| {np.abs(x).max():.4f} nm")
    for name, d in routes.items():
        print(f"  {name:10s} max |d - d_float64| "
              f"{np.abs(d - d64).max():.3e} nm")
    print(f"  port fused vs JAX fused: "
          f"{np.abs(routes['port fused'] - routes['JAX fused']).max():.3e}"
          f" nm")
    pj = np.asarray(JP._sqpairdist_fwd_impl(jnp.asarray(x)))
    pt = PK.sqpairdist_fwd_plain(torch.as_tensor(x)).numpy()
    print(f"  C plain vs TPU kernel: {np.abs(pt - pj).max() / pj.max():.3e}"
          f" of the largest squared distance")
    dp = np.triu(rng.normal(size=(4, x.shape[1], x.shape[1])), 1)
    dp = dp.astype(np.float32)
    gj = np.asarray(JP._sqpairdist_bwd_impl(jnp.asarray(x),
                                            jnp.asarray(dp)))
    gt = PK.sqpairdist_bwd_plain(torch.as_tensor(x),
                                 torch.as_tensor(dp)).numpy()
    print(f"  C' plain vs TPU kernel (upper-triangular dp): "
          f"{np.abs(gt - gj).max() / np.abs(gj).max():.3e} of the largest "
          f"|dx|")
    gref = np.asarray(jax.grad(lambda z: jnp.sum(jnp.sin(
        JP.flatpairdists(z, use_pallas=True))))(jnp.asarray(flat)))
    z = torch.as_tensor(flat).requires_grad_(True)
    torch.sin(P.flatpairdists(z)).sum().backward()
    print(f"  gradient of sum(sin(d)), port fused vs JAX fused: "
          f"{np.abs(z.grad.numpy() - gref).max() / np.abs(gref).max():.3e}"
          f" of the largest entry")


def model_setup():
    n = 172578 // 8
    t0 = time.perf_counter()
    MLP([n, 3100], gen=0)
    print(f"host draw of a ({n}, 3100) layer (1/8 of the default model's "
          f"first layer): {time.perf_counter() - t0:.2f} s on "
          f"{torch.get_num_threads()} threads")


def training():
    sim = itt.MDSimulation(pdb=VILLIN, steps=10, implicit="obc2",
                           features=itt.FeaturesAll(), device="cpu")
    data = itt.SimulationData.from_sim(sim, nx=4, nk=2,
                                       gen=itt.make_generator(60))
    jsim = itk.MDSimulation(pdb=VILLIN, steps=10, implicit="obc2",
                            features=itk.FeaturesAll())
    jdata = JaxData.from_coords(jsim, data.coords.numpy(),
                                data.propcoords.numpy())
    for lr in (1e-3, 1e-6):
        iso = itt.Iso(data=data, model=densenet([172578, 8, 1],
                                                layernorm=True, gen=1),
                      opt=itt.AdamRegularized(adam=lr), gen=0)
        jiso = itk.Iso(data=jdata, model=jax_densenet(
            [172578, 8, 1], layernorm=True, key=jax.random.PRNGKey(1)),
            opt=itk.AdamRegularized(adam=lr), key=0, shard=False)
        for name, it in (("port", iso), ("JAX", jiso)):
            try:
                it.run(10)
                out = f"loss {it.losses[0]:.4f} -> {it.losses[-1]:.4f}"
            except (itt.DomainError, itk.DomainError) as e:
                out = f"{type(e).__name__} after {len(it.losses)} losses"
            print(f"Adam lr {lr:g}, {name}: run(10) {out}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    accuracy()
    model_setup()
    training()
