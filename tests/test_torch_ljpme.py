"""Port parity of LJPME, the Ewald-summed r^-6 dispersion
(``md/ewald.py``, method "LJPME"): the kernels h(r), dh/d(r^2) and h^(k)
and the coefficients against the JAX package and float64, the series
branch's crossing, the brute-force lattice-sum anchor of the JAX test,
the water box's tables and energies (dense, neighbor, at a box given at
run time) against the JAX package, and the dispersion term of kernel E's
plain version against the tensor sweep (CPU)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md import ewald as JE
from isokann_tpu.md import forces as JF
from isokann_tpu.md import neighbor as JN
from isokann_tpu.md.system import build_system as jax_build

from isokann_tpu_torch.md import ewald as E
from isokann_tpu_torch.md import forces as F
from isokann_tpu_torch.md import neighbor as NB
from isokann_tpu_torch.md import neighbor_kernel as NK
from isokann_tpu_torch.md.system import build_system, system_from_tables

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)


def _hhat64(k2, beta):
    import scipy.special as sp
    b2 = k2 / (4.0 * beta * beta)
    b = math.sqrt(b2)
    return (math.pi ** 1.5 * beta ** 3 / 3.0) * (
        (1.0 - 2.0 * b2) * math.exp(-b2)
        + 2.0 * math.sqrt(math.pi) * b2 * b * sp.erfc(b))


def test_hhat_and_coefs_match_jax_and_float64():
    """h^(k) in float32 within 2e-4 of h^(0) of the float64 closed form
    (the JAX test's bound), and within 1e-5 relative of the JAX
    package's; the float64 coefficients equal JAX's to 1e-12."""
    beta = 2.7
    scale = _hhat64(0.0, beta)
    for k in (0.0, 0.5, 2.0, 5.0, 12.0):
        got = float(E.ljpme_hhat(torch.tensor(k * k, dtype=torch.float32),
                                 beta))
        assert abs(got - _hhat64(k * k, beta)) < 2e-4 * scale, k
        assert abs(got - float(JE.ljpme_hhat(jnp.asarray(k * k), beta))) \
            < 1e-5 * scale, k
    box = (3.1, 2.7, 2.9)
    kv, _ = E.ewald_kvectors(box, beta, 5e-4)
    np.testing.assert_allclose(E.ljpme_coefs(box, beta, kv),
                               JE.ljpme_coefs(box, beta, kv), rtol=1e-12)


def test_hker_and_grad_match_jax_across_the_series_switch():
    """h and dh/d(r^2) equal the JAX package's (1e-5 relative) on both
    sides of u = 0.1225; dh/d(r^2) equals autograd of h (2e-3, the JAX
    test's bound); the series and direct forms meet at the switch (2e-4)
    against float64."""
    beta = 3.1
    r2 = torch.tensor([0.004, 0.009, 0.0121, 0.0127, 0.013, 0.04, 0.25,
                       1.0])
    h, dh = E.ljpme_hker_grad(r2, beta)
    hj, dhj = JE.ljpme_hker_grad(jnp.asarray(r2.numpy()), beta)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=1e-5)
    np.testing.assert_allclose(dh.numpy(), np.asarray(dhj), rtol=1e-5)
    np.testing.assert_allclose(E.ljpme_hker(r2, beta).numpy(), h.numpy(),
                               rtol=1e-6)
    rg = r2.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(E.ljpme_hker(rg, beta).sum(), rg)
    np.testing.assert_allclose(dh.numpy(), g.numpy(), rtol=2e-3,
                               atol=1e-3 * float(g.abs().max()))
    # the kernel's form of dh/d(r^2) (neighbor_kernel.ljpme_dh)
    np.testing.assert_allclose(NK.ljpme_dh(r2, beta).numpy(), dh.numpy(),
                               rtol=2e-5)
    for x in (0.2, 0.3, 0.34, 0.36, 0.5, 1.0):
        r2x = (x / beta) ** 2
        direct = (1.0 - (1.0 + x * x + x ** 4 / 2.0) * math.exp(-x * x)) \
            / r2x ** 3
        got = float(E.ljpme_hker(torch.tensor(r2x, dtype=torch.float32),
                                 beta))
        assert got == pytest.approx(direct, rel=2e-4), x


def _lj_gas(n=24, L=1.6, rmin_half=0.17, eps=0.6, cutoff=0.75, tol=1e-5,
            seed=0):
    """The JAX test's uniform-type neutral LJ gas (geometric == Amber
    mixing for one type, so lattice sums are the truth) as a port system
    and its float32 coordinates."""
    rng = np.random.default_rng(seed)
    g = int(np.ceil(n ** (1 / 3)))
    pts = np.stack(np.meshgrid(*[np.arange(g)] * 3), -1).reshape(-1, 3)
    x = (pts[:n] + 0.5 + 0.25 * rng.uniform(-1, 1, (n, 3))) * (L / g)
    sys = system_from_tables(
        masses=[40.0] * n, charges=[0.0] * n, rmin_half=[rmin_half] * n,
        eps=[eps] * n, method="LJPME", cutoff=cutoff, box=(L, L, L),
        ewald_tol=tol, device="cpu")
    return sys, x


def _brute_lattice_lj(x, L, rmin_half, eps, nimg=7):
    """Float64 brute-force periodic LJ energy over image cells |n| <= nimg
    plus the continuum remainder of the r^-6 part (the JAX test's)."""
    n = x.shape[0]
    c6 = 2.0 * eps * (2.0 * rmin_half) ** 6
    c12 = eps * (2.0 * rmin_half) ** 12
    e = 0.0
    rng = range(-nimg, nimg + 1)
    for ax in rng:
        for ay in rng:
            for az in rng:
                d = x[:, None, :] - x[None, :, :] + np.array(
                    [ax, ay, az], float) * L
                r2 = np.sum(d * d, axis=-1)
                if ax == ay == az == 0:
                    np.fill_diagonal(r2, np.inf)
                r6 = r2 ** 3
                e += 0.5 * np.sum(c12 / (r6 * r6) - c6 / r6)
    R = (nimg + 0.5) * L
    return e - 0.5 * n * n * (4.0 * math.pi / L ** 3) * c6 / (3.0 * R ** 3)


@pytest.mark.parametrize("L,cutoff,tol,seed", [(1.6, 0.75, 2e-3, 0),
                                               (1.3, 0.6, 3e-3, 1),
                                               (2.0, 0.6, 3e-3, 1)])
def test_lattice_sum_anchor(L, cutoff, tol, seed):
    """The dense LJPME energy of the LJ gas equals the brute-force lattice
    sum (the JAX test's bounds) across densities, translation leaves it,
    and the net force vanishes."""
    sys, x = _lj_gas(L=L, cutoff=cutoff, seed=seed)
    xt = torch.as_tensor(x, dtype=torch.float32)[None]
    e = float(F.nonbonded_energy(sys, xt)[0])
    e_ref = _brute_lattice_lj(x, L, 0.17, 0.6)
    assert e == pytest.approx(e_ref, abs=max(0.02, tol * abs(e_ref)))
    e1 = float(F.nonbonded_energy(sys, xt + torch.tensor([0.31, -0.2,
                                                          0.11]))[0])
    assert e1 == pytest.approx(e, abs=5e-3 + 1e-5 * abs(e))
    xg = xt.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(F.nonbonded_energy(sys, xg).sum(), xg)
    assert float(g.sum(1).abs().max()) < 5e-3 * float(g.abs().max())


@pytest.fixture(scope="module")
def water():
    """The JAX test's LJPME water box (alanine, padding 0.62): JAX dense,
    the port dense and sparse, the JAX sparse, and the coordinates."""
    base = itk.MDSimulation(addwater=True, padding=0.62)
    from isokann_tpu_torch.md.pdbio import PDBStructure
    st = base.structure
    tst = PDBStructure(st.atom_names, st.res_names, st.res_ids,
                       st.chain_ids, st.elements, st.coords, st.box)
    x = np.asarray(base.coords).reshape(-1, 3).astype(np.float32)
    return dict(
        jd=jax_build(st, method="LJPME"),
        js=jax_build(st, method="LJPME", dense_pairs=False),
        td=build_system(tst, method="LJPME", device="cpu"),
        ts=build_system(tst, method="LJPME", dense_pairs=False,
                        device="cpu"),
        tew=build_system(tst, method="Ewald", device="cpu"), x=x)


def test_water_box_tables_match_jax(water):
    jd, td = water["jd"], water["td"]
    assert td.method == "LJPME" and not td.use_dispersion
    assert td.ljpme_beta == jd.ljpme_beta == td.ewald_alpha
    np.testing.assert_allclose(td.q6.numpy(), np.asarray(jd.q6), rtol=1e-6)
    np.testing.assert_allclose(td.ljpme_coefs.numpy(),
                               np.asarray(jd.ljpme_coefs), rtol=1e-6)
    np.testing.assert_allclose(td.ewald_kvecs.numpy(),
                               np.asarray(jd.ewald_kvecs), rtol=1e-6)


def test_water_box_energies_match_jax(water):
    """The dense LJPME nonbonded energy within 1e-5 relative of the JAX
    package's (also at a box given at run time, 3% larger); the LJPME -
    Ewald difference within 35% of the isotropic tail correction (the
    JAX test's bound: the same physics)."""
    td, jd, x = water["td"], water["jd"], water["x"]
    xt = torch.as_tensor(x)[None]
    e_t = float(F.nonbonded_energy(td, xt)[0])
    e_j = float(JF.nonbonded_energy(jd, jnp.asarray(x)))
    assert abs(e_t - e_j) < 1e-5 * abs(e_j)
    box2 = tuple(1.03 * b for b in td.box)
    e_t2 = float(F.nonbonded_energy(td, xt, box=box2)[0])
    e_j2 = float(JF.nonbonded_energy(jd, jnp.asarray(x),
                                     box=jnp.asarray(box2, jnp.float32)))
    assert abs(e_t2 - e_j2) < 1e-5 * abs(e_j2)
    e_same = float(F.nonbonded_energy(td, xt, box=td.box)[0])
    assert e_same == pytest.approx(e_t, abs=0.05 + 1e-5 * abs(e_t))
    d = e_t - float(F.nonbonded_energy(water["tew"], xt)[0])
    tail = float(F.dispersion_correction_energy(water["tew"]))
    assert tail < 0 and d < 0 and d == pytest.approx(tail, rel=0.35)


def test_neighbor_route_matches_dense_and_jax(water):
    """The O(n) LJPME energy equals the dense one within 0.2 + 2e-4|E| and
    the JAX neighbor engine's within 1e-5 relative; its analytic forces
    equal autograd of its energy (5e-4 max|f| + 0.5, the JAX test's
    bounds), and the batched wrapper's equal them within 1e-4 of the
    largest."""
    ts, td, js, x = water["ts"], water["td"], water["js"], water["x"]
    plan = NB.NeighborPlan(ts, x0=x)
    xt = torch.as_tensor(x)
    e_s = float(NB.neighbor_nonbonded_energy(ts, xt, plan))
    e_d = float(F.nonbonded_energy(td, xt[None])[0])
    assert e_s == pytest.approx(e_d, abs=0.2 + 2e-4 * abs(e_d))
    e_j = float(JN.neighbor_nonbonded_energy(
        js, jnp.asarray(x), JN.NeighborPlan(js, x0=x)))
    assert abs(e_s - e_j) < 1e-5 * abs(e_j)
    f_a = NB.force_neighbor(ts, xt, plan).numpy()
    xg = xt.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(NB.potential_energy_neighbor(ts, xg, plan),
                               xg)
    scale = float(g.abs().max())
    assert np.abs(f_a + g.numpy()).max() < 5e-4 * scale + 0.5
    # the batched wrapper: kernel E's plain version with its dispersion
    # term, the exceptions, both reciprocal sums and the bonded terms
    f_w = NB.force_flat_neighbor(ts, xt.reshape(1, -1), plan)
    assert np.abs(f_w.numpy().reshape(-1, 3) - f_a).max() < 1e-4 * scale


def test_kernel_plain_dispersion_term_matches_the_tensor_sweep(water):
    """Kernel E's plain version with ``beta`` (its records' q6 from
    sqrt(eps) and Rmin/2) equals the tensor sweep's forces (q6 from the
    system) within 1e-5 of the largest, and without ``beta`` differs by
    the dispersion term."""
    ts, x = water["ts"], water["x"]
    plan = NB.NeighborPlan(ts, x0=x)
    xt = torch.as_tensor(x)
    f_sweep = NB._sweep(ts, plan, xt, True, NB._alpha(ts)).numpy()
    f_k = NK.neighbor_sweep(ts, plan, xt.reshape(1, -1), NB._alpha(ts),
                            NB._beta(ts))[0].numpy().reshape(-1, 3)
    scale = np.abs(f_sweep).max()
    assert np.abs(f_k - f_sweep).max() < 1e-5 * scale
    f_no = NK.neighbor_sweep(ts, plan, xt.reshape(1, -1),
                             NB._alpha(ts))[0].numpy().reshape(-1, 3)
    assert np.abs(f_no - f_sweep).max() > 1e-3


@pytest.mark.parametrize("entry", ["neighbor_sweep", "neighbor_layout"])
def test_kernel_e_bindings_match_the_c_signatures(entry):
    """The ctypes declarations of kernel E's two entry points take as many
    arguments as ``csrc/neighbor_sweep.cu`` declares (the LJPME branch and
    the box added arguments; a mismatch shows only at the first launch on
    the card), pointers and the stream as ``c_void_p``."""
    import ctypes
    import os
    import re
    from types import SimpleNamespace
    src = open(os.path.join(os.path.dirname(NK.__file__), "..", "csrc",
                            "neighbor_sweep.cu")).read()
    params = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)",
                       src).group(1).split(",")
    wrapper = (NK.neighbor_sweep if entry == "neighbor_sweep"
               else NK.neighbor_layout)
    lib = SimpleNamespace(**{entry: SimpleNamespace()})
    wrapper._declare(lib)
    argtypes = getattr(lib, entry).argtypes
    assert len(argtypes) == len(params)
    for c, t in zip(params, argtypes):
        kind = (ctypes.c_void_p if "*" in c else
                ctypes.c_float if "float" in c else ctypes.c_int)
        assert t is kind, (c, t)
