"""Port parity: system build, energies and forces of ``isokann_tpu_torch.md``
against the JAX package on the same inputs (CPU)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md.forces import force_flat as jax_force_flat
from isokann_tpu.md.system import build_system as jax_build_system

from isokann_tpu_torch.md import langevin_kernel as LK
from isokann_tpu_torch.md.fixtures import alanine_dipeptide_pdb
from isokann_tpu_torch.md.forces import energy_terms, force_flat
from isokann_tpu_torch.md.system import build_system

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)


GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "golden",
                      "ala2_vacuum_msm.npz")

FLOAT_FIELDS = ("bond_k", "bond_r0", "angle_k", "angle_t0", "dih_pk",
                "dih_phase", "dih_n", "charges", "rmin_half", "eps",
                "qq_scale", "lj_scale", "masses")
INT_FIELDS = ("bond_idx", "angle_idx", "dih_idx")


@pytest.fixture(scope="module")
def systems():
    pdb = alanine_dipeptide_pdb()
    return jax_build_system(pdb), build_system(pdb, device="cpu")


@pytest.fixture(scope="module")
def xs():
    sim = itk.MDSimulation(steps=10)
    rng = np.random.default_rng(0)
    return (np.asarray(sim.coords)[None, :]
            + rng.normal(scale=0.01, size=(8, 66))).astype(np.float32)


def test_system_fields_match_jax(systems):
    js, ts = systems
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert (ts.method, ts.cutoff, ts.eps_rf, ts.box) == \
        (js.method, js.cutoff, js.eps_rf, js.box)
    assert ts.use_dispersion == js.use_dispersion
    assert ts.disp_c6sum == pytest.approx(js.disp_c6sum, rel=1e-6)
    assert ts.disp_c12sum == pytest.approx(js.disp_c12sum, rel=1e-6)


def test_energy_terms_match_golden(systems):
    g = np.load(GOLDEN)
    keys = [k for k in g.files if k.startswith("eterm_")]
    n = len(g[keys[0]])
    confs = torch.as_tensor(g["xs"][:n].reshape(n, -1, 3))
    terms = energy_terms(systems[1], confs)
    for k in keys:
        got = terms[k[len("eterm_"):]].numpy()
        np.testing.assert_allclose(got, g[k], rtol=2e-3, atol=0.05,
                                   err_msg=k)


def _term_variants(sys, zeros):
    """The system with all terms but one switched off, per term."""
    z = {n: zeros(getattr(sys, n)) for n in
         ("bond_k", "angle_k", "dih_pk", "charges", "eps")}
    keep = {"bond": ("bond_k",), "angle": ("angle_k",),
            "dihedral": ("dih_pk",), "nonbonded": ("charges", "eps")}
    return {term: {k: v for k, v in z.items() if k not in kept}
            for term, kept in keep.items()}


@pytest.mark.parametrize("term", ["bond", "angle", "dihedral", "nonbonded"])
def test_forces_match_jax_per_term(systems, xs, term):
    """Autograd forces and the kernel module's plain forces, one term at
    a time, against JAX ``force_flat`` (1e-5 relative to the largest)."""
    js, ts = systems
    jz = _term_variants(js, lambda a: jnp.zeros(a.shape))[term]
    tz = _term_variants(ts, torch.zeros_like)[term]
    jsys = dataclasses.replace(js, **jz)
    tsys = ts.replace(**tz)
    f_ref = np.asarray(jax_force_flat(jsys, jnp.asarray(xs)))
    scale = max(np.abs(f_ref).max(), 1e-9)
    x = torch.as_tensor(xs)
    f_auto = force_flat(tsys, x).numpy()
    plan = LK.LangevinPlan(tsys, 310.0, 1.0, 0.002)
    f_plain = LK.forces(plan, x).numpy()
    assert np.abs(f_auto - f_ref).max() / scale < 1e-5
    assert np.abs(f_plain - f_ref).max() / scale < 1e-5


def test_nocutoff_forces_match_jax(xs):
    pdb = alanine_dipeptide_pdb()
    js = jax_build_system(pdb, method="NoCutoff")
    ts = build_system(pdb, method="NoCutoff", device="cpu")
    f_ref = np.asarray(jax_force_flat(js, jnp.asarray(xs)))
    x = torch.as_tensor(xs)
    scale = np.abs(f_ref).max()
    assert np.abs(force_flat(ts, x).numpy() - f_ref).max() / scale < 1e-5
    plan = LK.LangevinPlan(ts, 310.0, 1.0, 0.002)
    assert np.abs(LK.forces_plain(plan, x).numpy() - f_ref).max() \
        / scale < 1e-5


def test_unported_method_raises():
    """LJPME is not ported; Ewald and PME build, with the JAX package's
    tables."""
    with pytest.raises(NotImplementedError, match="LJPME"):
        build_system(alanine_dipeptide_pdb(), method="LJPME", device="cpu")
    for method in ("Ewald", "PME"):
        ts = build_system(alanine_dipeptide_pdb(), method=method,
                          device="cpu")
        js = jax_build_system(alanine_dipeptide_pdb(), method=method)
        assert ts.method == method and ts.ewald_alpha == js.ewald_alpha > 0
        np.testing.assert_array_equal(ts.ewald_kvecs.numpy(),
                                      np.asarray(js.ewald_kvecs))
