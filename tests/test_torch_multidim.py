"""Port parity of the multi-dimensional learner and the learner's
diagnostics against the JAX package on the CPU.

A Triplewell ``Iso`` with nout=3 and minibatch=0 (full batch) is built
in both packages on the same data, the JAX model's weights carried over
by ``weights.load_jax_params``: the default target is ``TransformISA``,
and one ``run(1)`` (host target, per-dimension weighting) gives the same
losses and parameters at 1e-4.  ``growmodel``, ``chicoords``, the rates,
``chi_exit_rate``, ``koopman_variance``, ``simulationtime``,
``validationloss`` and the residuals agree at 1e-5 on a shared model; a
save/load round trip gives equal chis and continues identically."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu import targets as JT
from isokann_tpu.models import growmodel as jax_growmodel

import isokann_tpu_torch as itt
from isokann_tpu_torch import targets as PT
from isokann_tpu_torch.models import growmodel, smallnet
from isokann_tpu_torch.weights import load_jax_params

torch.set_num_threads(1)


def close(got, ref, tol=1e-5):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err <= tol, f"max rel err {err:.3e} > {tol}"


def params_np(jiso):
    return jax.tree_util.tree_map(np.asarray, jiso.model.params)


def port_iso(jiso, psim, **kw):
    """The port's Iso on the JAX Iso's coordinates and weights."""
    d = jiso.data
    data = itt.SimulationData.from_coords(
        psim, torch.tensor(np.asarray(d.coords)),
        torch.tensor(np.asarray(d.propcoords)))
    m = jiso.model
    model = load_jax_params(
        itt.MLP(m.sizes, m.activation, m.lastactivation, m.layernorm),
        params_np(jiso))
    return itt.Iso(data=data, model=model, **kw)


@pytest.fixture(scope="module")
def triple():
    """A JAX Triplewell Iso after 30 ISA iterations: the chi columns are
    distinct, so that no near-tie decides the ISA vertices or the column
    permutation (an untrained chi is near constant in every column)."""
    jiso = itk.Iso(sim=itk.Triplewell(), nx=32, nk=4, nout=3, minibatch=0,
                   key=0, opt=itk.AdamRegularized(1e-2))
    jiso.run(30)
    return jiso


def test_default_target_is_isa(triple):
    piso = port_iso(triple, itt.Triplewell(device="cpu"), minibatch=0)
    assert isinstance(triple.target, JT.TransformISA)
    assert isinstance(piso.target, PT.TransformISA)
    assert isinstance(itt.Iso(sim=itt.Triplewell(device="cpu"), nx=8, nk=2,
                              nout=3, gen=0).target, PT.TransformISA)
    assert isinstance(itt.Iso(sim=itt.Triplewell(device="cpu"), nx=8, nk=2,
                              gen=0).target, PT.TransformShiftscale)


def test_isotarget_matches_jax(triple):
    """chi at 1e-6 against the JAX model; the port's ``isotarget`` (one
    forward over xs and ys, one transfer) equals the JAX package's
    ``TransformISA`` on those chi values.  (Against the JAX package's own
    chi the ISA target moves by ~3e-5: the inverse of the 3 x 3 vertex
    matrix magnifies the float32 chi differences of XLA and PyTorch.)"""
    piso = port_iso(triple, itt.Triplewell(device="cpu"), minibatch=0)
    xs = np.asarray(triple.data.features)
    ys = np.asarray(triple.data.propfeatures)

    @torch.no_grad()
    def chi(z):
        return piso.model(torch.tensor(z)).numpy()

    close(chi(xs), np.asarray(triple.chis()), 1e-6)
    close(chi(ys), np.asarray(triple.model(jnp.asarray(ys))), 1e-6)
    before = PT.stacked_fallback_count
    got = PT.isotarget(piso)
    assert PT.stacked_fallback_count == before
    close(got, np.asarray(JT.TransformISA()(chi, xs, ys)), 1e-6)


def test_isa_run_one_iteration_matches_jax(triple):
    """One Koopman iteration with the ISA target: losses and every
    parameter at 1e-4 (the default NesterovRegularized)."""
    jiso = itk.Iso(data=triple.data, model=copy.deepcopy(triple.model),
                   minibatch=0, key=0)
    piso = port_iso(jiso, itt.Triplewell(device="cpu"), minibatch=0)
    jiso.run(1)
    piso.run(1)
    close(piso.losses, jiso.losses, 1e-4)
    ref = load_jax_params(smallnet(2, nout=3), params_np(jiso)).state_dict()
    for k, v in piso.model.state_dict().items():
        close(v, ref[k].numpy(), 1e-4)


def test_fused_target_weights_dimensions_by_std():
    """A fused target of d > 1 dimensions: the loss weights each
    dimension by 1 / (masked std + 1e-12) over the real rows, so the
    padding rows (40 rows in a bucket of 48) change nothing."""
    sim = itt.Triplewell(device="cpu")

    class Columns:
        fused = True

        def fused_target(self, kchi, mask=None, n_true=None):
            return kchi * torch.tensor([1.0, 10.0, 100.0])

    iso = itt.Iso(sim=sim, nx=40, nk=2, nout=3, minibatch=0, gen=0,
                  target=Columns())
    x = iso.data.features
    with torch.no_grad():
        t = itt.expectation(iso.model, iso.data.propfeatures) * torch.tensor(
            [1.0, 10.0, 100.0])
        w = 1.0 / (t.std(dim=0, unbiased=False) + 1e-12)
        want = float(torch.mean(torch.sum(((iso.model(x) - t) * w) ** 2, 1)))
    iso.run(1)
    assert iso.losses[0] == pytest.approx(want, rel=1e-5)


@pytest.fixture(scope="module")
def double():
    """A JAX Doublewell Iso trained 50 iterations, its twin in the port
    with the same weights, and held-out validation data."""
    jiso = itk.Iso(sim=itk.Doublewell(), nx=32, nk=8, key=1,
                   opt=itk.AdamRegularized())
    jiso.run(50)
    piso = port_iso(jiso, itt.Doublewell(device="cpu"))
    vsim = itk.Doublewell()
    vx = vsim.randx0(16, key=jax.random.PRNGKey(2))
    vy = vsim.propagate(vx, 8, key=jax.random.PRNGKey(3))
    val = (np.asarray(vx), np.asarray(vy))
    return jiso, piso, val


def test_chis_koopman_chicoords(double):
    jiso, piso, _ = double
    close(piso.chis(), np.asarray(jiso.chis()))
    close(piso.koopman(), np.asarray(jiso.koopman()))
    xs = np.linspace(-1.5, 1.5, 31, dtype=np.float32)[:, None]
    close(piso.chicoords(xs), np.asarray(jiso.chicoords(jnp.asarray(xs))))
    c, k = piso.chi_kchi()
    jc, jk = jiso.chi_kchi()
    close(c, np.asarray(jc))
    close(k, np.asarray(jk))


def test_rates_and_exit_rates(double):
    jiso, piso, _ = double
    close(piso.rates(), jiso.rates())
    close(piso.exit_rates(), jiso.exit_rates())
    close(piso.chi_exit_rate(), jiso.chi_exit_rate())
    x, kx = np.asarray(jiso.chis()), np.asarray(jiso.koopman())
    close(itt.iso.chi_exit_rate(x, kx, 1.0),
          itk.iso.chi_exit_rate(x, kx, 1.0), 1e-12)


def test_variance_time_validation(double):
    jiso, piso, val = double
    close(piso.koopman_variance(), jiso.koopman_variance())
    assert piso.simulationtime() == jiso.simulationtime() == 256.0
    close(itt.validationloss(piso, val), itk.validationloss(jiso, val))


def test_residuals_match_jax(double):
    jiso, piso, _ = double
    got, ref = PT.residual_linear(piso), JT.residual_linear(jiso)
    close(got["relres"], ref["relres"])
    close(got["lambda"], ref["lambda"])
    got, ref = PT.residual_ritz(piso), JT.residual_ritz(jiso)
    close(got["vals"], ref["vals"])
    close(got["relres"], ref["relres"], 1e-4)
    got, ref = PT.residual_subspace(piso), JT.residual_subspace(jiso)
    close(got["res"], ref["res"], 1e-4)


def test_growmodel_matches_jax(double):
    jiso, piso, _ = double
    jg = jax_growmodel(jiso.model, 3, key=jax.random.PRNGKey(4))
    pg = growmodel(piso.model, 3, gen=4)
    assert pg.sizes == jg.sizes == (1, 8, 8, 8, 3)
    for a, b in zip(pg.layers[:-1], piso.model.layers[:-1]):
        assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    assert float(pg.layers[-1].bias.detach().abs().max()) == 0.0
    # with the JAX draw of the new layer, the outputs agree
    pg.load_state_dict(load_jax_params(
        itt.MLP(jg.sizes), jax.tree_util.tree_map(np.asarray, jg.params))
        .state_dict())
    xs = np.linspace(-1.5, 1.5, 17, dtype=np.float32)[:, None]
    with torch.no_grad():
        close(pg(torch.as_tensor(xs)), np.asarray(jg(jnp.asarray(xs))))


def test_loggers_match_jax(double):
    jiso, piso, val = double
    jl = itk.FunctionLogger(f=lambda iso: len(iso.losses), logevery=2)
    pl = itt.FunctionLogger(f=lambda iso: len(iso.losses), logevery=2)
    jv, pv = itk.ValidationLogger(val, 3), itt.ValidationLogger(val, 3)
    j = itk.Iso(data=jiso.data, model=jiso.model, loggers=[jl, jv],
                opt=itk.AdamRegularized(), key=5)
    p = itt.Iso(data=piso.data, model=growmodel(piso.model, 1, gen=0),
                loggers=[pl, pv], opt=itt.AdamRegularized(), gen=5,
                validation=val)
    p.model.load_state_dict(piso.model.state_dict())
    j.run(6)
    p.run(6)
    assert pl.values == jl.values == [2, 4, 6]
    # both run in chunks of min(logevery) = 2: the validation logger
    # (every 3) fires at 4 only
    assert pv.iters == jv.iters == [4]
    assert p.loggers[-1].iters == [] and p.loggers[-1].diagnostic()[1] is None
    p.run(4)
    assert p.loggers[-1].iters == [10]


def test_save_load_round_trip(tmp_path, triple):
    """The Triplewell learner after two ISA iterations: the loaded copy
    gives the same chis bit for bit and the same next iteration."""
    piso = port_iso(triple, itt.Triplewell(device="cpu"), minibatch=0,
                    opt=itt.AdamRegularized())
    piso.run(2)
    piso.data.sim.bias = lambda x, t, sigma, F: x      # not pickled
    path = tmp_path / "iso.pt"
    piso.save(path)
    loaded = itt.load(path, device="cpu")
    assert loaded.data.sim.bias is None and piso.data.sim.bias is not None
    assert isinstance(loaded.target, PT.TransformISA)
    assert torch.equal(loaded.chis(), piso.chis())
    assert loaded.losses == piso.losses
    piso.data.sim.bias = None
    piso.run(1)
    loaded.run(1)
    assert loaded.losses == piso.losses
    with pytest.raises(ValueError, match="pass sim="):
        itt.load(path, device="meta")


def test_load_optimizer_state_keeps_capturable_flags():
    """A snapshot of a capturable Adam (as on the card) loads into this
    optimiser with its own flag and its step counters on the CPU, and
    the next step runs."""
    from isokann_tpu_torch.iso import _load_optimizer_state

    m1, m2 = smallnet(2, nout=3, gen=0), smallnet(2, nout=3, gen=1)
    o1 = itt.AdamRegularized()(m1.parameters())
    o2 = itt.AdamRegularized()(m2.parameters())
    m1(torch.ones(4, 2)).sum().backward()
    o1.step()
    sd = o1.state_dict()
    sd["param_groups"][0]["capturable"] = True
    _load_optimizer_state(o2, sd)
    assert o2.param_groups[0]["capturable"] is False
    steps = [st["step"] for st in o2.state.values()]
    assert steps and all(s.device.type == "cpu" and float(s) == 1.0
                         for s in steps)
    m2(torch.ones(4, 2)).sum().backward()
    o2.step()
    assert all(float(st["step"]) == 2.0 for st in o2.state.values())
