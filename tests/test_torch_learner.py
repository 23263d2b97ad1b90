"""Port parity of the learner: features, chi model, optimiser, target,
and the whole slice (features + Koopman training + chis), against the JAX
package on the same numpy inputs and parameters (CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.data import SimulationData as JaxData
from isokann_tpu.features import FeaturesAll as JaxFeaturesAll
from isokann_tpu.models import pairnet as jax_pairnet
from isokann_tpu.targets import shiftscale as jax_shiftscale
from isokann_tpu.targets import shiftscale_jit as jax_shiftscale_jit

import isokann_tpu_torch as itt
from isokann_tpu_torch.data import bucket_capacity, pad_rows
from isokann_tpu_torch.iso import rates
from isokann_tpu_torch.targets import shiftscale, shiftscale_jit
from isokann_tpu_torch.weights import load_jax_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)


GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "golden",
                      "ala2_vacuum_msm.npz")


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    return g["xs"][:20], g["ys"][:20, :5]


def _params_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_features_all_on_golden_xs(golden):
    """Both packages use the Gram trick |xi|^2 + |xj|^2 - 2 xi.xj in f32,
    whose cancellation alone puts the JAX values 6.1e-6 nm from the exact
    distances on these coordinates (|x| ~ 1.5 nm).  So the port is held to
    1e-5 nm against JAX and against float64 distances, not to 1e-6."""
    xs = golden[0]
    ref = np.asarray(JaxFeaturesAll()(jnp.asarray(xs)))
    got = itt.FeaturesAll()(torch.as_tensor(xs)).numpy()
    x64 = xs.astype(np.float64).reshape(20, 22, 3)
    i, j = np.triu_indices(22, 1)
    exact = np.sqrt(((x64[:, i] - x64[:, j]) ** 2).sum(-1))
    assert got.shape == (20, 231)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5)


def test_pairnet_forward_with_jax_params():
    jm = jax_pairnet(231, key=jax.random.PRNGKey(0))
    tm = load_jax_params(itt.pairnet(231), _params_np(jm.params))
    assert tm.sizes == jm.sizes == (231, 38, 6, 1)
    x = np.random.default_rng(1).uniform(0.1, 1.5, size=(32, 5, 231))
    x = x.astype(np.float32)
    ref = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_glorot_init_limits():
    m = itt.pairnet(231, gen=3)
    for layer in m.layers:
        fan_out, fan_in = layer.weight.shape
        lim = (6.0 / (fan_in + fan_out)) ** 0.5
        assert float(layer.weight.detach().abs().max()) <= lim
        assert float(layer.bias.detach().abs().max()) == 0.0
    assert m.ln.eps == 1e-5


def test_adam_regularized_one_step():
    jm = jax_pairnet(231, key=jax.random.PRNGKey(2))
    params = _params_np(jm.params)
    rng = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    opt = itk.AdamRegularized()
    updates, _ = opt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                            opt.init(params), params)
    import optax
    new = _params_np(optax.apply_updates(params, updates))

    tm = load_jax_params(itt.pairnet(231), params)
    tg = load_jax_params(itt.pairnet(231), grads)
    topt = itt.AdamRegularized()(tm.parameters())
    for p, g in zip(tm.parameters(), tg.parameters()):
        p.grad = g.detach().clone()
    topt.step()
    ref = load_jax_params(itt.pairnet(231), new).state_dict()
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_shiftscale_matches_jax():
    ks = np.random.default_rng(5).normal(size=(24, 1)).astype(np.float32)
    np.testing.assert_allclose(shiftscale(torch.as_tensor(ks)).numpy(),
                               np.asarray(jax_shiftscale(jnp.asarray(ks))),
                               rtol=1e-6, atol=1e-6)
    mask = np.r_[np.ones(20), np.zeros(4)].astype(np.float32)
    ref = jax_shiftscale_jit(jnp.asarray(ks), jnp.asarray(mask),
                             jnp.float32(20.0), quantile=0.1)
    got = shiftscale_jit(torch.as_tensor(ks), torch.as_tensor(mask), 20.0,
                         quantile=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(itt.DomainError):
        shiftscale(torch.ones(5, 1))


def test_bucket_padding():
    assert [bucket_capacity(n) for n in (1, 9, 20, 100, 129)] == \
        [8, 12, 24, 128, 192]
    a = torch.arange(5.0)
    assert pad_rows(a, 8).tolist() == [0, 1, 2, 3, 4, 0, 1, 2]


@pytest.mark.parametrize("features", ["shared", "own"])
def test_slice_matches_jax(golden, features):
    """Same coordinates and initial parameters through both packages: 5
    Koopman iterations of full-batch AdamRegularized training on a
    20-point dataset padded to its 24-row bucket, then chis and koopman.

    "shared": both learners get the JAX package's features, which
    isolates the learner: losses, chis and koopman agree to 1e-5.
    "own": each package featurizes the coordinates itself; the two f32
    Gram tricks differ by up to 4.7e-6 nm (see the features test), which
    moves the losses by up to 2e-5 relative, so that case is held to 1e-4.
    """
    xs, ys = golden
    jsim = itk.MDSimulation(steps=10)
    jm = jsim.defaultmodel(n=231, key=jax.random.PRNGKey(0))
    params0 = _params_np(jm.params)
    jdata = JaxData.from_coords(jsim, xs, ys)
    jiso = itk.Iso(data=jdata, model=jm, opt=itk.AdamRegularized(), key=0,
                   shard=False)
    jiso.run(5)

    sim = itt.MDSimulation(steps=10, device="cpu")
    shared = None
    if features == "shared":
        shared = (torch.tensor(np.asarray(jdata.features)),
                  torch.tensor(np.asarray(jdata.propfeatures)))
    data = itt.SimulationData.from_coords(sim, torch.as_tensor(xs),
                                          torch.as_tensor(ys),
                                          features=shared)
    tm = load_jax_params(sim.defaultmodel(n=231), params0)
    iso = itt.Iso(data=data, model=tm, opt=itt.AdamRegularized(), gen=0)
    iso.run(5)
    tol = 1e-5 if features == "shared" else 1e-4
    np.testing.assert_allclose(iso.losses, jiso.losses, rtol=tol, atol=0)
    np.testing.assert_allclose(iso.chis().numpy(), np.asarray(jiso.chis()),
                               rtol=tol, atol=0)
    np.testing.assert_allclose(iso.koopman().numpy(),
                               np.asarray(jiso.koopman()), rtol=tol, atol=0)


def test_minibatch_path_trains(golden):
    """A bucket larger than the minibatch takes the permuted minibatch
    path; losses stay finite and the generator makes it reproducible."""
    xs, ys = golden
    sim = itt.MDSimulation(steps=10, device="cpu")
    data = itt.SimulationData.from_coords(sim, torch.as_tensor(xs),
                                          torch.as_tensor(ys))
    runs = []
    for _ in range(2):
        iso = itt.Iso(data=data, model=itt.pairnet(231, gen=1),
                      opt=itt.AdamRegularized(), minibatch=8, gen=2)
        runs.append(iso.run(3).losses)
    assert runs[0] == runs[1] and np.all(np.isfinite(runs[0]))


def test_rates_matches_jax():
    from isokann_tpu.iso import rates as jax_rates
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(50, 1))
    y = 0.1 + 0.8 * x + rng.normal(scale=0.01, size=(50, 1))
    np.testing.assert_allclose(rates(x, y), jax_rates(x, y), rtol=1e-10)
