"""Port parity of the toy diffusions (``simulators/langevin.py``) and of
the overdamped integrators (``md.integrators.brownian``,
``brownian_girsanov``) against the JAX package on the CPU: potentials and
forces against ``jax.grad`` at 1e-5 relative, noiseless Euler-Maruyama
lags at 1e-5 (Mueller-Brown's lag is its 10 steps), noisy bursts in
distribution (the random streams differ by design), Girsanov weights
with E[w] = 1, and the short Doublewell drive of the verify recipe."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md import integrators as JI

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import integrators as I

torch.set_num_threads(1)

SYSTEMS = ["Doublewell", "Triplewell", "MuellerBrown"]


def close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err <= tol, f"max rel err {err:.3e} > {tol}"


def points(sim, n, seed):
    box = sim._supportbox
    rng = np.random.default_rng(seed)
    return rng.uniform(box[:, 0], box[:, 1], (n, sim.dim)).astype(np.float32)


@pytest.mark.parametrize("name", SYSTEMS)
def test_potential_and_force_match_jax(name):
    jsim = getattr(itk, name)()
    psim = getattr(itt, name)(device="cpu")
    x = points(jsim, 64, 0)
    close(psim.potential_batch(torch.as_tensor(x)).numpy(),
          np.asarray(jsim.potential_batch(jnp.asarray(x))))
    close(psim.force(torch.as_tensor(x)).numpy(),
          np.asarray(jsim.force(jnp.asarray(x))))


@pytest.mark.parametrize("name", SYSTEMS)
def test_noiseless_lag_matches_jax(name):
    """One lag at sigma = 0: 100 Euler steps (Doublewell, Triplewell),
    10 for Mueller-Brown (dt 1e-4, lag 1e-3)."""
    jsim = getattr(itk, name)(sigma=0.0)
    psim = getattr(itt, name)(sigma=0.0, device="cpu")
    assert psim.steps == jsim.steps == (10 if name == "MuellerBrown" else 100)
    x0 = points(jsim, 16, 1)
    ref = np.asarray(jsim.propagate(jnp.asarray(x0), 2,
                                    key=jax.random.PRNGKey(0)))
    got = psim.propagate(torch.as_tensor(x0), 2, gen=0).numpy()
    assert got.shape == (16, 2, jsim.dim)
    close(got, ref)


@pytest.mark.parametrize("name", SYSTEMS)
def test_randx0_inside_support(name):
    sim = getattr(itt, name)(device="cpu")
    x = sim.randx0(2000, gen=3).numpy()
    box = sim._supportbox
    assert x.shape == (2000, sim.dim) and x.dtype == np.float32
    assert np.all(x >= box[:, 0]) and np.all(x <= box[:, 1])
    se = (box[:, 1] - box[:, 0]) / np.sqrt(12 * 2000)
    assert np.all(np.abs(x.mean(0) - box.mean(1)) < 4 * se)
    assert not np.array_equal(x, sim.randx0(2000, gen=4).numpy())
    np.testing.assert_array_equal(x, sim.randx0(2000, gen=3).numpy())


def _moments(y):
    """mean, its standard error, variance, its standard error."""
    n = len(y)
    m, v = y.mean(), y.var()
    m4 = np.mean((y - m) ** 4)
    return m, np.sqrt(v / n), v, np.sqrt((m4 - v * v) / n)


@pytest.mark.parametrize("x0", [-1.0, 0.0, 0.4])
def test_noisy_doublewell_burst_in_distribution(x0):
    """Mean and variance of one lag from a fixed start agree with the JAX
    package's within 4 standard errors."""
    n = 4000
    ref = np.asarray(itk.Doublewell().propagate(
        jnp.asarray([[x0]], jnp.float32), n, key=jax.random.PRNGKey(5)))
    got = itt.Doublewell(device="cpu").propagate(
        torch.tensor([[x0]]), n, gen=5).numpy()
    mj, sj, vj, svj = _moments(ref.ravel().astype(np.float64))
    mp, sp, vp, svp = _moments(got.ravel().astype(np.float64))
    assert abs(mp - mj) < 4 * np.hypot(sj, sp), (mp, mj)
    assert abs(vp - vj) < 4 * np.hypot(svj, svp), (vp, vj)


def test_noiseless_brownian_matches_jax():
    """brownian at T = 0 on the Triplewell force, 50 steps, at 1e-5."""
    jsim, psim = itk.Triplewell(), itt.Triplewell(device="cpu")
    x0 = points(jsim, 32, 2)
    m = np.ones(2, np.float32)
    ref = JI.brownian(jsim.force, jnp.asarray(x0), jnp.asarray(m), 0.0, 1.0,
                      0.01, 50, jax.random.PRNGKey(0))
    got = I.brownian(psim.force, torch.as_tensor(x0), torch.as_tensor(m),
                     0.0, 1.0, 0.01, 50)
    close(got.numpy(), np.asarray(ref))


def test_noiseless_brownian_girsanov():
    """brownian_girsanov without noise (the JAX recursion always draws
    its noise): positions and log-weights against the recursion written
    out in float64 over the JAX package's force, at 1e-5."""
    jsim, psim = itk.Triplewell(), itt.Triplewell(device="cpu")
    x0 = points(jsim, 32, 2)
    m = torch.ones(2)
    T = 0.7 ** 2 / (2 * I.KB)
    px, pl = I.brownian_girsanov(
        psim.force, lambda x, t, sigma, F: -0.3 * x + t,
        torch.as_tensor(x0), m, T, 1.0, 0.01, 50)
    xr, lr, t = x0.astype(np.float64), np.zeros(32), 0.0
    for _ in range(50):
        f = np.asarray(jsim.force(jnp.asarray(xr, jnp.float32)), np.float64)
        u = -0.3 * xr + t
        xr = xr + (f + 0.7 * u) * 0.01
        lr -= np.sum(u * u, -1) / 2 * 0.01
        t += 0.01
    close(px.numpy(), xr)
    close(pl.numpy(), lr)


def test_biased_propagate_weights_are_a_martingale():
    """A biased Doublewell burst: WeightedSamples whose weights have
    E[w] = 1 within 4 standard errors."""
    sim = itt.Doublewell(device="cpu")
    sim.bias = lambda x, t, sigma, F: 0.5 * torch.tanh(-x)
    ws = sim.propagate(torch.tensor([[-1.0], [0.2]]), 4000, gen=7)
    assert isinstance(ws, itt.WeightedSamples)
    assert ws.values.shape == (2, 4000, 1) and ws.weights.shape == (2, 4000)
    w = ws.weights.double().numpy()
    assert np.all(np.isfinite(w)) and np.all(w > 0)
    for row in w:
        se = row.std() / np.sqrt(len(row))
        assert abs(row.mean() - 1.0) < 4 * se, (row.mean(), se)


def test_trajectory_shapes():
    sim = itt.Triplewell(device="cpu")
    tr = sim.trajectory(T=0.5, saveat=0.1, gen=1, save_start=True)
    assert tr.shape == (6, 2) and bool(torch.isfinite(tr).all())
    lt = sim.laggedtrajectory(3, x0=torch.tensor([1.0, 0.0]), gen=2)
    assert lt.shape == (3, 2)


def test_doublewell_drive_recipe():
    """Doublewell, nx=64, nk=8, 200 iterations: chi separates the wells,
    |corr(chi, x)| > 0.99, and the rate matrix has a negative diagonal."""
    sim = itt.Doublewell(sigma=1.0, device="cpu")
    iso = itt.Iso(sim=sim, nx=64, nk=8, gen=0, opt=itt.AdamRegularized())
    iso.run(200)
    xs = torch.linspace(-1.3, 1.3, 101)[:, None]
    chi = iso.chicoords(xs)[:, 0].numpy()
    assert abs(np.corrcoef(chi, xs[:, 0].numpy())[0, 1]) > 0.99
    assert iso.losses[-1] < iso.losses[0]
    assert np.all(np.diag(iso.rates()) < 0)
