"""The port's lag tools (``isokann_tpu_torch.workflows``: ``lag_sweep``,
``rates_resolved``, ``cktest``, ``training_lag_headroom``,
``escalate_lag`` and their helpers) on the CPU: the numpy helpers and the
tools' rows against the JAX package's on shared inputs, and the cases of
``tests/test_lag_sweep.py`` and ``tests/test_cktest.py`` through the port
at those tests' thresholds."""

import copy
import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import isokann_tpu.workflows as JW
from isokann_tpu.data import WeightedSamples as JWeighted

import isokann_tpu_torch as itt
import isokann_tpu_torch.workflows as W
from isokann_tpu_torch.data import WeightedSamples
from isokann_tpu_torch.iso import rates as rates_fn

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained_doublewell():
    sim = itt.Doublewell(sigma=1.0, device="cpu")
    iso = itt.Iso(sim=sim, nx=80, nk=5, gen=1, opt=itt.AdamRegularized())
    iso.run(150)
    return iso


def _with_sim(iso, sim):
    out = copy.copy(iso)
    out.data = dataclasses.replace(iso.data, sim=sim)
    return out


def _close(a, b, atol):
    """Rows or values equal to ``atol`` (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], atol)
    elif isinstance(a, (list, tuple)) and a and isinstance(a[0], dict):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, atol)
    elif isinstance(a, (bool, np.bool_)) or a is None:
        assert a == b
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=0,
                                   atol=atol)


# ---- the numpy helpers against the JAX package's ----------------------------

def test_numpy_helpers_match_jax():
    rng = np.random.default_rng(0)
    for d in (1, 2, 3):
        x = rng.uniform(0.05, 0.95, (40, d))
        y = 0.7 * x + 0.15 + rng.normal(0, 0.01, x.shape)
        for a, b in zip(W._fit_koopman(x, y), JW._fit_koopman(x, y)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for eigs in ([1.0, 1.00871], [1.2, 0.5], [1.0, -0.1], [0.999, 0.42],
                 [1.0, 0.3 + 0.1j, 0.3 - 0.1j], [1.0, 0.9 + 0.5j, 0.9 - 0.5j]):
        assert W._spectrum_resolved(np.array(eigs)) \
            == JW._spectrum_resolved(np.array(eigs))
    for _ in range(50):
        rows = [dict(steps=s, lag=float(s), resolved=bool(rng.random() < 0.7),
                     eigs=[1.0, float(rng.uniform(0.5, 1.0))],
                     timescale=float(rng.choice([np.nan, rng.uniform(1, 20)])))
                for s in (100, 200, 400, 800)]
        assert W._recommend_lag(rows) == JW._recommend_lag(rows)
        assert W._ladder_edge_rising(rows) == JW._ladder_edge_rising(rows)


def test_check_steps_override_matches_jax():
    class NoOverride:
        def propagate(self, xs, nk, gen=None):
            pass

    class Kwargs:
        def propagate(self, xs, nk, **kw):
            pass

    for w in (W, JW):
        with pytest.raises(TypeError, match="lag_sweep"):
            w._check_steps_override(NoOverride(), "lag_sweep")
        w._check_steps_override(Kwargs(), "cktest")


def _stub_propagate(arr, cat, weighted_cls):
    """A noiseless stub propagation y = 0.8 x, half the replicas junk at
    weight 0, in one package's arrays (``arr``, ``cat``)."""
    def propagate(xs, nk, key=None, gen=None, steps=None):
        xs = arr(xs)
        n, half = xs.shape[0], nk // 2
        good = 0.8 * xs[:, None, :] + arr(np.zeros((n, half, 1)))
        junk = arr(np.full((n, nk - half, xs.shape[1]), 37.0))
        w = cat([arr(np.ones((n, half))), arr(np.zeros((n, nk - half)))], 1)
        return weighted_cls(cat([good, junk], 1), w)
    return propagate


@pytest.mark.parametrize("max_batch", [None, 8])
def test_chi_pairs_at_lag_matches_jax(max_batch):
    """The same starts, a noiseless stub propagation and a numpy chi in
    both packages give the same chi pairs, chunked or not."""
    rng = np.random.default_rng(1)
    xs = rng.uniform(-1, 1, (6, 2)).astype(np.float32)

    def chicoords(z):
        z = np.asarray(z)
        return 1.0 / (1.0 + np.exp(-z.sum(-1, keepdims=True)))

    def tarr(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32)

    out = []
    for w, arr, cat, ws, gen in (
            (W, tarr, torch.cat, WeightedSamples, itt.make_generator(0)),
            (JW, jnp.asarray, jnp.concatenate, JWeighted,
             jax.random.PRNGKey(0))):
        sim = types.SimpleNamespace(propagate=_stub_propagate(arr, cat, ws))
        iso = types.SimpleNamespace(data=types.SimpleNamespace(sim=sim),
                                    chicoords=chicoords)
        out.append(w._chi_pairs_at_lag(iso, arr(xs), 50, 4, gen,
                                       max_batch=max_batch))
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[0][1], chicoords(0.8 * xs), atol=1e-6)


def _fake_pairs(iso, xs, s, nk, key_or_gen, max_batch=None):
    """Deterministic chi pairs of a lag: chi_y relaxes towards 1/2 with
    factor exp(-s / 150), plus fixed noise."""
    rng = np.random.default_rng(s)
    chi_x = np.linspace(0.05, 0.95, len(xs))[:, None]
    chi_y = 0.5 + np.exp(-s / 150.0) * (chi_x - 0.5) \
        + rng.normal(0, 0.01, chi_x.shape)
    return chi_x, chi_y


@pytest.fixture
def shared_pairs(monkeypatch):
    """Both packages' tools on the same chi pairs and starts."""
    for w in (W, JW):
        monkeypatch.setattr(w, "_chi_pairs_at_lag", _fake_pairs)
        monkeypatch.setattr(w, "_strat_starts",
                            lambda iso, nx, keepedges, key: np.arange(nx))
    sim = types.SimpleNamespace(steps=100, lagtime=0.2,
                                propagate=lambda xs, nk, steps=None: None)
    return types.SimpleNamespace(data=types.SimpleNamespace(sim=sim))


def test_lag_sweep_rows_match_jax(shared_pairs):
    got = W.lag_sweep(shared_pairs, steps=[100, 200, 400, 800], nx=40,
                      n_boot=60, verbose=False)
    ref = JW.lag_sweep(shared_pairs, steps=[100, 200, 400, 800], nx=40,
                       n_boot=60, verbose=False)
    assert got[0] == ref[0]
    _close(got[1], ref[1], 1e-10)
    assert any("exit_rates_lo" in r for r in got[1])


def test_rates_resolved_rows_match_jax(shared_pairs):
    got = W.rates_resolved(shared_pairs, lags=[100, 300], nx=40,
                           verbose=False, return_rows=True)
    ref = JW.rates_resolved(shared_pairs, lags=[100, 300], nx=40,
                            verbose=False, return_rows=True)
    _close(got[0], ref[0], 1e-10)
    _close(got[1], ref[1], 1e-10)
    _close(got[2], ref[2], 1e-10)
    assert "Q" in got[1]


def test_cktest_rows_match_jax(shared_pairs):
    got = W.cktest(shared_pairs, factors=(2, 4), nx=40, n_boot=80,
                   verbose=False)
    ref = JW.cktest(shared_pairs, factors=(2, 4), nx=40, n_boot=80,
                    verbose=False)
    assert got[0] == ref[0]
    _close(got[1], ref[1], 1e-10)


def test_strat_starts_picks_rows_of_the_data(trained_doublewell):
    iso = trained_doublewell
    xs = W._strat_starts(iso, 12, True, itt.make_generator(0))
    assert xs.shape == (12, 1)
    coords = iso.data.coords
    assert all(bool((coords == x).all(dim=1).any()) for x in xs)
    chi = iso.chis()[:, 0]
    cx = iso.chicoords(xs)[:, 0]
    assert float(cx.min()) == float(chi.min())      # keepedges
    assert float(cx.max()) == float(chi.max())
    again = W._strat_starts(iso, 12, True, itt.make_generator(0))
    assert torch.equal(xs, again)
    assert len(W._strat_starts(iso, 500, True, itt.make_generator(0))) \
        == len(iso.data)


# ---- tests/test_lag_sweep.py through the port ---------------------------

def test_fit_koopman_augments_1d():
    chi = np.linspace(0.05, 0.95, 40)
    kchi = 0.5 * chi + 0.25
    K, eigs = W._fit_koopman(chi, kchi)
    assert K.shape == (2, 2)
    eigs = np.sort(np.real(eigs))
    assert eigs[1] == pytest.approx(1.0, abs=1e-9)
    assert eigs[0] == pytest.approx(0.5, abs=1e-9)
    assert W._spectrum_resolved(np.array([1.0, 0.5]))


def test_spectrum_resolved_criteria():
    assert not W._spectrum_resolved(np.array([1.0, 1.00871]))
    assert not W._spectrum_resolved(np.array([1.2, 0.5]))
    assert not W._spectrum_resolved(np.array([1.0, -0.1]))
    assert W._spectrum_resolved(np.array([0.999, 0.42]))
    assert W._spectrum_resolved(np.array([1.0, 0.3 + 0.1j, 0.3 - 0.1j]))
    assert not W._spectrum_resolved(np.array([1.0, 0.9 + 0.5j, 0.9 - 0.5j]))


def test_lag_sweep_doublewell(trained_doublewell):
    iso = trained_doublewell
    rec, rows = iso.lag_sweep(steps=[50, 100, 200], nx=40, nk=16,
                              n_boot=40, gen=3, verbose=False)
    assert [r["steps"] for r in rows] == [50, 100, 200]
    for r in rows:
        assert len(r["eigs"]) == 2
        assert r["lag"] == pytest.approx(r["steps"] * iso.data.sim.dt)
    assert rec == 50
    resolved = [r for r in rows if r["resolved"]]
    assert len(resolved) == 3
    ts = np.array([r["timescale"] for r in resolved])
    assert np.all(np.isfinite(ts))
    assert ts.max() / ts.min() < 3.0
    for r in resolved:
        assert "exit_rates_lo" in r and "exit_rates_hi" in r
        lo, hi = np.asarray(r["exit_rates_lo"]), np.asarray(r["exit_rates_hi"])
        assert lo.shape == (2,) and np.all(lo <= hi)
        Q = np.real(scipy.linalg.logm(np.asarray(r["K"]))) / r["lag"]
        point = -np.diag(Q)
        assert np.all(point >= lo - 1e-12) and np.all(point <= hi + 1e-12)


def test_lag_sweep_unresolved_reports_none(trained_doublewell):
    class FrozenSim:
        steps = 100
        lagtime = 1.0

        def propagate(self, xs, nk, gen=None, steps=None):
            noise = 1e-3 * torch.randn((xs.shape[0], nk, xs.shape[1]),
                                       generator=gen)
            return xs[:, None, :] + noise

    iso = _with_sim(trained_doublewell, FrozenSim())
    rec, rows = iso.lag_sweep(steps=[100], nx=30, nk=2, n_boot=60, gen=4,
                              verbose=False)
    assert rows[0]["resolved_frac"] < 0.9
    assert not rows[0]["resolved"]
    assert np.isnan(rows[0]["timescale"]) or rows[0]["timescale"] > 50.0
    assert rec is None


def test_rates_no_spurious_warning_when_resolved():
    chi = np.linspace(0.05, 0.95, 50)[:, None]
    kchi = 0.5 * chi + 0.25
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Q = rates_fn(chi, kchi)
    assert Q[0, 0] < 0 and Q[1, 1] < 0
    assert Q[0, 0] == pytest.approx(np.log(0.5) / 2, rel=1e-6)


def test_rates_warns_when_unresolved():
    rng = np.random.default_rng(0)
    chi = np.linspace(0.05, 0.95, 50)[:, None]
    kchi = chi + rng.normal(0, 0.02, chi.shape)
    with pytest.warns(UserWarning, match="not.*resolved|outside"):
        rates_fn(chi, kchi)


class _BiasedSim:
    """Half the replicas frozen at weight 1, half junk at weight 0."""
    steps = 50
    lagtime = 0.5

    def propagate(self, xs, nk, gen=None, steps=None):
        return _frozen_weighted(xs, nk)


def _frozen_weighted(xs, nk):
    n = xs.shape[0]
    good = xs[:, None, :].repeat(1, nk // 2, 1)
    junk = torch.full((n, nk - nk // 2, xs.shape[1]), 37.0)
    w = torch.cat([torch.ones(n, nk // 2), torch.zeros(n, nk - nk // 2)], 1)
    return WeightedSamples(torch.cat([good, junk], 1), w)


def test_lag_sweep_uses_girsanov_weights(trained_doublewell):
    iso = _with_sim(trained_doublewell, _BiasedSim())
    rec, rows = iso.lag_sweep(steps=[50], nx=20, nk=4, n_boot=10, gen=5,
                              verbose=False)
    eigs = rows[0]["eigs"]
    assert abs(eigs[0] - 1.0) < 1e-6
    assert eigs[1] > 0.9


def test_fit_koopman_multidim_no_augmentation():
    chi = np.linspace(0.05, 0.95, 60)
    X = np.stack([chi, 1.0 - chi], axis=1)
    Y = np.stack([0.6 * chi + 0.2, 0.8 - 0.6 * chi], axis=1)
    K, eigs = W._fit_koopman(X, Y)
    assert K.shape == (2, 2)
    eigs = np.sort(np.real(eigs))
    assert eigs[1] == pytest.approx(1.0, abs=1e-9)
    assert eigs[0] == pytest.approx(0.6, abs=1e-9)


def test_lag_sweep_on_md_simulation():
    sim = itt.MDSimulation(steps=10, device="cpu")
    iso = itt.Iso(sim=sim, nx=24, nk=3, gen=0, minibatch=0,
                  opt=itt.AdamRegularized())
    iso.run(30)
    rec, rows = iso.lag_sweep(steps=[10, 20], nx=12, nk=4, n_boot=20,
                              gen=2, verbose=False)
    assert [r["steps"] for r in rows] == [10, 20]
    for r in rows:
        assert r["lag"] == pytest.approx(
            r["steps"] * sim.lagtime / sim.steps)
        assert len(r["eigs"]) == 2
        assert np.isfinite(r["eigs"]).all()


def test_training_lag_headroom_and_escalation(trained_doublewell):
    # a copy that trains on without touching the shared fixture's model
    iso = copy.copy(trained_doublewell)
    iso.model = copy.deepcopy(trained_doublewell.model)
    iso.optimizer = iso.opt(iso.model.parameters())
    iso.losses = list(trained_doublewell.losses)
    lam = W.training_lag_headroom(iso)
    assert 0.0 < lam < 1.0

    old_model = iso.model
    old_steps = iso.data.sim.steps
    W.escalate_lag(iso, old_steps * 3, nx_max=24, gen=5)
    assert iso.data.sim.steps == old_steps * 3
    assert iso.data.sim.lagtime == pytest.approx(
        trained_doublewell.data.sim.lagtime * 3)
    assert len(iso.data) <= 24
    assert iso.model is old_model                # model kept (warm start)
    iso.run(5)
    assert np.isfinite(iso.losses[-1])


def test_escalate_lag_md_copy_path():
    """MDSimulation: a shallow copy with ``steps`` overridden, in its
    constructor arguments too; the original simulation is untouched."""
    sim = itt.MDSimulation(steps=20, device="cpu")
    iso = itt.Iso(sim=sim, nx=8, nk=2, gen=0, opt=itt.AdamRegularized())
    iso.run(3)
    W.escalate_lag(iso, 40, nx_max=6, gen=1)
    assert iso.data.sim.steps == 40 and iso.data.sim is not sim
    assert iso.data.sim.constructor["steps"] == 40
    assert sim.steps == 20 and sim.constructor["steps"] == 20
    assert len(iso.data) <= 6
    assert iso.data.propcoords.shape[1:] == (2, sim.dim)
    iso.run(2)
    assert np.isfinite(iso.losses[-1])


def test_escalate_lag_sim_factory(trained_doublewell):
    iso = copy.copy(trained_doublewell)
    made = []

    def factory(steps):
        made.append(steps)
        sim = itt.Doublewell(sigma=1.0, device="cpu")
        sim.lagtime_ = steps * sim.dt
        return sim

    W.escalate_lag(iso, 200, nx_max=10, gen=2, sim_factory=factory)
    assert made == [200] and iso.data.sim.steps == 200
    assert len(iso.data) == 10


def test_recommendation_rejects_shrinking_timescale():
    rows = [
        dict(steps=100, lag=0.2, eigs=[1.0, 0.9485], timescale=3.78,
             resolved_frac=0.97, resolved=True),
        dict(steps=500, lag=1.0, eigs=[1.0, 0.4066], timescale=1.11,
             resolved_frac=1.0, resolved=True),
        dict(steps=2500, lag=5.0, eigs=[1.0, 0.0122], timescale=1.13,
             resolved_frac=1.0, resolved=True),
    ]
    assert W._recommend_lag(rows) == 500


def test_rates_resolved_doublewell(trained_doublewell):
    Q, row = W.rates_resolved(trained_doublewell, lags=[50, 100], nx=40,
                              nk=16, gen=8, verbose=False)
    assert Q is not None
    assert row["steps"] == 50
    Q = np.asarray(Q)
    assert Q.shape == (2, 2)
    assert Q[0, 0] < 0 and Q[1, 1] < 0
    assert Q[0, 1] > 0 or Q[1, 0] > 0
    ex = -np.diag(Q)
    ex0 = -np.diag(np.asarray(trained_doublewell.rates()))
    assert 0.2 < ex.sum() / ex0.sum() < 5.0


def test_chi_pairs_at_lag_max_batch(trained_doublewell):
    iso = trained_doublewell
    real = iso.data.sim
    calls = []

    class Recording:
        steps = real.steps
        lagtime = real.lagtime

        def propagate(self, xs, nk, gen=None, steps=None):
            calls.append(len(xs) * nk)
            return real.propagate(xs, nk, gen=gen, steps=steps)

    iso2 = _with_sim(iso, Recording())
    xs = iso.data.coords[:12]
    chi_x, chi_y = W._chi_pairs_at_lag(iso2, xs, 50, 4,
                                       itt.make_generator(0), max_batch=16)
    assert len(calls) == 3 and max(calls) <= 16
    assert chi_x.shape == (12, 1) and chi_y.shape == (12, 1)
    assert np.isfinite(chi_y).all()

    calls.clear()
    W._chi_pairs_at_lag(iso2, xs, 50, 4, itt.make_generator(0))
    assert calls == [48]


def test_chi_pairs_at_lag_max_batch_weighted(trained_doublewell):
    iso = _with_sim(trained_doublewell, _BiasedSim())
    xs = trained_doublewell.data.coords[:6]
    chi_x, chi_y = W._chi_pairs_at_lag(iso, xs, 50, 4, itt.make_generator(1),
                                       max_batch=8)
    np.testing.assert_allclose(chi_y, chi_x, atol=1e-6)


def test_ladder_edge_rising():
    def row(steps, ts, resolved=True):
        return dict(steps=steps, lag=float(steps), timescale=ts,
                    resolved=resolved, eigs=[1.0, 0.5])

    assert W._ladder_edge_rising([row(100, 8.4), row(500, 5.5),
                                  row(2500, 5.8), row(12500, 15.5),
                                  row(62500, 67.9)])
    assert not W._ladder_edge_rising([row(500, 5.5), row(2500, 5.8),
                                      row(12500, 6.1)])
    assert not W._ladder_edge_rising([row(500, 5.5), row(2500, 5.8),
                                      row(12500, 60.0, resolved=False)])
    assert not W._ladder_edge_rising([row(500, 5.5)])


def test_lag_sweep_warns_on_rising_edge(trained_doublewell):
    class SlowingSim:
        steps = 50
        lagtime = 0.5

        def propagate(self, xs, nk, gen=None, steps=None):
            lam = {50: 0.2, 100: 0.2, 200: 0.8}[int(steps)]
            y = 0.5 + lam * xs
            return y[:, None, :].repeat(1, nk, 1)

    iso = _with_sim(trained_doublewell, SlowingSim())
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        iso.lag_sweep(steps=[50, 100, 200], nx=20, nk=4, n_boot=20,
                      gen=5, verbose=False)
    assert any("RISING at the ladder edge" in str(x.message) for x in rec)


# ---- tests/test_cktest.py through the port ----------------------------------

def _linear_chi_ou_iso(theta=1.0, sigma=0.5, dt=0.01, steps=100, n=200):
    """A stub Iso over an exactly solvable OU process with an affine chi:
    E[chi(X_t)|x] = 0.5 + a e^{-theta t} x, so Chapman-Kolmogorov holds
    exactly at every lag."""

    class OUSim:
        def __init__(self):
            self.steps = steps
            self.lagtime = steps * dt

        def propagate(self, xs, nk, gen=None, steps=None):
            s = self.steps if steps is None else int(steps)
            t = s * dt
            mean = xs[:, None, :] * np.exp(-theta * t)
            std = np.sqrt(sigma**2 / (2 * theta)
                          * (1.0 - np.exp(-2 * theta * t)))
            noise = torch.randn((xs.shape[0], nk, xs.shape[1]),
                                generator=gen, dtype=xs.dtype)
            return mean + std * noise

    rng = np.random.default_rng(0)
    coords = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, 1)))

    def chicoords(xs):
        return 0.5 + 0.25 * W._np(xs)

    return types.SimpleNamespace(
        data=types.SimpleNamespace(sim=OUSim(), coords=coords),
        chis=lambda: chicoords(coords), chicoords=chicoords)


def test_cktest_exact_chi_passes_all_factors():
    iso = _linear_chi_ou_iso()
    ok, rows = W.cktest(iso, factors=(2, 4), nx=60, nk=32, n_boot=100,
                        atol=0.05, gen=3, verbose=False)
    assert ok
    assert [r["factor"] for r in rows] == [2, 4]
    for r in rows:
        assert r["ok"]
        K_pred = np.asarray(r["K_pred"])
        K_est = np.asarray(r["K_est"])
        assert K_pred.shape == K_est.shape == (2, 2)
        assert np.allclose(K_est.sum(axis=1), 1.0, atol=5e-2)
        dev = np.asarray(r["dev"])
        lo, hi = np.asarray(r["dev_lo"]), np.asarray(r["dev_hi"])
        assert np.all(lo <= hi)
        assert r["max_abs_dev"] == pytest.approx(np.abs(dev).max())
        assert r["max_abs_dev"] < 0.06
        assert r["steps"] == r["factor"] * iso.data.sim.steps


def test_cktest_trained_doublewell(trained_doublewell):
    ok, rows = trained_doublewell.cktest(factors=(2, 4), nx=40, nk=16,
                                         n_boot=80, gen=3, verbose=False)
    assert ok
    assert all(r["ok"] for r in rows)
    assert rows[0]["max_abs_dev"] < 0.1
    assert rows[0]["lag"] == pytest.approx(
        2 * trained_doublewell.data.sim.lagtime)

    ok_sharp, rows_sharp = trained_doublewell.cktest(
        factors=(4,), nx=40, nk=16, n_boot=80, atol=0.05, gen=3,
        verbose=False)
    assert not ok_sharp
    assert 0.05 < rows_sharp[0]["max_abs_dev"] < 0.1


def test_cktest_detects_non_markovian(trained_doublewell):
    base = int(trained_doublewell.data.sim.steps)

    class NonMarkovSim:
        steps = base
        lagtime = float(trained_doublewell.data.sim.lagtime)

        def propagate(self, xs, nk, gen=None, steps=None):
            noise = 1e-3 * torch.randn((xs.shape[0], nk, xs.shape[1]),
                                       generator=gen)
            s = base if steps is None else int(steps)
            sign = 1.0 if s <= base else -1.0
            return sign * xs[:, None, :] + noise

    iso = _with_sim(trained_doublewell, NonMarkovSim())
    ok, rows = iso.cktest(factors=(2,), nx=30, nk=8, n_boot=60, gen=4,
                          verbose=False)
    assert not ok
    assert not rows[0]["ok"]
    assert rows[0]["max_abs_dev"] > 0.3


def test_cktest_respects_girsanov_weights(trained_doublewell):
    iso = _with_sim(trained_doublewell, _BiasedSim())
    ok, rows = iso.cktest(factors=(2,), nx=20, nk=4, n_boot=30, gen=5,
                          verbose=False)
    assert ok
    assert rows[0]["max_abs_dev"] < 1e-6


def test_cktest_requires_steps_override(trained_doublewell):
    class NoOverrideSim:
        steps = 10
        lagtime = 0.1

        def propagate(self, xs, nk, gen=None):
            raise AssertionError("should not be called")

    iso = _with_sim(trained_doublewell, NoOverrideSim())
    with pytest.raises(TypeError, match="cktest"):
        iso.cktest(verbose=False)
