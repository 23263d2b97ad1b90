"""The acceptance goldens of the port: exact reference solutions and the
runs that are held against them.

Exact-eigenfunction goldens of the toy diffusions (overdamped Langevin
dX = -grad V dt + sigma dW, generator L = -grad V . grad + sigma^2/2
laplace, finite differences with reflecting boundaries):

- ``exact_chi_doublewell``: the second eigenfunction of expm(tau L) in
  1-D, shift-scaled to [0, 1];
- ``mueller_brown_golden`` and ``triplewell_golden``: the slow
  eigenfunctions of the 2-D generators by sparse shift-invert ``eigs``.

The alanine goldens read ``data/golden/ala2_vacuum_msm.npz``, an Ulam/MSM
estimate of the dominant Koopman eigenfunction on the (phi, psi) torus
with the lagged (xs, ys) data it came from, and
``data/golden/ala2_solvated_msm.npz``, the same for alanine in explicit
solvent with float16 features of its (xs, ys) in place of coordinates.

Each ``*_run`` function trains or simulates through the port's entry
points on ``device`` at the sizes of the JAX package's golden tests and
returns the measured quantities; the callers (``tests/
test_torch_golden.py`` on the CPU, ``chip_smoke.py`` on the card) hold
them to the thresholds.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.linalg
import torch

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "data", "golden")
GOLDEN_MD = os.path.join(GOLDEN_DIR, "ala2_vacuum_msm.npz")
GOLDEN_SOLVATED = os.path.join(GOLDEN_DIR, "ala2_solvated_msm.npz")


# ==========================================================================
# Exact reference solutions
# ==========================================================================

def generator_matrix(V_prime, xs, sigma):
    """1-D finite-difference generator with reflecting boundaries."""
    n = len(xs)
    h = xs[1] - xs[0]
    L = np.zeros((n, n))
    D = sigma ** 2 / 2
    for i in range(n):
        b = -V_prime(xs[i])
        if 0 < i < n - 1:
            L[i, i - 1] += D / h ** 2
            L[i, i] += -2 * D / h ** 2
            L[i, i + 1] += D / h ** 2
            L[i, i - 1] += -b / (2 * h)
            L[i, i + 1] += b / (2 * h)
        elif i == 0:
            L[i, i] += -D / h ** 2
            L[i, i + 1] += D / h ** 2
            L[i, i + 1] += b / h if b > 0 else 0
            L[i, i] += -b / h if b > 0 else 0
        else:
            L[i, i] += -D / h ** 2
            L[i, i - 1] += D / h ** 2
            L[i, i - 1] += -b / h if b < 0 else 0
            L[i, i] += b / h if b < 0 else 0
    return L


def exact_chi_doublewell(sigma=1.0, tau=1.0, lo=-1.5, hi=1.5, n=301):
    """(xs, phi2 shift-scaled with phi2[0] < 0.5, the three leading
    eigenvalues of expm(tau L)) of the double well."""
    xs = np.linspace(lo, hi, n)
    L = generator_matrix(lambda x: 4 * x * (x ** 2 - 1), xs, sigma)
    K = scipy.linalg.expm(tau * L)
    vals, vecs = np.linalg.eig(K)
    order = np.argsort(-np.real(vals))
    phi2 = np.real(vecs[:, order[1]])
    phi2 = (phi2 - phi2.min()) / (phi2.max() - phi2.min())
    if phi2[0] > 0.5:
        phi2 = 1 - phi2
    return xs, phi2, np.real(vals[order[:3]])


def _grad_potential(potential, pts):
    z = torch.as_tensor(pts, dtype=torch.float32).requires_grad_(True)
    (g,) = torch.autograd.grad(potential(z).sum(), z)
    return g.numpy()


def generator_2d(potential, xs, ys, D):
    """Sparse FD generator of a 2-D overdamped diffusion with reflecting
    boundaries: ``(L (csr, nx ny), pts (nx ny, 2))``, row-major
    (i ny + j); central drift inside, one-sided at the walls."""
    import scipy.sparse as sp

    nx, ny = len(xs), len(ys)
    hx, hy = xs[1] - xs[0], ys[1] - ys[0]
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], 1)
    gradV = _grad_potential(potential, pts)
    bx = -gradV[:, 0].reshape(nx, ny)
    by = -gradV[:, 1].reshape(nx, ny)
    rows, cols, vals = [], [], []

    def add(i, j, i2, j2, v):
        rows.append(i * ny + j)
        cols.append(i2 * ny + j2)
        vals.append(v)

    for i in range(nx):
        for j in range(ny):
            diag = 0.0
            if 0 < i < nx - 1:
                add(i, j, i - 1, j, D / hx**2 - bx[i, j] / (2 * hx))
                add(i, j, i + 1, j, D / hx**2 + bx[i, j] / (2 * hx))
                diag += -2 * D / hx**2
            elif i == 0:
                c = D / hx**2 + max(bx[i, j], 0) / hx
                add(i, j, i + 1, j, c)
                diag += -c
            else:
                c = D / hx**2 - min(bx[i, j], 0) / hx
                add(i, j, i - 1, j, c)
                diag += -c
            if 0 < j < ny - 1:
                add(i, j, i, j - 1, D / hy**2 - by[i, j] / (2 * hy))
                add(i, j, i, j + 1, D / hy**2 + by[i, j] / (2 * hy))
                diag += -2 * D / hy**2
            elif j == 0:
                c = D / hy**2 + max(by[i, j], 0) / hy
                add(i, j, i, j + 1, c)
                diag += -c
            else:
                c = D / hy**2 - min(by[i, j], 0) / hy
                add(i, j, i, j - 1, c)
                diag += -c
            add(i, j, i, j, diag)
    L = sp.coo_matrix((vals, (rows, cols)), shape=(nx * ny, nx * ny))
    return L.tocsr(), pts


def mueller_brown_golden(nx=80, ny=80):
    """(pts, phi2 shift-scaled, V at pts) of the Mueller-Brown generator
    (sigma 7) on its support box."""
    import scipy.sparse.linalg as spla

    from .simulators.langevin import mueller_brown

    xs = np.linspace(-1.4, 1.1, nx)
    ys = np.linspace(-0.25, 2.0, ny)
    L, pts = generator_2d(mueller_brown, xs, ys, 7.0 ** 2 / 2)
    w, v = spla.eigs(L, k=3, sigma=0.1, which="LM")
    order = np.argsort(-np.real(w))
    phi = np.real(v[:, order[1]])
    phi = (phi - phi.min()) / (phi.max() - phi.min())
    with torch.no_grad():
        V = mueller_brown(torch.as_tensor(pts, dtype=torch.float32)).numpy()
    return pts, phi, V


def triplewell_golden(nx=100, ny=100):
    """(gx, gy, psi (nx ny, 4), w) of the default Triplewell (sigma 1):
    span{psi_2, psi_3} lies ~24x in eigenvalue above psi_4, so the 3-D
    ISA chi has a well-conditioned exact target subspace."""
    import scipy.sparse.linalg as spla

    from .simulators.langevin import triplewell

    gx = np.linspace(-2.0, 2.0, nx)
    gy = np.linspace(-1.5, 2.5, ny)
    L, _ = generator_2d(triplewell, gx, gy, 1.0 ** 2 / 2)
    w, v = spla.eigs(L, k=4, sigma=0.02, which="LM")
    order = np.argsort(-np.real(w))
    w = np.real(w[order])
    psi = np.real(v[:, order])
    if not (abs(w[0]) < 1e-8 and w[2] > 5 * w[3]):
        raise ValueError(f"triplewell golden spectrum off: {w}")
    return gx, gy, psi, w


def bilinear(gx, gy, grid_vals, q):
    """Bilinear interpolation of a row-major grid field at q (n, 2)."""
    nx, ny = len(gx), len(gy)
    g = grid_vals.reshape(nx, ny)
    fx = np.clip((q[:, 0] - gx[0]) / (gx[1] - gx[0]), 0, nx - 1.001)
    fy = np.clip((q[:, 1] - gy[0]) / (gy[1] - gy[0]), 0, ny - 1.001)
    i0, j0 = fx.astype(int), fy.astype(int)
    tx, ty = fx - i0, fy - j0
    return (g[i0, j0] * (1 - tx) * (1 - ty) + g[i0 + 1, j0] * tx * (1 - ty)
            + g[i0, j0 + 1] * (1 - tx) * ty + g[i0 + 1, j0 + 1] * tx * ty)


def _corr(a, b):
    return float(np.corrcoef(a, b)[0, 1])


# ==========================================================================
# The toy goldens (tests/test_golden.py of the JAX package)
# ==========================================================================

def doublewell_run(device, gen=0, iters=2000):
    """Doublewell, nx=256, nk=64, minibatch 128, AdamRegularized(1e-3,
    1e-5), ``run(iters)``.  Returns (iso, dict(corr, rate, exact_rate,
    vals, exit_rate)): corr of the shift-scaled chi with the exact phi2;
    the rate -log(g1)/tau of the fit Kchi ~ g1 chi + g0 and its exact
    value -log(lambda2)."""
    from . import AdamRegularized, Doublewell, Iso

    xs, phi2, vals = exact_chi_doublewell()
    iso = Iso(sim=Doublewell(sigma=1.0, device=device), nx=256, nk=64,
              gen=gen, minibatch=128, opt=AdamRegularized(1e-3, 1e-5))
    iso.run(iters)
    chi = iso.chicoords(xs[:, None])[:, 0].cpu().numpy().astype(np.float64)
    chi = (chi - chi.min()) / (chi.max() - chi.min())
    if chi[0] > 0.5:
        chi = 1 - chi
    c = iso.chis().cpu().numpy().ravel().astype(np.float64)
    k = iso.koopman().cpu().numpy().ravel().astype(np.float64)
    (g1, _), *_ = np.linalg.lstsq(np.stack([c, np.ones_like(c)], 1), k,
                                  rcond=None)
    return iso, dict(corr=_corr(chi, phi2),
                     rate=float(-np.log(g1) / iso.data.sim.lagtime),
                     exact_rate=float(-np.log(vals[1])), vals=vals,
                     exit_rate=float(iso.chi_exit_rate()))


def triplewell_run(device, gen=0, iters=1500):
    """Triplewell ISA: the 32-unit densenet [2, 32, 32, 32, 3], nx=1024,
    nk=64, nout=3, minibatch 256, ``run(iters)``.  Returns dict(R2, R3:
    containment of psi_2 and psi_3 in span{1, chi}; rowsum_mean,
    rowsum_std; wells: the argmax column of chi at the three wells; iso:
    the trained learner)."""
    from . import AdamRegularized, Iso, Triplewell
    from .analysis.msm import containment_R
    from .models import densenet

    gx, gy, psi, _ = triplewell_golden()
    model = densenet([2, 32, 32, 32, 3], gen=100, device=device)
    iso = Iso(sim=Triplewell(device=device), nx=1024, nk=64, nout=3,
              gen=gen, minibatch=256, model=model,
              opt=AdamRegularized(1e-3, 1e-5))
    iso.run(iters)
    chi = iso.chis().cpu().numpy()
    samp = iso.data.coords.cpu().numpy()
    R2, _ = containment_R(bilinear(gx, gy, psi[:, 1], samp), chi)
    R3, _ = containment_R(bilinear(gx, gy, psi[:, 2], samp), chi)
    rowsum = chi.sum(axis=1)
    wells = np.asarray([[-1.0, 0.0], [1.0, 0.0], [0.0, 5.0 / 3.0]])
    cw = iso.chicoords(wells).cpu().numpy()
    return dict(R2=R2, R3=R3, rowsum_mean=float(rowsum.mean()),
                rowsum_std=float(rowsum.std()),
                wells=np.argmax(cw, axis=1).tolist(), iso=iso)


def mueller_brown_run(device, gen=0, iters=3000):
    """Mueller-Brown, nx=512, nk=32, minibatch 256, ``run(iters)``.
    Returns |corr| of the shift-scaled chi with the exact phi2 where
    V < min V + 100."""
    from . import AdamRegularized, Iso, MuellerBrown

    pts, phi, V = mueller_brown_golden()
    iso = Iso(sim=MuellerBrown(device=device), nx=512, nk=32, gen=gen,
              minibatch=256, opt=AdamRegularized(1e-3, 1e-5))
    iso.run(iters)
    chi = iso.chicoords(pts)[:, 0].cpu().numpy().astype(np.float64)
    chi = (chi - chi.min()) / (chi.max() - chi.min())
    mask = V < V.min() + 100.0
    return abs(_corr(chi[mask], phi[mask]))


# ==========================================================================
# The alanine goldens (tests/test_golden_md.py of the JAX package)
# ==========================================================================

def load_golden_md():
    z = np.load(GOLDEN_MD)
    return {k: z[k] for k in z.files}


def golden_dict(g):
    return dict(cells=g["cells"], vec=g["vec"], lo=-np.pi, hi=np.pi,
                nbins=int(g["nbins"]), periodic=True)


def md_chi_run(device, golden=None, gen=3, iters=800):
    """chi trained on the committed (xs, ys) (``FeaturesAll``, the default
    pairnet, AdamRegularized, minibatch 512, ``run(iters)``) against the
    committed MSM eigenfunction.  Returns (corr, frac of samples in
    golden cells)."""
    from . import AdamRegularized, Iso, MDSimulation, SimulationData
    from .analysis.msm import chi_msm_correlation, phipsi

    g = load_golden_md() if golden is None else golden
    sim = MDSimulation(steps=int(g["lag_steps"]), temp=float(g["temp"]),
                       device=device)
    xs = torch.as_tensor(g["xs"], device=sim.device)
    ys = torch.as_tensor(g["ys"], device=sim.device)
    data = SimulationData.from_coords(sim, xs, ys)
    iso = Iso(data=data, gen=gen, opt=AdamRegularized(), minibatch=512)
    iso.run(iters)
    chi = iso.chis().cpu().numpy().ravel()
    return chi_msm_correlation(chi, phipsi(sim, g["xs"]), golden_dict(g))


def md_fresh_run(device, golden=None, gen=9):
    """Fresh dynamics: 384 committed starts picked by ``default_rng(1)``,
    ``propagate`` x 4 of ``MDSimulation(steps=500)`` (one launch of
    kernel A on the card), ``ramachandran_msm(nbins=8, k=3,
    min_count=4)``.  Returns dict(corr, frac (finite in both), t_fresh,
    t_gold): the MSM's psi_2 against the golden's on the starts, and the
    implied timescales of lambda_2."""
    from . import MDSimulation
    from .analysis.msm import eigenfunction_on_samples, ramachandran_msm

    g = load_golden_md() if golden is None else golden
    sub = np.random.default_rng(1).choice(len(g["xs"]), size=384,
                                          replace=False)
    xs = g["xs"][sub]
    short = MDSimulation(steps=500, temp=float(g["temp"]), device=device)
    ys = short.propagate(torch.as_tensor(xs, device=short.device), 4,
                         gen=gen).cpu().numpy()
    msm = ramachandran_msm(short, xs, ys, nbins=8, k=3, min_count=4)
    fresh = eigenfunction_on_samples(msm["cv_x"], msm["cells"],
                                     msm["eigvecs"][:, 1], -np.pi, np.pi, 8,
                                     periodic=True)
    ref = eigenfunction_on_samples(msm["cv_x"], g["cells"], g["vec"],
                                   -np.pi, np.pi, int(g["nbins"]),
                                   periodic=True)
    ok = np.isfinite(fresh) & np.isfinite(ref)
    lam2 = msm["eigvals"][1]
    t_fresh = -short.lagtime / np.log(max(min(lam2, 0.99999), 1e-6))
    lag_g = int(g["lag_steps"]) * short.step
    lam2_g = float(g["eigvals"][1])
    t_gold = -lag_g / np.log(max(min(lam2_g, 0.99999), 1e-6))
    return dict(corr=abs(_corr(fresh[ok], ref[ok])), frac=float(ok.mean()),
                t_fresh=float(t_fresh), t_gold=float(t_gold))


def solvated_chi_run(device, gen=5, iters=600):
    """chi trained on the committed solvated features (768 x 4 bursts of
    231 distances, float16 on disk, float32 here) as ``ExternalSimulation``
    data: ``pairnet(231)`` (weights from seed 0), AdamRegularized,
    minibatch 256, ``run(iters)``.  Returns (corr, frac): |corr| of chi
    with the committed MSM eigenfunction on the samples where that is
    finite, and the fraction finite."""
    from . import AdamRegularized, ExternalSimulation, Iso, SimulationData
    from .analysis.msm import eigenfunction_on_samples
    from .models import pairnet
    from ._device import resolve_device

    device = resolve_device(device)
    z = np.load(GOLDEN_SOLVATED)
    fx = torch.as_tensor(np.asarray(z["feat_x"], np.float32), device=device)
    fy = torch.as_tensor(np.asarray(z["feat_y"], np.float32), device=device)
    data = SimulationData.from_coords(ExternalSimulation(), fx, fy,
                                      features=(fx, fy))
    iso = Iso(data=data, model=pairnet(fx.shape[-1], gen=0),
              opt=AdamRegularized(), minibatch=256, gen=gen)
    iso.run(iters)
    chi = iso.chis().cpu().numpy().ravel()
    ref = eigenfunction_on_samples(
        np.asarray(z["cv_x"], np.float64), z["cells"], z["vec"], -np.pi,
        np.pi, int(z["nbins"]), periodic=True)
    ok = np.isfinite(ref)
    return abs(_corr(chi[ok], ref[ok])), float(ok.mean())
