"""Committor of a rate matrix; counterpart of
``isokann_tpu/analysis/committor.py`` (reference
``scripts/251126_carsten/committor.jl:4-61``): boundary-condition row
surgery on the generator and a GMRES solve with a diagonal
preconditioner, on the host in float64 (scipy)."""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def committor_system(Q, classes):
    """The committor's linear system (A, b) from the generator ``Q``:
    ``classes`` is 0 for interior states, 1 for set B (committor 1) and
    any other nonzero value for set A (committor 0); the boundary rows
    of Q become unit rows (reference ``committor_system``,
    ``committor.jl:34-61``)."""
    Q = sp.csr_matrix(np.asarray(Q, dtype=np.float64), copy=True)
    b = np.asarray(classes, dtype=np.float64).copy()
    n = Q.shape[0]
    mask = np.ones(n, bool)
    mask[np.flatnonzero(b != 0)] = False
    Q = sp.diags(mask.astype(np.float64)) @ Q + sp.diags(
        (~mask).astype(np.float64))
    b[(b != 0) & (b != 1)] = 0.0
    return Q.tocsr(), b


def solve_committor(Q, classes, maxiter=1000, tol=1e-8):
    """The committor q (n,): GMRES on ``committor_system`` with a
    diagonal preconditioner (reference ``committor``,
    ``committor.jl:4-29``); warns when it does not converge."""
    A, b = committor_system(Q, classes)
    d = A.diagonal()
    d[d == 0] = 1.0
    M = sp.diags(1.0 / d)
    c, info = spla.gmres(A, b, x0=b.copy(), maxiter=maxiter, rtol=tol, M=M)
    if info != 0:
        warnings.warn(f"Committor computation did not converge (info={info})")
    return c
