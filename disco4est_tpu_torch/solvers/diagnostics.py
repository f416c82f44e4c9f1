"""Standalone solver diagnostics.

Port of `disco4est_tpu/solvers/diagnostics.py` (roles of the reference's
`Solver/d4est_solver_full_matrix.c`, dense assembly by unit vectors;
`d4est_solver_matrix_symmetry.c`, the Aᵀ = A check with mismatch
reporting; `d4est_solver_jacobian_tester.c`, the finite-difference check
of a nonlinear problem's Jacobian against its residual).  No driver path
reaches them.
"""

from __future__ import annotations

import numpy as np
import torch


def full_matrix(A, shape, dtype=torch.float64, device="cpu") -> np.ndarray:
    """Dense matrix of the matrix-free operator, one unit vector per
    column (`d4est_solver_full_matrix`).  `A(u)` maps fields of `shape`;
    returns [N, N] with N = prod(shape)."""
    N = int(np.prod(shape))
    v = torch.zeros(N, dtype=dtype, device=device)
    cols = []
    for j in range(N):
        v[j] = 1.0
        cols.append(A(v.reshape(shape)).reshape(-1).cpu().numpy())
        v[j] = 0.0
    return np.stack(cols, axis=1)


def matrix_symmetry(A, shape, *, tol=1e-10, print_unequal_pairs=False,
                    device="cpu"):
    """Symmetry test (`d4est_solver_matrix_symmetry`,
    SYM_PRINT_UNEQUAL_PAIRS mode): returns (is_symmetric, max_asym,
    worst_pair)."""
    M = full_matrix(A, shape, device=device)
    D = M - M.T
    max_asym = float(np.abs(D).max())
    scale = max(float(np.abs(M).max()), 1e-300)
    i, j = np.unravel_index(np.argmax(np.abs(D)), D.shape)
    ok = max_asym <= tol * scale
    if print_unequal_pairs and not ok:
        for a, b in np.argwhere(np.abs(D) > tol * scale)[:20]:
            print(f"[SYMMETRY] A[{a},{b}] = {M[a, b]:.15e} != "
                  f"A[{b},{a}] = {M[b, a]:.15e}")
    return ok, max_asym, (int(i), int(j))


def jacobian_test(residual, jacobian_apply, u0, *, n_dirs=5, eps=1e-6,
                  seed=0):
    """Finite-difference Jacobian check (`d4est_solver_jacobian_tester`):
    J(u0)v against (F(u0+εv) − F(u0−εv))/2ε for `n_dirs` random v (a
    numpy generator seeded with `seed`).  Returns the worst relative
    error."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for _ in range(n_dirs):
        v = torch.as_tensor(rng.standard_normal(tuple(u0.shape)),
                            dtype=u0.dtype, device=u0.device)
        Jv = jacobian_apply(u0, v)
        fd = (residual(u0 + eps * v) - residual(u0 - eps * v)) / (2 * eps)
        num = float(torch.max(torch.abs(Jv - fd)))
        den = max(float(torch.max(torch.abs(Jv))), 1e-300)
        worst = max(worst, num / den)
    return worst
