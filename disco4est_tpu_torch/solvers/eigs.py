"""Spectral-bound estimators: CG-Lanczos and power method.

Port of `disco4est_tpu/solvers/eigs.py` (role of the reference's
`Solver/d4est_solver_cg_eigs.c`, the tridiagonal Lanczos matrix built from
CG's α/β that bounds the Chebyshev smoother, and
`Solver/d4est_power_method.c`).  Both run a fixed number of iterations
with no host read inside; `cg_eigs` reads its α/β back once, at the end,
and takes the eigenvalues of the small tridiagonal in f64 on the host.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _local_dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def cg_eigs(A: Callable, b, iters: int = 10, dot: Callable | None = None):
    """Run `iters` CG iterations on A x = b and estimate the extreme
    eigenvalues of A from the CG tridiagonal (Lanczos) matrix; `dot`
    replaces the local dot product (the distributed set-up passes its
    global one).

    Returns (lmin, lmax) as host floats.  The reference feeds
    lmax·multiplier and lmax/ratio into the Chebyshev smoother
    (`d4est_solver_multigrid_smoother_cheby.h:13-26`)."""
    _dot = dot or _local_dot
    r = b
    p = r
    rr = _dot(r, r)
    alphas, betas = [], []
    for _ in range(iters):
        Ap = A(p)
        alpha = rr / _dot(p, Ap)
        r = r - alpha * Ap
        rr_new = _dot(r, r)
        beta = rr_new / rr
        p = r + beta * p
        rr = rr_new
        alphas.append(alpha)
        betas.append(beta)
    alphas = torch.stack(alphas).cpu().numpy().astype(np.float64)
    betas = torch.stack(betas).cpu().numpy().astype(np.float64)
    # Lanczos tridiagonal from CG coefficients:
    # T_ii = 1/α_i + β_{i-1}/α_{i-1}; T_{i,i+1} = √β_i / α_i
    prev = np.concatenate([[0.0], betas[:-1] / alphas[:-1]])
    diag = 1.0 / alphas + prev
    off = np.sqrt(np.maximum(betas[:-1], 0.0)) / alphas[:-1]
    T = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    w = np.linalg.eigvalsh(T)
    return float(w[0]), float(w[-1])


def power_method(A: Callable, v0, iters: int = 100):
    """Largest eigenvalue via power iteration (`d4est_power_method.c`);
    a 0-d tensor on `v0`'s device."""
    v = v0 / torch.sqrt(_local_dot(v0, v0))
    lam = torch.zeros((), dtype=v0.dtype, device=v0.device)
    for _ in range(iters):
        w = A(v)
        lam = _local_dot(v, w) / _local_dot(v, v)
        v = w / torch.sqrt(_local_dot(w, w))
    return lam
