"""Flexible conjugate gradients (FCG).

Port of `disco4est_tpu/solvers/fcg.py` (role of the reference's
`Solver/d4est_solver_fcg_improved.c` and the PETSc `fcg` KSP type): CG that
re-orthogonalizes the search direction against the previous one.  A Python
loop with the JAX arithmetic order; the stopping test is read once per
iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class FCGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: float


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def fcg_solve(
    A: Callable,
    b,
    x0=None,
    *,
    atol: float = 1e-15,
    rtol: float = 1e-20,
    max_iter: int = 1000,
) -> FCGResult:
    """Flexible CG (Notay variant, one-direction truncation).
    Unpreconditioned: the JAX solver's `M` comes with the preconditioners
    (ROADMAP A13)."""
    x = torch.zeros_like(b) if x0 is None else x0

    bnorm = float(torch.sqrt(_dot(b, b)))
    tol2 = max(atol, rtol * bnorm) ** 2

    r = b - A(x)
    p = r
    Ap = A(p)
    k = 0
    while k < max_iter and float(_dot(r, r)) > tol2:
        pAp = _dot(p, Ap)
        alpha = _dot(r, p) / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        # flexible step: orthogonalize against the previous direction
        Ar = A(r)
        beta = -_dot(Ar, p) / pAp
        p = r + beta * p
        Ap = Ar + beta * Ap
        k += 1
    return FCGResult(x=x, iterations=k,
                     residual_norm=float(torch.sqrt(_dot(r, r))))
