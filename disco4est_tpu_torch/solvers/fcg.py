"""Flexible conjugate gradients (FCG).

Port of `disco4est_tpu/solvers/fcg.py` (role of the reference's
`Solver/d4est_solver_fcg_improved.c` and the PETSc `fcg` KSP type): CG that
re-orthogonalizes the search direction against the previous one.  A Python
loop with the JAX arithmetic order; the stopping test is read once per
iteration.

`return_state` / `resume_state`: the exact mid-solve checkpoint and
continue of the JAX module (`d4est_solver_fcg_improved.c:319` hook role),
with the JAX state tuple `(x, r, p, Ap, k)`: the previous direction and its
product carry the truncation across chunks, and `max_iter` is the
cumulative cap.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class FCGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: float


def _local_dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def fcg_solve(
    A: Callable,
    b,
    x0=None,
    *,
    M: Callable | None = None,
    atol: float = 1e-15,
    rtol: float = 1e-20,
    max_iter: int = 1000,
    resume_state: tuple | None = None,
    return_state: bool = False,
    dot: Callable | None = None,
):
    """Flexible CG (Notay variant, one-direction truncation) with the
    optional, possibly variable, preconditioner `M`; `dot` replaces the
    local dot product (the distributed solves pass their global one).
    Returns the `FCGResult`, and with `return_state` also the state to
    resume from."""
    _dot = dot or _local_dot
    M = M or (lambda v: v)

    bnorm = float(torch.sqrt(_dot(b, b)))
    tol2 = max(atol, rtol * bnorm) ** 2

    if resume_state is None:
        x = torch.zeros_like(b) if x0 is None else x0
        r = b - A(x)
        p = M(r)
        Ap = A(p)
        k = 0
    else:
        x, r, p, Ap, k = resume_state
    while k < max_iter and float(_dot(r, r)) > tol2:
        pAp = _dot(p, Ap)
        alpha = _dot(r, p) / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        # flexible step: orthogonalize against the previous direction
        Az = A(z)
        beta = -_dot(Az, p) / pAp
        p = z + beta * p
        Ap = Az + beta * Ap
        k += 1
    res = FCGResult(x=x, iterations=k,
                    residual_norm=float(torch.sqrt(_dot(r, r))))
    return (res, (x, r, p, Ap, k)) if return_state else res
