"""Newton–Krylov with a backtracking line search.

Port of `disco4est_tpu/solvers/newton.py` (role of the reference's PETSc
SNES wrapper, `Solver/d4est_solver_newton_petsc.c:406-530`: matrix-free
shell Jacobian = `apply_lhs` with u0 frozen, inner KSP, backtracking line
search; and the in-house inexact Newton, `d4est_solver_newton.c:136-367`).

The outer loop runs on the host: each step reads ‖F‖ back once per line
search trial, and the inner Krylov solve is the caller's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class NewtonParams:
    atol: float = 1e-12
    rtol: float = 1e-50
    max_iter: int = 50
    # Eisenstat–Walker style inner tolerance (the in-house Newton uses
    # min(0.5, sqrt(‖F‖)) via `d4est_util_min_dbl`, newton.c:205),
    # floored by inner_rtol
    inner_rtol: float = 1e-3
    line_search_max: int = 8
    monitor: bool = False


class NewtonResult(NamedTuple):
    u: torch.Tensor
    iterations: int
    residual_norm: float
    history: list


def _norm(F) -> float:
    return float(torch.sqrt(torch.sum(F * F)))


def newton_solve(
    residual: Callable,  # F(u)
    jacobian_solve: Callable,  # (u0, rhs, rtol) -> du solving J(u0) du = rhs
    u0,
    params: NewtonParams = NewtonParams(),
    callback: Callable | None = None,  # (it, u, fnorm) per Newton iterate
) -> NewtonResult:
    """Newton iterates from `u0` until ‖F‖ < atol or < rtol·‖F(u0)‖.
    `callback` runs after every accepted step (the reference checkpoints
    there every n iterations, `d4est_solver_newton_petsc.c:232-245`)."""
    u = u0
    F = residual(u)
    fnorm = _norm(F)
    fnorm0 = fnorm
    history = [fnorm]
    for it in range(params.max_iter):
        if fnorm < params.atol or fnorm < params.rtol * fnorm0:
            break
        inner_rtol = max(params.inner_rtol, min(0.5, fnorm**0.5))
        du = jacobian_solve(u, -F, inner_rtol)
        # backtracking line search on ‖F‖
        lam = 1.0
        for _ in range(params.line_search_max):
            u_try = u + lam * du
            F_try = residual(u_try)
            fnorm_try = _norm(F_try)
            if fnorm_try < (1.0 - 1e-4 * lam) * fnorm or fnorm_try < fnorm:
                break
            lam *= 0.5
        u, F, fnorm = u_try, F_try, fnorm_try
        history.append(fnorm)
        if callback is not None:
            callback(it + 1, u, fnorm)
        if params.monitor:
            print(f"newton it {it + 1}: ||F|| = {fnorm:.14e} (lambda={lam})")
    return NewtonResult(u=u, iterations=len(history) - 1,
                        residual_norm=fnorm, history=history)
