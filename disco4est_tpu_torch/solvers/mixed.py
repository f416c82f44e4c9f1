"""Mixed-precision iterative refinement: f64 contract, f32 inner solves.

Port of `disco4est_tpu/solvers/mixed.py`:

    x = x0                                (f64)
    repeat:
        r = b - A(x)                      (f64 apply, ONE per outer step)
        d ~= A^{-1} r  via CG in f32      (inner solve)
        x = x + d                         (f64 update)
    until ||r|| <= tol, or the residual stops contracting

The residual is scaled to unit norm before the f32 cast, so the inner
problem stays well conditioned in f32 when ||r|| is far below f32's
normal range.  A step that grows the residual is rejected (best iterate
kept), and the loop stops once the outer residual stops contracting.  The
outer loop runs on the host; the `optimization_barrier` workarounds of the
JAX version (an XLA:TPU miscompile) have no counterpart here.  The JAX
module's `mesh_astype` is `MeshData.astype` in the port.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from disco4est_tpu_torch.solvers.cg import cg_solve

F32 = torch.float32


class MixedResult(NamedTuple):
    x: torch.Tensor
    outer_iterations: int
    inner_iterations: int  # total inner (f32) Krylov iterations
    residual_norm: float


def _norm(a) -> float:
    return float(torch.sqrt(torch.dot(a.reshape(-1), a.reshape(-1))))


def mixed_refine_solve(
    A: Callable,
    b,
    x0=None,
    *,
    inner_solve: Callable | None = None,
    A32: Callable | None = None,
    inner_rtol: float = 1e-5,
    inner_max_iter: int = 2000,
    atol: float = 5e-15,
    rtol: float = 1e-14,
    max_outer: int = 60,
) -> MixedResult:
    """Solve A x = b to f64 accuracy with f32 inner solves.

    `A` is the f64 matrix-free operator.  The inner correction solve is
    either `inner_solve(r32) -> (d32, iterations)`
    (`structured.make_inner_solve` has this shape) or, by default, CG on
    `A32` (defaults to `A` evaluated on f32 inputs)."""
    x = torch.zeros_like(b) if x0 is None else x0
    if inner_solve is None:
        A32_ = A32 or (lambda v: A(v.to(b.dtype)).to(F32))

        def inner_solve(r32):
            res = cg_solve(
                A32_, r32, atol=0.0, rtol=inner_rtol,
                max_iter=inner_max_iter,
            )
            return res.x, res.iterations

    tol = max(atol, rtol * _norm(b))
    r = b - A(x)
    rn = _norm(r)
    rn_prev = math.inf
    k = tot = 0
    # stall exit: once the outer residual stops contracting (the
    # f32-representation floor) further outer steps are wasted, and a
    # diverging inner solve must not keep feeding corrections
    while rn > tol and k < max_outer and (k < 3 or rn < 0.9 * rn_prev):
        scale = rn if rn > 0 else 1.0
        d32, it = inner_solve((r / scale).to(F32))
        x_new = x + scale * d32.to(b.dtype)
        r_new = b - A(x_new)
        rn_new = _norm(r_new)
        # keep the BEST iterate: reject a step that grows the residual
        if not rn_new > rn:
            x, r = x_new, r_new
        rn_prev, rn = rn, min(rn_new, rn)
        k += 1
        tot += int(it)
    return MixedResult(x=x, outer_iterations=k, inner_iterations=tot,
                       residual_norm=rn)

