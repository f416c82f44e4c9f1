"""Matrix-free (preconditioned) conjugate gradients.

Port of `disco4est_tpu/solvers/cg.py` (role of the reference's
`Solver/d4est_solver_cg.c:76-280`).  The JAX `lax.while_loop` becomes a
Python loop with the same arithmetic order; the stopping test is read
once per iteration, which is the loop's one host sync (through the
tracer's Krylov probe, `util/trace.py`, which counts the iterations and
times the host's enqueue and its wait in that read).

Mid-solve checkpointing (`d4est_solver_krylov_petsc.c:236-245` role):
`return_state=True` also returns the whole Krylov state `(x, r, z, p, rz,
k)`, the JAX tuple; passing it back as `resume_state` with a larger
`max_iter` (the cumulative cap) continues exactly where the solve stopped,
so a chunked solve equals the uninterrupted one bit for bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from disco4est_tpu_torch.util import trace


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: float


def _local_dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def cg_solve(
    A: Callable,
    b,
    x0=None,
    *,
    M: Callable | None = None,
    atol: float = 1e-15,
    rtol: float = 1e-15,
    max_iter: int = 10000,
    resume_state: tuple | None = None,
    return_state: bool = False,
    dot: Callable | None = None,
):
    """Solve A x = b.  `A` and the optional preconditioner `M` are
    matrix-free callables on tensors shaped like `b`; `dot` replaces the
    local dot product (the distributed solves pass their global one).
    Returns the `CGResult`, and with `return_state` also the state to
    resume from."""
    _dot = dot or _local_dot
    with trace.krylov() as probe:
        if resume_state is None:
            x = torch.zeros_like(b) if x0 is None else x0
            r = b - A(x)
            z = r if M is None else M(r)
            p = z
            rz = _dot(r, z)
            k = 0
        else:
            x, r, z, p, rz, k = resume_state
        k0 = k
        bnorm = probe.read(torch.sqrt(_dot(b, b)))
        tol2 = max(atol, rtol * bnorm) ** 2

        while k < max_iter and probe.read(_dot(r, r)) > tol2:
            Ap = A(p)
            alpha = rz / _dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = r if M is None else M(r)
            rz_new = _dot(r, z)
            beta = rz_new / rz
            p = z + beta * p
            rz = rz_new
            k += 1
        probe.iterations = k - k0
    res = CGResult(x=x, iterations=k,
                   residual_norm=float(torch.sqrt(_dot(r, r))))
    return (res, (x, r, z, p, rz, k)) if return_state else res
