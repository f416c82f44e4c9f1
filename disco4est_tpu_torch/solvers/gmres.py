"""Restarted GMRES.

Port of `disco4est_tpu/solvers/gmres.py` (role of the reference's PETSc
`gmres` KSP option, `d4est_solver_krylov_petsc.h:16-29`, and the Schwarz
subdomain GMRES, `d4est_solver_schwarz_subdomain_solver_gmres.c`):
left-preconditioned GMRES(m) with a fixed-size Krylov basis, modified
Gram-Schmidt, and the small Hessenberg least-squares problem solved by
`torch.linalg.lstsq`.  The restart loop reads the residual norm once per
cycle; no driver path reaches it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class GMRESResult(NamedTuple):
    x: torch.Tensor
    residual_norm: float
    iterations: int  # restart cycles


def _norm(a):
    return torch.sqrt(torch.dot(a.reshape(-1), a.reshape(-1)))


def gmres_solve(
    A: Callable,
    b,
    x0=None,
    *,
    M: Callable | None = None,
    restart: int = 30,
    max_restarts: int = 20,
    atol: float = 1e-12,
    rtol: float = 1e-12,
) -> GMRESResult:
    """Left-preconditioned restarted GMRES(m)."""
    M = M or (lambda v: v)
    x = torch.zeros_like(b) if x0 is None else x0
    shape, n = b.shape, b.numel()
    tol = max(atol, rtol * float(_norm(M(b))))

    def arnoldi_cycle(x):
        r = M(b - A(x))
        beta = _norm(r)
        V = b.new_zeros((restart + 1, n))
        H = b.new_zeros((restart + 1, restart))
        V[0] = r.reshape(-1) / torch.where(beta > 0, beta, 1.0)
        for j in range(restart):
            w = M(A(V[j].reshape(shape))).reshape(-1)
            for i in range(j + 1):  # modified Gram-Schmidt
                h = torch.dot(V[i], w)
                w = w - h * V[i]
                H[i, j] = h
            hnorm = torch.sqrt(torch.dot(w, w))
            H[j + 1, j] = hnorm
            V[j + 1] = w / torch.where(hnorm > 1e-30, hnorm, 1.0)
        e1 = b.new_zeros(restart + 1)
        e1[0] = beta
        # the JAX module's lstsq, a minimum-norm SVD solve on the host
        y = torch.linalg.lstsq(H.cpu(), e1.cpu()[:, None],
                               driver="gelsd").solution[:, 0].to(b.device)
        x = x + (V[:restart].T @ y).reshape(shape)
        return x, float(_norm(b - A(x)))

    rnorm = float(_norm(b - A(x)))
    k = 0
    while rnorm > tol and k < max_restarts:
        x, rnorm = arnoldi_cycle(x)
        k += 1
    return GMRESResult(x=x, residual_norm=rnorm, iterations=k)
