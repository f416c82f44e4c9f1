"""Chebyshev iteration / smoother.

Port of `disco4est_tpu/solvers/cheby.py` (role of the reference's
`Solver/d4est_solver_multigrid_smoother_cheby.c`): Chebyshev polynomial
smoothing on the interval [λmax/ratio, λmax·mult], λmax from CG-Lanczos
(`cg_eigs`).  The bounds are host floats, so the recurrence's scalars are
computed on the host and a smoothing pass reads nothing back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from disco4est_tpu_torch.solvers.eigs import cg_eigs


@dataclasses.dataclass(frozen=True)
class ChebyParams:
    iterations: int = 8
    eigs_cg_iters: int = 10
    lmax_lmin_ratio: float = 30.0
    lmax_multiplier: float = 1.0


def cheby_smooth(A: Callable, b, x, lmin: float, lmax: float,
                 iterations: int):
    """x ← Cheby(A, b, x): the three-term Chebyshev acceleration of
    Richardson iteration on the eigenvalue interval [lmin, lmax]."""
    lmin, lmax = float(lmin), float(lmax)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    r = b - A(x)
    d = r / theta
    rho_old = 1.0 / sigma
    for _ in range(iterations - 1):
        x = x + d
        r = r - A(d)
        rho = 1.0 / (2.0 * sigma - rho_old)
        d = rho * rho_old * d + (2.0 * rho / delta) * r
        rho_old = rho
    return x + d


def cheby_solve(A: Callable, b, x0=None, params: ChebyParams = ChebyParams()):
    """Standalone Chebyshev solve with self-estimated spectral bounds."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    _, lmax = cg_eigs(A, b, params.eigs_cg_iters)
    lmax = lmax * params.lmax_multiplier
    return cheby_smooth(A, b, x0, lmax / params.lmax_lmin_ratio, lmax,
                        params.iterations)
