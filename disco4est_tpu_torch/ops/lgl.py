"""Jacobi polynomials and Gauss / Gauss-Lobatto-Legendre nodes & weights.

Role of the reference's `dGMath/d4est_lgl.c` and the hard-coded long-double
node tables in `dGMath/GL_and_GLL_nodes_and_weights.h` (4,661 lines): instead
of shipping tables, nodes/weights are computed at setup time in float64
numpy (Newton iteration on the Legendre derivative for LGL; Golub-Welsch via
numpy.polynomial for Gauss), accurate to ~1e-16 which matches the table
precision that survives a cast to double.

Everything here is host-side setup code (numpy, float64); runtime kernels
consume the resulting small operator matrices as torch tensors.

Port of `disco4est_tpu/ops/lgl.py` (host numpy, copied unchanged).
"""

from __future__ import annotations

import functools

import numpy as np


def jacobi(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    """Normalized Jacobi polynomial P̃_n^{(α,β)}(x), orthonormal w.r.t. the
    Jacobi weight on [-1, 1].

    Mirrors the semantics of `d4est_lgl_jacobi` (reference
    `dGMath/d4est_lgl.c`): the normalized polynomial used to build
    Vandermonde matrices, so that M = (V Vᵀ)⁻¹ is the exact mass matrix.
    Standard three-term recurrence (Hesthaven & Warburton, Appendix A).
    """
    x = np.asarray(x, dtype=np.float64)
    ab = alpha + beta
    gamma0 = (
        2.0 ** (ab + 1) / (ab + 1.0)
        * _gamma_ratio(alpha + 1, beta + 1, ab + 1)
    )
    p0 = np.ones_like(x) / np.sqrt(gamma0)
    if n == 0:
        return p0
    gamma1 = (alpha + 1.0) * (beta + 1.0) / (ab + 3.0) * gamma0
    p1 = ((ab + 2.0) * x / 2.0 + (alpha - beta) / 2.0) / np.sqrt(gamma1)
    if n == 1:
        return p1
    aold = (
        2.0 / (2.0 + ab)
        * np.sqrt((alpha + 1.0) * (beta + 1.0) / (ab + 3.0))
    )
    pm2, pm1 = p0, p1
    for i in range(1, n):
        h1 = 2.0 * i + ab
        anew = (
            2.0 / (h1 + 2.0)
            * np.sqrt(
                (i + 1.0)
                * (i + 1.0 + ab)
                * (i + 1.0 + alpha)
                * (i + 1.0 + beta)
                / (h1 + 1.0)
                / (h1 + 3.0)
            )
        )
        bnew = -(alpha**2 - beta**2) / h1 / (h1 + 2.0)
        pnew = (1.0 / anew) * (-aold * pm2 + (x - bnew) * pm1)
        pm2, pm1 = pm1, pnew
        aold = anew
    return pm1


def _gamma_ratio(a: float, b: float, c: float) -> float:
    """Γ(a)Γ(b)/Γ(c) computed stably through lgamma."""
    from math import lgamma, exp

    return exp(lgamma(a) + lgamma(b) - lgamma(c))


def grad_jacobi(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    """d/dx of the normalized Jacobi polynomial (`d4est_lgl_gradjacobi`)."""
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.zeros_like(x)
    return np.sqrt(n * (n + alpha + beta + 1.0)) * jacobi(
        x, alpha + 1.0, beta + 1.0, n - 1
    )


@functools.lru_cache(maxsize=None)
def gauss_nodes_weights(n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [-1, 1] (degree = n_nodes-1)."""
    x, w = np.polynomial.legendre.leggauss(n_nodes)
    return x.astype(np.float64), w.astype(np.float64)


@functools.lru_cache(maxsize=None)
def lobatto_nodes_weights(n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Lobatto-Legendre nodes/weights on [-1, 1].

    Newton iteration on q(x) = (1-x²) P'_N(x) with Chebyshev-Gauss-Lobatto
    initial guess; weights w_i = 2 / (N (N+1) P_N(x_i)²) with the
    *unnormalized* Legendre polynomial P_N.
    """
    if n_nodes < 2:
        raise ValueError("LGL requires at least 2 nodes")
    N = n_nodes - 1
    # Chebyshev-Gauss-Lobatto initial guess.
    x = -np.cos(np.pi * np.arange(n_nodes) / N)
    # Newton: solve (1-x²) P'_N(x) = 0 at interior points.
    # Use the identity with normalized polys is awkward; use plain Legendre
    # via numpy polynomial evaluation for robustness.
    c = np.zeros(n_nodes)
    c[N] = 1.0
    for _ in range(100):
        pN = np.polynomial.legendre.legval(x, c)
        dpN = np.polynomial.legendre.legval(x, np.polynomial.legendre.legder(c))
        d2pN = np.polynomial.legendre.legval(
            x, np.polynomial.legendre.legder(c, 2)
        )
        # q = (1-x²)dpN ; q' = -2x dpN + (1-x²) d2pN
        q = (1.0 - x**2) * dpN
        dq = -2.0 * x * dpN + (1.0 - x**2) * d2pN
        interior = slice(1, N)
        dx = np.zeros_like(x)
        dx[interior] = q[interior] / dq[interior]
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    x[0], x[N] = -1.0, 1.0
    pN = np.polynomial.legendre.legval(x, c)
    w = 2.0 / (N * (N + 1) * pN**2)
    return x.astype(np.float64), w.astype(np.float64)
