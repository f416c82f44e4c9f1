"""Jacobi polynomials and Gauss / Gauss-Lobatto-Legendre nodes & weights.

Role of the reference's `dGMath/d4est_lgl.c` and the hard-coded long-double
node tables in `dGMath/GL_and_GLL_nodes_and_weights.h` (4,661 lines):
the port ships float64 tables too (`ops/gauss_table.py`), written once by
`util/gen_gauss.py` from numpy's `leggauss` (Gauss) and a Newton
iteration on the Legendre derivative (Gauss-Lobatto), accurate to ~1e-16.
Computed at run time, their last bits would move with the numpy version,
and digits at the f64 floor with them (ROADMAP C9).

Everything here is host-side setup code (numpy, float64); runtime kernels
consume the resulting small operator matrices as torch tensors.

Port of `disco4est_tpu/ops/lgl.py` (host numpy), with one change: the
rules come from that table, which holds the values the JAX module computes
under numpy 2.0.2.
"""

from __future__ import annotations

import functools

import numpy as np

from disco4est_tpu_torch.ops import gauss_table


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


def _tabulated(rules: dict, n_nodes: int, what: str):
    if n_nodes not in rules:
        raise ValueError(
            f"no tabulated {what} rule with {n_nodes} nodes (up to "
            f"{gauss_table.MAX_NODES}; `python -m "
            "disco4est_tpu_torch.util.gen_gauss` writes the table)"
        )
    x, w = rules[n_nodes]
    return (np.array([float.fromhex(v) for v in x]),
            np.array([float.fromhex(v) for v in w]))


@functools.lru_cache(maxsize=None)
def gauss_nodes_weights(n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [-1, 1] (degree = n_nodes-1): numpy's
    `leggauss`, from the shipped table (module docstring)."""
    return _tabulated(gauss_table.GAUSS, n_nodes, "Gauss")


@functools.lru_cache(maxsize=None)
def lobatto_nodes_weights(n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Lobatto-Legendre nodes/weights on [-1, 1], from the shipped
    table (module docstring): Newton iteration on q(x) = (1-x²) P'_N(x)
    from a Chebyshev-Gauss-Lobatto guess, weights 2 / (N (N+1) P_N(x_i)²)
    (`util/gen_gauss.py:lobatto`)."""
    if n_nodes < 2:
        raise ValueError("LGL requires at least 2 nodes")
    return _tabulated(gauss_table.LOBATTO, n_nodes, "Gauss-Lobatto")
