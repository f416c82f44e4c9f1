"""Compactified quadrature: per-element Gaussian rules for the rational
weights of 1/r-compactified shells.

Role of the reference's `Quadrature/d4est_quadrature_compactified.c`
(1,856 LoC): on a compactified outer shell the radial map is
R(t) ∝ 1/(c1 + c2·t), so volume integrands carry a factor
(c1 + c2·t)^{-k}; plain Gauss–Legendre cannot integrate the rational
part exactly, while a Gaussian rule FOR THE WEIGHT w_k = (c1+c2·t)^{-k}
is exact for polynomial·w_k.  The reference builds the rules from
hard-coded Mathematica recurrence coefficients and closed-form moments
in `long double` (`c1tpc2_negk_aa_and_bb` / `_moment_fcn`), then divides
the weights by w_k (`DIVIDE_WEIGHTS_BY_WEIGHT_FCN`) so the rule is a
drop-in replacement for the Gauss weights.

Design: the rules are HOST precomputation (once per mesh
epoch), so we compute the recurrence numerically — a discretized
Stieltjes procedure in numpy `longdouble` (80-bit, the same extended
precision as the reference's `long double` on x86) against a high-order
Legendre discretization, then Golub–Welsch.  This covers every k and
every n without 1,200 lines of generated closed forms, at the same
precision (validated against the reference's own rules to ~1e-15,
tests/test_compactified.py).

Port of `disco4est_tpu/quadrature/compactified.py` (host numpy, copied
unchanged).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

LD = np.longdouble


@lru_cache(maxsize=None)
def _legendre_disc(m: int):
    """m-point Gauss–Legendre discretization, refined to longdouble by
    one Newton step on P_m (nodes accurate to ~1e-19)."""
    x64, w64 = np.polynomial.legendre.leggauss(m)
    x = x64.astype(LD)
    # Newton refinement: P_m(x) via the recurrence in longdouble
    for _ in range(2):
        p0 = np.ones_like(x)
        p1 = x.copy()
        for j in range(2, m + 1):
            p0, p1 = p1, ((2 * j - 1) * x * p1 - (j - 1) * p0) / LD(j)
        dp = m * (x * p1 - p0) / (x * x - 1)
        x = x - p1 / dp
    # weights from the derivative formula
    p0 = np.ones_like(x)
    p1 = x.copy()
    for j in range(2, m + 1):
        p0, p1 = p1, ((2 * j - 1) * x * p1 - (j - 1) * p0) / LD(j)
    dp = m * (x * p1 - p0) / (x * x - 1)
    w = LD(2) / ((1 - x * x) * dp * dp)
    return x, w


def weight_fcn(t, c1: float, c2: float, k: int):
    """w_k(t) = (c1 + c2·t)^{-k} — `c1tpc2_negk_weight_fcn`.

    NB the reference's shell parametrization gives NEGATIVE c1 with
    |c1| > |c2| (c1 = (R2-R1)(cmax+cmin) - 4R2 + 2R1 < 0), so c1+c2·t
    keeps one sign on [-1,1]; odd powers flip the weight's sign, which
    cancels again in DIVIDE_WEIGHTS_BY_WEIGHT_FCN."""
    return (LD(c1) + LD(c2) * np.asarray(t, LD)) ** (-k)


def stieltjes_recurrence(c1: float, c2: float, k: int, n: int):
    """(aa[n], bb[n]) recurrence coefficients of the orthogonal
    polynomials for weight w_k on [-1,1] via the discretized Stieltjes
    procedure (the numerical twin of `c1tpc2_negk_aa_and_bb`)."""
    m = max(8 * n + 20, 60)
    x, wl = _legendre_disc(m)
    w = wl * weight_fcn(x, c1, c2, k)
    sgn = LD(1)
    if w.sum() < 0:  # odd k with negative c1: orthogonalize against -w
        w = -w
        sgn = LD(-1)
    aa = np.zeros(n, LD)
    bb = np.zeros(n, LD)
    p_prev = np.zeros_like(x)
    p = np.ones_like(x)
    norm = (w * p * p).sum()
    for j in range(n):
        aa[j] = (w * x * p * p).sum() / norm
        if j == 0:
            bb[j] = 0.0
        else:
            bb[j] = norm / norm_prev
        p_new = (x - aa[j]) * p - (bb[j] if j > 0 else 0.0) * p_prev
        p_prev, p = p, p_new
        norm_prev = norm
        norm = (w * p * p).sum()
    mu0 = sgn * (w * np.ones_like(x)).sum()
    return aa, bb, mu0


def rule(c1: float, c2: float, k: int, n: int):
    """n-point rule (abscissas, weights) with the weights DIVIDED by
    w_k (drop-in replacement for Gauss–Legendre): Σ wᵢ g(tᵢ) is exact
    for g = (poly of degree ≤ 2n−1)·w_k.  Sorted by abscissa."""
    aa, bb, mu0 = stieltjes_recurrence(c1, c2, k, n)
    # Golub–Welsch on the symmetric Jacobi matrix
    J = np.zeros((n, n))
    for j in range(n):
        J[j, j] = float(aa[j])
        if j > 0:
            off = float(np.sqrt(np.abs(bb[j])))
            J[j, j - 1] = off
            J[j - 1, j] = off
    lam, V = np.linalg.eigh(J)
    w_gauss = np.abs(float(mu0)) * V[0, :] ** 2
    sign_mu = np.sign(float(mu0))
    t = lam
    w = sign_mu * w_gauss / np.asarray(
        weight_fcn(t, c1, c2, k), np.float64
    )
    order = np.argsort(t)
    return t[order], w[order]


def shell_c1_c2(cmin: float, cmax: float, R1: float, R2: float):
    """Element radial-extent parameters of the compactified OUTER SHELL
    (`d4est_quadrature_compactified_compute_abscissas_and_weights`,
    GEOM_CUBED_SPHERE_OUTER_SHELL branch): cmin/cmax are the element's
    radial corners in the [1,2] topological coordinate."""
    c1 = (R2 - R1) * (cmax + cmin) - 4.0 * R2 + 2.0 * R1
    c2 = (R2 - R1) * (cmax - cmin)
    return c1, c2


def element_rule_outer_shell(
    anchor_c: int, dq: int, root: int, R1: float, R2: float, k: int, n: int
):
    """Per-element rule for an outer-shell element with radial anchor
    `anchor_c` and size `dq` in integer tree units (root = tree length)."""
    cmin = 1.0 + anchor_c / root
    cmax = 1.0 + (anchor_c + dq) / root
    c1, c2 = shell_c1_c2(cmin, cmax, R1, R2)
    return rule(c1, c2, k, n)
