"""Frozen yardstick: the work of one SIPG apply and the card's peaks.

The counts describe the operator, not an implementation, so a roofline
share built on them reads the same whatever kernel applies it.  They are
copied from the JAX package's `bench.py` (`model_flops_per_apply`, and the
compact-factor term of `min_bytes_per_apply`), with one change: the
inter-element traces that `min_bytes_per_apply` writes and reads again
are intermediate values of one implementation and are left out.  Do not
edit them: a later change that edits them moves every roofline share.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAK_POWER_W = 700.0


def apply_flops(E: int, dim: int, nl: int, nq: int) -> int:
    """Useful flops of one apply: the separable tensor-product count
    (volume interpolation, derivatives, pointwise metric products, their
    transposes, then the face interpolations and flux terms)."""
    vol_q = nq**dim
    interp = dim * 2 * nq * nl * max(nl, nq) ** (dim - 1)
    deriv = dim * 2 * nl * nl * nl ** (dim - 1)
    pointwise = (dim * dim + dim) * vol_q * 2
    per_elem = deriv + dim * interp + pointwise + dim * interp + deriv
    nf = 2 * dim
    face_interp = nf * (dim - 1) * 2 * nq * nl * max(nl, nq) ** (dim - 2) * 4
    face_terms = nf * (nq ** (dim - 1)) * 2 * (2 * dim + 6)
    return E * (per_elem + face_interp + face_terms)


def apply_bytes(E: int, dim: int, nl: int, itemsize: int = 4) -> int:
    """Least memory traffic of one apply: u read once, Au written once and
    the compact per-element constants read once (the metric's dim^2, per
    face the normal, surface Jacobian and penalty, and a flag)."""
    nf = 2 * dim
    factors = dim * dim + nf * (dim + 2) + nf
    return E * (2 * nl**dim + factors) * itemsize


def least_seconds(E: int, dim: int, nl: int, nq: int,
                  peak_flops: float = PEAK_TF32_FLOPS):
    """(the least time of one f32 apply on the card, the binding bound:
    "bytes" or "flops")."""
    t_bytes = apply_bytes(E, dim, nl) / PEAK_HBM_BYTES
    t_flops = apply_flops(E, dim, nl, nq) / peak_flops
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")
