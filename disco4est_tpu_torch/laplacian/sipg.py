"""Matrix-free SIPG Laplacian apply, mass apply and strong-BC rhs.

Port of the conforming-affine subset of `disco4est_tpu/laplacian/sipg.py`
(role of the reference's `dGMath/d4est_laplacian.c` and
`d4est_laplacian_flux_sipg.c`).  `apply_sipg` dispatches to the GEMM-form
fast path (`laplacian/fast.py`); the general quadrature-point apply
(curved elements, Robin data, zeroed neighbors) is not ported yet and
raises (ROADMAP A8).
"""

from __future__ import annotations

import torch

from disco4est_tpu_torch.laplacian.fast import (
    apply_sipg_fast,
    fast_path_available,
)
from disco4est_tpu_torch.mesh.builder import MeshData, vol_interp, vol_weights


def apply_sipg(mesh: MeshData, u, g=None):
    """Au for the SIPG Laplacian (−∇² weak form).  `u`: [E, nl...] nodal
    field; `g`: optional Dirichlet data at face Lobatto nodes
    [E, 2d, nfl...] (None ⇒ homogeneous, the pure linear operator).
    The JAX function's `neighbors` and `robin_coeff` arguments come with
    the general apply (ROADMAP A8)."""
    if fast_path_available(mesh):
        return apply_sipg_fast(mesh, u, g)
    raise NotImplementedError(
        "the general SIPG apply (curved elements) is not ported yet "
        "(ROADMAP A8)"
    )


def apply_mass(mesh: MeshData, v):
    """M v: nodal mass apply via quadrature
    (`d4est_quadrature_apply_mass_matrix`)."""
    w = vol_weights(mesh, v.dtype)
    v_q = vol_interp(mesh, v)
    return vol_interp(mesh, w * mesh.j_quad.to(v.dtype) * v_q,
                      transpose=True)


def build_rhs_with_strong_bc(mesh: MeshData, f, g):
    """rhs = M·f − A(0; g): moves inhomogeneous Dirichlet data into the
    load vector (`d4est_laplacian_build_rhs_with_strong_bc`,
    `dGMath/d4est_laplacian.c:16-130`).  `f`: load at Lobatto nodes
    [E, nl...]; `g`: face-Lobatto Dirichlet data [E, 2d, nfl...]."""
    Au0 = apply_sipg(mesh, torch.zeros_like(f), g)
    return apply_mass(mesh, f) - Au0
