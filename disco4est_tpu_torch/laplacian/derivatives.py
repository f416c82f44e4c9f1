"""Physical-space derivatives of nodal fields: gradient and Hessian trace.

Port of `disco4est_tpu/laplacian/derivatives.py` (role of the reference's
`dGMath/d4est_gradient.c` and `dGMath/d4est_hessian.c`: ∇u and the
Hessian trace on quadrature points).  The second-geometry terms come from
differentiating the inverse-Jacobian fields in reference space, and the
inverse Jacobians from the geometry's `dx` (autodiff for curved maps), so
curved geometries need no hand-written D2X.  The factors are evaluated on
the mesh's device; everything is torch operations.
"""

from __future__ import annotations

import numpy as np
import torch

from disco4est_tpu_torch.mesh.builder import (
    ROOT,
    MeshData,
    _factors,
    _tensor_points,
)
from disco4est_tpu_torch.ops import tensor
from disco4est_tpu_torch.ops.operators import DB


def _grad(D, u, dim: int):
    """Reference-space gradient [dim, *u.shape]: D along each direction."""
    return torch.stack([tensor.apply_axis(D, u, l) for l in range(dim)])


def gradient(mesh: MeshData, u, on_quad: bool = True):
    """∇u in physical coords at the volume quadrature points:
    [E, dim, nq...] (`d4est_gradient.h:12-14`; JAX `gradient`)."""
    if not on_quad:
        raise NotImplementedError(
            "gradient on Lobatto nodes: use on_quad=True")
    dim, deg = mesh.dim, mesh.deg
    kw = dict(dtype=u.dtype, device=u.device)
    D = torch.as_tensor(DB.ops(deg).diff, **kw)
    Vq = torch.as_tensor(mesh.quad.interp(deg, mesh.deg_quad), **kw)
    dudr = _grad(D, u, dim)  # [l, E, nl...]
    dudr_q = torch.stack([tensor.apply_iso(Vq, dudr[l], dim)
                          for l in range(dim)])
    drdx = _volume_drdx(mesh).to(u.dtype)  # [E, l, d, nq...]
    return (drdx * dudr_q.transpose(0, 1)[:, :, None]).sum(1)


def hessian_trace(mesh: MeshData, u):
    """Δu at the volume quadrature points [E, nq...] (JAX
    `hessian_trace`; the reference's HESSIAN_ANALYTICAL role):

    Δu = Σ_d [ Σ_l ∂r_l/∂x_d · ∂/∂r_l ( Σ_m ∂r_m/∂x_d · ∂u/∂r_m ) ]

    as nested reference-space derivative applies with the inverse-Jacobian
    fields on the Lobatto nodes."""
    dim, deg = mesh.dim, mesh.deg
    kw = dict(dtype=u.dtype, device=u.device)
    D = torch.as_tensor(DB.ops(deg).diff, **kw)
    Vq = torch.as_tensor(mesh.quad.interp(deg, mesh.deg_quad), **kw)
    drdx_l = _volume_drdx_lobatto(mesh).to(u.dtype)  # [E, l, d, nl...]

    dudr = _grad(D, u, dim)  # [l, E, nl...]
    out = None
    for d in range(dim):
        # v_d = Σ_m drdx[m,d] du/dr_m  (on Lobatto nodes)
        v = sum(drdx_l[:, m, d] * dudr[m] for m in range(dim))
        # w_d = Σ_l drdx[l,d] dv/dr_l
        dvdr = _grad(D, v, dim)
        w = sum(drdx_l[:, l, d] * dvdr[l] for l in range(dim))
        out = w if out is None else out + w
    return tensor.apply_iso(Vq, out, dim)


def _drdx_at(mesh: MeshData, x1):
    """∂r/∂x at the tensor points of the 1D nodes `x1`: [E, l, d, n...]
    (recomputed from the geometry: the mesh stores only the fused
    wjgg)."""
    forest = mesh.forest
    dev = mesh.device
    pts = _tensor_points(x1, mesh.dim, dev)
    _, drdx = _factors(
        mesh.geom,
        torch.as_tensor(forest.tree.astype(np.int64), device=dev),
        torch.as_tensor(forest.anchor, dtype=torch.float64, device=dev)
        / ROOT,
        torch.as_tensor(2.0 ** -forest.level.astype(np.float64),
                        device=dev),
        pts,
    )  # [E, pts..., l, d]
    return torch.movedim(torch.movedim(drdx, -1, 1), -1, 1)


def _volume_drdx(mesh: MeshData):
    """∂r/∂x at the volume quadrature points [E, l, d, nq...]."""
    xq, _ = mesh.quad.nodes_weights(mesh.deg_quad)
    return _drdx_at(mesh, xq)


def _volume_drdx_lobatto(mesh: MeshData):
    """∂r/∂x at the Lobatto nodes [E, l, d, nl...]."""
    return _drdx_at(mesh, DB.ops(mesh.deg).lobatto_nodes)
