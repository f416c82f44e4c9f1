"""Mass-weighted nonlinear terms: M·f(x,u) and its linearization.

Port of `disco4est_tpu/laplacian/nonlinear.py` (role of the reference's
`d4est_quadrature_apply_fofufofvlj` / `apply_fofufofvlilj`,
`Quadrature/d4est_quadrature.h:135-139`): integrate a pointwise function
of the solution against the test functions (the nonlinear term of a
Newton residual), and the frozen-u0 term of the Jacobian (e.g.
ConstantDensityStar's −2πρψ⁵ / −10πρψ⁴·v, TwoPunctures' ψ⁻⁷ / ψ⁻⁸ terms).

`fof(xyz, u_q)` and `dfof(xyz, u0_q)` are pointwise torch functions of the
coordinate tuple and the field at the volume quadrature points.
"""

from __future__ import annotations

import numpy as np
import torch

from disco4est_tpu_torch.mesh.builder import MeshData, vol_interp, vol_weights
from disco4est_tpu_torch.ops import tensor


def _xyz_quad(mesh: MeshData, dtype):
    return tuple(mesh.xyz_quad[:, d].to(dtype) for d in range(mesh.dim))


def apply_mass_fof(mesh: MeshData, u, fof):
    """Vᵀ W J f(x_q, u_q): the nodal vector of ∫ f(x,u) φ_i dV."""
    dtype = u.dtype
    w = vol_weights(mesh, dtype)
    f_q = fof(_xyz_quad(mesh, dtype), vol_interp(mesh, u))
    return vol_interp(mesh, w * mesh.j_quad.to(dtype) * f_q, transpose=True)


def apply_mass_fof_lin(mesh: MeshData, u0, v, dfof):
    """Vᵀ W J f'(x_q, u0_q) ⊙ v_q: the frozen-u0 Jacobian term."""
    return apply_mass_coeff(mesh, fof_lin_coeff(mesh, u0, dfof, v.dtype), v)


def fof_lin_coeff(mesh: MeshData, u0, dfof, dtype=None):
    """W J f'(x_q, u0_q) at the volume quadrature points [E, nq...]: the
    frozen-u0 part of `apply_mass_fof_lin`, to evaluate once per Newton
    step rather than once per Krylov iteration (eager torch runs every
    pointwise operation of `dfof` as a launch; XLA fuses them)."""
    dtype = dtype or u0.dtype
    w = vol_weights(mesh, dtype)
    c_q = dfof(_xyz_quad(mesh, dtype), vol_interp(mesh, u0.to(dtype)))
    return w * mesh.j_quad.to(dtype) * c_q


def apply_mass_coeff(mesh: MeshData, coeff, v):
    """Vᵀ (coeff ⊙ V v), with coeff from `fof_lin_coeff`: the same
    products in the same order as `apply_mass_fof_lin`."""
    return vol_interp(mesh, coeff * vol_interp(mesh, v), transpose=True)


def assemble_fof_blocks(mesh: MeshData, u0, dfof, dtype=None):
    """Per-element dense blocks [E, n, n] of the frozen-u0 term
    Vᵀ diag(w·J·f'(x_q, u0_q)) V: the fine-level input of the multigrid
    matrix operator (`d4est_solver_multigrid_matrix_operator.h:1-21`).
    Like the JAX version it takes the shared Gauss rule (no per-element
    radial rule)."""
    dtype = dtype or u0.dtype
    dim = mesh.dim
    kw = dict(dtype=dtype, device=u0.device)
    V1 = np.asarray(mesh.quad.interp(mesh.deg, mesh.deg_quad))
    _, wq1 = mesh.quad.nodes_weights(mesh.deg_quad)
    w = tensor.tensor_weights([wq1] * dim, **kw)
    u0_q = tensor.apply_iso(torch.as_tensor(V1, **kw), u0.to(dtype), dim)
    c_q = dfof(_xyz_quad(mesh, dtype), u0_q)  # [E, nq...]
    E = c_q.shape[0]
    diag = (w * mesh.j_quad.to(dtype) * c_q).reshape(E, -1)  # [E, nq^d]
    # dense ⊗V, [nq^d, nl^d] in x-fastest flattening
    Vfull = np.array([[1.0]])
    for _ in range(dim):
        Vfull = np.kron(Vfull, V1)
    Vfull = torch.as_tensor(Vfull, **kw)
    # B = Vᵀ diag V per element, as one batched GEMM
    return Vfull.T @ (diag[:, :, None] * Vfull)
