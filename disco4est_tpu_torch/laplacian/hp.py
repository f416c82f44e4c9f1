"""True hp (mixed per-element degree) operators by subspace conjugation.

Port of `disco4est_tpu/laplacian/hp.py` (the reference carries a
per-element `deg` everywhere, `Mesh/d4est_element_data.h:13-46`).

- Fields on an hp mesh are stored as PADDED nodal arrays at the storage
  degree `deg = max_e deg_e`: element `e`'s coefficients live in the
  low-index `(deg_e+1)^dim` corner block; the rest are structural zeros.
- With `P` the block-diagonal per-element p-prolongation (the exact
  polynomial embedding `V_hp → V_max`), the Galerkin SIPG operator on the
  hp space is exactly `A_hp = Pᵀ · A_max · P`, the penalty σ built from the
  true degrees (`build_mesh(deg_e=...)`).  So the uniform-degree apply
  serves every degree mixture; only the [E, n, n] per-element 1D
  prolongations vary, gathered from a (deg+1)-entry table.

The per-element applies are `einsum`s over gathered [E, n, n] matrices, as
the JAX module's are XLA contractions.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from disco4est_tpu_torch.laplacian import sipg as _sipg
from disco4est_tpu_torch.mesh.builder import MeshData
from disco4est_tpu_torch.ops.operators import DB


@lru_cache(maxsize=None)
def _prolong_table_np(deg_max: int) -> np.ndarray:
    """[deg_max+1, n, n]: padded 1D p-prolongation per true degree.
    Column block [:, :d+1] = `DB.p_prolong(d, deg_max)`; zero elsewhere."""
    n = deg_max + 1
    T = np.zeros((n, n, n))
    for d in range(1, deg_max + 1):  # degree 0 unused (reference min deg 1)
        T[d, :, : d + 1] = DB.p_prolong(d, deg_max)
    return T


@lru_cache(maxsize=None)
def _restrict_table_np(deg_max: int) -> np.ndarray:
    """[deg_max+1, n, n]: padded 1D L2 p-restriction per true degree.
    Row block [:d+1, :] = `DB.p_restrict(deg_max, d)` (L2 projection,
    `d4est_operators_build_p_restrict_1d`)."""
    n = deg_max + 1
    T = np.zeros((n, n, n))
    for d in range(1, deg_max + 1):  # degree 0 unused (reference min deg 1)
        T[d, : d + 1, :] = DB.p_restrict(deg_max, d)
    return T


def _row_apply_axes(mats, u, dim: int):
    """Per-element 1D matrix along every tensor axis: mats [E, n, n]."""
    for dir_ in range(dim):
        ax = u.ndim - 1 - dir_
        v = torch.movedim(u, ax, -1)
        v = torch.einsum("eab,e...b->e...a", mats, v)
        u = torch.movedim(v, -1, ax)
    return u


@lru_cache(maxsize=64)
def _table_on(table_fn, deg_max: int, dtype, device):
    """A padded table as a tensor on `device`, uploaded once."""
    return torch.as_tensor(table_fn(deg_max), dtype=dtype, device=device)


def _table_rows(table_fn, deg_max, deg_e, like, transpose=False):
    """Rows `deg_e` of the padded table `table_fn(deg_max)`, as a tensor of
    `like`'s dtype and device."""
    T = _table_on(table_fn, deg_max, like.dtype, like.device)
    if transpose:
        T = T.transpose(-1, -2)
    return T[torch.as_tensor(deg_e, device=like.device).long()]


def prolong_padded(u_own, deg_e, deg_storage: int, dim: int):
    """Mesh-free variant of `to_max` (for AMR transfer before the new
    MeshData exists): padded own-degree coefficients -> nodal field at
    `deg_storage`."""
    mats = _table_rows(_prolong_table_np, deg_storage, deg_e, u_own)
    return _row_apply_axes(mats, u_own, dim)


def restrict_padded(u_max, deg_e, deg_storage: int, dim: int):
    """Mesh-free variant of `restrict_to_own` (L2 projection)."""
    mats = _table_rows(_restrict_table_np, deg_storage, deg_e, u_max)
    return _row_apply_axes(mats, u_max, dim)


def to_max(mesh: MeshData, u_own):
    """P û: padded own-degree coefficients -> storage-degree nodal field."""
    return prolong_padded(u_own, mesh.deg_e, mesh.deg, mesh.dim)


def adjoint_to_own(mesh: MeshData, r_max):
    """Pᵀ r: storage-degree residual -> hp-space residual (padded)."""
    mats = _table_rows(_prolong_table_np, mesh.deg, mesh.deg_e, r_max,
                       transpose=True)
    return _row_apply_axes(mats, r_max, mesh.dim)


def restrict_to_own(mesh: MeshData, u_max):
    """L2-project a storage-degree field into the hp space (padded
    coefficients).  Exact on fields already in the hp space."""
    return restrict_padded(u_max, mesh.deg_e, mesh.deg, mesh.dim)


def adjoint_restrict_to_storage(mesh: MeshData, r_own):
    """Rᵀ r: hp-space dual vector (padded) -> storage-degree dual — the
    adjoint of `restrict_to_own` (the hp-multigrid transfers use it)."""
    mats = _table_rows(_restrict_table_np, mesh.deg, mesh.deg_e, r_own,
                       transpose=True)
    return _row_apply_axes(mats, r_own, mesh.dim)


def own_mask(mesh: MeshData, dtype=torch.float64):
    """[E, nl, ...]: 1 on an element's true coefficient block, 0 on the
    structural padding."""
    nl = mesh.deg + 1
    E = mesh.n_elements
    line = (torch.arange(nl, device=mesh.device)[None, :]
            <= mesh.deg_e[:, None])  # [E, nl]
    out = torch.ones((E,) + (1,) * mesh.dim, dtype=torch.bool,
                     device=mesh.device)
    for d in range(mesh.dim):  # axis order (z, y, x); all axes same mask
        shape = [E] + [1] * mesh.dim
        shape[1 + d] = nl
        out = out & line.reshape(shape)
    return out.expand((E,) + (nl,) * mesh.dim).to(dtype)


def apply_sipg_hp(mesh: MeshData, u_own, g=None):
    """A_hp û = Pᵀ A_max (P û) — the exact Galerkin SIPG operator on the
    mixed-degree space (uniform meshes: P = I, reduces to `apply_sipg`)."""
    return adjoint_to_own(mesh, _sipg.apply_sipg(mesh, to_max(mesh, u_own), g))


def apply_mass_hp(mesh: MeshData, v_own):
    return adjoint_to_own(mesh, _sipg.apply_mass(mesh, to_max(mesh, v_own)))


def build_rhs_with_strong_bc_hp(mesh: MeshData, f, g):
    """Pᵀ(M f − A_max(0; g)): the hp load vector with inhomogeneous
    Dirichlet data folded in (hp analog of
    `d4est_laplacian_build_rhs_with_strong_bc`)."""
    return adjoint_to_own(mesh, _sipg.build_rhs_with_strong_bc(mesh, f, g))


# ---------------------------------------------------------------------------
# Own-degree (reference) conventions on hp meshes
# ---------------------------------------------------------------------------
#
# The reference computes per-element quantities at the element's OWN
# degree (`d4est_mesh.c:2299` L2 on own deg_quad; the bi estimator's
# volume term measures the own-basis residual vector,
# `d4est_estimator_bi_new.c:437-489`).  On affine meshes every quadrature
# involved is exact for the polynomial integrands, so the own-degree
# values come WITHOUT per-degree kernels: take the field's own-space nodal
# values (its hp coefficients), apply the nonpolynomial step there (|·|
# sampling, residual dual transform), then embed with the exact
# prolongation P and integrate at storage degree.


def init_field_own(mesh: MeshData, fcn):
    """Evaluate `fcn` at each element's OWN-degree Lobatto nodes, padded
    into the storage-degree corner block (`d4est_mesh_init_field` on hp
    meshes samples at per-element nodes)."""
    from disco4est_tpu_torch.mesh.builder import _positions, _tensor_points
    from disco4est_tpu_torch.mesh.tree import ROOT

    dim, dev = mesh.dim, mesh.device
    nl = mesh.deg + 1
    deg_e = mesh.deg_e.cpu().numpy()
    forest = mesh.forest
    kw = dict(dtype=torch.float64, device=dev)
    tree = torch.as_tensor(forest.tree.astype(np.int64), device=dev)
    anchor = torch.as_tensor(forest.anchor, **kw) / ROOT
    hfrac = torch.as_tensor(2.0 ** -forest.level.astype(np.float64), **kw)
    out = torch.zeros((mesh.n_elements,) + (nl,) * dim, **kw)
    for d in np.unique(deg_e):
        d = int(d)
        idx = torch.as_tensor(np.where(deg_e == d)[0], device=dev)
        pts = _tensor_points(DB.ops(d).lobatto_nodes, dim, dev)
        xyz = _positions(mesh.geom, tree[idx], anchor[idx], hfrac[idx], pts)
        vals = fcn(*[xyz[..., c] for c in range(dim)])
        block = out[idx]
        block[(slice(None),) + (slice(0, d + 1),) * dim] = vals
        out[idx] = block
    return out


def l2_norm_sqr_own(mesh: MeshData, v_own):
    """Per-element ∫ v² J dV where v is the own-degree polynomial with
    padded nodal coefficients `v_own` — exact storage-degree integration
    of the embedded function (affine meshes: identical to the reference's
    own-deg-quad value)."""
    return mesh.l2_norm_sqr(to_max(mesh, v_own * own_mask(mesh, v_own.dtype)))


def norm_L2_interp_abs_own(mesh: MeshData, u_max, analytic_fcn):
    """The reference regression 'L2': nodal ABSOLUTE error sampled at each
    element's OWN Lobatto nodes, interpolated as an own-degree polynomial,
    then L2-integrated (`d4est_linalg_vec_fabsdiff` + `compute_l2_norm_sqr`
    at own degree).  `u_max` is the storage-degree solution field."""
    u_own = restrict_to_own(mesh, u_max)  # exact: u is in the hp space
    ua_own = init_field_own(mesh, analytic_fcn).to(u_max.dtype)
    e_abs = torch.abs(u_own - ua_own)
    return torch.sqrt(torch.sum(l2_norm_sqr_own(mesh, e_abs)))


def residual_own_embedded(mesh: MeshData, F_max):
    """The reference estimator's volume-term residual function: the
    OWN-basis residual vector Pᵀ F interpreted as nodal values of an
    own-degree polynomial, embedded back to storage degree
    (`d4est_estimator_bi_new.c:437` measures Au−rhs in the element's own
    basis).  Pass the result as `estimate_bi`'s residual for hp parity."""
    return to_max(mesh, adjoint_to_own(mesh, F_max))
