"""Matrix-free SIPG Laplacian apply, mass apply and strong-BC rhs.

Port of the affine subset of `disco4est_tpu/laplacian/sipg.py` (role of
the reference's `dGMath/d4est_laplacian.c` and
`d4est_laplacian_flux_sipg.c`).  `apply_sipg` dispatches to the GEMM-form
fast path (`laplacian/fast.py`), which also takes hanging faces.  The
general quadrature-point apply (curved elements, Robin data, zeroed
neighbors) and its hanging-face masking are not ported yet and raise
(ROADMAP A8).

`_apply_hanging` is the [M, K] mortar-row pass of the hanging faces (the
reference's hanging cases of `d4est_laplacian_flux_sipg_interface` with
`d4est_mortars_project_side_onto_mortar_space` and
`project_mass_mortar_onto_side`).  The fast path reaches it through
`fast._add_hanging` when a mesh has no dense hanging tables.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from disco4est_tpu_torch.laplacian.fast import (
    _base_mats,
    apply_sipg_fast,
    fast_path_available,
)
from disco4est_tpu_torch.mesh.builder import MeshData, vol_interp, vol_weights
from disco4est_tpu_torch.ops import tensor
from disco4est_tpu_torch.ops.operators import DB


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


# ---------------------------------------------------------------------------
# face helpers shared with the estimator
# ---------------------------------------------------------------------------


def _face_apply(A, v, dim):
    """Apply matrix A along every tangent axis of a face array
    [..., n_{t2}, n_{t1}] (dim-1 trailing axes); in 3D as one GEMM with
    the kron matrix A⊗A on the flattened face."""
    A = torch.as_tensor(A, dtype=v.dtype, device=v.device)
    if dim == 2:
        return tensor.apply_axis(A, v, 0)
    AF = torch.kron(A, A)
    lead = v.shape[: -(dim - 1)]
    out = v.reshape(lead + (-1,)) @ AF.T
    return out.reshape(lead + (A.shape[0],) * (dim - 1))


def _face_slices(u, dim):
    """[E, 2d, face_shape...] all face planes of a volume field."""
    return torch.stack(
        [tensor.face_slice(u, f, dim) for f in range(2 * dim)], dim=1
    )


def _face_quad_ops(mesh: MeshData, dtype, device):
    """Lobatto → face-quadrature interpolation Vq and the face quadrature
    weights wf [nq...]."""
    Vq = torch.as_tensor(mesh.quad.interp(mesh.deg, mesh.deg_quad),
                         dtype=dtype, device=device)
    _, wq1 = mesh.quad.nodes_weights(mesh.deg_quad)
    wf = tensor.tensor_weights([wq1] * (mesh.dim - 1), dtype=dtype,
                               device=device)
    return Vq, wf


# ---------------------------------------------------------------------------
# hanging-face mortar rows
# ---------------------------------------------------------------------------


def _row_mat_apply(mats, v, axis_from_back):
    """Per-row matrix apply: mats [R, a, b] contracted with v's axis
    `axis_from_back` (0 = last).  v: [R, ...]."""
    ax = v.ndim - 1 - axis_from_back
    out = torch.einsum("rab,r...b->r...a", mats, torch.movedim(v, ax, -1))
    return torch.movedim(out, -1, ax)


@functools.lru_cache(maxsize=None)
def _hanging_lift_mats(deg: int, dim: int):
    """Static per-face lift matrices for the mortar pass: W13[f] places a
    face plane into the volume (row-operand form plane @ W), W2[f]
    additionally applies Dᵀ_l after the lift for each direction l
    (stacked rows [dim*nfl, nv])."""
    # only sels/dvol are used; both depend on deg/dim alone, so the
    # "legendre" key is safe for any mesh
    bm = _base_mats(deg, deg, "legendre", dim)
    W13 = np.stack([bm["sels"][f] for f in range(2 * dim)])  # [2d, nfl, nv]
    W2 = np.stack([
        np.concatenate([bm["sels"][f] @ bm["dvol"][l] for l in range(dim)],
                       axis=0)
        for f in range(2 * dim)
    ])  # [2d, dim*nfl, nv]
    return W13, W2


def _lift_rows(elems, faces, vt13, vt2, E, deg, dim, dtype):
    """Volume accumulation of dynamic-face mortar rows: per-face masked
    GEMMs against the static lift matrices, then one `index_add_` onto the
    element axis (the JAX version's one-hot matmul, which avoids TPU
    scatters)."""
    nl = deg + 1
    nfl = nl ** (dim - 1)
    nv = nl**dim
    R = vt13.shape[0]
    dev = vt13.device
    W13, W2 = (torch.as_tensor(m, dtype=dtype, device=dev)
               for m in _hanging_lift_mats(deg, dim))
    z13 = vt13.reshape(R, nfl)
    z2 = vt2.reshape(R, dim * nfl)
    vol = torch.zeros((R, nv), dtype=dtype, device=dev)
    for f in range(2 * dim):
        m = (faces == f).to(dtype)[:, None]
        vol = vol + (m * z13) @ W13[f] + (m * z2) @ W2[f]
    out = torch.zeros((E, nv), dtype=dtype, device=dev)
    out.index_add_(0, elems.long(), vol)
    return out.reshape((E,) + (nl,) * dim)


def _apply_hanging(mesh: MeshData, u_f, dudr_f, dtype):
    """Hanging-face (nonconforming) mortar contributions, two batched
    passes:

    - COARSE rows (one per coarse hanging face): terms are computed on all
      K subfaces (the subface index is a batch axis), mass-projected back
      to the coarse face with Σ_b P_bᵀ;
    - FINE rows (one per fine element touching a coarse face): the mortar
      is the fine face itself; the coarse neighbor's trace is hp-prolonged
      onto it.

    `u_f` [E, 2d, nfl...] and `dudr_f` [E, 2d, dim, nfl...] are the face
    traces of u and of its reference gradient.  Identity orientations
    only: the mortar node permutations of the JAX version are the
    identity on a brick (the builder refuses others, ROADMAP A8)."""
    dim, deg = mesh.dim, mesh.deg
    nl = deg + 1
    K = 1 << (dim - 1)
    M = mesh.hc_elem.shape[0]
    E = u_f.shape[0]
    dev = u_f.device
    Vq, wf = _face_quad_ops(mesh, dtype, dev)
    ones = (1,) * (dim - 1)

    hp = torch.as_tensor(
        np.stack([DB.hp_prolong(deg, deg, c) for c in (0, 1)]),
        dtype=dtype, device=dev,
    )  # [2, nl, nl]
    bits = torch.as_tensor(
        [[(b >> t) & 1 for t in range(dim - 1)] for b in range(K)],
        device=dev,
    )  # [K, dim-1]

    ce, cfc = mesh.hc_elem.long(), mesh.hc_face.long()

    def prolong_b(v, t_axis, batched):
        """hp[bits[:, t]] along face axis t for every subface b:
        `batched=False`: [M, ...] -> [M, K, ...];
        `batched=True`:  [M, K, ...] -> [M, K, ...]."""
        mats = hp[bits[:, t_axis]]  # [K, nl, nl]
        ax = v.ndim - 1 - t_axis
        vm = torch.movedim(v, ax, -1)
        if batched:
            out = torch.einsum("kab,mk...b->mk...a", mats, vm)
            return torch.movedim(out, -1, ax)
        out = torch.einsum("kab,m...b->mk...a", mats, vm)
        return torch.movedim(out, -1, ax + 1)

    def project_back_b(v, t_axis):
        """P_bᵀ along face axis t; v [M, K, ...]."""
        mats = hp[bits[:, t_axis]]
        ax = v.ndim - 1 - t_axis
        out = torch.einsum("kba,mk...b->mk...a", mats,
                           torch.movedim(v, ax, -1))
        return torch.movedim(out, -1, ax)

    # ---------- coarse-side rows (batched over subfaces b) ---------------
    u_m_sub, du_m_sub = u_f[ce, cfc], dudr_f[ce, cfc]
    for t in range(dim - 1):
        u_m_sub = prolong_b(u_m_sub, t, batched=t > 0)
        du_m_sub = prolong_b(du_m_sub, t, batched=t > 0)
    u_m_q = _face_apply(Vq, u_m_sub, dim)  # [M, K, nfq...]
    du_m_q = _face_apply(Vq, du_m_sub, dim)  # [M, K, dim, nfq...]
    drst_m = mesh.hc_drst_m.to(dtype)  # [M, K, l, d, nfq...]
    dudx_m = torch.einsum("mkld...,mkl...->mkd...", drst_m, du_m_q)

    fe2, ff2 = mesh.hc_fine.long(), mesh.hc_fine_face.long()
    u_p_q = _face_apply(Vq, u_f[fe2, ff2], dim)
    du_p_q = _face_apply(Vq, dudr_f[fe2, ff2], dim)
    drst_p = mesh.face_drst[fe2, ff2].to(dtype)
    dudx_p = torch.einsum("mkld...,mkl...->mkd...", drst_p, du_p_q)

    sj = mesh.hc_sj.to(dtype)  # [M, K, nfq...]
    n = mesh.hc_n.to(dtype)  # [M, K, d, nfq...]
    jump = u_m_q - u_p_q
    term1 = -torch.einsum("mkd...,mkd...->mk...", n,
                          0.5 * (dudx_m + dudx_p)) * sj
    drst_n = torch.einsum("mkld...,mkd...->mkl...", drst_m, n)
    term2 = -0.5 * drst_n * (sj * jump)[:, :, None]
    term3 = sj * mesh.hc_sigma.to(dtype).reshape((M, K) + ones) * jump

    vt13 = _face_apply(Vq.T, wf * (term1 + term3), dim)
    vt2 = _face_apply(Vq.T, wf * term2, dim)
    # mass-project subface residuals back to the coarse face: Σ_b P_bᵀ
    for t in range(dim - 1):
        vt13 = project_back_b(vt13, t)
        vt2 = project_back_b(vt2, t)
    Au = _lift_rows(ce, cfc, vt13.sum(dim=1), vt2.sum(dim=1), E, deg, dim,
                    dtype)

    # ---------- fine-side rows -------------------------------------------
    fe = fe2.reshape(-1)  # [Mf]
    ff = ff2.reshape(-1)
    Mf = fe.shape[0]
    b_idx = torch.arange(K, device=dev).repeat(M)
    ce_rep = ce.repeat_interleave(K)
    cf_rep = cfc.repeat_interleave(K)

    drst_m = mesh.face_drst[fe, ff].to(dtype)  # [Mf, l, d, nfq...]
    sj = mesh.face_sj[fe, ff].to(dtype)
    n = mesh.face_n[fe, ff].to(dtype)
    u_m_q = _face_apply(Vq, u_f[fe, ff], dim)
    du_m_q = _face_apply(Vq, dudr_f[fe, ff], dim)
    dudx_m = torch.einsum("mld...,ml...->md...", drst_m, du_m_q)

    # the coarse neighbor's trace prolonged onto my subface
    u_p, du_p = u_f[ce_rep, cf_rep], dudr_f[ce_rep, cf_rep]
    for t in range(dim - 1):
        mats = hp[(b_idx >> t) & 1]  # [Mf, nl, nl]
        u_p = _row_mat_apply(mats, u_p, t)
        du_p = _row_mat_apply(mats, du_p, t)
    # the coarse element's drst at my quadrature points
    drst_p = mesh.hc_drst_m.to(dtype).reshape(drst_m.shape)
    u_p_q = _face_apply(Vq, u_p, dim)
    du_p_q = _face_apply(Vq, du_p, dim)
    dudx_p = torch.einsum("mld...,ml...->md...", drst_p, du_p_q)

    jump = u_m_q - u_p_q
    term1 = -torch.einsum("md...,md...->m...", n,
                          0.5 * (dudx_m + dudx_p)) * sj
    drst_n = torch.einsum("mld...,md...->ml...", drst_m, n)
    term2 = -0.5 * drst_n * (sj * jump)[:, None]
    term3 = sj * mesh.hc_sigma.to(dtype).reshape((Mf,) + ones) * jump

    vt13f = _face_apply(Vq.T, wf * (term1 + term3), dim)
    vt2f = _face_apply(Vq.T, wf * term2, dim)
    return Au + _lift_rows(fe, ff, vt13f, vt2f, E, deg, dim, dtype)
