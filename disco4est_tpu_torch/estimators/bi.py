"""A-posteriori error estimator η² per element ("bi" estimator).

Port of `disco4est_tpu/estimators/bi.py` (role of the reference's
`Estimators/d4est_estimator_bi.c:350-602`):

  η²(e) = (h_vol/p)² ‖R‖²_{L2(e)}                       (volume residual)
        + Σ_faces ∫ Je1² sj                             (∇u jump)
        + Σ_faces Σ_d ∫ Je2_d² sj                       (u jump)

with Je1 = c_∇·n·(∇u⁻−∇u⁺), Je2_d = c_u·n_d(u⁻−u⁺) (boundary: u−g),
prefactors from the Houston library (`d4est_estimator_bi.h:25-200`).
R is the nodal residual Au−rhs, measured through the mass matrix exactly
as `d4est_mesh_compute_l2_norm_sqr` does.  Conforming and boundary faces
run as one batch over [E, 2d], the hanging mortars as one batch per
subface, added into both sides' elements in a fixed order.  The other
side's data reach each face through the builder's node permutations
(`perm_l`, `perm_q` for conforming faces, `hc_perm_*` for the mortars), so
faces across reoriented trees line up point by point.
"""

from __future__ import annotations

import numpy as np
import torch

from disco4est_tpu_torch.laplacian import sipg as _sipg
from disco4est_tpu_torch.mesh.builder import MeshData
from disco4est_tpu_torch.ops import tensor
from disco4est_tpu_torch.ops.operators import DB
from disco4est_tpu_torch.ops.rows import add_face_rows

# elements per chunk of the pairwise-distance volume h (bounds the
# [chunk, dim, n, n] temporary)
_DIAM_CHUNK_ENTRIES = 1 << 25


def _prefactors(mesh: MeshData, penalty_prefactor: float):
    """(c_gradu², c_u², c_u_dirichlet²) per directed face [E, 2d], the
    Houston flavor the driver uses (`houston_gradu_prefactor_maxp_minh`
    etc.; the JAX module's one called flavor):
      c_∇² = ½·min(h)/max(p);  c_u² = ½·pf·max(p)²/min(h);
      boundary c_u² without the ½.
    """
    h_m = mesh.face_h
    nbr_e = mesh.nbr_elem.long()
    h_p = h_m[nbr_e, mesh.nbr_face.long()]
    min_h = torch.minimum(h_m, h_p)
    p_e = mesh.deg_e.to(h_m.dtype)
    p_m = p_e[:, None].expand(h_m.shape)
    p = torch.maximum(p_m, p_e[nbr_e])  # max(p⁻, p⁺); boundary: nbr = self
    c_grad2 = 0.5 * min_h / p
    c_u2 = 0.5 * penalty_prefactor * p * p / min_h
    c_u2_dirichlet = penalty_prefactor * p_m * p_m / h_m
    return c_grad2, c_u2, c_u2_dirichlet


def _volume_h(mesh: MeshData, vol_h: str):
    """h_vol per element: the largest distance between two Lobatto nodes
    (VOL_H_EQ_DIAM), divided by sqrt(dim) for VOL_H_EQ_CUBE_APPROX
    (`d4est_mesh_data_compute_volume_diam`)."""
    E, dim = mesh.n_elements, mesh.dim
    xs = mesh.xyz_lobatto.reshape(E, dim, -1)
    n = xs.shape[-1]
    step = max(1, _DIAM_CHUNK_ENTRIES // (dim * n * n))
    d2 = torch.cat([
        torch.sum((c[:, :, :, None] - c[:, :, None, :]) ** 2, dim=1)
        .amax(dim=(1, 2))
        for c in torch.split(xs, step)
    ])
    diam = torch.sqrt(d2)
    return diam if vol_h == "diam" else diam / np.sqrt(dim)


def _estimate_bi_impl(mesh: MeshData, u, residual, g, pf, vol_h):
    dim, deg = mesh.dim, mesh.deg
    E = u.shape[0]
    F = 2 * dim
    dtype, dev = u.dtype, u.device
    K = 1 << (dim - 1)
    ones = (1,) * (dim - 1)

    # ---- volume term ---------------------------------------------------
    p_e = mesh.deg_e.to(dtype)
    eta2 = (_volume_h(mesh, vol_h) / p_e) ** 2 * mesh.l2_norm_sqr(residual)

    # ---- face terms (conforming + boundary, fused) ---------------------
    D = torch.as_tensor(DB.ops(deg).diff, dtype=dtype, device=dev)
    Vq, wf = _sipg._face_quad_ops(mesh, dtype, dev)

    dudr = [tensor.apply_axis(D, u, l) for l in range(dim)]
    u_f = _sipg._face_slices(u, dim)  # [E, 2d, nfl...]
    dudr_f = torch.stack([_sipg._face_slices(dudr[l], dim)
                          for l in range(dim)], dim=2)
    drst_m = mesh.face_drst.to(dtype)

    fshape_l = u_f.shape[2:]
    fshape_q = drst_m.shape[4:]

    def gather(a, perm, fshape):
        """The neighbor's face data in my frame: [E, 2d, C..., fshape]."""
        lead = a.shape[:-len(fshape)]
        flat = a.reshape(lead + (-1,))
        return _sipg._gather_nd(flat, mesh.nbr_elem, mesh.nbr_face,
                                perm).reshape(a.shape)

    u_m_q = _sipg._face_apply(Vq, u_f, dim)
    u_p_q = _sipg._face_apply(Vq, gather(u_f, mesh.perm_l, fshape_l), dim)
    du_m_q = _sipg._face_apply(Vq, dudr_f, dim)
    du_p_q = _sipg._face_apply(
        Vq, gather(dudr_f, mesh.perm_l, fshape_l), dim)
    dudx_m = torch.einsum("efld...,efl...->efd...", drst_m, du_m_q)
    dudx_p = torch.einsum("efld...,efl...->efd...",
                          gather(drst_m, mesh.perm_q, fshape_q), du_p_q)

    bnd = mesh.bnd_mask
    bshape = bnd.shape + ones
    bnd_b = bnd.reshape(bshape)
    if g is None:
        g_q = torch.zeros_like(u_m_q)
    else:
        g_q = _sipg._face_apply(Vq, g.to(dtype), dim)
    u_p_q = torch.where(bnd_b, g_q, u_p_q)
    dudx_p = torch.where(bnd_b[:, :, None], dudx_m, dudx_p)

    c_grad2, c_u2, c_u2_d = _prefactors(mesh, pf)
    c_u2 = torch.where(bnd, c_u2_d, c_u2)

    jump_u = u_m_q - u_p_q
    jump_du = torch.einsum("efd...,efd...->ef...", mesh.face_n.to(dtype),
                           dudx_m - dudx_p)

    # boundary faces contribute no gradient-jump term
    # (`d4est_estimator_bi_dirichlet` computes Je2 only)
    cmask = mesh.conf_mask.reshape(bshape).to(dtype)
    grad_mask = (mesh.conf_mask & ~bnd).reshape(bshape).to(dtype)
    Je1_2 = c_grad2.to(dtype).reshape(bshape) * jump_du**2 * grad_mask
    # Σ_d (n_d jump_u)² = jump_u² (unit normal)
    Je2_2 = c_u2.to(dtype).reshape(bshape) * jump_u**2 * cmask
    sj = mesh.face_sj.to(dtype)
    eta2 = eta2 + torch.sum((wf * sj * (Je1_2 + Je2_2)).reshape(E, -1),
                            dim=1)

    # ---- hanging mortar contributions ----------------------------------
    M = mesh.hc_elem.shape[0]
    if M == 0:
        return eta2
    hp = torch.as_tensor(
        np.stack([DB.hp_prolong(deg, deg, c) for c in (0, 1)]),
        dtype=dtype, device=dev,
    )
    ce, cfc = mesh.hc_elem.long(), mesh.hc_face.long()
    uc, duc = u_f[ce, cfc], dudr_f[ce, cfc]
    h_c = mesh.face_h[ce, cfc]
    contribs = []  # per subface b: [M]
    for b in range(K):
        u_m_sub, du_m_sub = uc, duc
        for t in range(dim - 1):
            mat = hp[(b >> t) & 1]
            u_m_sub = tensor.apply_axis(mat, u_m_sub, t)
            du_m_sub = tensor.apply_axis(mat, du_m_sub, t)
        u_mq = _sipg._face_apply(Vq, u_m_sub, dim)
        du_mq = _sipg._face_apply(Vq, du_m_sub, dim)
        dudxm = torch.einsum("mld...,ml...->md...",
                             mesh.hc_drst_m[:, b].to(dtype), du_mq)

        # the fine side's data, permuted into the coarse frame
        fe, ff = mesh.hc_fine[:, b].long(), mesh.hc_fine_face[:, b].long()
        pl, pq = mesh.hc_perm_l[:, b], mesh.hc_perm_q[:, b]  # [M, n_flat]
        uf = torch.gather(u_f[fe, ff].reshape(M, -1), -1, pl)
        duf = torch.gather(dudr_f[fe, ff].reshape(M, dim, -1), -1,
                           pl[:, None].expand(M, dim, pl.shape[-1]))
        drstp = torch.gather(
            drst_m[fe, ff].reshape(M, dim, dim, -1), -1,
            pq[:, None, None].expand(M, dim, dim, pq.shape[-1]))
        u_pq = _sipg._face_apply(Vq, uf.reshape(uc.shape), dim)
        du_pq = _sipg._face_apply(Vq, duf.reshape(duc.shape), dim)
        dudxp = torch.einsum("mld...,ml...->md...",
                             drstp.reshape(drst_m[fe, ff].shape), du_pq)

        min_h = torch.minimum(h_c, mesh.face_h[fe, ff])
        p = torch.maximum(p_e[ce], p_e[fe])  # max(p⁻, p⁺) per mortar row
        cg2 = (0.5 * min_h / p).to(dtype).reshape((M,) + ones)
        cu2 = (0.5 * pf * p * p / min_h).to(dtype).reshape((M,) + ones)

        ju = u_mq - u_pq
        jdu = torch.einsum("md...,md...->m...", mesh.hc_n[:, b].to(dtype),
                           dudxm - dudxp)
        contrib = torch.sum(
            (wf * mesh.hc_sj[:, b].to(dtype)
             * (cg2 * jdu**2 + cu2 * ju**2)).reshape(M, -1),
            dim=1,
        )
        contribs.append(contrib)
    # both sides accumulate the same mortar integral, each element's rows
    # in the fixed order of their faces (`ops/rows.py`, ROADMAP C10)
    contrib = torch.stack(contribs, dim=1)  # [M, K]
    eta2 = add_face_rows(eta2, contrib.sum(1), ce, cfc, F)
    return add_face_rows(eta2, contrib.reshape(-1), mesh.hc_fine.reshape(-1),
                         mesh.hc_fine_face.reshape(-1), F)


def estimate_bi(mesh: MeshData, u, residual, g=None, penalty_prefactor=2.0,
                vol_h="cube_approx"):
    """η² per element [E].  `residual` = Au − rhs (nodal).
    `vol_h`: volume-h option for the residual term ("cube_approx" or
    "diam", `Mesh/d4est_mesh.h:31-49` VOL_H_EQ_*)."""
    if vol_h not in ("cube_approx", "diam"):
        raise ValueError(f"unknown vol_h {vol_h!r}")
    return _estimate_bi_impl(mesh, u, residual, g, penalty_prefactor, vol_h)
