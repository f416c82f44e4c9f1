"""Standalone DG (IP) energy norm via a face sweep.

Port of `disco4est_tpu/io/ip_energy_norm.py` (role of the reference's
`dGMath/d4est_ip_energy_norm.c:1-448`):

    ‖u‖²_IP = ∫ |∇u|² J dV                      (volume term :349)
            + Σ_interfaces ∫ σ [u]² sj          (interface term :254)
            + Σ_boundary   ∫ σ (u−g)² sj        (boundary term :89)

with σ the SIPG penalty read from the mesh's penalty tensors (sigma /
sigma_q / hc_sigma*), so the norm uses exactly the penalty function,
prefactor and h-mode the operator was built with.  Unlike the
quadratic-form shortcut eᵀAe, this is the literal face-sweep definition
with the per-term breakdown the reference prints.

Torch operations on the mesh's device (the JAX module is plain XLA; no
kernel).  Each term is a plain reduction of a whole tensor in a fixed
order, so two runs on one device give the same digits.
"""

from __future__ import annotations

import torch

from disco4est_tpu_torch.laplacian import sipg as _sipg
from disco4est_tpu_torch.mesh.builder import MeshData, vol_interp
from disco4est_tpu_torch.ops import tensor
from disco4est_tpu_torch.ops.operators import DB


def ip_energy_norm_sqr(mesh: MeshData, u, g=None) -> dict:
    """Returns dict(total, volume, interface, boundary) of ‖u‖²_IP as 0-d
    tensors.  `g`: optional Dirichlet data [E, 2d, nfl...] for the
    boundary term (None compares against zero)."""
    dim, deg, deg_quad = mesh.dim, mesh.deg, mesh.deg_quad
    nl = deg + 1
    E = u.shape[0]
    kw = dict(dtype=u.dtype, device=u.device)
    nfaces = 2 * dim

    D = torch.as_tensor(DB.ops(deg).diff, **kw)
    Vq = torch.as_tensor(mesh.quad.interp(deg, deg_quad), **kw)
    _, wq1 = mesh.quad.nodes_weights(deg_quad)
    wf = tensor.tensor_weights([wq1] * (dim - 1), **kw)

    # ---- volume: Σ_l,l' ∫ (∂u/∂r_l)(∂u/∂r_l') wjgg[l,l'] ---------------
    t = [vol_interp(mesh, tensor.apply_axis(D, u, l)) for l in range(dim)]
    vol = torch.zeros((), **kw)
    if mesh.wjgg_c is not None:
        w3 = tensor.tensor_weights([wq1] * dim, **kw)
        cshape = (E,) + (1,) * dim
        for l in range(dim):
            for lp in range(dim):
                c = mesh.wjgg_c[:, l, lp].to(u.dtype).reshape(cshape)
                vol = vol + torch.sum(c * w3 * t[l] * t[lp])
    else:
        for l in range(dim):
            for lp in range(dim):
                vol = vol + torch.sum(
                    mesh.wjgg[:, l, lp].to(u.dtype) * t[l] * t[lp])

    # ---- conforming and boundary faces ----------------------------------
    nfl_flat = nl ** (dim - 1)
    fshape_l = (nl,) * (dim - 1)
    u_f = _sipg._face_slices(u, dim)
    u_p = _sipg._gather_nd(
        u_f.reshape(E, nfaces, nfl_flat)[:, :, None],
        mesh.nbr_elem, mesh.nbr_face, mesh.perm_l,
    )[:, :, 0].reshape((E, nfaces) + fshape_l)
    u_p = _sipg._apply_orient_codes(u_p, mesh.orient_code, mesh.orient_codes,
                                    dim)
    u_m_q = _sipg._face_apply(Vq, u_f, dim)
    u_p_q = _sipg._face_apply(Vq, u_p, dim)

    bnd = mesh.bnd_mask
    bshape = bnd.shape + (1,) * (dim - 1)
    bnd_b = bnd.reshape(bshape)
    g_q = (torch.zeros_like(u_m_q) if g is None
           else _sipg._face_apply(Vq, g.to(u.dtype), dim))
    u_p_q = torch.where(bnd_b, g_q, u_p_q)
    jump2 = (u_m_q - u_p_q) ** 2

    sj = (mesh.face_sj_c.to(u.dtype).reshape(bshape)
          if mesh.face_sj_c is not None else mesh.face_sj.to(u.dtype))
    sig = (mesh.sigma_q.to(u.dtype) if mesh.sigma_q is not None
           else mesh.sigma.to(u.dtype).reshape(bshape))

    integrand = wf * sj * sig * jump2
    conf_int = (mesh.conf_mask & ~bnd).reshape(bshape)
    # each interior face is visited from BOTH sides: halve
    interface = 0.5 * torch.sum(torch.where(conf_int, integrand, 0.0))
    boundary = torch.sum(torch.where(bnd_b, integrand, 0.0))

    # ---- hanging mortars (coarse rows, once per mortar) ----------------
    M = mesh.hc_elem.shape[0]
    if M > 0:
        K = 1 << (dim - 1)
        hp = [torch.as_tensor(DB.hp_prolong(deg, deg, c), **kw)
              for c in (0, 1)]
        uc = u_f[mesh.hc_elem.long(), mesh.hc_face.long()]
        for b in range(K):
            u_sub = uc
            for t_ in range(dim - 1):
                u_sub = tensor.apply_axis(hp[(b >> t_) & 1], u_sub, t_)
            u_mq = _sipg._face_apply(Vq, u_sub, dim)
            fe = mesh.hc_fine[:, b].long()
            ff = mesh.hc_fine_face[:, b].long()
            uf = torch.gather(u_f[fe, ff].reshape(M, nfl_flat), -1,
                              mesh.hc_perm_l[:, b].long()
                              ).reshape((M,) + fshape_l)
            u_pq = _sipg._face_apply(Vq, uf, dim)
            sjm = mesh.hc_sj[:, b].to(u.dtype)
            sgm = (mesh.hc_sigma_q[:, b].to(u.dtype)
                   if mesh.hc_sigma_q is not None
                   else mesh.hc_sigma[:, b].to(u.dtype).reshape(
                       (M,) + (1,) * (dim - 1)))
            interface = interface + torch.sum(
                wf * sjm * sgm * (u_mq - u_pq) ** 2)

    return {
        "volume": vol,
        "interface": interface,
        "boundary": boundary,
        "total": vol + interface + boundary,
    }
