"""The halo-exchange SIPG apply: one all-to-all of halo volume values.

Port of `disco4est_tpu/parallel/halo.py` (the scalable path of the JAX
package, replacing the reference's `Mesh/d4est_ghost_data.c`
Isend/Irecv halo):

- elements are block-partitioned in SFC order over the ranks;
- a per-epoch `HaloProgram` (host numpy index tables, equal to the JAX
  package's entry by entry; float tables as torch on the mesh's device)
  holds, per rank: which local elements go to which peer (`send_idx`),
  where received elements land in the halo buffer (`recv_pos`), the
  neighbor table in local + halo numbering, the halo elements' static
  face factors and the rank's hanging-mortar rows (`_hanging_passes`);
- at apply time each rank packs its halo elements' volume values
  (`halo_pack`), exchanges them with one all-to-all (`comm.exchange`),
  recomputes their face traces and runs the face terms (`halo_compute`).

The three phases are separate functions so that tests can drive n ranks
in lockstep in one process.  Conforming, boundary and hanging faces,
Robin data, the pointwise penalty (`sigma_q`) and the compactified radial
rule (the volume term is `laplacian/sipg.py`'s) are covered.

JAX lets pad rows of the mortar tables index the trash slot B+H and
relies on jit scatter dropping their out-of-range writes (`halo.py:53-57`);
torch raises or writes through, so here the trash slot is a real row: it
reads zero (the halo buffer's trash row is cleared after the exchange),
takes the pad rows' writes, and is cut away.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from disco4est_tpu_torch.laplacian.sipg import (
    _face_apply,
    _face_scatter_dynamic,
    _face_slices,
    _gather_nd,
    _general_ops,
    _lift_faces,
    _mortar_ops,
    _row_mat_apply,
    _volume_stiffness,
)
from disco4est_tpu_torch.mesh.builder import MeshData
from disco4est_tpu_torch.ops import tensor

_HANG_INT = ("hco_elem", "hco_face", "hco_fine", "hco_fine_face",
             "hco_perm_l", "hco_perm_q", "hfi_elem", "hfi_face", "hfi_bbit",
             "hfi_coarse", "hfi_cface", "hfi_perm_l", "hfi_perm_q")
_HANG_FLOAT = ("hco_sj", "hco_n", "hco_drst_m", "hco_sigma", "hfi_drst_p",
               "hfi_sigma")
HANG_FIELDS = _HANG_INT + _HANG_FLOAT


@dataclasses.dataclass
class HaloProgram:
    """The tables of every rank (leading axis n): index tables host numpy,
    float tables torch.  `local(rank, device)` is one rank's part."""

    n_dev: int
    B: int  # elements per rank
    H: int  # halo slots (max over ranks; slot H is the trash slot)
    K: int  # max elements exchanged per (src, dst) pair
    send_idx: np.ndarray  # [n, n, K] local element ids to send (pad 0)
    recv_pos: np.ndarray  # [n, n, K] halo slot of each received element
    nbr_local: np.ndarray  # [n, B, 2d] neighbor ids in [0, B+H+1)
    halo_face_drst: torch.Tensor  # [n, H+1, 2d, d, d, nfq...]
    # hanging-mortar rows per rank, padded (pad rows index the trash slot
    # B+H); {} without hanging faces
    Mc: int = 0
    Mf: int = 0
    hang: dict = dataclasses.field(default_factory=dict)

    def local(self, rank: int, device=None) -> "LocalHalo":
        dev = device if device is not None else self.halo_face_drst.device
        idx = lambda a: torch.as_tensor(np.asarray(a[rank], np.int64),  # noqa
                                        device=dev)
        hang = {k: (idx(v) if k in _HANG_INT else v[rank].to(dev))
                for k, v in self.hang.items()}
        return LocalHalo(
            n_dev=self.n_dev, B=self.B, H=self.H, K=self.K, Mc=self.Mc,
            Mf=self.Mf, send_idx=idx(self.send_idx),
            recv_pos=idx(self.recv_pos), nbr_local=idx(self.nbr_local),
            halo_face_drst=self.halo_face_drst[rank].to(dev), hang=hang)


@dataclasses.dataclass
class LocalHalo:
    """One rank's halo tables, torch on the rank's device."""

    n_dev: int
    B: int
    H: int
    K: int
    Mc: int
    Mf: int
    send_idx: torch.Tensor  # [n, K]
    recv_pos: torch.Tensor  # [n, K]
    nbr_local: torch.Tensor  # [B, 2d]
    halo_face_drst: torch.Tensor  # [H+1, 2d, d, d, nfq...]
    hang: dict

    def astype(self, dtype) -> "LocalHalo":
        """The float tables cast to `dtype` (the mixed solve's f32 copy)."""
        return dataclasses.replace(
            self, halo_face_drst=self.halo_face_drst.to(dtype),
            hang={k: (v.to(dtype) if v.is_floating_point() else v)
                  for k, v in self.hang.items()})


def _host(t):
    return t.cpu().numpy()


def build_halo_program(mesh: MeshData, n_dev: int) -> HaloProgram:
    """The per-epoch halo exchange and local work tables of a block SFC
    partition of `mesh` (padded to n_dev·B rows), covering conforming,
    boundary and hanging faces (JAX `build_halo_program`).

    The coarse row of a hanging mortar runs on the rank owning the coarse
    element; each fine row (m, b) on the rank owning that fine element
    (each scatters only into its own element).  Their remote partners join
    the halo element set, so the one volume-value exchange covers them
    (the role of the reference's ghost exchange on adapted meshes,
    `Mesh/d4est_ghost_data.c:143-246`)."""
    E = mesh.n_elements
    assert E % n_dev == 0, (E, n_dev)
    B = E // n_dev
    nbr = _host(mesh.nbr_elem).astype(np.int64)  # [E, 2d]
    nfaces = nbr.shape[1]
    dim = mesh.dim
    K2 = 1 << (dim - 1)
    M_g = int(mesh.hc_elem.shape[0])
    hc_elem_g = _host(mesh.hc_elem).astype(np.int64)
    hc_face_g = _host(mesh.hc_face).astype(np.int64)
    hc_fine_g = _host(mesh.hc_fine).astype(np.int64).reshape(M_g, K2)
    hc_fine_face_g = _host(mesh.hc_fine_face).astype(np.int64).reshape(
        M_g, K2)
    own_c, own_f = hc_elem_g // B, hc_fine_g // B

    ext_sets = []
    for s in range(n_dev):
        lo, hi = s * B, (s + 1) * B
        blk = nbr[lo:hi]
        mc = own_c == s
        mf = (own_f == s).any(axis=1) & ~mc
        remote = np.concatenate([
            blk[(blk < lo) | (blk >= hi)],
            hc_fine_g[mc][own_f[mc] != s],
            hc_elem_g[mf],
        ])
        ext_sets.append(np.unique(remote))
    H = max((len(x) for x in ext_sets), default=0)

    # (src, dst) -> the elements of dst's halo set that src owns, in the
    # halo set's (ascending) order
    pairs = {}
    for dst, ext in enumerate(ext_sets):
        owner = ext // B
        for src in np.unique(owner):
            pairs[(int(src), dst)] = np.where(owner == src)[0]
    K = max([len(v) for v in pairs.values()] + [1])
    send_idx = np.zeros((n_dev, n_dev, K), np.int32)
    recv_pos = np.full((n_dev, n_dev, K), H, np.int32)  # pad -> trash slot
    for (src, dst), pos in pairs.items():
        send_idx[src, dst, :len(pos)] = ext_sets[dst][pos] - src * B
        recv_pos[dst, src, :len(pos)] = pos

    def loc(s, g):
        """global padded ids -> rank s's local (< B) or B + halo slot."""
        g = np.asarray(g, np.int64)
        own = (g >= s * B) & (g < (s + 1) * B)
        return np.where(own, g - s * B,
                        B + np.searchsorted(ext_sets[s], np.where(own, 0, g)))

    nbr_local = np.stack([loc(s, nbr[s * B:(s + 1) * B])
                          for s in range(n_dev)]).astype(np.int32)

    # static face factors of the halo elements (drst, for ∇u⁺)
    fd = mesh.face_drst
    halo_fd = fd.new_zeros((n_dev, H + 1) + tuple(fd.shape[1:]))
    for s, ext in enumerate(ext_sets):
        halo_fd[s, :len(ext)] = fd[torch.as_tensor(ext, device=fd.device)]

    hang, Mc, Mf = {}, 0, 0
    if M_g > 0:
        TRASH = B + H
        co_rows = [np.where(own_c == s)[0] for s in range(n_dev)]
        fi_rows = [np.where(own_f.reshape(-1) == s)[0] for s in range(n_dev)]
        Mc = max(max(len(r) for r in co_rows), 1)
        Mf = max(max(len(r) for r in fi_rows), 1)
        nq = mesh.nq
        nfl_flat = mesh.nl ** (dim - 1)
        nfq_flat = nq ** (dim - 1)
        fq = (nq,) * (dim - 1)
        hc_perm_l_g = _host(mesh.hc_perm_l)
        hc_perm_q_g = _host(mesh.hc_perm_q)
        hc_drst_g = _host(mesh.hc_drst_m)
        hf_perm_l_g = _host(mesh.hf_perm_l).reshape(M_g, K2, -1)
        hf_perm_q_g = _host(mesh.hf_perm_q).reshape(M_g, K2, -1)
        # σ broadcast-ready against [.., nfq...] face arrays: a scalar
        # penalty gets trailing 1s; the pointwise one (j_div_sj_quad) its
        # per-point tables, the fine side permuted into each fine frame
        if mesh.hc_sigma_q is not None:
            sig_shape = fq
            hc_sig_g = _host(mesh.hc_sigma_q)
            hf_sig_g = np.take_along_axis(
                hc_sig_g.reshape(M_g * K2, nfq_flat),
                hf_perm_q_g.reshape(M_g * K2, nfq_flat), axis=-1,
            ).reshape((M_g, K2) + fq)
        else:
            sig_shape = (1,) * (dim - 1)
            hc_sig_g = _host(mesh.hc_sigma).reshape((M_g, K2) + sig_shape)
            hf_sig_g = hc_sig_g

        t = dict(
            hco_elem=np.full((n_dev, Mc), TRASH, np.int32),
            hco_face=np.zeros((n_dev, Mc), np.int32),
            hco_fine=np.full((n_dev, Mc, K2), TRASH, np.int32),
            hco_fine_face=np.zeros((n_dev, Mc, K2), np.int32),
            hco_perm_l=np.zeros((n_dev, Mc, K2, nfl_flat), np.int32),
            hco_perm_q=np.zeros((n_dev, Mc, K2, nfq_flat), np.int32),
            hco_sj=np.zeros((n_dev, Mc, K2) + fq),
            hco_n=np.zeros((n_dev, Mc, K2, dim) + fq),
            hco_drst_m=np.zeros((n_dev, Mc, K2, dim, dim) + fq),
            hco_sigma=np.zeros((n_dev, Mc, K2) + sig_shape),
            hfi_elem=np.full((n_dev, Mf), TRASH, np.int32),
            hfi_face=np.zeros((n_dev, Mf), np.int32),
            hfi_bbit=np.zeros((n_dev, Mf, max(dim - 1, 1)), np.int32),
            hfi_coarse=np.full((n_dev, Mf), TRASH, np.int32),
            hfi_cface=np.zeros((n_dev, Mf), np.int32),
            hfi_perm_l=np.zeros((n_dev, Mf, nfl_flat), np.int32),
            hfi_perm_q=np.zeros((n_dev, Mf, nfq_flat), np.int32),
            hfi_drst_p=np.zeros((n_dev, Mf, dim, dim) + fq),
            hfi_sigma=np.zeros((n_dev, Mf) + sig_shape),
        )
        hc_sj_g, hc_n_g = _host(mesh.hc_sj), _host(mesh.hc_n)
        for s in range(n_dev):
            m = co_rows[s]
            i = slice(0, len(m))
            t["hco_elem"][s, i] = loc(s, hc_elem_g[m])
            t["hco_face"][s, i] = hc_face_g[m]
            t["hco_fine"][s, i] = loc(s, hc_fine_g[m])
            t["hco_fine_face"][s, i] = hc_fine_face_g[m]
            t["hco_perm_l"][s, i] = hc_perm_l_g[m]
            t["hco_perm_q"][s, i] = hc_perm_q_g[m]
            t["hco_sj"][s, i] = hc_sj_g[m]
            t["hco_n"][s, i] = hc_n_g[m]
            t["hco_drst_m"][s, i] = hc_drst_g[m]
            t["hco_sigma"][s, i] = hc_sig_g[m]
            m, b = np.divmod(fi_rows[s], K2)
            i = slice(0, len(m))
            t["hfi_elem"][s, i] = loc(s, hc_fine_g[m, b])
            t["hfi_face"][s, i] = hc_fine_face_g[m, b]
            for ax in range(dim - 1):
                t["hfi_bbit"][s, i, ax] = (b >> ax) & 1
            t["hfi_coarse"][s, i] = loc(s, hc_elem_g[m])
            t["hfi_cface"][s, i] = hc_face_g[m]
            t["hfi_perm_l"][s, i] = hf_perm_l_g[m, b]
            t["hfi_perm_q"][s, i] = hf_perm_q_g[m, b]
            t["hfi_drst_p"][s, i] = hc_drst_g[m, b]
            t["hfi_sigma"][s, i] = hf_sig_g[m, b]
        dev = fd.device
        hang = {k: (v if k in _HANG_INT
                    else torch.as_tensor(v, dtype=fd.dtype, device=dev))
                for k, v in t.items()}

    return HaloProgram(n_dev=n_dev, B=B, H=H, K=K, send_idx=send_idx,
                       recv_pos=recv_pos, nbr_local=nbr_local,
                       halo_face_drst=halo_fd, Mc=Mc, Mf=Mf, hang=hang)


def halo_pack(halo: LocalHalo, u_l):
    """The send buffer [n, K, nl...] of the rank's field u_l [B, nl...]:
    block j holds the elements rank j needs."""
    return u_l[halo.send_idx.reshape(-1)].reshape(
        (halo.n_dev, halo.K) + tuple(u_l.shape[1:]))


def halo_compute(mesh: MeshData, halo: LocalHalo, u_l, recv,
                 robin_coeff=None):
    """Au on the rank's rows from its own field u_l [B, nl...] and the
    received halo blocks recv [n, K, nl...] (JAX `apply_sipg_halo`'s
    `body` after its all-to-all).  `mesh` is the rank's block
    (`sharding.shard_mesh_data`); `robin_coeff` [B, 2d, nfq...] replaces
    every boundary flux term by ∫ sj·c·u·v."""
    dim, deg = mesh.dim, mesh.deg
    nl, nq = deg + 1, mesh.nq
    dtype, dev = u_l.dtype, u_l.device
    nfaces = 2 * dim
    B, H = halo.B, halo.H
    Bx = B + H + 1
    nfl_flat, nfq_flat = nl ** (dim - 1), nq ** (dim - 1)
    fshape_l, fshape_q = (nl,) * (dim - 1), (nq,) * (dim - 1)
    ones = (1,) * (dim - 1)
    ops = _general_ops(deg, mesh.deg_quad, mesh.quad.kind, dim, dtype, dev)
    D, Vq, wf = ops["D"], ops["Vq"], ops["wf"]

    # ---- the received volume values into the halo buffer [H+1, nl...] ---
    vshape = tuple(u_l.shape[1:])
    halo_u = u_l.new_zeros((H + 1,) + vshape)
    halo_u.index_copy_(0, halo.recv_pos.reshape(-1),
                       recv.reshape((-1,) + vshape).to(dtype))
    halo_u[H] = 0  # the trash slot (pad blocks landed there) reads zero
    u_ext = torch.cat([u_l, halo_u])  # [B+H+1, nl...]

    # ---- volume stiffness (local) ---------------------------------------
    dudr_ext = [tensor.apply_axis(D, u_ext, l) for l in range(dim)]
    volume_mode = ("dense" if deg <= 4 and dim == 3 and mesh.rad_interp is None
                   else "tensor")
    Au = _volume_stiffness(mesh, u_l, [d[:B] for d in dudr_ext], ops,
                           volume_mode)

    # ---- face traces on the extended element set ------------------------
    u_f_ext = _face_slices(u_ext, dim)  # [Bx, 2d, nfl...]
    dudr_f_ext = torch.stack([_face_slices(dudr_ext[l], dim)
                              for l in range(dim)], dim=2)
    face_drst_ext = torch.cat([mesh.face_drst.to(dtype),
                               halo.halo_face_drst.to(dtype)])
    u_f, dudr_f = u_f_ext[:B], dudr_f_ext[:B]
    nb, nf = halo.nbr_local, mesh.nbr_face
    u_p = _gather_nd(u_f_ext.reshape(Bx, nfaces, 1, nfl_flat), nb, nf,
                     mesh.perm_l)[:, :, 0].reshape((B, nfaces) + fshape_l)
    dudr_p = _gather_nd(dudr_f_ext.reshape(Bx, nfaces, dim, nfl_flat), nb,
                        nf, mesh.perm_l).reshape((B, nfaces, dim) + fshape_l)
    drst_p = _gather_nd(face_drst_ext.reshape(Bx, nfaces, dim, dim,
                                              nfq_flat),
                        nb, nf, mesh.perm_q
                        ).reshape((B, nfaces, dim, dim) + fshape_q)

    u_m_q = _face_apply(Vq, u_f, dim)
    u_p_q = _face_apply(Vq, u_p, dim)
    du_m_q = _face_apply(Vq, dudr_f, dim)
    du_p_q = _face_apply(Vq, dudr_p, dim)
    drst_m = mesh.face_drst.to(dtype)
    n_m = mesh.face_n.to(dtype)
    sj = mesh.face_sj.to(dtype)
    dudx_m = (drst_m * du_m_q[:, :, :, None]).sum(2)  # [B, 2d, d, nfq...]
    dudx_p = (drst_p * du_p_q[:, :, :, None]).sum(2)

    bnd_b = mesh.bnd_mask.reshape((B, nfaces) + ones)
    u_p_q = torch.where(bnd_b, 0.0, u_p_q)
    dudx_p = torch.where(bnd_b[:, :, None], dudx_m, dudx_p)
    jump = u_m_q - u_p_q
    c2 = torch.where(bnd_b, 2.0, 1.0).to(dtype)
    term1 = -(n_m * (0.5 * (dudx_m + dudx_p))).sum(2) * sj
    drst_n = (drst_m * n_m[:, :, None]).sum(3)
    term2 = -0.5 * c2[:, :, None] * drst_n * (sj * jump)[:, :, None]
    sigma = (mesh.sigma_q if mesh.sigma_q is not None
             else mesh.sigma.reshape((B, nfaces) + ones))
    term3 = sj * sigma.to(dtype) * jump
    if robin_coeff is not None:
        # boundary faces are the rank's own: no exchange is involved
        term1 = torch.where(bnd_b, sj * robin_coeff.to(dtype) * u_m_q, term1)
        term2 = torch.where(bnd_b[:, :, None], 0.0, term2)
        term3 = torch.where(bnd_b, 0.0, term3)

    # hanging faces are the mortar passes' below
    cm = mesh.conf_mask.reshape((B, nfaces) + ones).to(dtype)
    vt1 = _face_apply(Vq.T, wf * (term1 + term3), dim) * cm
    vt2 = _face_apply(Vq.T, wf * term2, dim) * cm[:, :, None]
    Au = _lift_faces(Au, vt1, vt2, D, dim, nl)

    if halo.Mc > 0 or halo.Mf > 0:
        Au = Au + _hanging_passes(halo.hang, u_f_ext, dudr_f_ext,
                                  face_drst_ext, mesh.face_sj, mesh.face_n,
                                  Vq, wf, D, dtype, dim, nl, nq, B)
    return Au


def _hanging_passes(hang, u_f_ext, dudr_f_ext, face_drst_ext, face_sj,
                    face_n, Vq, wf, D, dtype, dim, nl, nq, B):
    """The rank's hanging-mortar contributions on the halo-extended face
    arrays (JAX `_hanging_passes`, the distributed twin of
    `laplacian/sipg._apply_hanging`).  Pad rows index the trash slot
    B+H, which reads zero; their zero rows land in the trash row of the
    [B+H+1]-row sum, which is cut away."""
    Bx = u_f_ext.shape[0]
    Mc = hang["hco_elem"].shape[0]
    Mf = hang["hfi_elem"].shape[0]
    K2 = 1 << (dim - 1)
    nfl_flat, nfq_flat = nl ** (dim - 1), nq ** (dim - 1)
    fshape_l, fshape_q = (nl,) * (dim - 1), (nq,) * (dim - 1)
    dev = u_f_ext.device
    hp = _mortar_ops(nl - 1, dim, dtype, dev)[0]  # [2, nl, nl]
    Au = u_f_ext.new_zeros((Bx,) + (nl,) * dim)
    f = lambda k: hang[k].to(dtype)  # noqa: E731

    # ---------- coarse-side rows -----------------------------------------
    ce, cfc = hang["hco_elem"], hang["hco_face"]
    uc, duc = u_f_ext[ce, cfc], dudr_f_ext[ce, cfc]
    acc13 = u_f_ext.new_zeros((Mc,) + fshape_l)
    acc2 = u_f_ext.new_zeros((Mc, dim) + fshape_l)
    for b in range(K2):
        bits = [(b >> t) & 1 for t in range(dim - 1)]
        u_m_sub, du_m_sub = uc, duc
        for t in range(dim - 1):
            u_m_sub = tensor.apply_axis(hp[bits[t]], u_m_sub, t)
            du_m_sub = tensor.apply_axis(hp[bits[t]], du_m_sub, t)
        u_m_q = _face_apply(Vq, u_m_sub, dim)
        du_m_q = _face_apply(Vq, du_m_sub, dim)
        drst_m = f("hco_drst_m")[:, b]
        dudx_m = (drst_m * du_m_q[:, :, None]).sum(1)

        fe, ff = hang["hco_fine"][:, b], hang["hco_fine_face"][:, b]
        pl = hang["hco_perm_l"][:, b]
        pq = hang["hco_perm_q"][:, b]
        uf = torch.gather(u_f_ext[fe, ff].reshape(Mc, nfl_flat), -1,
                          pl).reshape((Mc,) + fshape_l)
        duf = torch.gather(dudr_f_ext[fe, ff].reshape(Mc, dim, nfl_flat),
                           -1, pl[:, None].expand(Mc, dim, nfl_flat)
                           ).reshape((Mc, dim) + fshape_l)
        drst_p = torch.gather(
            face_drst_ext[fe, ff].to(dtype).reshape(Mc, dim, dim, nfq_flat),
            -1, pq[:, None, None].expand(Mc, dim, dim, nfq_flat),
        ).reshape((Mc, dim, dim) + fshape_q)
        u_p_q = _face_apply(Vq, uf, dim)
        du_p_q = _face_apply(Vq, duf, dim)
        dudx_p = (drst_p * du_p_q[:, :, None]).sum(1)

        sj, n = f("hco_sj")[:, b], f("hco_n")[:, b]
        sig = f("hco_sigma")[:, b]
        jump = u_m_q - u_p_q
        term1 = -(n * (0.5 * (dudx_m + dudx_p))).sum(1) * sj
        drst_n = (drst_m * n[:, None]).sum(2)
        term2 = -0.5 * drst_n * (sj * jump)[:, None]
        term3 = sj * sig * jump
        vt13 = _face_apply(Vq.T, wf * term1, dim) + _face_apply(
            Vq.T, wf * term3, dim)
        vt2 = _face_apply(Vq.T, wf * term2, dim)
        for t in range(dim - 1):
            vt13 = tensor.apply_axis(hp[bits[t]].T, vt13, t)
            vt2 = tensor.apply_axis(hp[bits[t]].T, vt2, t)
        acc13 = acc13 + vt13
        acc2 = acc2 + vt2

    Au = _face_scatter_dynamic(Au, ce, cfc, acc13, dim, nl)
    for l in range(dim):
        Au = _face_scatter_dynamic(Au, ce, cfc, acc2[:, l], dim, nl, D=D,
                                   term2_l=l)

    # ---------- fine-side rows -------------------------------------------
    fe, ff = hang["hfi_elem"], hang["hfi_face"]
    u_m, du_m = u_f_ext[fe, ff], dudr_f_ext[fe, ff]
    drst_m = face_drst_ext[fe, ff].to(dtype)
    fe_c = torch.clamp(fe, max=B - 1)  # pad rows: clamp the local reads
    sj = face_sj[fe_c, ff].to(dtype)
    n = face_n[fe_c, ff].to(dtype)
    sig = f("hfi_sigma")
    u_m_q = _face_apply(Vq, u_m, dim)
    du_m_q = _face_apply(Vq, du_m, dim)
    dudx_m = (drst_m * du_m_q[:, :, None]).sum(1)

    uc_rep = u_f_ext[hang["hfi_coarse"], hang["hfi_cface"]]
    duc_rep = dudr_f_ext[hang["hfi_coarse"], hang["hfi_cface"]]
    for t in range(dim - 1):
        mats = hp[hang["hfi_bbit"][:, t]]  # [Mf, nl, nl]
        uc_rep = _row_mat_apply(mats, uc_rep, t)
        duc_rep = _row_mat_apply(mats, duc_rep, t)
    pl, pq = hang["hfi_perm_l"], hang["hfi_perm_q"]
    u_p = torch.gather(uc_rep.reshape(Mf, nfl_flat), -1,
                       pl).reshape((Mf,) + fshape_l)
    du_p = torch.gather(duc_rep.reshape(Mf, dim, nfl_flat), -1,
                        pl[:, None].expand(Mf, dim, nfl_flat)
                        ).reshape((Mf, dim) + fshape_l)
    drst_p = torch.gather(
        f("hfi_drst_p").reshape(Mf, dim, dim, nfq_flat), -1,
        pq[:, None, None].expand(Mf, dim, dim, nfq_flat),
    ).reshape((Mf, dim, dim) + fshape_q)
    u_p_q = _face_apply(Vq, u_p, dim)
    du_p_q = _face_apply(Vq, du_p, dim)
    dudx_p = (drst_p * du_p_q[:, :, None]).sum(1)

    jump = u_m_q - u_p_q
    term1 = -(n * (0.5 * (dudx_m + dudx_p))).sum(1) * sj
    drst_n = (drst_m * n[:, None]).sum(2)
    term2 = -0.5 * drst_n * (sj * jump)[:, None]
    term3 = sj * sig * jump
    vt13 = _face_apply(Vq.T, wf * term1, dim) + _face_apply(
        Vq.T, wf * term3, dim)
    vt2 = _face_apply(Vq.T, wf * term2, dim)
    Au = _face_scatter_dynamic(Au, fe, ff, vt13, dim, nl)
    for l in range(dim):
        Au = _face_scatter_dynamic(Au, fe, ff, vt2[:, l], dim, nl, D=D,
                                   term2_l=l)
    return Au[:B]


def apply_sipg_halo(mesh: MeshData, halo: LocalHalo, u_l, comm,
                    robin_coeff=None):
    """The halo-exchange SIPG apply on the rank's rows: pack, one
    `comm.exchange`, compute (JAX `apply_sipg_halo`).  Equals
    `apply_sipg(mesh, u)` on the whole mesh up to float reassociation."""
    return halo_compute(mesh, halo, u_l, comm.exchange(halo_pack(halo, u_l)),
                        robin_coeff)


def apply_sipg_hp_halo(mesh: MeshData, halo: LocalHalo, u_own, comm):
    """The mixed-degree (hp) halo apply A_hp = Pᵀ A_max P (JAX
    `apply_sipg_hp_halo`): P is element-local, so the halo still exchanges
    storage-degree volume values only."""
    from disco4est_tpu_torch.laplacian.hp import adjoint_to_own, to_max

    return adjoint_to_own(mesh, apply_sipg_halo(mesh, halo,
                                                to_max(mesh, u_own), comm))
