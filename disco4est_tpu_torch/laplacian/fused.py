"""Fused SIPG apply for conforming orthogonal affine meshes, any element
order.

Port of `disco4est_tpu/laplacian/pallas_sipg.py`.  The apply runs in two
phases, like the reference's stiffness → ghost-exchange → flux sequence:

    phase A (torch.matmul):  tr = scale(u @ W_tr)        [E·2d face rows]
    phase B (one kernel):    Au = cw ⊙ (u @ W_vol) + Z(tr_own, tr[nbr_row]) @ W_lift

The face-mass matrix is folded into the lift rows, and lanes are laid out
per directed face as [t13 (nfl) | s2n (nfl)], so the face terms Z form a
flat [E, 2d·2·nfl] tile with per-face scalars.

Two versions of phase B, one function:

- `fused_apply_cuda`: the hand-written Hopper kernel
  (`csrc/fused_apply.cu`, replacing the Pallas kernel `_kernel`), for CUDA
  tensors.  It reads the element's own traces from phase A (the TPU kernel
  recomputed them in VMEM) and the neighbor's at row
  `nbr_row = nbr_elem·2d + nbr_face` inside the kernel, so the gathered
  array never exists in device memory.
- `fused_apply_plain`: the same arithmetic in plain torch ops.

`apply_fused` takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.  Only IEEE f32 is ported: the
bf16 mode of `apply_sipg_pallas` is ROADMAP B4.  The host tables here
(`_mats`, the per-face scalars, the plain fused pass) are shared with the
structured apply (`laplacian/structured.py`, `csrc/structured_apply.cu`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from disco4est_tpu_torch.laplacian import fast as F
from disco4est_tpu_torch.mesh.builder import MeshData
from disco4est_tpu_torch.util.cuda_build import check_operand, load_library

F32 = torch.float32
SOURCE = "fused_apply.cu"

# Launch counter of the CUDA kernel: the wrapper adds one each time it
# launches the kernel, so a run can show that it went through it.
KERNEL_LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _mats(deg: int, deg_quad: int, quad_key, dim: int, iso: bool):
    """Host-side f64 fixed matrices in the fused lane layout."""
    bm = F._base_mats(deg, deg_quad, quad_key, dim)
    Mt, Kt = bm["Mt"], bm["Kt"]
    kron_dirs = bm["kron_dirs"]
    nfaces, nv, nfl = bm["nfaces"], bm["nv"], bm["nfl"]

    diag_blocks = [
        kron_dirs([Kt if a == l else Mt for a in range(dim)])
        for l in range(dim)
    ]
    if iso:
        W_vol = sum(diag_blocks)
        nblk = 1
    else:
        W_vol = np.concatenate(diag_blocks, axis=1)
        nblk = dim

    # trace columns, per directed face: [u_f (nfl) | raw dn (nfl)]
    tr_cols = []
    for f in range(nfaces):
        tr_cols.append(bm["sels"][f].T)
        tr_cols.append(bm["dvol"][f // 2][bm["sel_rows"][f]].T)
    W_tr = np.concatenate(tr_cols, axis=1)  # [nv, nfaces*2*nfl]

    # lift rows, per directed face: [t13 (nfl) | s2n (nfl)]; face mass
    # folded into BOTH lane groups (no separate mj GEMM)
    Mf = bm["Mf"]
    rows = []
    for f in range(nfaces):
        rows.append(Mf @ bm["sels"][f])  # t13 lanes
        rows.append(Mf @ bm["sels"][f] @ bm["dvol"][f // 2])  # s2n lanes
    W_lift = np.concatenate(rows, axis=0)  # [nfaces*2*nfl, nv]

    return dict(
        W_vol=W_vol, nblk=nblk, W_tr=W_tr, W_lift=W_lift,
        nv=nv, nfl=nfl, nfaces=nfaces,
    )


def scaled_traces(u2, W_tr, drstn):
    """Own face traces [E, 2d·2·nfl] from u2 [E, nv]: per face
    [u_f | drstn·∂_n u], the dn lanes scaled by the face's own drstn
    ([E, 2d]), so a gathered row needs no second gather."""
    E, nfaces = drstn.shape
    tr = (u2 @ W_tr).reshape(E, nfaces, -1)
    nfl = tr.shape[2] // 2
    lane = torch.arange(2 * nfl, device=u2.device) < nfl
    tr = tr * torch.where(
        lane, torch.ones((), dtype=u2.dtype, device=u2.device),
        drstn[..., None],
    )
    return tr.reshape(E, -1)


def compute_traces(mesh: MeshData, u):
    """Phase A: scaled traces [E·2d, 2·nfl] in u's dtype."""
    E = u.shape[0]
    hm = _mats(mesh.deg, mesh.deg_quad, mesh.quad.kind, mesh.dim, mesh.iso)
    W_tr = torch.as_tensor(hm["W_tr"], dtype=u.dtype, device=u.device)
    tr = scaled_traces(u.reshape(E, -1), W_tr, F.drstn_normal(mesh, u.dtype))
    return tr.reshape(E * 2 * mesh.dim, 2 * hm["nfl"])


def fused_path_available(mesh: MeshData, g) -> bool:
    """The gate of JAX `pallas_path_available`: orthogonal, no orientation
    codes, no boundary data, degree ≥ 1, no hanging faces and no pointwise
    (sigma_q) penalty."""
    return (
        mesh.orth
        and not mesh.orient_codes
        and g is None
        and mesh.deg >= 1
        and mesh.hc_elem.shape[0] == 0
        and mesh.sigma_q is None
    )


def face_scalars(mesh: MeshData):
    """Per-element f32 tables of the fused pass: cw_in [E, nblk] (the
    diagonal volume weights), scal [E, 2d·4] (drstn_n, sj, sigma, bnd per
    face) and drstn [E, 2d]."""
    E, nfaces = mesh.n_elements, 2 * mesh.dim
    nblk = 1 if mesh.iso else mesh.dim
    cw = mesh.wjgg_c.to(F32)
    cw_in = torch.stack([cw[:, b, b] for b in range(nblk)], dim=1)
    drstn = F.drstn_normal(mesh, F32)
    scal = torch.stack(
        [drstn, mesh.face_sj_c.to(F32), mesh.sigma.to(F32),
         mesh.bnd_mask.to(F32)],
        dim=-1,
    ).reshape(E, nfaces * 4)
    return cw_in, scal, drstn


@dataclasses.dataclass
class FusedMesh:
    """Per-epoch f32 operands of the fused apply (original element
    order)."""

    dim: int
    deg: int
    nblk: int
    nbr_row: torch.Tensor  # [E, 2d] int32: the neighbor's face row
    cw_in: torch.Tensor  # [E, nblk]
    scal: torch.Tensor  # [E, 2d*4]: (drstn_n, sj, sigma, bnd) per face
    drstn: torch.Tensor  # [E, 2d]
    W_vol: torch.Tensor  # [nv, nblk*nv]
    W_tr: torch.Tensor  # [nv, 2d*2*nfl]
    W_lift: torch.Tensor  # [2d*2*nfl, nv]
    W_pack: torch.Tensor  # B of the kernel, `pack_sipg_weights`
    meta: torch.Tensor  # [E, 28]: the kernel's table rows, `sipg_meta`

    @property
    def n_elements(self) -> int:
        return self.nbr_row.shape[0]

    @property
    def nv(self) -> int:
        return (self.deg + 1) ** self.dim


def build_fused(mesh: MeshData) -> FusedMesh:
    """The fused apply's operands for `mesh`; raises unless
    `fused_path_available(mesh, None)`."""
    if not fused_path_available(mesh, None):
        raise ValueError(
            "the fused apply needs a conforming orthogonal affine mesh of "
            "degree >= 1 without orientation codes"
        )
    nfaces = 2 * mesh.dim
    cw_in, scal, drstn = face_scalars(mesh)
    nbr_row = mesh.nbr_elem.long() * nfaces + mesh.nbr_face.long()
    hm = _mats(mesh.deg, mesh.deg_quad, mesh.quad.kind, mesh.dim, mesh.iso)
    kw = dict(dtype=F32, device=mesh.device)
    W_vol = torch.as_tensor(hm["W_vol"], **kw)
    W_lift = torch.as_tensor(hm["W_lift"], **kw)
    return FusedMesh(
        dim=mesh.dim, deg=mesh.deg, nblk=hm["nblk"],
        nbr_row=nbr_row.to(torch.int32).contiguous(),
        cw_in=cw_in.contiguous(), scal=scal.contiguous(),
        drstn=drstn.contiguous(), W_vol=W_vol,
        W_tr=torch.as_tensor(hm["W_tr"], **kw), W_lift=W_lift,
        W_pack=pack_sipg_weights(W_vol, W_lift, hm["nblk"]),
        meta=sipg_meta(cw_in, scal),
    )


def fused_pass_plain(u2, tr, nb, cw_in, scal, W_vol, W_lift):
    """The fused pass in plain torch ops: cw ⊙ (u2 @ W_vol) + Z @ W_lift,
    where Z comes from the own traces tr [E, tw] and, face by face, the
    traces of the neighbor across that face, nb [E, tw].  On boundary
    faces nb is not read (u+ = 0, dn+ = -dn-)."""
    E, nv = u2.shape
    nblk = cw_in.shape[1]
    acc = u2 @ W_vol
    au = cw_in[:, 0][:, None] * acc[:, :nv]
    for b in range(1, nblk):
        au = au + cw_in[:, b][:, None] * acc[:, b * nv:(b + 1) * nv]
    return au + face_terms(tr, nb, scal) @ W_lift


def face_terms(tr, nb, scal):
    """The face block Z [E, tw] of the fused pass, per face [t13 | s2n],
    from the own traces tr, the neighbor's nb (both [E, tw]) and the
    per-face scalars scal [E, 2d·4]."""
    E = tr.shape[0]
    nfaces = scal.shape[1] // 4
    tr3 = tr.reshape(E, nfaces, -1)
    nb3 = nb.reshape(E, nfaces, -1)
    nfl = tr3.shape[2] // 2
    s = scal.reshape(E, nfaces, 4)
    drstn, sj, sig, bnd = (s[..., i:i + 1] for i in range(4))
    zero = torch.zeros((), dtype=tr.dtype, device=tr.device)
    u_f, dn_m = tr3[..., :nfl], tr3[..., nfl:]
    u_p = torch.where(bnd > 0, zero, nb3[..., :nfl])
    dn_p = torch.where(bnd > 0, -dn_m, nb3[..., nfl:])
    c2 = 1.0 + bnd
    jump = u_f - u_p
    t13 = -0.5 * sj * (dn_m - dn_p) + sj * sig * jump
    s2n = -0.5 * c2 * sj * drstn * jump
    return torch.cat([t13, s2n], dim=2).reshape(E, -1)


# The kernels' K chunk (`kKC` of `csrc/sipg_gemm.cuh`): B is packed in
# chunks of this many K rows.
SIPG_KC = 16
# The width of the kernels' per-element table rows (`kMetaW`).
SIPG_META_W = 28


def sipg_meta(cw_in, scal):
    """The kernels' per-element table [E, 28] in f32: scal (drstn, sj,
    sigma, bnd per face, 24 columns), then cw_in (nblk columns), then
    zeros, so that each row is 112 bytes and a tile's rows are one aligned
    bulk copy."""
    E, nblk = cw_in.shape
    pad = torch.zeros((E, SIPG_META_W - scal.shape[1] - nblk), dtype=F32,
                      device=scal.device)
    return torch.cat([scal.to(F32), cw_in.to(F32), pad], dim=1).contiguous()


def sipg_layout(nv: int, nblk: int, tw: int):
    """The padded shape of B in the kernels (`Cfg` of `sipg_gemm.cuh`):
    (NP, NCH), the column count nv rounded up to the warpgroups' widths
    (a multiple of 8, or of 16 where a warpgroup's columns are cut in two
    halves) and the count of K chunks."""
    K = nblk * nv + tw
    if nv > 256:
        NP = 2 * ((nv + 15) // 16 * 8)
    elif nv > 128:
        NP = (nv + 15) // 16 * 16
    else:
        NP = (nv + 7) // 8 * 8
    return NP, -(-K // SIPG_KC)


def tf32_round(x):
    """x rounded to TF32 as `cvt.rna.tf32.f32` rounds it: the nearest
    value with 10 mantissa bits, ties away from zero, kept in f32."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(F32)


def split_tf32(x):
    """(hi, lo), both TF32 values, hi + lo ≈ x to ~2^-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(F32) - hi)


def sipg_b(W_vol, W_lift, nblk):
    """B = [W_vol blocks stacked along K ; W_lift], [K, nv]: row
    b·nv + m is W_vol[m, b·nv:(b+1)·nv], row nblk·nv + j is W_lift[j]."""
    nv = W_vol.shape[0]
    blocks = [W_vol[:, b * nv:(b + 1) * nv] for b in range(nblk)]
    return torch.cat(blocks + [W_lift], dim=0)


def pack_sipg_weights(W_vol, W_lift, nblk):
    """B of the fused pass, split into TF32 hi and lo, transposed to
    K-major, padded with zeros (N to `sipg_layout`'s NP, K to whole
    chunks) and cut into K chunks in the kernels' shared-memory image:
    [NCH, 2 (hi, lo), NP/8, KC/4, 8, 4], f32.  Entry (chunk c, part,
    g, q, r, i) is part(B)[c·KC + 4q + i, 8g + r]."""
    B = sipg_b(W_vol, W_lift, nblk).to(F32)
    K, nv = B.shape
    NP, NCH = sipg_layout(nv, nblk, K - nblk * nv)
    Bt = torch.zeros((NP, NCH * SIPG_KC), dtype=F32, device=B.device)
    Bt[:nv, :K] = B.T
    parts = [
        p.reshape(NP // 8, 8, NCH, SIPG_KC // 4, 4).permute(2, 0, 3, 1, 4)
        for p in split_tf32(Bt)
    ]
    return torch.stack(parts, dim=1).contiguous()


def gather_rows(fm: FusedMesh, tr):
    """The neighbor traces nb [E, tw]: face row `nbr_row` of tr seen as
    [E·2d, 2·nfl] (phase A's exchange, the JAX `tr[rows]`)."""
    E, tw = tr.shape
    rows = fm.nbr_row.reshape(-1).long()
    return tr.reshape(E * 2 * fm.dim, -1)[rows].reshape(E, tw)


def fused_apply_plain(fm: FusedMesh, u2, tr):
    """Plain torch version of phase B: Au [E, nv] from u2 [E, nv] and the
    scaled traces tr [E, tw] (row gather, face terms, two GEMMs)."""
    return fused_pass_plain(u2, tr, gather_rows(fm, tr), fm.cw_in, fm.scal,
                            fm.W_vol, fm.W_lift)


def check_sipg_operands(dim, deg, nblk, E, dev):
    """The limits both fused SIPG kernels share; returns tw."""
    if dev.type != "cuda":
        raise ValueError(f"the fused SIPG kernels need CUDA tensors, got {dev}")
    if dim != 3 or not 1 <= deg <= 7 or nblk not in (1, 3):
        raise ValueError(
            f"the fused SIPG kernels support dim 3, degrees 1-7 and nblk 1 "
            f"or 3; got dim {dim}, degree {deg}, nblk {nblk}"
        )
    nv, tw = (deg + 1) ** 3, 6 * 2 * (deg + 1) ** 2
    if E == 0 or E * max(tw, nblk * nv) >= 2**31:
        raise ValueError(f"fused SIPG kernel: unsupported element count {E}")
    return tw


def check_sipg_weights(W_pack, nv, nblk, tw, dev):
    """The packed B operand's check, shared by both kernel wrappers."""
    NP, NCH = sipg_layout(nv, nblk, tw)
    check_operand("W_pack", W_pack, (NCH, 2, NP // 8, SIPG_KC // 4, 8, 4),
                  dev, F32)


@functools.lru_cache(maxsize=None)
def _load():
    lib = load_library(SOURCE)
    fn = lib.d4est_fused_apply
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def fused_apply_cuda(fm: FusedMesh, u2, tr):
    """Phase B on the card: launches `csrc/fused_apply.cu`.  Same contract
    as `fused_apply_plain`; raises on anything the kernel does not take and
    on a failed launch."""
    global KERNEL_LAUNCHES
    dev = u2.device
    E, nv, nblk = fm.n_elements, fm.nv, fm.nblk
    tw = check_sipg_operands(fm.dim, fm.deg, nblk, E, dev)
    for name, t, shape in (
        ("u", u2, (E, nv)), ("tr", tr, (E, tw)),
        ("meta", fm.meta, (E, SIPG_META_W)),
    ):
        check_operand(name, t, shape, dev, F32)
    check_sipg_weights(fm.W_pack, nv, nblk, tw, dev)
    check_operand("nbr_row", fm.nbr_row, (E, 6), dev, torch.int32)
    fn = _load().d4est_fused_apply
    out = torch.empty((E, nv), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            u2.data_ptr(), tr.data_ptr(), fm.nbr_row.data_ptr(),
            fm.meta.data_ptr(), fm.W_pack.data_ptr(), out.data_ptr(), E,
            fm.deg + 1, nblk, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out


def apply_fused(fm: FusedMesh, u):
    """Au in f32, input shape kept.  On a CUDA tensor this launches the
    hand-written kernel (or raises); on a CPU tensor it runs the plain
    version."""
    dev = u.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"apply_fused: unsupported device {dev}")
    u2 = u.reshape(fm.n_elements, fm.nv).to(F32).contiguous()
    tr = scaled_traces(u2, fm.W_tr, fm.drstn)
    if dev.type == "cpu":
        out = fused_apply_plain(fm, u2, tr)
    else:
        out = fused_apply_cuda(fm, u2, tr.contiguous())
    return out.reshape(u.shape).to(u.dtype)


def apply_sipg_fused(mesh: MeshData, u):
    """The whole fused apply u → Au (the JAX `apply_sipg_pallas` with
    precision="f32"): the same discrete operator as `fast.apply_sipg_fast`
    on meshes that pass `fused_path_available(mesh, None)`."""
    return apply_fused(build_fused(mesh), u)
