"""Speed-of-light SIPG apply for affine meshes (GEMM form).

Port of the orthogonal part of `disco4est_tpu/laplacian/fast.py`
(reference semantics: `dGMath/d4est_laplacian.c:318-399` +
`d4est_laplacian_flux_sipg.c`).  For affine elements every geometric factor
is constant, so the exact quadrature folds into fixed Lobatto-space
matrices: the volume term is Σ_b c_b ⊙ (u @ Q_b) with shared dense
[nv, nv] blocks, the face traces come out of the same GEMM, neighbors are
one packed row gather, and mass + lift is one more GEMM.  The GEMMs stay
`torch.matmul`, as they were plain XLA GEMMs in the JAX package.

This is the f64 outer operator of the mixed-precision solve, and in f32
the generic inner one.  Hanging faces ride the same [E, 2d] face arrays
through the dense mortar pass of `_apply_orth` (the builder's `hang_code`
tables); `_add_hanging` is the legacy route through the [M, K] row kernels
of `sipg._apply_hanging`, kept as the reference the dense pass is tested
against.  `_apply_general` takes affine meshes with sheared cells or
reoriented tree faces (6 volume blocks, every drstn component, the static
orientation transforms).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from disco4est_tpu_torch.mesh.builder import MeshData
from disco4est_tpu_torch.ops import tensor
from disco4est_tpu_torch.ops.operators import DB


def _base_mats(deg: int, deg_quad: int, quad_key, dim: int):
    from disco4est_tpu_torch.quadrature.quadrature import Quadrature

    quad = Quadrature(quad_key)
    nl = deg + 1
    V = quad.interp(deg, deg_quad)  # [nq, nl]
    _, w = quad.nodes_weights(deg_quad)
    D = DB.ops(deg).diff
    Mt = V.T @ np.diag(w) @ V  # 1D quadrature mass at Lobatto
    Kt = D.T @ Mt @ D
    Bt = Mt @ D

    def kron_dirs(fs):
        # fs[d] = 1D factor for DIRECTION d (0 = x = fastest ⇒ last operand)
        out = fs[dim - 1]
        for d in range(dim - 2, -1, -1):
            out = np.kron(out, fs[d])
        return out

    nfaces = 2 * dim
    nv = nl**dim
    nfl = nl ** (dim - 1)
    sel_rows = [
        tensor.np_face_slice_indices(f, dim, nl) for f in range(nfaces)
    ]
    sels = []
    for f in range(nfaces):
        S = np.zeros((nfl, nv))
        S[np.arange(nfl), sel_rows[f]] = 1.0
        sels.append(S)
    dvol = []
    for l in range(dim):
        fs = [np.eye(nl)] * dim
        fs[l] = D
        dvol.append(kron_dirs(fs))
    Mf = Mt
    for _ in range(dim - 2):
        Mf = np.kron(Mf, Mt)
    if dim == 2:
        Mf = Mt.copy()
    return dict(
        Mt=Mt, Kt=Kt, Bt=Bt, D=D, kron_dirs=kron_dirs, sels=sels,
        sel_rows=sel_rows, dvol=dvol, Mf=Mf, nv=nv, nfl=nfl, nfaces=nfaces,
    )


@functools.lru_cache(maxsize=None)
def _host_mats_general(deg: int, deg_quad: int, quad_key, dim: int,
                       orth: bool):
    """Fixed f64 numpy matrices for the general-affine GEMM apply."""
    bm = _base_mats(deg, deg_quad, quad_key, dim)
    Mt, Kt, Bt = bm["Mt"], bm["Kt"], bm["Bt"]
    kron_dirs = bm["kron_dirs"]
    nfaces = bm["nfaces"]

    pairs = [(l, l) for l in range(dim)]
    if not orth:
        pairs += [(l, lp) for l in range(dim) for lp in range(l + 1, dim)]
    blocks = []
    for l, lp in pairs:
        if l == lp:
            blocks.append(
                kron_dirs([Kt if a == l else Mt for a in range(dim)])
            )
        else:
            # T_{lp,l} + T_{l,lp} (symmetric; coefficient wjgg_c[l,lp])
            f1 = [Mt] * dim
            f1[l] = Bt
            f1[lp] = Bt.T
            f2 = [Mt] * dim
            f2[l] = Bt.T
            f2[lp] = Bt
            blocks.append(kron_dirs(f1) + kron_dirs(f2))
    W_vol = np.concatenate(blocks, axis=1)

    dn_cols, dn_dirs = [], []
    for f in range(nfaces):
        for l in ([f // 2] if orth else range(dim)):
            dn_cols.append(bm["dvol"][l][bm["sel_rows"][f]].T)
            dn_dirs.append((f, l))
    return dict(
        W_vol=W_vol, nblk=len(pairs), pairs=tuple(pairs),
        W_dn=np.concatenate(dn_cols, axis=1), dn_dirs=tuple(dn_dirs),
        sel_cat=np.concatenate(bm["sel_rows"]), Mf=bm["Mf"], D=bm["D"],
    )


@functools.lru_cache(maxsize=None)
def _host_mats_orth(deg: int, deg_quad: int, quad_key, dim: int, iso: bool):
    """Fixed f64 numpy matrices for the orthogonal fast path (wjgg
    diagonal, unit normals along axes ⇒ only the normal drstn component
    survives)."""
    bm = _base_mats(deg, deg_quad, quad_key, dim)
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

    # trace blocks, 2*nfl per face: [u_f | raw normal derivative]
    tr_cols = []
    for f in range(nfaces):
        tr_cols.append(bm["sels"][f].T)
        tr_cols.append(bm["dvol"][f // 2][bm["sel_rows"][f]].T)
    W_tr = np.concatenate(tr_cols, axis=1)  # [nv, nfaces*2*nfl]

    # fused mass+lift GEMM, input [t13_raw (nfaces*nfl) | s2n (nfaces*nfl)]
    Mf = bm["Mf"]
    rows = [Mf @ bm["sels"][f] for f in range(nfaces)]
    rows += [bm["sels"][f] @ bm["dvol"][f // 2] for f in range(nfaces)]
    W_lift = np.concatenate(rows, axis=0)  # [2*nfaces*nfl, nv]

    # mass-FREE lift for the dense coarse-mortar lanes (their loads carry
    # the subface mass already): [place t13m | D̂_nᵀ place s2n]
    rows2 = [bm["sels"][f] for f in range(nfaces)]
    rows2 += [bm["sels"][f] @ bm["dvol"][f // 2] for f in range(nfaces)]
    W_lift2 = np.concatenate(rows2, axis=0)

    return dict(W_vol=W_vol, nblk=nblk, W_tr=W_tr, W_lift=W_lift,
                W_lift2=W_lift2, Mf=Mf, nv=nv, nfl=nfl)


@functools.lru_cache(maxsize=None)
def _hang_prolong_mats(deg: int, dim: int):
    """[K, nfl, nfl] coarse-face -> subface-b interpolation (flattened face
    layout, subface bit t on the t-th-fastest face axis — the same
    convention as `sipg._apply_hanging`'s `prolong_b`)."""
    hp = [DB.hp_prolong(deg, deg, c) for c in (0, 1)]
    K = 1 << (dim - 1)
    mats = []
    for b in range(K):
        Pm = hp[b & 1]
        for t in range(1, dim - 1):
            Pm = np.kron(hp[(b >> t) & 1], Pm)
        mats.append(Pm)
    return np.stack(mats)


@functools.lru_cache(maxsize=64)
def _device_mats_orth(deg, deg_quad, quad_key, dim, iso, dtype, device):
    """`_host_mats_orth` as tensors of `dtype` on `device`, uploaded once
    per (operator, dtype, device) instead of once per apply."""
    hm = _host_mats_orth(deg, deg_quad, quad_key, dim, iso)
    kw = dict(dtype=dtype, device=device)
    return dict(
        W_A=torch.as_tensor(
            np.concatenate([hm["W_vol"], hm["W_tr"]], axis=1), **kw
        ),
        W_lift=torch.as_tensor(hm["W_lift"], **kw),
        W_lift2=torch.as_tensor(hm["W_lift2"], **kw),
        Mf=torch.as_tensor(hm["Mf"], **kw),
        P=torch.as_tensor(_hang_prolong_mats(deg, dim), **kw),
        nv=hm["nv"], nblk=hm["nblk"],
    )


@functools.lru_cache(maxsize=64)
def _device_mats_general(deg, deg_quad, quad_key, dim, orth, dtype, device):
    """`_host_mats_general` as tensors on `device`, uploaded once."""
    hm = _host_mats_general(deg, deg_quad, quad_key, dim, orth)
    kw = dict(dtype=dtype, device=device)
    return dict(
        W=torch.as_tensor(np.concatenate([hm["W_vol"], hm["W_dn"]], axis=1),
                          **kw),
        sel=torch.as_tensor(hm["sel_cat"], device=device),
        Mf=torch.as_tensor(hm["Mf"], **kw),
        D=torch.as_tensor(hm["D"], **kw),
    )


def fast_path_available(mesh: MeshData, neighbors: str, robin) -> bool:
    """Whether `apply_sipg(mesh, u, g, neighbors, robin_coeff=robin)` may
    take the GEMM form: an affine mesh with one scalar σ per face, the
    full neighbor coupling and no Robin data."""
    return (
        mesh.affine
        and mesh.wjgg_c is not None
        # hanging meshes ride the fast conforming bulk + a mortar pass:
        # either the dense orth tables, or the legacy [M, K] kernels
        # (which need the full face factor arrays for the fine sides)
        and (
            mesh.hc_elem.shape[0] == 0
            or (
                mesh.orth
                and not mesh.orient_codes
                and mesh.hang_code is not None
                and mesh.hc_sigma_q is None
            )
            or mesh.face_drst is not None
        )
        and neighbors == "full"
        and robin is None
        and mesh.sigma_q is None  # the fast paths take a scalar σ per face
    )


def _add_hanging(mesh: MeshData, Au, u_vol, dtype):
    """Mortar contributions on top of the conf-masked fast bulk through
    the legacy [M, K] row kernels of `sipg._apply_hanging`."""
    from disco4est_tpu_torch.laplacian import sipg as _sipg

    dim, deg = mesh.dim, mesh.deg
    D1 = _sipg._general_ops(deg, mesh.deg_quad, mesh.quad.kind, dim, dtype,
                            u_vol.device)["D"]
    dudr = [tensor.apply_axis(D1, u_vol, l) for l in range(dim)]
    u_f = _sipg._face_slices(u_vol, dim)
    dudr_f = torch.stack(
        [_sipg._face_slices(dudr[l], dim) for l in range(dim)], dim=2
    )
    return Au + _sipg._apply_hanging(mesh, u_f, dudr_f, dtype)


def apply_sipg_fast(mesh: MeshData, u, g=None):
    """GEMM-form SIPG apply; requires `fast_path_available`."""
    if mesh.orth and not mesh.orient_codes:
        return _apply_orth(mesh, u, g)
    return _apply_general(mesh, u, g)


def drstn_normal(mesh: MeshData, dtype):
    """Normal component of (drdx·n) per directed face: [E, 2d]."""
    nfaces = 2 * mesh.dim
    drstn = torch.einsum(
        "eld,efd->efl", mesh.drdx_c.to(dtype), mesh.face_n_c.to(dtype)
    )  # [E, 2d, dim]
    f_idx = torch.arange(nfaces, device=drstn.device)
    return drstn[:, f_idx, f_idx // 2]


def _apply_orth(mesh: MeshData, u, g=None):
    """Orthogonal (axis-aligned) fast path: 1-3 volume blocks, traces
    gathered straight from the trace GEMM output, one fused lift GEMM."""
    dim, deg = mesh.dim, mesh.deg
    nfl = (deg + 1) ** (dim - 1)
    nfaces = 2 * dim
    E = u.shape[0]
    dtype = u.dtype

    dm = _device_mats_orth(deg, mesh.deg_quad, mesh.quad.kind, dim,
                           mesh.iso, dtype, u.device)
    nv, nblk = dm["nv"], dm["nblk"]

    Y = u.reshape(E, nv) @ dm["W_A"]
    cw = mesh.wjgg_c.to(dtype)
    Au = cw[:, 0, 0][:, None] * Y[:, :nv]
    for b in range(1, nblk):
        Au = Au + cw[:, b, b][:, None] * Y[:, b * nv:(b + 1) * nv]

    drstn_n = drstn_normal(mesh, dtype)  # [E, 2d]

    # traces: scale the dn lanes, then one packed row gather (scaling
    # BEFORE the gather means the gathered rows already hold the
    # neighbor's own-normal derivative)
    lane = torch.arange(2 * nfl, device=u.device) < nfl
    tr = Y[:, nblk * nv:].reshape(E, nfaces, 2 * nfl)
    tr = tr * torch.where(
        lane, torch.ones((), dtype=dtype, device=u.device),
        drstn_n[..., None],
    )
    rows = (mesh.nbr_elem.long() * nfaces + mesh.nbr_face.long()).reshape(-1)
    gath = tr.reshape(E * nfaces, 2 * nfl)[rows].reshape(E, nfaces, 2 * nfl)
    u_f, dn_m = tr[..., :nfl], tr[..., nfl:]
    u_p, dn_p = gath[..., :nfl], gath[..., nfl:]

    # boundary overrides
    bnd = mesh.bnd_mask[..., None]
    if g is None:
        u_p = torch.where(bnd, torch.zeros((), dtype=dtype,
                                           device=u.device), u_p)
    else:
        u_p = torch.where(bnd, g.to(dtype).reshape(E, nfaces, nfl), u_p)
    dn_p = torch.where(bnd, -dn_m, dn_p)
    c2 = torch.where(bnd, 2.0, 1.0).to(dtype)

    sj = mesh.face_sj_c.to(dtype)[..., None]
    sig = mesh.sigma.to(dtype)[..., None]

    hanging = mesh.hc_elem.shape[0] > 0
    dense_hang = hanging and mesh.hang_code is not None
    if dense_hang:
        # Dense mortar pass: the [M, K] row kernels of `sipg._apply_hanging`
        # re-expressed on the conforming [E, 2d] face arrays.  FINE side:
        # the gathered neighbor row IS the coarse face's trace (faces.py
        # sets nbr_* to the coarse element); prolong its lanes onto my
        # subface and use the mortar penalty — then the conforming
        # t13/s2n formulas apply verbatim (the fine face is the mortar).
        # The COARSE side reuses the fine rows via the mortar
        # antisymmetry t13_c = -t13_f, jump_c = -jump_f.
        code = mesh.hang_code  # [E, 2d]
        P = dm["P"]  # [K, nfl, nfl]
        for k in range(P.shape[0]):
            mk = (code == k + 1)[..., None]
            u_p = torch.where(mk, u_p @ P[k].T, u_p)
            dn_p = torch.where(mk, dn_p @ P[k].T, dn_p)
        sig = torch.where((code > 0)[..., None],
                          mesh.hang_sigma.to(dtype)[..., None], sig)

    jump = u_f - u_p
    t13 = -0.5 * sj * (dn_m - dn_p) + sj * sig * jump
    mj = (jump.reshape(-1, nfl) @ dm["Mf"]).reshape(E, nfaces, nfl)
    s2n = (-0.5) * c2 * sj * mj * drstn_n[..., None]

    t13_z, s2n_z = t13, s2n
    if hanging:
        # faces this pass does not handle are masked out: every hanging
        # face for the legacy mortar pass, coarse-hanging only in dense mode
        cmb = mesh.conf_mask
        if dense_hang:
            cmb = cmb | (code > 0)
        cm = cmb[..., None].to(dtype)
        t13_z, s2n_z = t13 * cm, s2n * cm
    Z = torch.cat(
        [t13_z.reshape(E, nfaces * nfl), s2n_z.reshape(E, nfaces * nfl)],
        dim=1,
    )
    Au = Au + Z @ dm["W_lift"]

    if dense_hang:
        # coarse side: gather the M·K fine-face loads, transpose-prolong
        # and negate per mortar, then one unique-index store onto the
        # dense face arrays (coarse hanging faces are distinct rows)
        K = P.shape[0]
        t13m = (t13.reshape(-1, nfl) @ dm["Mf"]).reshape(E, nfaces, nfl)
        packc = torch.cat([t13m, sj * mj], dim=-1).reshape(
            E * nfaces, 2 * nfl)
        rows_c = mesh.hc_fine.long() * nfaces + mesh.hc_fine_face.long()
        gk = packc[rows_c.reshape(-1)].reshape(-1, K, 2 * nfl)
        cidx = mesh.hc_elem.long() * nfaces + mesh.hc_face.long()
        loads = torch.zeros((E * nfaces, 2 * nfl), dtype=dtype,
                            device=u.device)
        loads[cidx] = -torch.cat(
            [torch.einsum("mkb,kba->ma", gk[..., :nfl], P),
             torch.einsum("mkb,kba->ma", gk[..., nfl:], P)], dim=-1)
        loads = loads.reshape(E, nfaces, 2 * nfl)
        s2n_c = -0.5 * loads[..., nfl:] * drstn_n[..., None]
        Z2 = torch.cat([loads[..., :nfl].reshape(E, nfaces * nfl),
                        s2n_c.reshape(E, nfaces * nfl)], dim=1)
        Au = Au + Z2 @ dm["W_lift2"]

    Au = Au.reshape(u.shape)
    if hanging and not dense_hang:
        Au = _add_hanging(mesh, Au, u.reshape((E,) + (deg + 1,) * dim),
                          dtype)
    return Au


def _apply_general(mesh: MeshData, u, g=None):
    """General affine path (sheared cells, cross-tree orientations): the
    volume blocks and the normal-derivative partials in one GEMM, every
    component of drstn, the static orientation transforms on the gathered
    neighbor rows, and the lift through per-face Dᵀ contractions."""
    from disco4est_tpu_torch.laplacian.sipg import _apply_orient_codes

    dim, deg = mesh.dim, mesh.deg
    nl = deg + 1
    nfl = nl ** (dim - 1)
    nfaces = 2 * dim
    E = u.shape[0]
    dtype, dev = u.dtype, u.device
    fshape_l = (nl,) * (dim - 1)
    kw = dict(dtype=dtype, device=dev)

    hm = _host_mats_general(deg, mesh.deg_quad, mesh.quad.kind, dim,
                            mesh.orth)
    dm = _device_mats_general(deg, mesh.deg_quad, mesh.quad.kind, dim,
                              mesh.orth, dtype, dev)
    nblk, nv = hm["nblk"], nl**dim
    u2 = u.reshape(E, nv)

    # ---- one fused GEMM: volume blocks + normal-derivative partials ----
    Y = u2 @ dm["W"]
    cw = mesh.wjgg_c.to(dtype)  # [E, dim, dim]
    Au = torch.zeros((E, nv), **kw)
    for b, (l, lp) in enumerate(hm["pairs"]):
        Au = Au + cw[:, l, lp][:, None] * Y[:, b * nv:(b + 1) * nv]

    # ---- traces at Lobatto ----------------------------------------------
    u_f = u2[:, dm["sel"]].reshape(E, nfaces, nfl)
    dparts = Y[:, nblk * nv:]  # [E, len(dn_dirs)*nfl]
    # dn = n·∇u = Σ_l drstn[e,f,l]·(D_l u)|_f, drstn = (drdx·n) per face
    drstn = torch.einsum("eld,efd->efl", mesh.drdx_c.to(dtype),
                         mesh.face_n_c.to(dtype))  # [E, 2d, dim]
    dn_m = torch.zeros((E, nfaces, nfl), **kw)
    for i, (f, l) in enumerate(hm["dn_dirs"]):
        dn_m[:, f] += drstn[:, f, l][:, None] * dparts[:, i * nfl:(i + 1) * nfl]

    # ---- neighbor gather (one packed row gather) -------------------------
    rows = (mesh.nbr_elem.long() * nfaces + mesh.nbr_face.long()).reshape(-1)
    packed = torch.cat([u_f, dn_m], dim=-1).reshape(E * nfaces, 2 * nfl)
    gath = packed[rows].reshape(E, nfaces, 2 * nfl)
    u_p = gath[..., :nfl].reshape((E, nfaces) + fshape_l)
    dn_p = gath[..., nfl:].reshape((E, nfaces) + fshape_l)
    u_p = _apply_orient_codes(u_p, mesh.orient_code, mesh.orient_codes, dim)
    dn_p = _apply_orient_codes(dn_p, mesh.orient_code, mesh.orient_codes,
                               dim)
    u_p = u_p.reshape(E, nfaces, nfl)
    dn_p = dn_p.reshape(E, nfaces, nfl)

    # ---- boundary overrides ----------------------------------------------
    bnd = mesh.bnd_mask[..., None]  # [E, 2d, 1]
    g_f = (torch.zeros((E, nfaces, nfl), **kw) if g is None
           else g.to(dtype).reshape(E, nfaces, nfl))
    u_p = torch.where(bnd, g_f, u_p)
    dn_p = torch.where(bnd, -dn_m, dn_p)
    c2 = torch.where(bnd, 2.0, 1.0).to(dtype)

    sj = mesh.face_sj_c.to(dtype)[..., None]  # [E, 2d, 1]
    sig = mesh.sigma.to(dtype)[..., None]
    jump = u_f - u_p
    t13 = -0.5 * sj * (dn_m - dn_p) + sj * sig * jump

    # face-mass applies at Lobatto (M̃_f = ⊗M̃, conforming faces only)
    Mf = dm["Mf"]
    t13m = (t13.reshape(-1, nfl) @ Mf).reshape(E, nfaces, nfl)
    s2 = (-0.5) * c2 * sj * (jump.reshape(-1, nfl) @ Mf).reshape(
        E, nfaces, nfl)
    hanging = mesh.hc_elem.shape[0] > 0
    if hanging:
        cm = mesh.conf_mask[..., None].to(dtype)
        t13m, s2 = t13m * cm, s2 * cm

    # ---- lift back to the volume -----------------------------------------
    Au = Au.reshape((E,) + (nl,) * dim)
    t13m = t13m.reshape((E, nfaces) + fshape_l)
    s2 = s2.reshape((E, nfaces) + fshape_l)
    Dt = dm["D"].T
    cshape = (E,) + (1,) * (dim - 1)
    for f in range(nfaces):
        dir_, side = divmod(f, 2)
        tang = [d for d in range(dim) if d != dir_]
        a = t13m[:, f]
        for l in tang:
            vt2_l = drstn[:, f, l].reshape(cshape) * s2[:, f]
            a = a + tensor.apply_axis(Dt, vt2_l, tang.index(l))
        axis = Au.ndim - 1 - dir_
        Au.select(axis, 0 if side == 0 else nl - 1).add_(a)
        # normal-direction symmetry term: Dᵀ[:, edge] ⊗ (drstn_n · s2)
        vt2_n = drstn[:, f, dir_].reshape(cshape) * s2[:, f]
        dcol = Dt[:, 0] if side == 0 else Dt[:, -1]
        col_shape = [1] * Au.ndim
        col_shape[axis] = nl
        Au = Au + vt2_n.unsqueeze(axis) * dcol.reshape(col_shape)

    if hanging:
        Au = _add_hanging(mesh, Au, u.reshape((E,) + (nl,) * dim), dtype)
    return Au
