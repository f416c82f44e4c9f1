"""Matrix-free SIPG Laplacian apply, mass apply and strong-BC rhs.

Port of `disco4est_tpu/laplacian/sipg.py` (role of the reference's
`dGMath/d4est_laplacian.c:318-399` and `d4est_laplacian_flux_sipg.c`).
`apply_sipg` dispatches to the GEMM-form fast path (`laplacian/fast.py`)
on affine meshes; everywhere else (curved elements, Robin data, zeroed
neighbors, the pointwise penalty) it runs the general quadrature-point
apply below, in torch operations, as the JAX package runs it in plain XLA:

- the volume stiffness as dense [E, nl^dim]·[nl^dim, nq^dim] GEMMs
  (`volume_mode="dense"`, the default up to deg 4) or per-axis tensor
  contractions (`"tensor"`, which also takes the per-element radial rule
  of compactified shells);
- one batch over every directed face (element, face): the neighbor's
  trace and normal derivative come through one packed row gather, fixed
  into my frame by one static flip/swap transform per orientation code
  present (`_apply_orient_codes`); boundary faces take u⁺ := g,
  ∂u⁺ := ∂u⁻ and a doubled symmetry term
  (`d4est_laplacian_flux_sipg.c:133-148`);
- hanging faces masked out of that batch and done by the mortar rows of
  `_apply_hanging`, with the mortar node permutations.

SIPG terms on each directed face (minus side),
`d4est_laplacian_flux_sipg_interface_aux` (reference :560-640):
  term1 = -n·sj·½(∇u⁻ + ∇u⁺)            (consistency)
  term2_l = -½·(∂r_l/∂x·n)·sj·(u⁻-u⁺)    (symmetry; then lifted & Dᵀ)
  term3 = sj·σ·(u⁻-u⁺)                   (penalty; pointwise σ on
                                          j_div_sj_quad meshes)
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
from disco4est_tpu_torch.ops.rows import add_face_rows


def apply_sipg(mesh: MeshData, u, g=None, neighbors: str = "full",
               robin_coeff=None, robin_rhs=None, volume_mode: str = "auto"):
    """Au for the SIPG Laplacian (−∇² weak form).  `u`: [E, nl...] nodal
    field; `g`: optional Dirichlet data at face Lobatto nodes
    [E, 2d, nfl...] (None ⇒ homogeneous, the pure linear operator).

    `neighbors="zero"` drops every cross-element coupling: the
    element-block-diagonal action, whose unit-vector probes assemble the
    diagonal blocks of A (`d4est_solver_schwarz_apply_lhs` role).

    Robin boundary conditions (`d4est_laplacian_flux_sipg_robin_aux`,
    reference :340-436: ∂u/∂n + c·u = r replaces every boundary flux term
    by ∫ sj·(c·u − r)·v): `robin_coeff` [E, 2d, nfq...] (values used on
    physical-boundary faces, e.g. `mesh.boundary_values_quad` of the
    coefficient) and optionally `robin_rhs`.

    `volume_mode`: "auto" (fast path where it applies, else dense up to
    deg 4 in 3D without a radial rule, else tensor), "fast" (raise if the
    fast path does not apply), "dense" or "tensor"."""
    if volume_mode in ("auto", "fast"):
        if fast_path_available(mesh, neighbors, robin_coeff):
            return apply_sipg_fast(mesh, u, g)
        if volume_mode == "fast":
            raise ValueError("fast path unavailable for this mesh/options")
        volume_mode = (
            "dense"
            if mesh.deg <= 4 and mesh.dim == 3 and mesh.rad_interp is None
            else "tensor"
        )
    if volume_mode not in ("dense", "tensor"):
        raise ValueError(f"unknown volume_mode {volume_mode!r}")
    if neighbors not in ("full", "zero"):
        raise ValueError(f"unknown neighbors {neighbors!r}")

    dim, deg = mesh.dim, mesh.deg
    nl, nq = deg + 1, mesh.nq
    E = u.shape[0]
    dtype, dev = u.dtype, u.device
    ops = _general_ops(deg, mesh.deg_quad, mesh.quad.kind, dim, dtype, dev)
    D, Vq, wf = ops["D"], ops["Vq"], ops["wf"]

    # ---- reference-space gradient (shared volume/face) ------------------
    dudr = [tensor.apply_axis(D, u, l) for l in range(dim)]

    # ---- volume stiffness ----------------------------------------------
    # Au_vol = Σ_lp Dᵀ_lp Vᵀ (w·J·Σ_l g_lp·g_l ⊙ V D_l u)
    w3 = ops["w3"]
    if volume_mode == "dense":
        Gs = ops["Gs"]
        u_flat = u.reshape(E, -1)
        t_flat = torch.stack([u_flat @ Gs[l] for l in range(dim)], 1)
        if mesh.wjgg_c is not None:
            wjgg_flat = mesh.wjgg_c.to(dtype)[..., None] * w3.reshape(-1)
        else:
            wjgg_flat = mesh.wjgg.to(dtype).reshape(E, dim, dim, -1)
        Au = torch.zeros_like(u)
        for lp in range(dim):
            # elementwise: an einsum here is a batched GEMV over E·nq^dim
            s_flat = (wjgg_flat[:, lp] * t_flat).sum(1)
            Au = Au + (s_flat @ Gs[lp].T).reshape(u.shape)
    else:
        t = [vol_interp(mesh, dudr[l]) for l in range(dim)]
        Au = torch.zeros_like(u)
        cshape = (E,) + (1,) * dim
        for lp in range(dim):
            s = torch.zeros_like(t[0])
            for l in range(dim):
                if mesh.wjgg_c is not None:
                    c = mesh.wjgg_c[:, lp, l].to(dtype).reshape(cshape)
                    s = s + c * (w3 * t[l])
                else:
                    s = s + mesh.wjgg[:, lp, l].to(dtype) * t[l]
            s = vol_interp(mesh, s, transpose=True)
            Au = Au + tensor.apply_axis(D.T, s, lp)

    # ---- face sweep (single batch over [E, 2d]) -------------------------
    # Neighbor data is two scalars per face point: the trace u⁺ and the
    # frame-independent normal derivative n⁺·∇u⁺, one row gather and the
    # static orientation transforms.
    nfl_flat = nl ** (dim - 1)
    nfq_flat = nq ** (dim - 1)
    fshape_l = (nl,) * (dim - 1)
    fshape_q = (nq,) * (dim - 1)
    nfaces = 2 * dim
    ones = (1,) * (dim - 1)

    u_f = _face_slices(u, dim)  # [E, 2d, nfl...]
    dudr_f = torch.stack([_face_slices(dudr[l], dim) for l in range(dim)],
                         dim=2)  # [E, 2d, dim, nfl...]
    u_m_q = _face_apply(Vq, u_f, dim)  # [E, 2d, nfq...]
    dudr_m_q = _face_apply(Vq, dudr_f, dim)  # [E, 2d, dim, nfq...]

    # own-side geometric data (trailing 1s for the compact affine factors)
    if mesh.face_n_c is not None:
        drst_m = mesh.drdx_c.to(dtype).reshape((E, 1, dim, dim) + ones)
        n_m = mesh.face_n_c.to(dtype).reshape((E, nfaces, dim) + ones)
        sj = mesh.face_sj_c.to(dtype).reshape((E, nfaces) + ones)
    else:
        drst_m = mesh.face_drst.to(dtype)  # [E, 2d, l, d, nfq...]
        n_m = mesh.face_n.to(dtype)  # [E, 2d, d, nfq...]
        sj = mesh.face_sj.to(dtype)  # [E, 2d, nfq...]

    # n·∇u = (drst·n)·∂u/∂r : only drst_n is needed, not the full ∂u/∂x
    drst_n = (drst_m * n_m[:, :, None]).sum(3)  # [E, 2d, l, nfq...|1s]
    dn_m = (drst_n * dudr_m_q).sum(2)  # [E, 2d, nfq...]

    bnd_b = mesh.bnd_mask.reshape((E, nfaces) + ones)

    if neighbors == "zero":
        u_p_q = torch.zeros_like(u_m_q)
        dn_p = torch.zeros_like(dn_m)
    else:
        # one packed row gather for both traces
        rows = mesh.nbr_elem.long() * nfaces + mesh.nbr_face.long()
        packed = torch.cat(
            [u_f.reshape(E, nfaces, nfl_flat),
             dn_m.reshape(E, nfaces, nfq_flat)], dim=-1,
        ).reshape(E * nfaces, nfl_flat + nfq_flat)
        gath = packed[rows]  # [E, 2d, nfl + nfq]
        u_p = gath[..., :nfl_flat].reshape((E, nfaces) + fshape_l)
        dn_p = gath[..., nfl_flat:].reshape((E, nfaces) + fshape_q)
        u_p = _apply_orient_codes(u_p, mesh.orient_code, mesh.orient_codes,
                                  dim)
        dn_p = _apply_orient_codes(dn_p, mesh.orient_code,
                                   mesh.orient_codes, dim)
        u_p_q = _face_apply(Vq, u_p, dim)

    # boundary: u⁺ := g (or 0), ∂u⁺ := ∂u⁻ (⇔ gathered dn_p := -dn_m)
    g_q = (torch.zeros_like(u_m_q) if g is None
           else _face_apply(Vq, g.to(dtype), dim))
    u_p_q = torch.where(bnd_b, g_q, u_p_q)
    dn_p = torch.where(bnd_b, -dn_m, dn_p)

    jump = u_m_q - u_p_q
    c2 = torch.where(bnd_b, 2.0, 1.0).to(dtype)

    # n⁺ = -n⁻ at matched points, so n⁻·∇u⁺ = -dn_p
    term1 = -0.5 * sj * (dn_m - dn_p)
    term2 = -0.5 * c2[:, :, None] * drst_n * (sj * jump)[:, :, None]
    if mesh.sigma_q is not None:
        # pointwise penalty (FACE_H_EQ_J_DIV_SJ_QUAD)
        term3 = sj * mesh.sigma_q.to(dtype) * jump
    else:
        term3 = sj * mesh.sigma.to(dtype).reshape((E, nfaces) + ones) * jump

    if robin_coeff is not None:
        rr = (torch.zeros_like(u_m_q) if robin_rhs is None
              else robin_rhs.to(dtype))
        robin_term = sj * (robin_coeff.to(dtype) * u_m_q - rr)
        term1 = torch.where(bnd_b, robin_term, term1)
        term2 = torch.where(bnd_b[:, :, None], 0.0, term2)
        term3 = torch.where(bnd_b, 0.0, term3)

    # Galerkin integral on the face: Vᵀ(w ⊙ term); hanging faces are
    # masked out here and done by the mortar rows below
    cmask = mesh.conf_mask.reshape((E, nfaces) + ones).to(dtype)
    vt1 = _face_apply(Vq.T, wf * (term1 + term3), dim) * cmask
    vt2 = _face_apply(Vq.T, wf * term2, dim) * cmask[:, :, None]

    # lift to volume and accumulate: per face, the tangential Dᵀ terms act
    # within the face plane; the normal-direction Dᵀ of a lifted plane is
    # an outer product with one column of Dᵀ
    Dt = D.T
    for f in range(nfaces):
        dir_, side = divmod(f, 2)
        tang = [d for d in range(dim) if d != dir_]
        a = vt1[:, f]
        for l in tang:
            a = a + tensor.apply_axis(Dt, vt2[:, f, l], tang.index(l))
        axis = Au.ndim - 1 - dir_
        Au.select(axis, 0 if side == 0 else nl - 1).add_(a)
        dcol = Dt[:, 0] if side == 0 else Dt[:, -1]
        col_shape = [1] * Au.ndim
        col_shape[axis] = nl
        Au = Au + vt2[:, f, dir_].unsqueeze(axis) * dcol.reshape(col_shape)

    if mesh.hc_elem.shape[0] > 0:
        Au = Au + _apply_hanging(mesh, u_f, dudr_f, dtype,
                                 neighbors=neighbors)
    return Au


@functools.lru_cache(maxsize=None)
def _dense_grad_ops(deg, deg_quad, quad_key, dim):
    """Per-direction dense [nl^dim, nq^dim] operators G_l = ((⊗V)·D_l)ᵀ,
    flattened for [E, n] GEMMs: the volume stage as GEMMs with contraction
    nl^dim instead of per-axis contractions of size nl (host f64)."""
    from disco4est_tpu_torch.quadrature.quadrature import Quadrature

    V = Quadrature(quad_key).interp(deg, deg_quad)
    D = DB.ops(deg).diff

    def kron_all(mats):
        # direction 0 acts on the fastest (x) index: the LAST kron operand
        out = mats[-1]
        for m in mats[-2::-1]:
            out = np.kron(out, m)
        return out

    return [kron_all([V @ D if d == l else V for d in range(dim)]).T
            for l in range(dim)]


@functools.lru_cache(maxsize=64)
def _general_ops(deg, deg_quad, quad_key, dim, dtype, device):
    """The general apply's fixed operators as tensors of `dtype` on
    `device`, uploaded once per (operator, dtype, device)."""
    from disco4est_tpu_torch.quadrature.quadrature import Quadrature

    quad = Quadrature(quad_key)
    kw = dict(dtype=dtype, device=device)
    _, wq1 = quad.nodes_weights(deg_quad)
    return dict(
        D=torch.as_tensor(DB.ops(deg).diff, **kw),
        Vq=torch.as_tensor(quad.interp(deg, deg_quad), **kw),
        wf=tensor.tensor_weights([wq1] * (dim - 1), **kw),
        w3=tensor.tensor_weights([wq1] * dim, **kw),
        Gs=[torch.as_tensor(G, **kw)
            for G in _dense_grad_ops(deg, deg_quad, quad_key, dim)],
    )


def apply_mass(mesh: MeshData, v, on_quad: bool = False):
    """M v: nodal mass apply via quadrature
    (`d4est_quadrature_apply_mass_matrix`).  With `on_quad`, v is given at
    the volume quadrature points and only Vᵀ(wJ·v) is applied."""
    w = vol_weights(mesh, v.dtype)
    v_q = v if on_quad else vol_interp(mesh, v)
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
# face helpers shared with the estimator and the curved apply
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
    ops = _general_ops(mesh.deg, mesh.deg_quad, mesh.quad.kind, mesh.dim,
                       dtype, device)
    return ops["Vq"], ops["wf"]


def _gather_nd(field_flat, ne, nf, perm):
    """Neighbor rows of a [S, 2d, C..., n_flat] face array (C component
    axes) permuted into my frame: row (ne, nf) of every directed face,
    node j taken from the neighbor's node perm[..., j]."""
    S, F = field_flat.shape[:2]
    flat = field_flat.reshape((S * F,) + field_flat.shape[2:])
    g = flat[ne.long() * F + nf.long()]  # [E, 2d, C..., n_flat]
    idx = perm.reshape(perm.shape[:2] + (1,) * (g.ndim - 3)
                       + perm.shape[-1:])
    return torch.gather(g, -1, idx.expand(g.shape[:-1] + perm.shape[-1:]))


def _orient_transform(v, code: int, dim: int):
    """STATIC orientation transform of a face array [..., n2, n1] (dim-1
    trailing tangent axes): out[j2, j1] = v[i2(j), i1(j)] for the
    flip/flip/swap encoding of `mesh/faces.py:orientation_perm`."""
    if dim == 2:
        return torch.flip(v, dims=(-1,)) if (code & 1) else v
    if code & 4:
        v = v.transpose(-1, -2)
    if code & 1:
        v = torch.flip(v, dims=(-1,))
    if code & 2:
        v = torch.flip(v, dims=(-2,))
    return v


def _apply_orient_codes(v, code_arr, codes: tuple, dim: int):
    """Fix gathered neighbor face data whose source frame differs from
    mine: for each static orientation code present, transform the whole
    array and select the rows with that code."""
    shape = code_arr.shape + (1,) * (dim - 1)
    for c in codes:
        v = torch.where((code_arr == c).reshape(shape),
                        _orient_transform(v, c, dim), v)
    return v


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
    GEMMs against the static lift matrices, then each element's rows
    summed in the fixed order of their faces (`ops.rows.add_face_rows`;
    the JAX version's one-hot matmul, where an `index_add` would run as
    atomics on CUDA, ROADMAP C10).  Each (element, face) has one row."""
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
    out = add_face_rows(out, vol, elems, faces, 2 * dim)
    return out.reshape((E,) + (nl,) * dim)


@functools.lru_cache(maxsize=64)
def _mortar_ops(deg, dim, dtype, device):
    """The two 1D child interpolations hp[c] and the subface bits
    [K, dim-1] of the mortar pass, on `device`, uploaded once."""
    K = 1 << (dim - 1)
    hp = torch.as_tensor(np.stack([DB.hp_prolong(deg, deg, c)
                                   for c in (0, 1)]),
                         dtype=dtype, device=device)
    bits = torch.as_tensor([[(b >> t) & 1 for t in range(dim - 1)]
                            for b in range(K)], device=device)
    return hp, bits


def _apply_hanging(mesh: MeshData, u_f, dudr_f, dtype,
                   neighbors: str = "full"):
    """Hanging-face (nonconforming) mortar contributions, two batched
    passes:

    - COARSE rows (one per coarse hanging face): terms are computed on all
      K subfaces (the subface index is a batch axis), mass-projected back
      to the coarse face with Σ_b P_bᵀ;
    - FINE rows (one per fine element touching a coarse face): the mortar
      is the fine face itself; the coarse neighbor's trace is hp-prolonged
      onto it.

    `u_f` [E, 2d, nfl...] and `dudr_f` [E, 2d, dim, nfl...] are the face
    traces of u and of its reference gradient.  The other side's data
    reach each row through the mortar node permutations (`hc_perm_*`,
    `hf_perm_*`: the identity unless the mortar crosses reoriented tree
    faces).  `neighbors="zero"` drops the other side."""
    dim, deg = mesh.dim, mesh.deg
    nl, nq = deg + 1, mesh.nq
    nfl_flat, nfq_flat = nl ** (dim - 1), nq ** (dim - 1)
    fshape_l, fshape_q = (nl,) * (dim - 1), (nq,) * (dim - 1)
    K = 1 << (dim - 1)
    M = mesh.hc_elem.shape[0]
    E = u_f.shape[0]
    dev = u_f.device
    Vq, wf = _face_quad_ops(mesh, dtype, dev)
    ones = (1,) * (dim - 1)

    hp, bits = _mortar_ops(deg, dim, dtype, dev)  # [2, nl, nl], [K, dim-1]

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
    # the small contractions elementwise (as einsums they are batched
    # GEMVs over every point)
    dudx_m = (drst_m * du_m_q[:, :, :, None]).sum(2)

    # the fine neighbors' traces, permuted from each fine frame into the
    # coarse one
    fe2, ff2 = mesh.hc_fine.long(), mesh.hc_fine_face.long()
    perm_l, perm_q = mesh.hc_perm_l, mesh.hc_perm_q  # [M, K, n_flat]
    uf = torch.gather(u_f[fe2, ff2].reshape(M, K, nfl_flat), -1, perm_l)
    duf = torch.gather(dudr_f[fe2, ff2].reshape(M, K, dim, nfl_flat), -1,
                       perm_l[:, :, None].expand(M, K, dim, nfl_flat))
    drst_p = torch.gather(
        mesh.face_drst[fe2, ff2].to(dtype).reshape(M, K, dim, dim, nfq_flat),
        -1, perm_q[:, :, None, None].expand(M, K, dim, dim, nfq_flat))
    u_p_q = _face_apply(Vq, uf.reshape((M, K) + fshape_l), dim)
    du_p_q = _face_apply(Vq, duf.reshape((M, K, dim) + fshape_l), dim)
    dudx_p = (drst_p.reshape((M, K, dim, dim) + fshape_q)
              * du_p_q[:, :, :, None]).sum(2)
    if neighbors == "zero":
        u_p_q = torch.zeros_like(u_p_q)
        dudx_p = torch.zeros_like(dudx_p)

    sj = mesh.hc_sj.to(dtype)  # [M, K, nfq...]
    n = mesh.hc_n.to(dtype)  # [M, K, d, nfq...]
    jump = u_m_q - u_p_q
    term1 = -(n * (0.5 * (dudx_m + dudx_p))).sum(2) * sj
    drst_n = (drst_m * n[:, :, None]).sum(3)
    term2 = -0.5 * drst_n * (sj * jump)[:, :, None]
    if mesh.hc_sigma_q is not None:  # pointwise mortar penalty
        term3 = sj * mesh.hc_sigma_q.to(dtype) * jump
    else:
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
    dudx_m = (drst_m * du_m_q[:, :, None]).sum(1)

    # the coarse neighbor's trace prolonged onto my subface, then
    # permuted from the coarse frame into mine
    u_p, du_p = u_f[ce_rep, cf_rep], dudr_f[ce_rep, cf_rep]
    for t in range(dim - 1):
        mats = hp[(b_idx >> t) & 1]  # [Mf, nl, nl]
        u_p = _row_mat_apply(mats, u_p, t)
        du_p = _row_mat_apply(mats, du_p, t)
    hf_l, hf_q = mesh.hf_perm_l, mesh.hf_perm_q  # [Mf, n_flat]
    u_p = torch.gather(u_p.reshape(Mf, nfl_flat), -1, hf_l)
    du_p = torch.gather(du_p.reshape(Mf, dim, nfl_flat), -1,
                        hf_l[:, None].expand(Mf, dim, nfl_flat))
    # the coarse element's drst at my quadrature points, in my frame
    drst_p = torch.gather(
        mesh.hc_drst_m.to(dtype).reshape(Mf, dim, dim, nfq_flat), -1,
        hf_q[:, None, None].expand(Mf, dim, dim, nfq_flat),
    ).reshape(drst_m.shape)
    u_p_q = _face_apply(Vq, u_p.reshape((Mf,) + fshape_l), dim)
    du_p_q = _face_apply(Vq, du_p.reshape((Mf, dim) + fshape_l), dim)
    dudx_p = (drst_p * du_p_q[:, :, None]).sum(1)
    if neighbors == "zero":
        u_p_q = torch.zeros_like(u_p_q)
        dudx_p = torch.zeros_like(dudx_p)

    jump = u_m_q - u_p_q
    term1 = -(n * (0.5 * (dudx_m + dudx_p))).sum(1) * sj
    drst_n = (drst_m * n[:, None]).sum(2)
    term2 = -0.5 * drst_n * (sj * jump)[:, None]
    if mesh.hc_sigma_q is not None:
        # the coarse-frame pointwise penalty permuted into each fine frame
        sig_q = torch.gather(mesh.hc_sigma_q.to(dtype).reshape(Mf, nfq_flat),
                             -1, hf_q).reshape((Mf,) + fshape_q)
        term3 = sj * sig_q * jump
    else:
        term3 = sj * mesh.hc_sigma.to(dtype).reshape((Mf,) + ones) * jump

    vt13f = _face_apply(Vq.T, wf * (term1 + term3), dim)
    vt2f = _face_apply(Vq.T, wf * term2, dim)
    return Au + _lift_rows(fe, ff, vt13f, vt2f, E, deg, dim, dtype)
