"""Tree-structured SIPG apply for CURVED uniform multi-tree meshes.

Port of `disco4est_tpu/laplacian/curved.py` (reference analog:
`p4est_iterate`'s cache-ordered face sweep, `Mesh/d4est_mortars.c:601`).
On a UNIFORM multi-tree mesh every tree is a regular lattice, so with the
elements in (tree, z, y, x) order:

- every INTRA-tree neighbor sits at a constant offset {±1, ±nx, ±nx·ny}
  with the identity orientation: the trace exchange is one row gather at
  those offsets (the JAX version's six `jnp.roll` shifts, as one launch);
- the face traces of u and of its reference gradient at the face
  quadrature points come out of ONE GEMM against a static matrix (face
  selection, Dᵀ_l and V⊗V folded), and the volume term up to deg 4 is the
  dense GEMM form of the general apply (`sipg._dense_grad_ops`); on a
  GPU the apply is a few dozen launches, not hundreds;
- the per-point factors (sj, the pointwise σ, and drstn = (∂r/∂x)·n,
  precomputed per epoch) stream once per apply;
- the face math runs on [E, 2d, nfq] blocks, and the lift is ONE GEMM
  against a static matrix that folds VᵀW, the face placement and Dᵀ;
- the directed faces that cross tree boundaries (domain boundaries are
  handled in the sweep) are redone by one batch: two row gathers and the
  static orientation transforms; each such face has one row, which is
  written into its own (element, face) place of the face terms before
  the lift, so nothing is accumulated out of order (ROADMAP C10).

It is the apply of the f32 inner solve of the curved mixed solve
(`make_inner_solve`), in torch operations as the JAX package runs it in
plain XLA; it matches `sipg.apply_sipg` to roundoff (tests).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from disco4est_tpu_torch.laplacian import sipg as _sipg
from disco4est_tpu_torch.mesh.builder import MeshData, vol_interp
from disco4est_tpu_torch.mesh.tree import ROOT
from disco4est_tpu_torch.ops import tensor
from disco4est_tpu_torch.ops.operators import DB


@dataclasses.dataclass
class TreeStructured:
    """Per-epoch view of a uniform conforming multi-tree mesh (element-major
    tensors in LEX order)."""

    dim: int
    deg: int
    deg_quad: int
    quad_key: str
    deltas: tuple  # per face: intra-tree lex offset
    it_codes: tuple  # static set of the nonzero crossing-face codes
    perm: torch.Tensor  # [E] lex -> original
    inv_perm: torch.Tensor  # [E] original -> lex
    drstn: torch.Tensor  # [E, 2d, dim, nfq...] (∂r_l/∂x)·n
    sj: torch.Tensor  # [E, 2d, nfq...]
    sigma_q: torch.Tensor  # [E, 2d, nfq...] pointwise (or broadcast scalar)
    bnd: torch.Tensor  # [E, 2d] domain-boundary flag
    tmask: torch.Tensor  # [E, 2d] 1 = intra-tree conforming (rolled) face
    nbr_rows: torch.Tensor  # [E, 2d] trace row of the lex neighbor at the
    #                         face's offset: ((r + delta) mod E)·2d + f^1
    # crossing faces, rows ordered by (face, lex element); one padding row
    # (it_elem = E) when there is none
    it_elem: torch.Tensor  # [RT] lex element
    it_face: torch.Tensor  # [RT] own face id
    it_nbr_row: torch.Tensor  # [RT] neighbor row lex_elem·2d + face
    it_code: torch.Tensor  # [RT] orientation code
    it_sj: torch.Tensor  # [RT, nfq_flat] own-side factors
    it_sigq: torch.Tensor  # [RT, nfq_flat]
    it_drstn: torch.Tensor  # [RT, dim, nfq_flat]
    it_row: torch.Tensor  # [RT] own face row lex_elem·2d + face (E·2d for
    #                       the padding row)

    @property
    def n_elements(self) -> int:
        return self.perm.shape[0]

    @property
    def n_crossing(self) -> int:
        """Crossing-face rows (the padding row included)."""
        return self.it_elem.shape[0]

    def astype(self, dtype) -> "TreeStructured":
        """Cast every floating tensor to `dtype` (index and mask tables
        keep theirs)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dtype)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
            and getattr(self, f.name).is_floating_point()
        })


def build_tree_structured(mesh: MeshData):
    """Build the lex view, or None when the mesh is not uniform (adapted,
    mixed degrees).  The face classification is numpy array work on the
    host; the factors are gathered on the mesh's device."""
    forest = mesh.forest
    lv = np.asarray(forest.level)
    if lv.size == 0 or not np.all(lv == lv[0]):
        return None
    if mesh.hc_elem.shape[0] != 0:
        return None
    if bool((mesh.deg_e != mesh.deg).any()):
        return None
    dim = mesh.dim
    nfaces = 2 * dim
    E = mesh.n_elements
    L = int(lv[0])
    n1 = 1 << L
    if (E // n1**dim) * n1**dim != E:
        return None
    dev = mesh.device

    tree = np.asarray(forest.tree).astype(np.int64)
    coords = np.asarray(forest.anchor).astype(np.int64) // (ROOT >> L)
    strides = [n1**d for d in range(dim)]
    key = tree * n1**dim + sum(coords[:, d] * strides[d] for d in range(dim))
    perm = np.argsort(key, kind="stable")
    inv = np.empty(E, np.int64)
    inv[perm] = np.arange(E)

    nbr_e = mesh.nbr_elem.cpu().numpy().astype(np.int64)[perm]  # lex rows
    nbr_f = mesh.nbr_face.cpu().numpy().astype(np.int64)[perm]
    orient = mesh.orient_code.cpu().numpy()[perm]
    bnd = mesh.bnd_mask.cpu().numpy()[perm]
    deltas = tuple((1 if f % 2 else -1) * strides[f // 2]
                   for f in range(nfaces))

    # classify: tmask = intra-tree constant-offset faces (rolled); every
    # other non-boundary face crosses a tree face and goes to the batch
    r = np.arange(E)
    same_tree = tree[perm][:, None] == tree[nbr_e]
    tmask = (
        ~bnd
        & same_tree
        & (inv[nbr_e] - r[:, None] == np.asarray(deltas)[None, :])
        & (nbr_f == (np.arange(nfaces) ^ 1)[None, :])
        & (orient == 0)
    )
    cross_f, cross_r = np.nonzero((~bnd & ~tmask).T)  # ordered (f, r)
    RT = max(len(cross_r), 1)
    it_elem = np.full(RT, E, np.int64)
    it_face = np.zeros(RT, np.int64)
    it_nbr_row = np.full(RT, E * nfaces, np.int64)
    it_code = np.zeros(RT, np.int64)
    n = len(cross_r)
    it_elem[:n] = cross_r
    it_face[:n] = cross_f
    it_nbr_row[:n] = inv[nbr_e[cross_r, cross_f]] * nfaces + nbr_f[cross_r,
                                                                 cross_f]
    it_code[:n] = orient[cross_r, cross_f]

    nfq_flat = mesh.nq ** (dim - 1)
    perm_d = torch.as_tensor(perm, device=dev)
    drstn = (mesh.face_drst * mesh.face_n[:, :, None]).sum(3)[perm_d]
    sj = mesh.face_sj[perm_d]
    if mesh.sigma_q is not None:
        sigq = mesh.sigma_q[perm_d]
    else:
        sigq = mesh.sigma[perm_d].reshape(
            (E, nfaces) + (1,) * (dim - 1)).expand(sj.shape).contiguous()
    ecl = torch.as_tensor(np.minimum(it_elem, E - 1), device=dev)
    fcl = torch.as_tensor(it_face, device=dev)

    def rows(a, inner):
        return a.reshape((E, nfaces) + inner)[ecl, fcl]

    def idx(a):
        return torch.as_tensor(a, device=dev)

    return TreeStructured(
        dim=dim, deg=mesh.deg, deg_quad=mesh.deg_quad,
        quad_key=mesh.quad.kind, deltas=deltas,
        it_codes=tuple(sorted(set(int(c) for c in it_code) - {0})),
        perm=perm_d, inv_perm=idx(inv), drstn=drstn, sj=sj, sigma_q=sigq,
        bnd=idx(bnd), tmask=idx(tmask),
        nbr_rows=idx(((r[:, None] + np.asarray(deltas)[None, :]) % E)
                     * nfaces + (np.arange(nfaces) ^ 1)[None, :]),
        it_elem=idx(it_elem), it_face=fcl, it_nbr_row=idx(it_nbr_row),
        it_code=idx(it_code),
        it_sj=rows(sj, (nfq_flat,)), it_sigq=rows(sigq, (nfq_flat,)),
        it_drstn=rows(drstn, (dim, nfq_flat)),
        it_row=idx(it_elem * nfaces + it_face),
    )


@functools.lru_cache(maxsize=None)
def _lift_q_mats(deg: int, deg_quad: int, quad_key, dim: int):
    """Static [2d*(1+dim)*nfq, nv] matrix (host f64) mapping the per-face
    QUADRATURE-point terms (t13, t2_x, t2_y, t2_z) straight to volume
    contributions: its rows fold diag(w)·V (Galerkin), the face placement
    and Dᵀ_l for the symmetry components."""
    from disco4est_tpu_torch.laplacian.fast import _base_mats
    from disco4est_tpu_torch.quadrature.quadrature import Quadrature

    bm = _base_mats(deg, deg_quad, quad_key, dim)
    V = Quadrature(quad_key).interp(deg, deg_quad)  # [nq, nl]
    _, w = Quadrature(quad_key).nodes_weights(deg_quad)
    VF = np.kron(V, V) if dim == 3 else V  # [nfq_flat, nfl_flat]
    wf = np.asarray(w)
    for _ in range(dim - 2):
        wf = np.multiply.outer(np.asarray(w), wf)
    VW = wf.reshape(-1)[:, None] * VF  # t_q -> (VᵀW t)ᵀ rows
    rows = []
    for f in range(2 * dim):
        S = bm["sels"][f]  # [nfl, nv]
        rows.append(VW @ S)  # t13 lift
        for l in range(dim):
            rows.append(VW @ S @ bm["dvol"][l])  # t2_l lift (Dᵀ after)
    return np.concatenate(rows, axis=0)


@functools.lru_cache(maxsize=None)
def _trace_q_mats(deg: int, deg_quad: int, quad_key, dim: int):
    """Static [nv, 2d*(1+dim)*nfq] matrix (host f64): u_flat @ it gives,
    per face f, u and ∂u/∂r_l (l < dim) at the face quadrature points, in
    the row layout of `_lift_q_mats`."""
    from disco4est_tpu_torch.laplacian.fast import _base_mats
    from disco4est_tpu_torch.quadrature.quadrature import Quadrature

    bm = _base_mats(deg, deg_quad, quad_key, dim)
    V = Quadrature(quad_key).interp(deg, deg_quad)
    VF = np.kron(V, V) if dim == 3 else V  # [nfq_flat, nfl_flat]
    cols = []
    for f in range(2 * dim):
        sel = bm["sel_rows"][f]
        cols.append(bm["sels"][f].T @ VF.T)  # u at the face points
        for l in range(dim):
            cols.append(bm["dvol"][l][sel].T @ VF.T)  # ∂u/∂r_l there
    return np.concatenate(cols, axis=1)


@functools.lru_cache(maxsize=64)
def _device_ops(deg, deg_quad, quad_key, dim, dtype, device):
    """The apply's fixed operators on `device` in `dtype`, uploaded once:
    D, the trace and lift GEMM matrices, and the dense volume operators
    Gcat = [G_0 | ... | G_{dim-1}] ([nv, dim·nq^dim])."""
    kw = dict(dtype=dtype, device=device)
    Gs = _sipg._dense_grad_ops(deg, deg_quad, quad_key, dim)
    return dict(
        D=torch.as_tensor(DB.ops(deg).diff, **kw),
        W_tr=torch.as_tensor(_trace_q_mats(deg, deg_quad, quad_key, dim),
                             **kw),
        W=torch.as_tensor(_lift_q_mats(deg, deg_quad, quad_key, dim), **kw),
        Gcat=torch.as_tensor(np.concatenate(Gs, axis=1), **kw),
    )


def apply_tree_structured(ts: TreeStructured, mesh: MeshData, u_lex):
    """Au in LEX order.  `u_lex`: [E, nl, ...] nodal field in lex order;
    `mesh` supplies the volume factors: pass the lex-permuted mesh of
    `permute_mesh_lex`.

    The crossing faces' rows go into their own places of the face terms
    before the one lift GEMM, where the JAX version lifts them apart and
    adds them with a one-hot [E, RT] product (a TPU scatter-add lowers to
    a serial loop): the sum is the same up to rounding, and the same on
    every run."""
    dim, deg, deg_quad = ts.dim, ts.deg, ts.deg_quad
    nq = deg_quad + 1
    E = ts.n_elements
    dtype = u_lex.dtype
    nfaces = 2 * dim
    nfq_flat = nq ** (dim - 1)
    nv = (deg + 1) ** dim
    ops = _device_ops(deg, deg_quad, ts.quad_key, dim, dtype, u_lex.device)
    u2 = u_lex.reshape(E, nv)

    # ---- volume: Σ_lp Dᵀ_lp Vᵀ (w·J·Σ_l g_lp·g_l ⊙ V D_l u) ------------
    if mesh.rad_interp is None and deg <= 4:
        # dense GEMM form (the general apply's "dense" volume mode)
        Gcat = ops["Gcat"]
        t = (u2 @ Gcat).reshape(E, dim, -1)  # [E, l, nq^dim]
        # Σ_l wjgg[e, p, l, q]·t[e, l, q] elementwise: as an einsum it is a
        # batched GEMV over E·nq^dim tiny products (28 launches of cuBLAS's
        # gemv kernel at 1.8·10^6 batches, most of the solve's device time)
        s = (mesh.wjgg.to(dtype).reshape(E, dim, dim, -1)
             * t[:, None]).sum(2)
        Au = s.reshape(E, -1) @ Gcat.T
    else:
        # tensor path (takes the per-element radial rules)
        D = ops["D"]
        dudr = [tensor.apply_axis(D, u_lex, l) for l in range(dim)]
        t = [vol_interp(mesh, dudr[l]) for l in range(dim)]
        Au = torch.zeros_like(u_lex)
        for lp in range(dim):
            s = torch.zeros_like(t[0])
            for l in range(dim):
                s = s + mesh.wjgg[:, lp, l].to(dtype) * t[l]
            s = vol_interp(mesh, s, transpose=True)
            Au = Au + tensor.apply_axis(D.T, s, lp)
        Au = Au.reshape(E, nv)

    # ---- face traces at QUADRATURE points: one GEMM --------------------
    tq = (u2 @ ops["W_tr"]).reshape(E, nfaces, 1 + dim, nfq_flat)
    u_q = tq[:, :, 0]  # [E, 2d, nfq]
    drstn = ts.drstn.to(dtype).reshape(E, nfaces, dim, nfq_flat)
    sj = ts.sj.to(dtype).reshape(E, nfaces, nfq_flat)
    sigq = ts.sigma_q.to(dtype).reshape(E, nfaces, nfq_flat)
    dn = (drstn * tq[:, :, 1:]).sum(2)  # [E, 2d, nfq] n·∇u

    # ---- intra-tree faces: the neighbor rows at the lex offsets --------
    packed = torch.cat([u_q, dn], dim=-1).reshape(E * nfaces, 2 * nfq_flat)
    gath = packed[ts.nbr_rows].reshape(E, nfaces, 2 * nfq_flat)
    b = ts.bnd[..., None]
    u_p = torch.where(b, 0.0, gath[..., :nfq_flat])
    dn_p = torch.where(b, -dn, gath[..., nfq_flat:])
    c2 = torch.where(b, 2.0, 1.0).to(dtype)
    m = torch.where(b, 1.0, ts.tmask[..., None].to(dtype)).to(dtype)
    jump = (u_q - u_p) * m
    t13 = -0.5 * sj * (dn - dn_p) * m + sj * sigq * jump
    t2 = -0.5 * (c2 * sj * jump)[:, :, None] * drstn
    Z = torch.cat([t13[:, :, None], t2], dim=2)  # [E, 2d, 1+dim, nfq]

    # ---- crossing faces: one batch, written into their own face rows ---
    packed = torch.cat([packed, packed.new_zeros((1, 2 * nfq_flat))])
    RT = ts.n_crossing
    fshape_q = (nq,) * (dim - 1)
    own = packed[ts.it_row]
    nbr = packed[ts.it_nbr_row].reshape((RT, 2) + fshape_q)
    nbr = _sipg._apply_orient_codes(nbr, ts.it_code[:, None], ts.it_codes,
                                    dim)
    up_r = nbr[:, 0].reshape(RT, nfq_flat)
    dn_r = nbr[:, 1].reshape(RT, nfq_flat)
    um_r, dnm_r = own[:, :nfq_flat], own[:, nfq_flat:]
    sj_r = ts.it_sj.to(dtype)
    valid = (ts.it_elem < E).to(dtype)[:, None]
    jump = (um_r - up_r) * valid
    t13 = (-0.5 * sj_r * (dnm_r - dn_r) * valid
           + sj_r * ts.it_sigq.to(dtype) * jump)
    t2 = -0.5 * ts.it_drstn.to(dtype) * (sj_r * jump)[:, None]
    Zr = torch.cat([t13[:, None], t2], dim=1).reshape(RT, -1)
    # the sweep left these rows zero (masked); each (element, face) has one
    # row, so writing them is order-free, and one GEMM lifts all faces
    width = Zr.shape[1]
    Z = torch.cat([Z.reshape(E * nfaces, width), Z.new_zeros((1, width))])
    Z = Z.index_copy(0, ts.it_row, Zr)[:-1]
    Au = Au + Z.reshape(E, -1) @ ops["W"]
    return Au.reshape(u_lex.shape)


def permute_mesh_lex(ts: TreeStructured, mesh: MeshData) -> MeshData:
    """The mesh's element-major VOLUME arrays in lex order (the face stage
    reads the `ts` tensors; only the volume factors are needed here)."""
    def g(a):
        return None if a is None else a[ts.perm]

    return dataclasses.replace(mesh, wjgg=g(mesh.wjgg),
                               rad_interp=g(mesh.rad_interp),
                               rad_w=g(mesh.rad_w))


def to_lex(ts: TreeStructured, v):
    return v[ts.perm]


def from_lex(ts: TreeStructured, v):
    return v[ts.inv_perm]


def make_inner_solve(ts: TreeStructured, mesh_lex: MeshData, *,
                     rtol: float = 1e-4, max_iter: int = 400):
    """Inner-solve closure for `solvers.mixed.mixed_refine_solve`: CG on
    the tree-structured apply in lex order (the permutation is paid once
    per OUTER refinement step).  `ts` and `mesh_lex` =
    `permute_mesh_lex(ts, mesh)` come already cast to the inner dtype, once
    per epoch; each outer f64 correction contracts the error ~rtol."""
    from disco4est_tpu_torch.solvers.cg import cg_solve

    def inner(r32):
        res = cg_solve(lambda v: apply_tree_structured(ts, mesh_lex, v),
                       to_lex(ts, r32), atol=0.0, rtol=rtol,
                       max_iter=max_iter)
        return from_lex(ts, res.x), res.iterations

    return inner
