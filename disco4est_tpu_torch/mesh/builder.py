"""Mesh-data builder: per-epoch precomputation of all geometric factors.

Port of the affine subset of `disco4est_tpu/mesh/builder.py` (role of
the reference's `d4est_mesh_update` + `d4est_mesh_data_compute`,
`Mesh/d4est_mesh.c:2544-2791`).  After every mesh epoch the struct of
element-major factor tensors is rebuilt once, on the requested device, in
float64; kernels read them every solver iteration.

What this subset covers: conforming and 2:1 hanging faces (the mortar
tables, their coarse-side factors and the dense per-face hanging tables of
the GEMM-form apply), identity face orientations, the scalar penalty modes
(`volume_div_area`, `tree_h`, `j_div_sj_min_lobatto`) and the full
per-point factor arrays the driver builds (`store_full=True` in the JAX
package).  Non-identity orientations, the pointwise `j_div_sj_quad`
penalty and compactified quadrature raise `NotImplementedError` naming the
ROADMAP item that brings them.  On identity orientations the JAX mortar
tables' node permutations (`hc_perm_*`, `hf_perm_*`) are the identity, so
the port carries none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from disco4est_tpu_torch.geometry.base import Geometry
from disco4est_tpu_torch.mesh.faces import (
    BOUNDARY,
    CONF,
    build_face_tables,
    _tangent_axes,
)
from disco4est_tpu_torch.mesh.tree import Forest, ROOT
from disco4est_tpu_torch.ops import tensor
from disco4est_tpu_torch.ops.operators import DB
from disco4est_tpu_torch.quadrature.quadrature import Quadrature

F64 = torch.float64


@dataclasses.dataclass
class MeshData:
    """Everything the solvers need for one mesh epoch (affine subset of
    the JAX `MeshData`; field names and layouts are the same).

    Host metadata: `dim`, `deg`, `deg_quad`, `quad`, `geom`, `forest`,
    `affine`, `orth`, `iso`, `orient_codes`.  Every other field is a torch
    tensor on the mesh's device.
    """

    dim: int
    deg: int
    deg_quad: int
    quad: Quadrature
    geom: Geometry
    forest: Forest
    affine: bool
    orth: bool
    iso: bool
    orient_codes: tuple

    deg_e: torch.Tensor  # [E] int32 per-element degree (≤ deg)
    # --- volume arrays ---
    xyz_lobatto: torch.Tensor  # [E, dim, nl^dim...]
    xyz_quad: torch.Tensor  # [E, dim, nq^dim...]
    j_quad: torch.Tensor  # [E, nq^dim...]
    wjgg: torch.Tensor  # [E, dim, dim, nq^dim...]
    # --- face arrays, [E, 2d, ...], element's own frame ---
    face_xyz_lobatto: torch.Tensor  # [E, 2d, dim, nfl...]
    face_xyz_quad: torch.Tensor  # [E, 2d, dim, nfq...]
    face_sj: torch.Tensor  # [E, 2d, nfq...]
    face_n: torch.Tensor  # [E, 2d, dim, nfq...]
    face_drst: torch.Tensor  # [E, 2d, dim, dim, nfq...]
    face_h: torch.Tensor  # [E, 2d]
    volume: torch.Tensor  # [E]
    area: torch.Tensor  # [E, 2d]
    sigma: torch.Tensor  # [E, 2d] SIPG penalty per face
    # --- neighbor tables ---
    nbr_elem: torch.Tensor  # [E, 2d] int32
    nbr_face: torch.Tensor  # [E, 2d] int32
    bnd_mask: torch.Tensor  # [E, 2d] bool (True on physical boundary)
    conf_mask: torch.Tensor  # [E, 2d] bool (conforming or boundary)
    # --- hanging-face mortars (coarse-side rows [M], K = 2^{dim-1}) ---
    # In the COARSE element's face frame; hc_sj includes the subface
    # parametrization factor (1/2)^{dim-1} (the reference's halved
    # spanning vectors, `d4est_mortars.c` dqa/=2).
    hc_elem: torch.Tensor  # [M] int32
    hc_face: torch.Tensor  # [M] int32
    hc_fine: torch.Tensor  # [M, K] int32, mortar-subface order
    hc_fine_face: torch.Tensor  # [M, K] int32
    hc_sj: torch.Tensor  # [M, K, nfq...]
    hc_n: torch.Tensor  # [M, K, dim, nfq...] outward from the coarse elem
    hc_drst_m: torch.Tensor  # [M, K, dim, dim, nfq...] coarse drst
    hc_sigma: torch.Tensor  # [M, K]
    # --- dense per-face hanging tables (GEMM-form apply; None if M = 0) ---
    hang_code: torch.Tensor | None = None  # [E, 2d] int32: 0, or subface
    #                                        b+1 on the FINE side
    hang_sigma: torch.Tensor | None = None  # [E, 2d] mortar penalty there
    # --- compact affine factors (None for curved geometries) ---
    j_c: torch.Tensor | None = None  # [E]
    drdx_c: torch.Tensor | None = None  # [E, dim(l), dim(d)]
    wjgg_c: torch.Tensor | None = None  # [E, dim, dim]
    face_sj_c: torch.Tensor | None = None  # [E, 2d]
    face_n_c: torch.Tensor | None = None  # [E, 2d, dim]

    @property
    def device(self) -> torch.device:
        return self.deg_e.device

    @property
    def n_elements(self) -> int:
        return self.deg_e.shape[0]

    @property
    def nl(self) -> int:
        return self.deg + 1

    @property
    def nq(self) -> int:
        return self.deg_quad + 1

    @property
    def local_nodes(self) -> int:
        return self.n_elements * self.nl**self.dim

    def to(self, device) -> "MeshData":
        return self._map_tensors(lambda t: t.to(device))

    def astype(self, dtype) -> "MeshData":
        """Cast every floating tensor to `dtype` (index/bool tables keep
        theirs)."""
        return self._map_tensors(
            lambda t: t.to(dtype) if t.is_floating_point() else t
        )

    def _map_tensors(self, fn) -> "MeshData":
        return dataclasses.replace(
            self,
            **{
                f.name: fn(getattr(self, f.name))
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )

    def init_field(self, fcn):
        """fcn(x, y[, z]) at Lobatto nodes -> [E, nl...]
        (`d4est_mesh_init_field`, INIT_FIELD_ON_LOBATTO)."""
        return fcn(*[self.xyz_lobatto[:, d] for d in range(self.dim)])

    def boundary_values(self, fcn):
        """fcn at face Lobatto nodes -> [E, 2d, nfl...] (Dirichlet data)."""
        return fcn(*[self.face_xyz_lobatto[:, :, d] for d in range(self.dim)])

    def l2_norm_sqr(self, u):
        """∫ u² J dV per element -> [E] (`d4est_mesh_compute_l2_norm_sqr`)."""
        u_q = vol_interp(self, u)
        w = vol_weights(self, u.dtype)
        integrand = w * self.j_quad.to(u.dtype) * u_q * u_q
        return torch.sum(integrand.reshape(u.shape[0], -1), dim=1)


def vol_interp(mesh: MeshData, v, transpose: bool = False):
    """Interpolate a volume field to (or Galerkin-transpose from) the
    volume quadrature points."""
    Vq = torch.as_tensor(
        mesh.quad.interp(mesh.deg, mesh.deg_quad), dtype=v.dtype,
        device=v.device,
    )
    return tensor.apply_iso(Vq.T if transpose else Vq, v, mesh.dim)


def vol_weights(mesh: MeshData, dtype):
    """Tensor volume quadrature weights [nq]*dim."""
    _, w1 = mesh.quad.nodes_weights(mesh.deg_quad)
    return tensor.tensor_weights([w1] * mesh.dim, dtype=dtype,
                                 device=mesh.device)


_NON_TENSOR = {
    "dim", "deg", "deg_quad", "quad", "geom", "forest", "affine", "orth",
    "iso", "orient_codes",
}


def mesh_from_numpy(arrays: dict, meta: dict, device) -> MeshData:
    """Build a port `MeshData` from another builder's fields given as
    numpy arrays (e.g. the JAX package's `MeshData` converted leaf by
    leaf).  `meta` holds the host metadata: dim, deg, deg_quad, quad (a
    `Quadrature` or its kind string), geom, forest (the port's own
    geometry and forest objects), affine, orth, iso, orient_codes."""
    quad = meta["quad"]
    if isinstance(quad, str):
        quad = Quadrature(quad)
    fields = {}
    for f in dataclasses.fields(MeshData):
        if f.name in _NON_TENSOR:
            continue
        a = arrays.get(f.name)
        fields[f.name] = None if a is None else torch.as_tensor(
            np.array(a), device=device
        )
    if tuple(meta["orient_codes"]):
        raise NotImplementedError(
            "non-identity face orientations need the general apply "
            "(ROADMAP A8)"
        )
    return MeshData(
        dim=int(meta["dim"]), deg=int(meta["deg"]),
        deg_quad=int(meta["deg_quad"]), quad=quad, geom=meta["geom"],
        forest=meta["forest"], affine=bool(meta["affine"]),
        orth=bool(meta["orth"]), iso=bool(meta["iso"]),
        orient_codes=tuple(meta["orient_codes"]), **fields,
    )


def build_mesh(
    geom: Geometry,
    forest: Forest,
    deg: int,
    quad: Quadrature | None = None,
    deg_quad: int | None = None,
    penalty_prefactor: float = 2.0,
    penalty_fcn: str = "maxp_sqr_over_minh",
    deg_e: np.ndarray | None = None,
    face_h_type: str = "volume_div_area",
    compactified_k: int | None = None,
    *,
    device,
) -> MeshData:
    """Build one mesh epoch on `device`.  `deg_e` (optional [E] int): true
    per-element degrees (penalties use them); storage stays at `deg`."""
    if compactified_k is not None:
        raise NotImplementedError(
            "compactified quadrature is not ported yet (ROADMAP A11)"
        )
    if face_h_type == "j_div_sj_quad":
        raise NotImplementedError(
            "the pointwise j_div_sj_quad penalty is not ported yet "
            "(ROADMAP A11)"
        )
    if face_h_type not in ("volume_div_area", "tree_h",
                           "j_div_sj_min_lobatto"):
        raise ValueError(f"unknown face_h_type {face_h_type!r}")
    device = torch.device(device)
    quad = quad or Quadrature("legendre")
    deg_quad = deg if deg_quad is None else deg_quad
    dim = forest.dim
    E = forest.n_elements
    nfaces = 2 * dim

    if deg_e is None:
        deg_e = np.full(E, deg, np.int32)
    else:
        deg_e = np.asarray(deg_e, np.int32)
        if deg_e.max(initial=0) > deg:
            raise ValueError("deg_e exceeds storage degree")

    ft = build_face_tables(forest)
    if ft.orient.any() or ft.hc_orient.any():
        raise NotImplementedError(
            "non-identity face orientations need the general apply "
            "(ROADMAP A8)"
        )
    orient_codes = ()
    affine = bool(getattr(geom, "is_affine", False))

    kw = dict(dtype=F64, device=device)
    tree = torch.as_tensor(forest.tree.astype(np.int64), device=device)
    anchor = torch.as_tensor(forest.anchor, **kw) / ROOT
    hfrac = torch.as_tensor(2.0 ** -forest.level.astype(np.float64), **kw)
    nbr_elem = torch.as_tensor(ft.nbr_elem.astype(np.int64), device=device)
    nbr_face = torch.as_tensor(ft.nbr_face.astype(np.int64), device=device)
    deg_e_f = torch.as_tensor(deg_e, **kw)
    penalty = (penalty_fcn, float(penalty_prefactor))

    compact = {}
    if affine:
        compact = _compute_affine_factors(
            geom, dim, penalty, tree, anchor, hfrac, nbr_elem, nbr_face,
            deg_e_f,
        )
        compact = {
            k: compact[k]
            for k in ("j_c", "drdx_c", "wjgg_c", "face_sj_c", "face_n_c")
        }
    fac = _compute_all_factors(
        geom, dim, deg, deg_quad, quad, penalty, tree, anchor, hfrac,
        nbr_elem, nbr_face, deg_e_f,
    )
    face_h_lob = fac.pop("face_h_lob")

    bnd = torch.as_tensor(ft.kind == BOUNDARY, device=device)
    if face_h_type != "volume_div_area":
        # recompute the penalty from the selected h
        # (`Mesh/d4est_mesh.c:650-800`); store it as face_h, which the
        # estimator prefactors read
        if face_h_type == "tree_h":
            th = hfrac[:, None].expand(E, nfaces).contiguous()
            h_m = th
        else:
            h_m = face_h_lob
        h_p = torch.where(bnd, h_m, h_m[nbr_elem, nbr_face])
        p_m = deg_e_f[:, None].expand(E, nfaces)
        p_p = deg_e_f[nbr_elem]
        fac["sigma"] = sigma_from_degrees(
            penalty_fcn, float(penalty_prefactor), p_m, p_p, h_m, h_p
        )
        fac["face_h"] = h_m

    mortar = _mortar_tables(
        geom, ft, forest, deg_quad, quad, penalty, deg_e, fac["face_h"],
        device,
    )
    kind = torch.as_tensor(ft.kind.astype(np.int64), device=device)
    return MeshData(
        dim=dim,
        deg=deg,
        deg_quad=deg_quad,
        quad=quad,
        geom=geom,
        forest=forest,
        affine=affine,
        orth=affine and bool(getattr(geom, "is_orthogonal", False)),
        iso=affine and bool(getattr(geom, "is_isotropic", False)),
        orient_codes=orient_codes,
        deg_e=torch.as_tensor(deg_e, dtype=torch.int32, device=device),
        nbr_elem=nbr_elem.to(torch.int32),
        nbr_face=nbr_face.to(torch.int32),
        bnd_mask=bnd,
        conf_mask=(kind == CONF) | (kind == BOUNDARY),
        **mortar,
        **fac,
        **compact,
    )


def _mortar_tables(geom, ft, forest, deg_quad, quad, penalty, deg_e,
                   face_h, device):
    """Hanging-mortar rows and the dense per-face hanging tables
    (JAX `build_mesh`, `builder.py:524-610`).  The mortar penalty takes
    h_m = the coarse full face's h and h_p = the fine element's face h,
    both of the selected face_h_type (`face_h`), and the true degrees."""
    penalty_fcn, penalty_prefactor = penalty
    dim = forest.dim
    E, nfaces = ft.kind.shape
    M = len(ft.hc_elem)
    K = 1 << (dim - 1)
    kw = dict(dtype=F64, device=device)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    ce, cf = idx(ft.hc_elem), idx(ft.hc_face)
    fe, ff = idx(ft.hc_fine), idx(ft.hc_fine_face)
    out = dict(
        hc_elem=ce.to(torch.int32), hc_face=cf.to(torch.int32),
        hc_fine=fe.reshape(M, K).to(torch.int32),
        hc_fine_face=ff.reshape(M, K).to(torch.int32),
    )
    mfac = _compute_mortar_factors(
        geom, dim, deg_quad, quad, K, idx(forest.tree[ft.hc_elem]),
        torch.as_tensor(forest.anchor[ft.hc_elem], **kw).reshape(M, dim)
        / ROOT,
        torch.as_tensor(2.0 ** -forest.level[ft.hc_elem].astype(np.float64),
                        **kw),
        cf,
    )
    fe, ff = fe.reshape(M, K), ff.reshape(M, K)
    h_c = face_h[ce, cf][:, None].expand(M, K)
    h_f = face_h[fe, ff]
    deg_t = torch.as_tensor(deg_e, **kw)
    p_c = deg_t[ce][:, None].expand(M, K)
    hc_sigma = sigma_from_degrees(penalty_fcn, penalty_prefactor, p_c,
                                  deg_t[fe], h_c, h_f)
    out.update(hc_sj=mfac["sj"], hc_n=mfac["n"], hc_drst_m=mfac["drst"],
               hc_sigma=hc_sigma)
    if M > 0:
        b = torch.arange(1, K + 1, dtype=torch.int32, device=device)
        hang_code = torch.zeros((E, nfaces), dtype=torch.int32,
                                device=device)
        hang_code[fe, ff] = b.expand(M, K)
        hang_sigma = torch.zeros((E, nfaces), **kw)
        hang_sigma[fe, ff] = hc_sigma
        out.update(hang_code=hang_code, hang_sigma=hang_sigma)
    return out


def sigma_from_degrees(penalty_fcn, pf, p_m, p_p, h_m, h_p):
    """SIPG penalty σ from both sides' (degree, h) — the reference's
    penalty-function library (`d4est_laplacian_flux_sipg.c:946-1005`)."""
    if penalty_fcn == "maxp_sqr_over_minh":
        return pf * torch.maximum(p_m, p_p) ** 2 / torch.minimum(h_m, h_p)
    if penalty_fcn == "maxpp1_sqr_over_minh":
        return pf * (torch.maximum(p_m, p_p) + 1.0) ** 2 / torch.minimum(
            h_m, h_p
        )
    if penalty_fcn == "meanp_sqr_over_meanh":
        return pf * (0.5 * (p_m + p_p)) ** 2 / (0.5 * (h_m + h_p))
    if penalty_fcn == "mean_p_sqr_over_h":
        return pf * 0.5 * (p_m**2 / h_m + p_p**2 / h_p)
    raise ValueError(penalty_fcn)


def _compute_all_factors(geom, dim, deg, deg_quad, quad, penalty, tree,
                         anchor, hfrac, nbr_elem, nbr_face, deg_e):
    """All per-point geometric factor tensors of one mesh epoch."""
    penalty_fcn, penalty_prefactor = penalty
    E = tree.shape[0]
    nfaces = 2 * dim
    dev = anchor.device
    xl = DB.ops(deg).lobatto_nodes
    xq, wq = quad.nodes_weights(deg_quad)

    vol_pts_l = _tensor_points(xl, dim, dev)
    vol_pts_q = _tensor_points(xq, dim, dev)

    j_quad, drdx = _factors(geom, tree, anchor, hfrac, vol_pts_q)
    xyz_l = _positions(geom, tree, anchor, hfrac, vol_pts_l)
    xyz_q = _positions(geom, tree, anchor, hfrac, vol_pts_q)
    w3 = tensor.tensor_weights([wq] * dim, device=dev)

    # wjgg[l,lp] = w * J * Σ_k drdx[l,k] drdx[lp,k]
    gg = torch.einsum("e...lk,e...mk->e...lm", drdx, drdx)
    wjgg = (w3[None] * j_quad)[..., None, None] * gg
    wjgg = torch.movedim(torch.movedim(wjgg, -1, 1), -1, 1)

    wf = tensor.tensor_weights([wq] * (dim - 1), device=dev)
    face_sj, face_n, face_drst, face_xyz_l, face_xyz_q, area = (
        [], [], [], [], [], []
    )
    face_h_lob = []
    for f in range(nfaces):
        pts_q = _face_points(xq, dim, f, dev)
        pts_l = _face_points(xl, dim, f, dev)
        fJ, fdrdx = _factors(geom, tree, anchor, hfrac, pts_q)
        sj, n = _surface_jacobian(fJ, fdrdx, f)
        # FACE_H_EQ_J_DIV_SJ_MIN_LOBATTO (`d4est_mesh.c:730-741`)
        lJ, ldrdx = _factors(geom, tree, anchor, hfrac, pts_l)
        lsj, _ = _surface_jacobian(lJ, ldrdx, f)
        face_h_lob.append(torch.amin((lJ / lsj).reshape(E, -1), dim=1))
        face_sj.append(sj)
        face_n.append(torch.movedim(n, -1, 1))
        face_drst.append(torch.movedim(torch.movedim(fdrdx, -1, 1), -1, 1))
        face_xyz_l.append(
            torch.movedim(_positions(geom, tree, anchor, hfrac, pts_l), -1, 1)
        )
        face_xyz_q.append(
            torch.movedim(_positions(geom, tree, anchor, hfrac, pts_q), -1, 1)
        )
        area.append(torch.sum((wf * sj).reshape(E, -1), dim=1))

    area = torch.stack(area, dim=1)
    volume = torch.sum((w3 * j_quad).reshape(E, -1), dim=1)
    face_h = volume[:, None] / area  # FACE_H_EQ_VOLUME_DIV_AREA

    h_m = face_h
    h_p = face_h[nbr_elem, nbr_face]
    p_m = deg_e[:, None].expand(h_m.shape)
    p_p = deg_e[nbr_elem]  # boundary faces: nbr = self ⇒ p_p = p_m
    sigma = sigma_from_degrees(
        penalty_fcn, penalty_prefactor, p_m, p_p, h_m, h_p
    )
    return dict(
        xyz_lobatto=torch.movedim(xyz_l, -1, 1),
        xyz_quad=torch.movedim(xyz_q, -1, 1),
        j_quad=j_quad,
        wjgg=wjgg,
        face_xyz_lobatto=torch.stack(face_xyz_l, dim=1),
        face_xyz_quad=torch.stack(face_xyz_q, dim=1),
        face_sj=torch.stack(face_sj, dim=1),
        face_n=torch.stack(face_n, dim=1),
        face_drst=torch.stack(face_drst, dim=1),
        face_h=face_h,
        volume=volume,
        area=area,
        sigma=sigma,
        face_h_lob=torch.stack(face_h_lob, dim=1),
    )


def _compute_affine_factors(geom, dim, penalty, tree, anchor, hfrac,
                            nbr_elem, nbr_face, deg_e):
    """Compact per-element factors for affine geometries: one evaluation
    at the element center (exact when `geom.is_affine`).  `wjgg_c`
    excludes the quadrature weights."""
    penalty_fcn, penalty_prefactor = penalty
    center = torch.zeros((1, dim), dtype=F64, device=anchor.device)
    J, drdx = _factors(geom, tree, anchor, hfrac, center)
    j_c = J[:, 0]
    drdx_c = drdx[:, 0]
    gg = torch.einsum("elk,emk->elm", drdx_c, drdx_c)
    wjgg_c = j_c[:, None, None] * gg

    sj_list, n_list = [], []
    for f in range(2 * dim):
        a0, side = divmod(f, 2)
        sign = -1.0 if side == 0 else 1.0
        ntilde = sign * j_c[:, None] * drdx_c[:, a0, :]
        sj = torch.sqrt(torch.sum(ntilde**2, dim=-1))
        sj_list.append(sj)
        n_list.append(ntilde / sj[:, None])
    face_sj_c = torch.stack(sj_list, dim=1)
    face_n_c = torch.stack(n_list, dim=1)
    return dict(
        j_c=j_c, drdx_c=drdx_c, wjgg_c=wjgg_c, face_sj_c=face_sj_c,
        face_n_c=face_n_c,
    )


def _compute_mortar_factors(geom, dim, deg_quad, quad, K, tree, anchor,
                            hfrac, cf):
    """Coarse-side geometry factors on hanging-mortar subfaces.

    For each mortar row (a coarse element's hanging face `cf`) and each of
    its K subfaces: sj (including the subface parametrization factor
    (1/2)^{dim-1}), outward unit normal and ∂r/∂x of the COARSE element at
    the subface quadrature points, as [M, K, ...] tensors.  The JAX
    function's mortar-sized j/sj feeds only the pointwise penalty, which
    comes with ROADMAP A11."""
    dev = anchor.device
    M = tree.shape[0]
    xq, _ = quad.nodes_weights(deg_quad)
    a0 = cf // 2
    sign = torch.where(cf % 2 == 0, -1.0, 1.0).to(F64)
    npts = dim - 1
    sjs, ns, drsts = [], [], []
    for b in range(K):
        # [2d, nfq..., dim] points of subface b of every face, row-selected
        pts = torch.stack([_subface_points(xq, dim, f, b, dev)
                           for f in range(2 * dim)])[cf]  # [M, nfq..., dim]
        a = anchor.reshape((M,) + (1,) * npts + (dim,))
        h = hfrac.reshape((M,) + (1,) * (npts + 1))
        rst_tree = a + (pts + 1.0) * 0.5 * h
        t = tree.reshape((M,) + (1,) * npts)
        dx = geom.dx(t, rst_tree) * (0.5 * h[..., None])
        J = _det(dx)
        drdx = _inv(dx, J)  # [M, nfq..., l, d]
        row = a0.reshape((M,) + (1,) * npts + (1, 1)).expand(
            drdx.shape[:-2] + (1, dim))
        ntilde = (sign.reshape((M,) + (1,) * (npts + 1)) * J[..., None]
                  * torch.gather(drdx, -2, row).squeeze(-2))
        sj = torch.sqrt(torch.sum(ntilde**2, dim=-1))
        n = ntilde / sj[..., None]
        sjs.append(sj * 0.5 ** (dim - 1))
        ns.append(torch.movedim(n, -1, 1))
        drsts.append(torch.movedim(torch.movedim(drdx, -1, 1), -1, 1))
    return {
        "sj": torch.stack(sjs, dim=1),
        "n": torch.stack(ns, dim=1),
        "drst": torch.stack(drsts, dim=1),
    }


def _subface_points(x1, dim: int, face: int, b: int, device):
    """Reference points of subface `b` of `face` (coarse element coords):
    the tangent-axis intervals are halved according to b's bits (bit 0 ↦
    the faster tangent axis).  [nf_shape..., dim]."""
    a0, side = divmod(face, 2)
    tang = _tangent_axes(dim, face)
    x1 = np.asarray(x1)

    def sub(x, bit):
        return 0.5 * (x - 1.0) if bit == 0 else 0.5 * (x + 1.0)

    n = len(x1)
    if dim == 2:
        pts = np.zeros((n, dim))
        pts[:, tang[0]] = sub(x1, b & 1)
    else:
        t1, t2 = tang
        g2, g1 = np.meshgrid(sub(x1, (b >> 1) & 1), sub(x1, b & 1),
                             indexing="ij")
        pts = np.zeros((n, n, dim))
        pts[..., t1] = g1
        pts[..., t2] = g2
    pts[..., a0] = -1.0 if side == 0 else 1.0
    return torch.as_tensor(pts, dtype=F64, device=device)


# ---------------------------------------------------------------------------
# geometry evaluation helpers
# ---------------------------------------------------------------------------


def _tensor_points(x1, dim: int, device):
    """[n^dim grid shaped (n_z, n_y, n_x), dim] reference points; component
    d of the last axis is the coordinate along direction d (x = dir 0)."""
    x = torch.as_tensor(np.asarray(x1), dtype=F64, device=device)
    grids = torch.meshgrid(*([x] * dim), indexing="ij")
    return torch.stack([grids[dim - 1 - d] for d in range(dim)], dim=-1)


def _face_points(x1, dim: int, face: int, device):
    """Reference points of a face: [nf_shape..., dim]."""
    a0, side = divmod(face, 2)
    tang = _tangent_axes(dim, face)
    x = torch.as_tensor(np.asarray(x1), dtype=F64, device=device)
    n = x.shape[0]
    edge = -1.0 if side == 0 else 1.0
    if dim == 2:
        pts = torch.zeros((n, dim), dtype=F64, device=device)
        pts[:, tang[0]] = x
        pts[:, a0] = edge
        return pts
    t1, t2 = tang  # t1 fast
    g2, g1 = torch.meshgrid(x, x, indexing="ij")
    pts = torch.zeros((n, n, dim), dtype=F64, device=device)
    pts[..., t1] = g1
    pts[..., t2] = g2
    pts[..., a0] = edge
    return pts


def _element_frame(tree, anchor, hfrac, r_pts):
    """Per-element tree coordinates of reference points: (tree broadcast to
    [E, 1...], rst_tree [E, pts..., dim], h [E, 1..., 1])."""
    E, dim = anchor.shape
    npts = r_pts.ndim - 1
    a = anchor.reshape((E,) + (1,) * npts + (dim,))
    h = hfrac.reshape((E,) + (1,) * (npts + 1))
    rst_tree = a + (r_pts + 1.0) * 0.5 * h
    return tree.reshape((E,) + (1,) * npts), rst_tree, h


def _positions(geom, tree, anchor, hfrac, r_pts):
    """xyz at reference points: [E, pts_shape..., dim]."""
    t, rst_tree, _ = _element_frame(tree, anchor, hfrac, r_pts)
    return geom.x(t, rst_tree)


def _factors(geom, tree, anchor, hfrac, r_pts):
    """J [E, pts...] and drdx [E, pts..., dim(l), dim(d)] with
    drdx[..., l, d] = ∂r_l/∂x_d (element reference coordinates)."""
    t, rst_tree, h = _element_frame(tree, anchor, hfrac, r_pts)
    dxdr = geom.dx(t, rst_tree) * (0.5 * h[..., None])
    J = _det(dxdr)
    return J, _inv(dxdr, J)


def _det(m):
    if m.shape[-1] == 2:
        return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def _inv(m, det):
    """Inverse of [..., i, j] returned as [..., j, i]: entry [l, d] is
    ∂r_l/∂x_d given m[i, j] = ∂x_i/∂r_j."""
    if m.shape[-1] == 2:
        inv = torch.stack(
            [
                torch.stack([m[..., 1, 1], -m[..., 0, 1]], -1),
                torch.stack([-m[..., 1, 0], m[..., 0, 0]], -1),
            ],
            -2,
        )
        return inv / det[..., None, None]
    cof = torch.stack(
        [
            torch.stack(
                [
                    m[..., (i + 1) % 3, (j + 1) % 3] * m[..., (i + 2) % 3, (j + 2) % 3]
                    - m[..., (i + 1) % 3, (j + 2) % 3] * m[..., (i + 2) % 3, (j + 1) % 3]
                    for j in range(3)
                ],
                -1,
            )
            for i in range(3)
        ],
        -2,
    )  # cof[..., i, j]
    return torch.swapaxes(cof, -1, -2) / det[..., None, None]


def _surface_jacobian(J, drdx, face: int):
    """sj and unit outward normal at face points: ñ_d = sign·J·∂r_{a0}/∂x_d,
    sj = |ñ|, n = ñ/sj (`Mesh/d4est_mortars.c` sj/n computation)."""
    a0, side = divmod(face, 2)
    sign = -1.0 if side == 0 else 1.0
    ntilde = sign * J[..., None] * drdx[..., a0, :]
    sj = torch.sqrt(torch.sum(ntilde**2, dim=-1))
    return sj, ntilde / sj[..., None]
