"""Mesh-data builder: per-epoch precomputation of all geometric factors.

Port of `disco4est_tpu/mesh/builder.py` (role of the reference's
`d4est_mesh_update` + `d4est_mesh_data_compute`,
`Mesh/d4est_mesh.c:2544-2791`).  After every mesh epoch the struct of
element-major factor tensors is rebuilt once, on the requested device, in
float64; kernels read them every solver iteration.

It covers affine and curved geometries (bricks, cubed spheres),
conforming and 2:1 hanging faces with any face orientation (the neighbor
node permutations `perm_*`, the mortar permutations `hc_perm_*` /
`hf_perm_*` and the static set `orient_codes`), the four penalty modes of
`[mesh_parameters] face_h_type` (the pointwise `j_div_sj_quad` mode as
`sigma_q` and `hc_sigma_q`), the compactified radial volume quadrature
(`compactified_k`: `rad_interp`, `rad_w` and the per-element volume
factors), and the full per-point factor arrays the driver builds
(`store_full=True` in the JAX package).  Geometric factors are torch on
the mesh's device; the face tables, orientation codes and compactified
rules are host numpy.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from disco4est_tpu_torch.geometry.base import Geometry
from disco4est_tpu_torch.mesh.faces import (
    BOUNDARY,
    CONF,
    build_face_tables,
    orientation_perm,
    _orientation_code,
    _tangent_axes,
)
from disco4est_tpu_torch.mesh.tree import Forest, ROOT
from disco4est_tpu_torch.ops import tensor
from disco4est_tpu_torch.ops.operators import DB
from disco4est_tpu_torch.quadrature.quadrature import Quadrature

F64 = torch.float64


@dataclasses.dataclass
class MeshData:
    """Everything the solvers need for one mesh epoch (the JAX
    `MeshData`; field names and layouts are the same).

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
    # neighbor node permutations: my face node j is the neighbor's face
    # node perm[j] (identity within a tree and across aligned trees)
    perm_l: torch.Tensor  # [E, 2d, nfl_flat] int64, Lobatto nodes
    perm_q: torch.Tensor  # [E, 2d, nfq_flat] int64, quadrature points
    orient_code: torch.Tensor  # [E, 2d] int32 face orientation code
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
    hc_perm_l: torch.Tensor  # [M, K, nfl_flat] fine frame -> coarse frame
    hc_perm_q: torch.Tensor  # [M, K, nfq_flat]
    hc_sj: torch.Tensor  # [M, K, nfq...]
    hc_n: torch.Tensor  # [M, K, dim, nfq...] outward from the coarse elem
    hc_drst_m: torch.Tensor  # [M, K, dim, dim, nfq...] coarse drst
    hc_sigma: torch.Tensor  # [M, K]
    # fine-side rows, flattened (m, b) -> row m*K + b
    hf_perm_l: torch.Tensor  # [M*K, nfl_flat] coarse frame -> fine frame
    hf_perm_q: torch.Tensor  # [M*K, nfq_flat]
    # --- pointwise penalty (j_div_sj_quad only; None otherwise) ---
    # h = J/sj at each face quadrature point, the neighbor's h point-aligned
    # through perm_q (`d4est_mesh.c:650-661`,
    # `d4est_laplacian_with_opt_flux_sipg.c:622-636`)
    sigma_q: torch.Tensor | None = None  # [E, 2d, nfq...]
    hc_sigma_q: torch.Tensor | None = None  # [M, K, nfq...] coarse frame
    # --- dense per-face hanging tables (GEMM-form apply; None if M = 0 or
    # a mortar is reoriented) ---
    hang_code: torch.Tensor | None = None  # [E, 2d] int32: 0, or subface
    #                                        b+1 on the FINE side
    hang_sigma: torch.Tensor | None = None  # [E, 2d] mortar penalty there
    # --- per-element radial quadrature (compactified outer shells) ---
    # (`d4est_quadrature_compactified.c` role: the radial direction of
    # outer-shell elements integrates the rational weight exactly; plain
    # Gauss rows elsewhere)
    rad_interp: torch.Tensor | None = None  # [E, nq, nl] Lobatto -> points
    rad_w: torch.Tensor | None = None  # [E, nq] radial weights
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

    def init_field_on_quad(self, fcn):
        """fcn at the volume quadrature points -> [E, nq...]."""
        return fcn(*[self.xyz_quad[:, d] for d in range(self.dim)])

    def boundary_values(self, fcn):
        """fcn at face Lobatto nodes -> [E, 2d, nfl...] (Dirichlet data)."""
        return fcn(*[self.face_xyz_lobatto[:, :, d] for d in range(self.dim)])

    def boundary_values_quad(self, fcn):
        """fcn at face quadrature points -> [E, 2d, nfq...] (Robin
        coefficients, EVAL_BNDRY_FCN_ON_QUAD)."""
        return fcn(*[self.face_xyz_quad[:, :, d] for d in range(self.dim)])

    def l2_norm_sqr(self, u):
        """∫ u² J dV per element -> [E] (`d4est_mesh_compute_l2_norm_sqr`)."""
        u_q = vol_interp(self, u)
        w = vol_weights(self, u.dtype)
        integrand = w * self.j_quad.to(u.dtype) * u_q * u_q
        return torch.sum(integrand.reshape(u.shape[0], -1), dim=1)


def vol_interp(mesh: MeshData, v, transpose: bool = False):
    """Interpolate a volume field to (or Galerkin-transpose from) the
    volume quadrature points, through the per-element radial rule
    (`rad_interp`) where the mesh has one."""
    Vq = _interp_on(mesh.deg, mesh.deg_quad, mesh.quad.kind, v.dtype,
                    v.device)
    A = Vq.T if transpose else Vq
    if mesh.rad_interp is None:
        return tensor.apply_iso(A, v, mesh.dim)
    for d in range(mesh.dim - 1):  # tangential directions share Vq
        v = tensor.apply_axis(A, v, d)
    R = mesh.rad_interp.to(v.dtype)
    if transpose:
        R = R.transpose(-1, -2)
    ax = v.ndim - mesh.dim  # radial = direction dim-1, the slowest axis
    out = torch.einsum("eab,e...b->e...a", R, torch.movedim(v, ax, -1))
    return torch.movedim(out, -1, ax)


@functools.lru_cache(maxsize=64)
def _interp_on(deg, deg_quad, quad_key, dtype, device):
    """The Lobatto -> quadrature interpolation as a tensor on `device`,
    uploaded once (a copy from pageable host memory per call would wait
    for the device's queue every time)."""
    return torch.as_tensor(Quadrature(quad_key).interp(deg, deg_quad),
                           dtype=dtype, device=device)


def vol_weights(mesh: MeshData, dtype):
    """Tensor volume quadrature weights: the shared [nq]*dim grid, or
    [E, nq...] when the mesh has a per-element radial rule."""
    _, w1 = mesh.quad.nodes_weights(mesh.deg_quad)
    kw = dict(dtype=dtype, device=mesh.device)
    if mesh.rad_w is None:
        return tensor.tensor_weights([w1] * mesh.dim, **kw)
    # the radial (slowest) axis takes each element's own weights
    w_t = tensor.tensor_weights([w1] * (mesh.dim - 1), **kw)
    rad = mesh.rad_w.to(dtype)
    return rad.reshape(rad.shape + (1,) * (mesh.dim - 1)) * w_t[None, None]


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
    return MeshData(
        dim=int(meta["dim"]), deg=int(meta["deg"]),
        deg_quad=int(meta["deg_quad"]), quad=quad, geom=meta["geom"],
        forest=meta["forest"], affine=bool(meta["affine"]),
        orth=bool(meta["orth"]), iso=bool(meta["iso"]),
        orient_codes=tuple(meta["orient_codes"]), **fields,
    )


_FACE_H_TYPES = ("volume_div_area", "tree_h", "j_div_sj_min_lobatto",
                 "j_div_sj_quad")


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
    per-element degrees (penalties use them); storage stays at `deg`.
    `compactified_k`: the power k of the compactified outer shells' radial
    weight (c1 + c2·t)^{-k}, whose per-element Gaussian rules then carry
    the volume quadrature there (`quadrature/compactified.py`)."""
    if face_h_type not in _FACE_H_TYPES:
        raise ValueError(f"unknown face_h_type {face_h_type!r}")
    device = torch.device(device)
    quad = quad or Quadrature("legendre")
    deg_quad = deg if deg_quad is None else deg_quad
    dim = forest.dim
    E = forest.n_elements
    nfaces = 2 * dim
    nl, nq = deg + 1, deg_quad + 1

    if deg_e is None:
        deg_e = np.full(E, deg, np.int32)
    else:
        deg_e = np.asarray(deg_e, np.int32)
        if deg_e.max(initial=0) > deg:
            raise ValueError("deg_e exceeds storage degree")

    ft = build_face_tables(forest)
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
    face_j = fac.pop("face_j")

    bnd = torch.as_tensor(ft.kind == BOUNDARY, device=device)
    if face_h_type in ("tree_h", "j_div_sj_min_lobatto"):
        # recompute the penalty from the selected h
        # (`Mesh/d4est_mesh.c:650-800`); store it as face_h, which the
        # estimator prefactors read.  j_div_sj_quad keeps volume/area as
        # its scalar h and adds the pointwise sigma_q below.
        if face_h_type == "tree_h":
            h_m = hfrac[:, None].expand(E, nfaces).contiguous()
        else:
            h_m = face_h_lob
        h_p = torch.where(bnd, h_m, h_m[nbr_elem, nbr_face])
        p_m = deg_e_f[:, None].expand(E, nfaces)
        p_p = deg_e_f[nbr_elem]
        fac["sigma"] = sigma_from_degrees(
            penalty_fcn, float(penalty_prefactor), p_m, p_p, h_m, h_p
        )
        fac["face_h"] = h_m

    # neighbor node permutations of every directed face (host tables)
    perms_l, perms_q = _orientation_perms(dim, nl), _orientation_perms(dim, nq)
    perm_q = torch.as_tensor(perms_q[ft.orient], device=device)

    # pointwise penalty for FACE_H_EQ_J_DIV_SJ_QUAD: h(x) = J/sj at each
    # face quadrature point; the neighbor's h is gathered and point-aligned
    # with perm_q, so min(h_m, h_p) is taken at matched physical points
    # (symmetric operator).  Boundary faces take h_m on both sides (the
    # reference's dirichlet aux passes (deg_m, h_m, deg_m, h_m)).
    sigma_q = h_q = None
    if face_h_type == "j_div_sj_quad":
        h_q = (face_j / fac["face_sj"]).reshape(E, nfaces, -1)
        rows = nbr_elem * nfaces + nbr_face
        h_p = torch.gather(h_q.reshape(E * nfaces, -1)[rows], -1, perm_q)
        h_p = torch.where(bnd[:, :, None], h_q, h_p)
        sigma_q = sigma_from_degrees(
            penalty_fcn, float(penalty_prefactor), deg_e_f[:, None, None],
            deg_e_f[nbr_elem][:, :, None], h_q, h_p,
        ).reshape((E, nfaces) + (nq,) * (dim - 1))

    mortar = _mortar_tables(
        geom, ft, forest, deg_quad, quad, penalty, deg_e, fac["face_h"],
        (perms_l, perms_q), h_q, device,
    )

    rad = {}
    if compactified_k is not None:
        rad = _compactified_volume(geom, forest, deg, deg_quad, quad,
                                   int(compactified_k), tree, anchor, hfrac)
        fac.update(rad.pop("factors"))

    conf_codes = ft.orient[ft.kind == CONF]
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
        # static set of the non-identity codes among conforming faces: the
        # general apply unrolls one flip/swap transform per code
        orient_codes=tuple(sorted(int(c) for c in np.unique(conf_codes)
                                  if c != 0)),
        deg_e=torch.as_tensor(deg_e, dtype=torch.int32, device=device),
        nbr_elem=nbr_elem.to(torch.int32),
        nbr_face=nbr_face.to(torch.int32),
        perm_l=torch.as_tensor(perms_l[ft.orient], device=device),
        perm_q=perm_q,
        orient_code=torch.as_tensor(ft.orient.astype(np.int32),
                                    device=device),
        bnd_mask=bnd,
        conf_mask=(kind == CONF) | (kind == BOUNDARY),
        sigma_q=sigma_q,
        **rad,
        **mortar,
        **fac,
        **compact,
    )


def _orientation_perms(dim: int, n: int) -> np.ndarray:
    """[codes, n^{dim-1}] int64: `faces.orientation_perm` of every
    orientation code, so that code arrays index it directly."""
    n_codes = 8 if dim == 3 else 2
    return np.stack([orientation_perm(dim, n, c)
                     for c in range(n_codes)]).astype(np.int64)


def _tree_face_codes(conn) -> np.ndarray:
    """[T, 2d] orientation code of each tree face's transform (0 at
    physical boundaries)."""
    T, nf = conn.nbr_tree.shape
    return np.array([[_orientation_code(conn, t, f)
                      if conn.nbr_tree[t, f] >= 0 else 0
                      for f in range(nf)] for t in range(T)], np.int64)


def _mortar_tables(geom, ft, forest, deg_quad, quad, penalty, deg_e,
                   face_h, perms, h_q, device):
    """Hanging-mortar rows, their node permutations and the dense
    per-face hanging tables (JAX `build_mesh`, `builder.py:524-623`,
    `:709-730`).  The mortar penalty takes h_m = the coarse full face's h
    and h_p = the fine element's face h, both of the selected face_h_type
    (`face_h`), and the true degrees.  `perms` are the (Lobatto, quadrature)
    tables of `_orientation_perms`; `h_q` [E, 2d, nfq_flat], the pointwise
    J/sj, is given for j_div_sj_quad only and adds `hc_sigma_q`."""
    penalty_fcn, penalty_prefactor = penalty
    perms_l, perms_q = perms
    dim = forest.dim
    E, nfaces = ft.kind.shape
    M = len(ft.hc_elem)
    K = 1 << (dim - 1)
    nq = deg_quad + 1
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

    # orientation codes per (m, b): identity within a tree, else the tree
    # face's transform seen from the coarse side (fine frame -> coarse
    # frame) and from the fine side (coarse frame -> fine frame)
    t_c = forest.tree[ft.hc_elem].astype(np.int64)[:, None]
    t_f = forest.tree[ft.hc_fine.reshape(M, K)].astype(np.int64)
    codes = _tree_face_codes(forest.conn)
    same = t_f == t_c
    code_c = np.where(same, 0, codes[t_c, ft.hc_face.astype(np.int64)[:, None]])
    code_f = np.where(same, 0, codes[t_f, ft.hc_fine_face.astype(np.int64)
                                     .reshape(M, K)])
    hc_perm_l = perms_l[code_c]
    hf_perm_l = perms_l[code_f].reshape(M * K, perms_l.shape[1])
    hc_perm_q = torch.as_tensor(perms_q[code_c], device=device)
    out.update(
        hc_perm_l=torch.as_tensor(hc_perm_l, device=device),
        hc_perm_q=hc_perm_q,
        hc_sj=mfac["sj"], hc_n=mfac["n"], hc_drst_m=mfac["drst"],
        hc_sigma=hc_sigma,
        hf_perm_l=torch.as_tensor(hf_perm_l, device=device),
        hf_perm_q=torch.as_tensor(perms_q[code_f].reshape(M * K, perms_q.shape[1]),
                                  device=device),
    )
    if h_q is not None and M > 0:
        # h_m on the coarse side is J/sj of the MORTAR-sized quadrant,
        # (1/2)·J_c/sj_c at the subface points (`d4est_mortars.c`
        # mortar_dq halving); h_p is the fine element's own-face J/sj,
        # reoriented into the coarse mortar frame (`d4est_mesh.c:1046-1070`)
        h_p_q = torch.gather(h_q[fe, ff], -1, hc_perm_q)
        out["hc_sigma_q"] = sigma_from_degrees(
            penalty_fcn, penalty_prefactor, deg_t[ce][:, None, None],
            deg_t[fe][:, :, None], mfac["j_div_sj"].reshape(h_p_q.shape), h_p_q,
        ).reshape((M, K) + (nq,) * (dim - 1))
    # dense per-face hanging tables (GEMM-form apply): identity mortar
    # orientations only, as that pass applies no permutation
    arange = np.arange(hc_perm_l.shape[-1])
    if M > 0 and (hc_perm_l == arange).all() and (hf_perm_l == arange).all():
        b = torch.arange(1, K + 1, dtype=torch.int32, device=device)
        hang_code = torch.zeros((E, nfaces), dtype=torch.int32,
                                device=device)
        hang_code[fe, ff] = b.expand(M, K)
        hang_sigma = torch.zeros((E, nfaces), **kw)
        hang_sigma[fe, ff] = hc_sigma
        out.update(hang_code=hang_code, hang_sigma=hang_sigma)
    return out


def _compactified_volume(geom, forest, deg, deg_quad, quad, k, tree, anchor,
                         hfrac):
    """Per-element radial quadrature of the compactified outer shells
    (JAX `build_mesh`, `builder.py:630-678`): each outer-shell element's
    radial direction (tree axis dim-1) gets the Gaussian rule of the
    weight (c1 + c2·t)^{-k} of its radial extent, the other elements plain
    Gauss rows; returns `rad_interp`, `rad_w` and, under "factors", the
    volume factor arrays rebuilt at those points."""
    from disco4est_tpu_torch.quadrature.compactified import rule, shell_c1_c2

    n_outer = int(getattr(geom, "n_outer", 0))
    if not (n_outer and getattr(geom, "compactify_outer", False)):
        raise ValueError(
            "compactified_k needs a compactified outer-shell geometry"
        )
    E, dim = forest.n_elements, forest.dim
    nq = deg_quad + 1
    xg, wg = quad.nodes_weights(deg_quad)
    rad_t = np.tile(np.asarray(xg), (E, 1))
    rad_w = np.tile(np.asarray(wg), (E, 1))
    verts = np.asarray(geom.verts)
    rules = {}  # elements of one radial extent share their rule
    for e in np.where(forest.tree < n_outer)[0]:
        t = int(forest.tree[e])
        c0, c1v = float(verts[t, 0, 2]), float(verts[t, 4, 2])
        frac = forest.anchor[e, 2] / ROOT
        hfrac_e = 2.0 ** -float(forest.level[e])
        cmin = c0 + frac * (c1v - c0)
        cmax = c0 + (frac + hfrac_e) * (c1v - c0)
        key = (cmin, cmax)
        if key not in rules:
            cc1, cc2 = shell_c1_c2(cmin, cmax, geom.R1, geom.R2)
            rules[key] = rule(cc1, cc2, k, nq)
        rad_t[e], rad_w[e] = rules[key]
    xl = np.asarray(DB.ops(deg).lobatto_nodes, np.float64)
    # Lagrange basis on the Lobatto nodes at each element's points
    rad_interp = np.ones((E, nq, len(xl)))
    for l in range(len(xl)):
        for m in range(len(xl)):
            if m != l:
                rad_interp[:, :, l] *= (rad_t - xl[m]) / (xl[l] - xl[m])
    kw = dict(dtype=F64, device=anchor.device)
    rad_t_d = torch.as_tensor(rad_t, **kw)
    rad_w_d = torch.as_tensor(rad_w, **kw)
    return dict(
        rad_interp=torch.as_tensor(rad_interp, **kw),
        rad_w=rad_w_d,
        factors=_compute_vol_factors_perelem(
            geom, dim, quad, deg_quad, tree, anchor, hfrac, rad_t_d, rad_w_d
        ),
    )


def _compute_vol_factors_perelem(geom, dim, quad, deg_quad, tree, anchor,
                                 hfrac, rad_t, rad_w):
    """Volume factor arrays at PER-ELEMENT quadrature grids: tangential
    directions on the shared Gauss nodes, the radial direction (tree axis
    dim-1) on each element's own abscissas `rad_t` [E, nq], with the own
    weights `rad_w` baked into wjgg exactly as the shared path bakes w⊗w⊗w
    (`d4est_quadrature_compactified_setup_storage` role)."""
    E = tree.shape[0]
    nq = deg_quad + 1
    xq, wq = quad.nodes_weights(deg_quad)
    kw = dict(dtype=F64, device=anchor.device)
    gx = torch.as_tensor(np.asarray(xq), **kw)
    wt = tensor.tensor_weights([wq] * (dim - 1), **kw)
    # pts[e, (z,) y, x, :]: x (and y) on gx, the radial axis on rad_t[e]
    pts = torch.zeros((E,) + (nq,) * dim + (dim,), **kw)
    for d in range(dim - 1):
        shape = [1] * (dim + 1)
        shape[dim - d] = nq
        pts[..., d] = gx.reshape(shape)
    pts[..., dim - 1] = rad_t.reshape((E, nq) + (1,) * (dim - 1))
    a = anchor.reshape((E,) + (1,) * dim + (dim,))
    h = hfrac.reshape((E,) + (1,) * (dim + 1))
    rst_tree = a + (pts + 1.0) * 0.5 * h
    t = tree.reshape((E,) + (1,) * dim)
    dx = geom.dx(t, rst_tree) * (0.5 * h[..., None])
    J = _det(dx)
    drdx = _inv(dx, J)
    w3 = rad_w.reshape((E, nq) + (1,) * (dim - 1)) * wt[None, None]
    gg = torch.einsum("...lk,...mk->...lm", drdx, drdx)
    wjgg = (w3 * J)[..., None, None] * gg
    return dict(
        xyz_quad=torch.movedim(geom.x(t, rst_tree), -1, 1),
        j_quad=J,
        wjgg=torch.movedim(torch.movedim(wjgg, -1, 1), -1, 1),
    )


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
    face_h_lob, face_j = [], []
    for f in range(nfaces):
        pts_q = _face_points(xq, dim, f, dev)
        pts_l = _face_points(xl, dim, f, dev)
        fJ, fdrdx = _factors(geom, tree, anchor, hfrac, pts_q)
        sj, n = _surface_jacobian(fJ, fdrdx, f)
        face_j.append(fJ)  # volume J at the face points
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
        face_j=torch.stack(face_j, dim=1),
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
    the subface quadrature points, as [M, K, ...] tensors, and the
    mortar-sized J/sj of the pointwise penalty (`j_div_sj`).  The
    reference computes the coarse side's J/sj with the MORTAR-sized (half)
    quadrant (`d4est_mortars_compute_qcoords_on_mortar` halves dq):
    J_mortar = (1/2)^dim J, sj_mortar = (1/2)^{dim-1} sj, so J/sj on the
    mortar is (1/2) J/sj of the coarse element (`d4est_mortars.c:255-257`)."""
    dev = anchor.device
    M = tree.shape[0]
    xq, _ = quad.nodes_weights(deg_quad)
    a0 = cf // 2
    sign = torch.where(cf % 2 == 0, -1.0, 1.0).to(F64)
    npts = dim - 1
    sjs, ns, drsts, jdivsjs = [], [], [], []
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
        jdivsjs.append(0.5 * J / sj)
        ns.append(torch.movedim(n, -1, 1))
        drsts.append(torch.movedim(torch.movedim(drdx, -1, 1), -1, 1))
    return {
        "sj": torch.stack(sjs, dim=1),
        "n": torch.stack(ns, dim=1),
        "drst": torch.stack(drsts, dim=1),
        "j_div_sj": torch.stack(jdivsjs, dim=1),
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
