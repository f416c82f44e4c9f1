"""Structured (lexicographic) SIPG apply for uniform brick meshes.

Port of `disco4est_tpu/laplacian/structured.py`.  On a uniform brick the
neighbor relation is translation-invariant: with the elements in
lexicographic order (x fastest) every face's neighbor sits at a constant
offset {±1, ±nx, ±nx·ny}.  The neighbor exchange is then a row shift, and
one fused pass computes volume GEMM + face terms + lift GEMM.

The permutation is applied once per solve, not per apply: Krylov
iterations commute with any permutation, so the inner CG runs entirely in
lex order (`to_lex` / `from_lex` around it).

Two versions of the fused pass, one function:

- `lex_apply_cuda`: the hand-written Hopper kernel
  (`csrc/structured_apply.cu`, replacing the Pallas kernel `_kernel_lex`),
  for CUDA tensors.  It reads neighbor traces straight from device
  memory, guarded at the ends, so it takes bricks of any size (the Pallas
  kernel's three-block window refuses z-strides above 512 elements).
- `lex_apply_plain`: the same arithmetic in plain torch ops.

`apply_structured` takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.  Both come in the
reference's two precisions: "f32" (the default; what JAX takes off the
TPU, and what `driver.py`'s solves take) and "bf16" (the TPU's default: bf16 u,
traces, Z and weights with f32 sums, `lex_apply_cuda_bf16`), which a
caller asks for explicitly, as `make_inner_solve(..., precision="bf16")`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from disco4est_tpu_torch.laplacian import fused
from disco4est_tpu_torch.mesh.builder import MeshData
from disco4est_tpu_torch.mesh.tree import ROOT
from disco4est_tpu_torch.util.cuda_build import check_operand, load_library

F32 = torch.float32
SOURCE = "structured_apply.cu"

# Launch counters of the CUDA kernel, one per precision: the wrapper adds
# one each time it launches the kernel, so a run can show that its solve
# went through it, and in which precision (the counterpart of the JAX
# module's TRACE_COUNT).
KERNEL_LAUNCHES = 0
KERNEL_LAUNCHES_BF16 = 0


@dataclasses.dataclass
class StructuredBrick(fused.LazyBf16Pack):
    """Per-epoch view of a uniform brick mesh in lex order (f32)."""

    dim: int
    deg: int
    nblk: int
    deltas: tuple  # per face: lex neighbor offset
    opp: tuple  # per face: the neighbor's face index
    # tensors (all in LEX element order)
    perm: torch.Tensor  # [E] lex -> original index
    inv_perm: torch.Tensor  # [E] original -> lex index
    cw_in: torch.Tensor  # [E, nblk]
    scal: torch.Tensor  # [E, 2d*4]: (drstn_n, sj, sigma, bnd) per face
    drstn: torch.Tensor  # [E, 2d]
    W_vol: torch.Tensor  # [nv, nblk*nv]
    W_tr: torch.Tensor  # [nv, 2d*2*nfl]
    W_lift: torch.Tensor  # [2d*2*nfl, nv]
    W_pack: torch.Tensor  # B of the kernel, `fused.pack_sipg_weights`
    meta: torch.Tensor  # [E, 28]: the kernel's table rows, `fused.sipg_meta`
    # the bf16 kernel's B, `fused.pack_sipg_weights_bf16`, at first use
    _W_pack_bf16: torch.Tensor | None = dataclasses.field(default=None,
                                                          repr=False)

    @property
    def n_elements(self) -> int:
        return self.perm.shape[0]

    @property
    def nv(self) -> int:
        return (self.deg + 1) ** self.dim

    def to(self, device) -> "StructuredBrick":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


def build_structured(mesh: MeshData):
    """Build the lex view, or None when the mesh isn't a uniform
    orthogonal brick with one scalar penalty per face."""
    if not (mesh.affine and mesh.orth and not mesh.orient_codes):
        return None
    if mesh.sigma_q is not None:
        return None
    forest = mesh.forest
    lv = np.asarray(forest.level)
    if lv.size == 0 or not np.all(lv == lv[0]):
        return None
    dim = mesh.dim
    nfaces = 2 * dim

    # global integer lattice coords (tree origin + in-tree anchor)
    origin = getattr(mesh.geom, "tree_origin", None)
    if origin is None:
        return None
    h = ROOT >> int(lv[0])
    coords = (
        np.asarray(origin)[np.asarray(forest.tree)] * ROOT
        + np.asarray(forest.anchor)
    ) // h
    coords = coords.astype(np.int64)
    dims = [int(coords[:, d].max()) + 1 for d in range(dim)]
    E = coords.shape[0]
    if int(np.prod(dims)) != E:
        return None
    strides = [int(np.prod(dims[:d])) for d in range(dim)]
    key = sum(coords[:, d] * strides[d] for d in range(dim))
    perm = np.argsort(key, kind="stable")  # lex -> original
    inv = np.empty(E, np.int64)
    inv[perm] = np.arange(E)

    # verify constant neighbor offsets & derive per-face (delta, opp)
    nbr_e = mesh.nbr_elem.cpu().numpy()
    nbr_f = mesh.nbr_face.cpu().numpy()
    bnd = mesh.bnd_mask.cpu().numpy()
    deltas, opps = [], []
    for f in range(nfaces):
        interior = ~bnd[perm, f]
        if not interior.any():
            deltas.append(0)
            opps.append(f ^ 1)
            continue
        nb_lex = inv[nbr_e[perm, f]]
        d = nb_lex[interior] - np.arange(E)[interior]
        of = nbr_f[perm, f][interior]
        if not (np.all(d == d[0]) and np.all(of == of[0])):
            return None
        deltas.append(int(d[0]))
        opps.append(int(of[0]))

    dev = mesh.device
    permt = torch.as_tensor(perm, device=dev)
    cw_in, scal, drstn = (t[permt].contiguous()
                          for t in fused.face_scalars(mesh))
    hm = fused._mats(mesh.deg, mesh.deg_quad, mesh.quad.kind, dim, mesh.iso)
    kw = dict(dtype=F32, device=dev)
    W_vol = torch.as_tensor(hm["W_vol"], **kw)
    W_lift = torch.as_tensor(hm["W_lift"], **kw)
    return StructuredBrick(
        dim=dim, deg=mesh.deg, nblk=hm["nblk"],
        deltas=tuple(deltas), opp=tuple(opps),
        perm=permt, inv_perm=torch.as_tensor(inv, device=dev),
        cw_in=cw_in, scal=scal, drstn=drstn,
        W_vol=W_vol, W_tr=torch.as_tensor(hm["W_tr"], **kw), W_lift=W_lift,
        W_pack=fused.pack_sipg_weights(W_vol, W_lift, hm["nblk"]),
        meta=fused.sipg_meta(cw_in, scal),
    )


def to_lex(sb: StructuredBrick, v):
    return v[sb.perm]


def from_lex(sb: StructuredBrick, v):
    return v[sb.inv_perm]


def compute_traces_lex(sb: StructuredBrick, u2, precision="f32"):
    """Own face traces in lex order: tr[e] = [u_f | drstn·∂_n u] per face,
    [E, 2d·2·nfl], stored in bf16 with precision="bf16".  Every face reads
    this one array, so both sides of a face see identical values and the
    operator stays symmetric."""
    return fused.scaled_traces(u2, sb.W_tr, sb.drstn, precision)


def lex_apply_plain(sb: StructuredBrick, u2, tr, precision="f32"):
    """Plain torch version of the fused pass: Au [E, nv] from u2 [E, nv]
    and the traces tr [E, 2d·2·nfl] (row shifts for the neighbor traces,
    then `fused.fused_pass_plain` in `precision`)."""
    E = u2.shape[0]
    tr3 = tr.reshape(E, 2 * sb.dim, -1)
    # neighbor row e + delta; rows that wrap around the ends are boundary
    # faces, which the fused pass does not read
    nb = torch.stack(
        [torch.roll(tr3[:, sb.opp[f]], -sb.deltas[f], dims=0)
         for f in range(2 * sb.dim)],
        dim=1,
    ).reshape(E, -1)
    return fused.fused_pass_plain(u2, tr, nb, sb.cw_in, sb.scal, sb.W_vol,
                                  sb.W_lift, precision)


@functools.lru_cache(maxsize=None)
def _load():
    lib = load_library(SOURCE)
    for fn in (lib.d4est_structured_apply, lib.d4est_structured_apply_bf16):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    lib.d4est_structured_apply_bf16_plan.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.d4est_structured_apply_bf16_plan.restype = ctypes.c_int
    return lib


def lex_bf16_plan(sb: StructuredBrick):
    """`fused.bf16_plan` of `d4est_structured_apply_bf16` for `sb`."""
    return fused.bf16_plan(_load().d4est_structured_apply_bf16_plan,
                           sb.n_elements, sb.deg, sb.nblk)


def _lex_launch(sb: StructuredBrick, u2, tr, precision):
    """Check the operands and launch the kernel of `precision`."""
    dev = u2.device
    E, nv, nblk = sb.n_elements, sb.nv, sb.nblk
    tw = fused.check_sipg_operands(sb.dim, sb.deg, nblk, E, dev)
    bf16 = precision == "bf16"
    check_operand("u", u2, (E, nv), dev, F32)
    check_operand("tr", tr, (E, tw), dev, fused.BF16 if bf16 else F32)
    check_operand("meta", sb.meta, (E, fused.SIPG_META_W), dev, F32)
    W_pack = sb.W_pack_bf16 if bf16 else sb.W_pack
    fused.check_sipg_weights(W_pack, nv, nblk, tw, dev, precision)
    lib = _load()
    fn = (lib.d4est_structured_apply_bf16 if bf16
          else lib.d4est_structured_apply)
    out = torch.empty((E, nv), dtype=F32, device=dev)
    delta = (ctypes.c_int * 6)(*sb.deltas)
    opp = (ctypes.c_int * 6)(*sb.opp)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            u2.data_ptr(), tr.data_ptr(), sb.meta.data_ptr(),
            W_pack.data_ptr(), out.data_ptr(), E, sb.deg + 1, nblk, delta,
            opp, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"structured {precision} kernel launch failed: CUDA error {err}"
        )
    return out


def lex_apply_cuda(sb: StructuredBrick, u2, tr):
    """The fused pass on the card: launches `csrc/structured_apply.cu`.
    Same contract as `lex_apply_plain`; raises on anything the kernel
    does not take and on a failed launch."""
    global KERNEL_LAUNCHES
    out = _lex_launch(sb, u2, tr, "f32")
    KERNEL_LAUNCHES += 1
    return out


def lex_apply_cuda_bf16(sb: StructuredBrick, u2, tr):
    """The fused pass in bf16 on the card: launches
    `d4est_structured_apply_bf16` of `csrc/structured_apply.cu` on u2
    [E, nv] f32 and the bf16 traces of `compute_traces_lex(..., "bf16")`.
    Same contract as `lex_apply_plain(..., precision="bf16")`; raises on
    anything the kernel does not take and on a failed launch."""
    global KERNEL_LAUNCHES_BF16
    out = _lex_launch(sb, u2, tr, "bf16")
    KERNEL_LAUNCHES_BF16 += 1
    return out


def apply_structured_plain(sb: StructuredBrick, u_lex, precision="f32"):
    """Au in lex order, plain torch version.  `u_lex`: [E, nl^dim] or
    [E, nl, ...]."""
    u2 = u_lex.reshape(sb.n_elements, sb.nv).to(F32)
    out = lex_apply_plain(sb, u2, compute_traces_lex(sb, u2, precision),
                          precision)
    return out.reshape(u_lex.shape).to(u_lex.dtype)


def apply_structured(sb: StructuredBrick, u_lex, precision="f32"):
    """Au in lex order, f32 values, products in `precision` ("f32" or
    "bf16").  On a CUDA tensor this launches the hand-written kernel (or
    raises); on a CPU tensor it runs the plain version."""
    fused.check_precision(precision)
    dev = u_lex.device
    if dev.type == "cpu":
        return apply_structured_plain(sb, u_lex, precision)
    if dev.type != "cuda":
        raise ValueError(f"apply_structured: unsupported device {dev}")
    u2 = u_lex.reshape(sb.n_elements, sb.nv).to(F32).contiguous()
    tr = compute_traces_lex(sb, u2, precision).contiguous()
    launch = lex_apply_cuda_bf16 if precision == "bf16" else lex_apply_cuda
    out = launch(sb, u2, tr)
    return out.reshape(u_lex.shape).to(u_lex.dtype)


def make_inner_solve(sb: StructuredBrick, *, rtol: float = 1e-3,
                     max_iter: int = 400, precision: str = "f32"):
    """Inner-solve closure for `solvers.mixed.mixed_refine_solve`: CG in
    f32 on the structured apply, in lex order, its products in
    `precision` (the JAX closure's, whose default is bf16 on a TPU only;
    the port's driver passes none, so f32).  The permutation is paid once
    per outer refinement step, not per Krylov iteration."""
    from disco4est_tpu_torch.solvers.cg import cg_solve

    fused.check_precision(precision)

    def inner(r32):
        shape = r32.shape
        b_lex = to_lex(sb, r32.reshape(sb.n_elements, -1))
        res = cg_solve(
            lambda v: apply_structured(sb, v, precision),
            b_lex, atol=0.0, rtol=rtol, max_iter=max_iter,
        )
        return from_lex(sb, res.x).reshape(shape), res.iterations

    return inner
