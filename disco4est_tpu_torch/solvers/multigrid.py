"""hp-multigrid V-cycle with Chebyshev smoothing.

Port of `disco4est_tpu/solvers/multigrid.py` (role of the reference's
`Solver/d4est_solver_multigrid.c`, whose V-cycle coarsens the live p4est
inside the cycle): the whole level hierarchy — coarse forests, their
meshes and the transfer tables — is built once per mesh epoch on the
host; a V-cycle is then a fixed sequence of device operations.

- Prolongation coarse → fine: per-element hp-prolong through the lineage
  (copy where the leaf is unchanged), the 1D child matrices selected per
  row and axis.
- Restriction of residuals: the transpose Σ_c P_cᵀ.  The JAX module sums
  the fine rows into their parents with `.at[].add`; on a card
  `index_add` runs as atomics, whose order changes from run to run
  (ROADMAP C10).  Here each coarse element has a padded slot table of its
  fine rows, built once per epoch, and the rows are summed over the slot
  axis in one fixed order (`restrict`, `restrict_blocks`).
- Smoother: Chebyshev with CG-Lanczos bounds per level, block or
  overlapping Schwarz, or none; bottom solver: CG, Chebyshev or the
  smoother.  The bottom CG runs a fixed `bottom_iters` loop whose updates
  freeze (through `torch.where`) once its stopping test holds: its `x`
  equals the stopped CG's bit for bit, with no host read inside a cycle.
  Up to `DENSE_BOTTOM_MAX` unknowns the bottom runs on the coarsest
  operator assembled as a dense matrix in `mg_setup` (one launch a step
  in place of a matrix-free apply).  `mg_setup` reads each level's λmax
  back once, as the JAX module does.

The coarse levels are rebuilt with the fine mesh's penalty options
(`mesh_kwargs`); the JAX module rebuilds them with `build_mesh`'s defaults
(ROADMAP C12).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from disco4est_tpu_torch.mesh.builder import MeshData, build_mesh
from disco4est_tpu_torch.mesh.tree import ROOT
from disco4est_tpu_torch.ops import tensor
from disco4est_tpu_torch.ops.operators import DB
from disco4est_tpu_torch.solvers.cheby import cheby_smooth
from disco4est_tpu_torch.solvers.eigs import cg_eigs
from disco4est_tpu_torch.solvers.schwarz import _apply_blocks
from disco4est_tpu_torch.util import trace

SMOOTHERS = ("cheby", "schwarz", "schwarz_overlap", "none")
BOTTOMS = ("cg", "cheby", "reuse_smoother")
# the bottom solve runs on the coarsest level's operator as a dense matrix
# (assembled in `mg_setup`) up to this many unknowns: its 100 fixed CG
# steps are then one matrix-vector product each, where the matrix-free
# apply launches ~20-150 kernels a step
DENSE_BOTTOM_MAX = 2048


@dataclasses.dataclass(frozen=True)
class MGParams:
    n_smooth: int = 8  # cheby_imax
    eigs_cg_iters: int = 10  # cheby_eigs_cg_imax
    lmax_lmin_ratio: float = 30.0
    lmax_multiplier: float = 1.0
    bottom_iters: int = 100
    bottom_rtol: float = 1e-10
    vcycle_imax: int = 1
    vcycle_rtol: float = 1e-9
    vcycle_atol: float = 0.0
    # plugins (the reference's smoother/bottom factories,
    # `d4est_solver_multigrid.c:1509-1603`): smoother ∈ SMOOTHERS
    # ("schwarz" = zero-overlap element blocks, "schwarz_overlap" = the
    # reference's overlapping vertex-patch Schwarz, `_smoother_schwarz.c:89`),
    # bottom ∈ BOTTOMS
    smoother: str = "cheby"
    bottom: str = "cg"
    schwarz_iterations: int = 3
    schwarz_damping: float = 2.0 / 3.0
    schwarz_overlap_nodes: int = 2
    schwarz_subdomain_iters: int = 15


class MGLevelMap:
    """Index maps between a fine level and the next coarser level.

    `bits` is the per-row child-bit path [Ef, D, dim] from the coarse
    ancestor down to the fine leaf (D = max descent depth; shallower rows
    are padded with bit 2 = identity).  `slots` [n_coarse, S] lists each
    coarse element's fine rows in ascending order, padded with Ef (a zero
    row): the fixed summation order of `restrict` and `restrict_blocks`.
    The host arrays stay on the map (`src_np`, `bits_np`, `copy_np`)."""

    def __init__(self, src, bits, copy, n_coarse=None, device="cpu"):
        src = np.asarray(src, np.int64)
        bits = np.asarray(bits, np.int64)
        if bits.ndim == 2:  # single-level descent convenience
            bits = bits[:, None, :]
        copy = np.array(copy, bool)
        self.src_np, self.bits_np, self.copy_np = src, bits, copy
        self.n_coarse = (int(n_coarse) if n_coarse is not None
                         else (int(src.max()) + 1 if len(src) else 0))
        self.src = torch.as_tensor(src, device=device)
        self.bits = torch.as_tensor(bits, device=device)
        self.copy = torch.as_tensor(copy, device=device)
        self.slots = torch.as_tensor(_slot_table(src, self.n_coarse),
                                     device=device)


def _slot_table(src: np.ndarray, n_coarse: int) -> np.ndarray:
    """[n_coarse, S]: the fine rows of each coarse element, ascending,
    padded with len(src)."""
    Ef = len(src)
    order = np.argsort(src, kind="stable")
    counts = np.bincount(src, minlength=n_coarse)
    S = max(1, int(counts.max(initial=0)))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    table = np.full((n_coarse, S), Ef, np.int64)
    for j in range(S):
        has = counts > j
        table[has, j] = order[starts[has] + j]
    return table


def _sum_slots(rows, slots):
    """Σ over each coarse element's slots of `rows` [Ef, ...], in the
    slot order: a gather of the padded table, then one reduction over the
    slot axis (the same order on every run)."""
    pad = torch.cat([rows, rows.new_zeros((1,) + rows.shape[1:])])
    return pad[slots].sum(1)


class MGHierarchy:
    """The multigrid hierarchy of one mesh epoch."""

    def __init__(self, meshes, maps, params: MGParams, bounds=None,
                 smoother_state=None, nl_blocks=None, hp=False):
        self.meshes = meshes  # fine → coarse
        self.maps = maps  # maps[i]: level i -> level i+1
        self.params = params
        self.bounds = bounds  # [(lmin, lmax)] host floats per level
        # per-level smoother state (BlockSchwarz / OverlappingSchwarz)
        self.smoother_state = smoother_state
        # per-level frozen-u0 nonlinear blocks [E_l, n, n] (Newton-MG
        # matrix operator) or None
        self.nl_blocks = nl_blocks
        # True on mixed-degree meshes: level fields are padded own-degree
        # coefficients, transfers are conjugated with the p-embeddings,
        # and `A` must be `apply_sipg_hp`
        self.hp = hp
        # the coarsest level's operator as a dense matrix, from `mg_setup`
        self.bottom_matrix = None

    @property
    def n_levels(self):
        return len(self.meshes)


def _bit_path(coarse_forest, fine_forest, src, dl):
    """Per-fine-leaf child-bit path [Ef, D, dim] from its coarse ancestor
    down to the leaf; rows shallower than D are padded with bit 2."""
    dim = fine_forest.dim
    Dmax = max(1, int(dl.max(initial=0)))
    bits = np.full((fine_forest.n_elements, Dmax, dim), 2, np.int64)
    rel = (fine_forest.anchor.astype(np.int64)
           - coarse_forest.anchor[src].astype(np.int64))
    h_old = ROOT >> coarse_forest.level[src].astype(np.int64)
    for k in range(Dmax):
        hk = h_old >> (k + 1)  # cell size at descent depth k+1
        active = dl > k
        for d in range(dim):
            b = (rel[:, d] // np.maximum(hk, 1)) & 1
            bits[active, k, d] = b[active]
    return bits


def build_hierarchy(mesh: MeshData, params: MGParams = MGParams(),
                    max_levels: int | None = None,
                    mesh_kwargs: dict | None = None) -> MGHierarchy:
    """Coarsen every family once per level (then 2:1 balance) until the
    forest stops changing or has one element.  On hp meshes a coarse
    element takes the minimum degree of its descendants (the reference's
    coarsen_init, `d4est_solver_multigrid_callbacks.h`).  `mesh_kwargs`
    (penalty_prefactor, penalty_fcn, face_h_type, compactified_k) are
    passed to the coarse levels' `build_mesh`, as the fine mesh was
    built with them."""
    from disco4est_tpu_torch.amr.amr import element_lineage

    kw = dict(mesh_kwargs or {})
    deg_e = mesh.deg_e.cpu().numpy()
    hp = bool((deg_e != mesh.deg).any())
    meshes, maps = [mesh], []
    forest = mesh.forest
    while max_levels is None or len(meshes) < max_levels:
        coarse_forest, _ = forest.coarsen(np.ones(forest.n_elements, bool))
        if coarse_forest.n_elements == forest.n_elements:
            break
        coarse_forest = coarse_forest.balance()
        src, _, dl = element_lineage(coarse_forest, forest)
        bits = _bit_path(coarse_forest, forest, src, dl)
        if hp:
            deg_c = np.full(coarse_forest.n_elements, mesh.deg, np.int64)
            np.minimum.at(deg_c, src, deg_e)
            kw["deg_e"] = deg_c
            deg_e = deg_c
        meshes.append(build_mesh(mesh.geom, coarse_forest, mesh.deg,
                                 mesh.quad, mesh.deg_quad,
                                 device=mesh.device, **kw))
        maps.append(MGLevelMap(src, bits, dl == 0, coarse_forest.n_elements,
                               device=mesh.device))
        forest = coarse_forest
        if coarse_forest.n_elements <= 1:
            break
    return MGHierarchy(meshes, maps, params, hp=hp)


def hierarchy_from_numpy(meshes, maps, params: MGParams = MGParams(),
                         bounds=None, hp=None) -> MGHierarchy:
    """A hierarchy on another package's tables: `maps` holds one dict per
    level with numpy `src`, `bits`, `copy` and `n_coarse` (e.g. the JAX
    package's `MGLevelMap`s converted leaf by leaf), `bounds` the
    per-level (lmin, lmax)."""
    dev = meshes[0].device
    lms = [MGLevelMap(m["src"], m["bits"], m["copy"], m["n_coarse"],
                      device=dev) for m in maps]
    if hp is None:
        hp = bool((meshes[0].deg_e != meshes[0].deg).any())
    return MGHierarchy(meshes, lms, params, hp=hp,
                       bounds=None if bounds is None
                       else [(float(a), float(b)) for a, b in bounds])


@lru_cache(maxsize=64)
def _hp_mats(deg, dtype, device):
    """[3, nl, nl]: child-0 prolong, child-1 prolong, identity (pad)."""
    return torch.as_tensor(
        np.stack([DB.hp_prolong(deg, deg, 0), DB.hp_prolong(deg, deg, 1),
                  np.eye(deg + 1)]), dtype=dtype, device=device)


def _apply_child(mats, bits, v, d):
    """Per-row child matrix along direction d: row i takes mats[bits[i]]
    (bit 2, the identity, leaves the row as it is).  Two fixed-matrix
    applies of the whole field and a select, instead of a batched GEMM
    of gathered [Ef, nl, nl] matrices."""
    shape = (-1,) + (1,) * (v.ndim - 1)
    b = bits.reshape(shape)
    out = torch.where(b == 0, tensor.apply_axis(mats[0], v, d), v)
    return torch.where(b == 1, tensor.apply_axis(mats[1], v, d), out)


def prolong(level_map: MGLevelMap, u_coarse, deg, dim):
    """coarse nodal field -> fine nodal field (multi-level descent)."""
    hp = _hp_mats(deg, u_coarse.dtype, u_coarse.device)
    vals = u_coarse[level_map.src]
    out = vals
    for k in range(level_map.bits.shape[1]):
        for d in range(dim):
            out = _apply_child(hp, level_map.bits[:, k, d], out, d)
    cshape = (-1,) + (1,) * dim
    return torch.where(level_map.copy.reshape(cshape), vals, out)


def restrict(level_map: MGLevelMap, r_fine, deg, dim, n_coarse):
    """fine residual -> coarse residual via Σ P_cᵀ (the adjoint of
    `prolong`: the child matrices transposed, in reverse descent order),
    summed per coarse element in the fixed slot order."""
    hpT = _hp_mats(deg, r_fine.dtype, r_fine.device).transpose(1, 2)
    out = r_fine
    for k in range(level_map.bits.shape[1] - 1, -1, -1):
        for d in range(dim):
            out = _apply_child(hpT, level_map.bits[:, k, d], out, d)
    cshape = (-1,) + (1,) * dim
    contrib = torch.where(level_map.copy.reshape(cshape), r_fine, out)
    assert level_map.slots.shape[0] == n_coarse
    return _sum_slots(contrib, level_map.slots)


def prolong_mats(level_map: MGLevelMap, deg, dim, dtype):
    """Per-fine-row dense prolongation matrices P_e [Ef, n, n]
    (n = nl^dim) through the full descent path: the building block of the
    Newton-MG matrix operator (PᵀBP restriction of frozen-u0 blocks)."""
    dev = level_map.src.device
    hp = _hp_mats(deg, dtype, dev)
    nl = deg + 1
    Ef, D = level_map.bits.shape[:2]

    def kron(ms):
        # ms[d]: [Ef, nl, nl] for direction d; the result acts on
        # x-fastest flat node vectors (direction 0 = last factor)
        out = ms[dim - 1]
        for d in range(dim - 2, -1, -1):
            out = (out[:, :, None, :, None] * ms[d][:, None, :, None, :]
                   ).reshape(Ef, out.shape[1] * nl, out.shape[2] * nl)
        return out

    P = None
    for k in range(D):
        Pk = kron([hp[level_map.bits[:, k, d]] for d in range(dim)])
        P = Pk if P is None else torch.matmul(Pk, P)
    eye = torch.eye(nl**dim, dtype=dtype, device=dev)
    return torch.where(level_map.copy[:, None, None], eye, P)


def restrict_blocks(level_map: MGLevelMap, blocks, deg, dim, n_coarse):
    """Galerkin restriction of per-element dense blocks, B_c = Σ PᵀBP
    (`d4est_solver_multigrid_matrix_operator.h:1-21` role), summed per
    coarse element in the fixed slot order."""
    P = prolong_mats(level_map, deg, dim, blocks.dtype)
    PtBP = torch.matmul(P.transpose(1, 2), torch.matmul(blocks, P))
    assert level_map.slots.shape[0] == n_coarse
    return _sum_slots(PtBP, level_map.slots)


def set_matrix_operator(hier: MGHierarchy, blocks_fine):
    """Install frozen-u0 nonlinear blocks [E0, n, n] on the fine level and
    Galerkin-restrict them through the hierarchy (the reference's
    `d4est_solver_multigrid_matrix_operator` for Newton-MG)."""
    deg, dim = hier.meshes[0].deg, hier.meshes[0].dim
    blocks = [blocks_fine]
    for i, lm in enumerate(hier.maps):
        blocks.append(restrict_blocks(lm, blocks[-1], deg, dim,
                                      hier.meshes[i + 1].n_elements))
    hier.nl_blocks = blocks
    return hier


def level_operator(hier: MGHierarchy, A: Callable, level: int):
    """The operator at a hierarchy level: the base apply plus the
    restricted frozen-u0 nonlinear blocks, where installed."""
    mesh = hier.meshes[level]
    if hier.nl_blocks is None:
        return lambda v: A(mesh, v)
    B = hier.nl_blocks[level]
    return lambda v: A(mesh, v) + _apply_blocks(B, v)


def mg_setup(hier: MGHierarchy, A: Callable, seed_field):
    """Per-level setup: Chebyshev bounds from CG-Lanczos (one read of
    λmax per level) and the smoother state, per the plugins.  `A(mesh, u)`
    is the operator; `seed_field(mesh)` makes the Lanczos start vector."""
    p = hier.params
    bounds = []
    need_cheby = p.smoother == "cheby" or p.bottom == "cheby"
    for level, mesh in enumerate(hier.meshes):
        if need_cheby:
            _, lmax = cg_eigs(level_operator(hier, A, level),
                              seed_field(mesh), p.eigs_cg_iters)
            lmax = lmax * p.lmax_multiplier
            bounds.append((lmax / p.lmax_lmin_ratio, lmax))
        else:
            bounds.append((0.0, 1.0))
    hier.bounds = bounds
    coarsest = hier.meshes[-1]
    n = coarsest.n_elements * coarsest.nl**coarsest.dim
    hier.bottom_matrix = (
        dense_matrix(level_operator(hier, A, hier.n_levels - 1), coarsest)
        if p.bottom in ("cg", "cheby") and n <= DENSE_BOTTOM_MAX else None)
    if p.smoother == "schwarz_overlap":
        # one overlapping Schwarz per level (the reference's
        # `d4est_solver_multigrid_smoother_schwarz_set_apply_lhs`), on the
        # storage-degree operator as in the JAX module, hp levels too
        from disco4est_tpu_torch.solvers.schwarz_overlap import (
            build_overlapping_schwarz,
        )

        hier.smoother_state = [
            build_overlapping_schwarz(
                m, num_nodes_overlap=p.schwarz_overlap_nodes,
                iterations=p.schwarz_subdomain_iters)
            for m in hier.meshes
        ]
    if p.smoother == "schwarz":
        # exact element-diagonal blocks of the base operator plus the
        # level's nonlinear blocks (block-diagonal by construction)
        from disco4est_tpu_torch.solvers.schwarz import (
            BlockSchwarz,
            assemble_diag_blocks,
        )

        state = []
        for level, m in enumerate(hier.meshes):
            blocks = assemble_diag_blocks(m)
            if hier.nl_blocks is not None:
                blocks = blocks + hier.nl_blocks[level].to(blocks.dtype)
            state.append(BlockSchwarz(inv_blocks=torch.linalg.inv(blocks)))
        hier.smoother_state = state
    return bounds


def dense_matrix(A_l: Callable, mesh: MeshData):
    """[n, n] matrix of the operator on `mesh`'s fields, one unit vector
    per column (n = E·nl^dim)."""
    shape = (mesh.n_elements,) + (mesh.nl,) * mesh.dim
    eye = torch.eye(int(np.prod(shape)), dtype=mesh.sigma.dtype,
                    device=mesh.device)
    return torch.stack([A_l(e.reshape(shape)).reshape(-1) for e in eye],
                       dim=1)


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def bottom_cg(A: Callable, b, x, rtol: float, iters: int):
    """`cg_solve(A, b, x0=x, atol=0, rtol=rtol, max_iter=iters).x` with no
    host read: `iters` iterations whose updates freeze once
    ‖r‖² ≤ (rtol·‖b‖)², the stopped solver's test, checked at the top of
    each iteration as there.  The arithmetic of an active iteration is the
    stopped solver's, so the result equals it bit for bit."""
    r = b - A(x)
    p = r
    rz = _dot(r, r)
    tol2 = (rtol * torch.sqrt(_dot(b, b))) ** 2
    for _ in range(iters):
        active = _dot(r, r) > tol2
        Ap = A(p)
        alpha = rz / _dot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        rz_new = _dot(r_new, r_new)
        beta = rz_new / rz
        p_new = r_new + beta * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
    return x


def v_cycle(hier: MGHierarchy, A: Callable, b, x):
    """One V-cycle with the configured smoother and bottom solver
    (`multigrid.c:752-1348` + factories :1509-1603).

    Traced (`util/trace.py`): one span `d4est.mg.vcycle` a call (no host
    read inside, so it holds the host's enqueue, and the card's time only
    where the launch queue fills), and the run's counters `mg.vcycles`,
    `mg.levels` (its deepest hierarchy) and `mg.applies.fine` /
    `mg.applies.coarse`, the level operators' applies on the finest and
    on the coarser levels (the bottom's dense matrix-vector products are
    not level-operator applies)."""
    p = hier.params
    deg = hier.meshes[0].deg
    dim = hier.meshes[0].dim
    if p.smoother not in SMOOTHERS:
        raise ValueError(f"unknown MG smoother {p.smoother!r}")
    if p.bottom not in BOTTOMS:
        raise ValueError(f"unknown MG bottom solver {p.bottom!r}")

    def smooth(level, A_l, b_l, x_l):
        if p.smoother == "none":
            return x_l
        if p.smoother == "schwarz_overlap":
            from disco4est_tpu_torch.solvers.schwarz_overlap import (
                overlap_schwarz_smooth,
            )

            return overlap_schwarz_smooth(
                A_l, hier.smoother_state[level], b_l, x_l,
                iterations=p.schwarz_iterations, damping=1.0)
        if p.smoother == "schwarz":
            from disco4est_tpu_torch.solvers.schwarz import schwarz_smooth

            return schwarz_smooth(
                A_l, hier.smoother_state[level], b_l, x_l,
                iterations=p.schwarz_iterations, damping=p.schwarz_damping)
        lmin, lmax = hier.bounds[level]
        return cheby_smooth(A_l, b_l, x_l, lmin, lmax, p.n_smooth)

    def bottom(level, A_l, b_l, x_l):
        if p.bottom == "reuse_smoother":
            return smooth(level, A_l, b_l, x_l)
        Ad = hier.bottom_matrix
        if Ad is not None:  # the operator `mg_setup` was given, assembled
            A_l = lambda v: (Ad.to(v.dtype) @ v.reshape(-1)).reshape(v.shape)
        if p.bottom == "cheby":
            lmin, lmax = hier.bounds[level]
            return cheby_smooth(A_l, b_l, x_l, lmin, lmax, p.bottom_iters)
        return bottom_cg(A_l, b_l, x_l, p.bottom_rtol, p.bottom_iters)

    def transfer_down(level, r):
        """level -> level+1 (hp: r_c = P_cᵀ Tᵀ Rᵀ r, conjugated with the
        padded p-embeddings)."""
        lm = hier.maps[level]
        n_c = hier.meshes[level + 1].n_elements
        if not hier.hp:
            return restrict(lm, r, deg, dim, n_c)
        from disco4est_tpu_torch.laplacian.hp import (
            adjoint_restrict_to_storage,
            adjoint_to_own,
        )

        s = adjoint_restrict_to_storage(hier.meshes[level], r)
        return adjoint_to_own(hier.meshes[level + 1],
                              restrict(lm, s, deg, dim, n_c))

    def transfer_up(level, e_c):
        """level+1 -> level (hp: e_f = R T P_c e_c; the coarse hp space
        embeds in the fine one under the min-degree rule)."""
        lm = hier.maps[level]
        if not hier.hp:
            return prolong(lm, e_c, deg, dim)
        from disco4est_tpu_torch.laplacian.hp import restrict_to_own, to_max

        e_s = prolong(lm, to_max(hier.meshes[level + 1], e_c), deg, dim)
        return restrict_to_own(hier.meshes[level], e_s)

    applies = [0, 0]  # finest level, coarser levels

    def counted(level, A_l):
        k = min(level, 1)

        def op(v):
            applies[k] += 1
            return A_l(v)
        return op

    def cycle(level, b_l, x_l):
        A_l = counted(level, level_operator(hier, A, level))
        if level == hier.n_levels - 1:
            return bottom(level, A_l, b_l, x_l)
        x_l = smooth(level, A_l, b_l, x_l)
        r_c = transfer_down(level, b_l - A_l(x_l))
        e_c = cycle(level + 1, r_c, torch.zeros_like(r_c))
        x_l = x_l + transfer_up(level, e_c)
        return smooth(level, A_l, b_l, x_l)

    with trace.span("d4est.mg.vcycle"):
        out = cycle(0, b, x)
    # `cycle` calls itself through its closure cell: emptying the cell
    # breaks that reference cycle, which would otherwise keep the
    # hierarchy (its meshes and fields) alive until Python's cyclic
    # collector runs, after the epoch and perhaps into the next one
    del cycle
    trace.count("mg.vcycles")
    trace.high("mg.levels", hier.n_levels)
    trace.count("mg.applies.fine", applies[0])
    trace.count("mg.applies.coarse", applies[1])
    return out


def mg_solve(hier: MGHierarchy, A: Callable, b, x0=None):
    """Standalone V-cycle iteration to tolerance
    (`d4est_solver_multigrid_solve` :1421); reads the residual norm back
    after each cycle.  Returns (x, residual-norm history)."""
    p = hier.params
    x = torch.zeros_like(b) if x0 is None else x0
    mesh = hier.meshes[0]
    norm = lambda v: float(torch.linalg.norm((b - A(mesh, v)).reshape(-1)))
    hist = [norm(x)]
    for _ in range(p.vcycle_imax):
        x = v_cycle(hier, A, b, x)
        hist.append(norm(x))
        if hist[-1] < p.vcycle_atol or hist[-1] < p.vcycle_rtol * hist[0]:
            break
    return x, hist


def graph_eligible(hier: MGHierarchy, device) -> bool:
    """Whether `MGPreconditioner` replays this hierarchy's V-cycle as a
    CUDA graph: a field on a card, a single-degree hierarchy, a Chebyshev
    smoother or none, and a CG or Chebyshev bottom.  The Schwarz
    smoothers and hp hierarchies stay eager."""
    p = hier.params
    return (torch.device(device).type == "cuda" and not hier.hp
            and p.smoother in ("cheby", "none")
            and p.bottom in ("cg", "cheby"))


def _capture(fn):
    """(graph, out): `out = fn()` captured as a CUDA graph, not run."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


class MGPreconditioner:
    """One V-cycle from a zero guess as a Krylov preconditioner
    (`d4est_krylov_pc_multigrid.c`), replayed as a CUDA graph where
    `graph_eligible`.

    The cycle reads nothing back and its Chebyshev scalars are host
    floats fixed by `mg_setup`, so it is one fixed sequence of launches
    for the epoch.  The first call runs `v_cycle` eagerly (it fills the
    lazy device tables, which a capture cannot make); the second copies
    `r` into a static input and captures `v_cycle` on it, from zeros made
    inside the capture, then launches the graph; every later call copies
    `r` in and launches it again.  Each call returns a fresh tensor.  A
    capture that raises leaves the epoch on eager cycles (counter
    `mg.graph.fallbacks`).  `eager=True` keeps every call eager.

    Traced: each call is one span `d4est.mg.vcycle` and adds the cycle's
    counters (`mg.vcycles`, `mg.applies.*`); a graph launch's span holds
    the copy and the launch, and the card's time falls in the caller's
    next read.  The capture call's `v_cycle` span lies in a span
    `d4est.mg.graph.capture` that also holds the instantiation and the
    first launch.  Counters `mg.graph.captures` and `mg.graph.replays`
    (graph launches, the capture call's included).

    The object belongs to one epoch: the hierarchy must not change after
    the second call, every `r` has the second call's shape and dtype, and
    `release` frees the graph, its memory pool and the static buffers
    when the epoch's solve is over."""

    def __init__(self, hier: MGHierarchy, A: Callable, *, eager=False):
        self.hier, self.A, self.eager = hier, A, eager
        self.calls = 0
        self.graph = self.b = self.out = self.counts = None

    def _cycle(self, r):
        return v_cycle(self.hier, self.A, r, torch.zeros_like(r))

    def __call__(self, r):
        self.calls += 1
        if self.graph is not None:
            with trace.span("d4est.mg.vcycle"):
                self.b.copy_(r)
                self.graph.replay()
                out = self.out.clone()
            self._launched()
            return out
        if (self.calls == 2 and not self.eager
                and graph_eligible(self.hier, r.device)):
            out = self._capture(r)
            if out is not None:
                return out
        return self._cycle(r)

    def _capture(self, r):
        b = r.clone()
        try:
            with trace.span("d4est.mg.graph.capture"), \
                    trace.tally() as counts:
                graph, out = _capture(lambda: self._cycle(b))
                graph.replay()
        except RuntimeError:
            trace.count("mg.graph.fallbacks")
            return None
        self.graph, self.b, self.out, self.counts = graph, b, out, counts
        trace.count("mg.graph.captures")
        self._launched()
        return out.clone()

    def _launched(self):
        self.counts.add()
        trace.count("mg.graph.replays")

    def release(self):
        """Drop the graph, its pool and the static buffers; later calls
        run eagerly.  cuBLAS keeps a workspace for each stream it has run
        on (32 MiB on an H100), allocated through the caching allocator:
        the capture stream's lies in the graph's pool and would stay
        allocated for the life of the process, so the workspaces are
        cleared too (the next cuBLAS call makes its stream's again)."""
        if self.graph is None:
            return
        cuda = self.b.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.b.device)
        self.graph = self.b = self.out = self.counts = None
        if cuda:
            torch._C._cuda_clearCublasWorkspaces()


def mg_preconditioner(hier: MGHierarchy, A: Callable, *, eager=False):
    """One V-cycle from a zero guess as a Krylov preconditioner
    (`d4est_krylov_pc_multigrid.c`): an `MGPreconditioner`."""
    return MGPreconditioner(hier, A, eager=eager)
