"""The shard-resident hp-multigrid: every level stays distributed.

Port of `disco4est_tpu/parallel/mg.py` (role of the reference's
distributed V-cycle, `Solver/d4est_solver_multigrid.c:752-1348`, whose
levels stay partitioned with per-level ghost caches,
`d4est_solver_multigrid.h:167-183`):

- every level gets its own node-weighted `PaddedLayout`, its rank block
  and its `HaloProgram` (the per-level ghost cache);
- smoothers and the bottom solve apply through the level's halo program;
- restriction and prolongation between level layouts exchange once each:
  all layouts are contiguous cuts of the same space-filling curve, so only
  families that straddle a cut move (`LevelTransfer`; its host tables
  equal the JAX package's entry by entry);
- dot products are the communicator's global, fixed-order dots.

The V-cycle never gathers a level to global order.  As in
`solvers/multigrid.py` the coarse levels take the fine mesh's penalty
options (ROADMAP C12) and the child rows of a coarse element are summed
in one fixed order.  The bottom CG runs on the level's halo operator and
stops at its test, as the JAX module's does: its iterate is the one
`solvers/multigrid.bottom_cg` (a fixed loop whose updates freeze) gives,
which would run every one of its global dots to the end.

A Schwarz smoother raises here: the JAX module treats every smoother
other than `none` as Chebyshev (`parallel/mg.py:428`, ROADMAP C2), and a
distributed Schwarz exists in neither package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from disco4est_tpu_torch.laplacian.hp import (
    adjoint_restrict_to_storage,
    adjoint_to_own,
    restrict_to_own,
    to_max,
)
from disco4est_tpu_torch.parallel.halo import (
    apply_sipg_halo,
    apply_sipg_hp_halo,
    build_halo_program,
)
from disco4est_tpu_torch.parallel.repartition import (
    PaddedLayout,
    migrate_field,
    pad_mesh_to_layout,
)
from disco4est_tpu_torch.parallel.sharding import shard_field, shard_mesh_data
from disco4est_tpu_torch.solvers.cg import cg_solve
from disco4est_tpu_torch.solvers.cheby import cheby_smooth
from disco4est_tpu_torch.solvers.eigs import cg_eigs
from disco4est_tpu_torch.solvers.multigrid import (
    MGHierarchy,
    _apply_child,
    _hp_mats,
)


def _exchange(n_dev, B, need):
    """Send/receive tables of a one-shot row exchange: `need[dst]` lists
    the padded rows (of an [n_dev·B] array) rank `dst` must receive.
    Returns (send_idx [n, n, K], recv_pos [n, n, K], H, index_of) with
    `index_of[dst][row]` its halo slot; pad slots point at H (trash)."""
    send_lists: dict = {}
    index_of = []
    for dst in range(n_dev):
        rows = sorted(set(int(r) for r in need[dst]))
        index_of.append({r: i for i, r in enumerate(rows)})
        for r in rows:
            src = r // B
            send_lists.setdefault((src, dst), []).append(r - src * B)
    H = max((len(ix) for ix in index_of), default=0)
    K = max([len(v) for v in send_lists.values()] + [1])
    send_idx = np.zeros((n_dev, n_dev, K), np.int32)
    recv_pos = np.full((n_dev, n_dev, K), H, np.int32)
    for (src, dst), locs in send_lists.items():
        for k, loc in enumerate(locs):
            send_idx[src, dst, k] = loc
            recv_pos[dst, src, k] = index_of[dst][src * B + loc]
    return send_idx, recv_pos, H, index_of


@dataclasses.dataclass
class LevelTransfer:
    """Restriction/prolongation between two level layouts: host tables of
    every rank (leading axis n where per rank)."""

    n_dev: int
    Bf: int
    Bc: int
    Hr: int  # restrict-direction halo slots
    Hp: int  # prolong-direction halo slots
    Kc: int  # max children per coarse row
    D: int  # bit-path depth
    bits: np.ndarray  # [Rf, D, dim] per fine padded row (2 = identity)
    copy: np.ndarray  # [Rf] bool
    r_send: np.ndarray  # [n, n, Kr] fine contribution rows to send
    r_recv: np.ndarray  # [n, n, Kr]
    child_rows: np.ndarray  # [n, Bc, Kc] into [Bf+Hr+1) (pad = trash)
    p_send: np.ndarray  # [n, n, Kp] coarse rows to send
    p_recv: np.ndarray  # [n, n, Kp]
    parent_rows: np.ndarray  # [n, Bf] into [Bc+Hp+1) (pad = trash)

    def local(self, rank: int, device) -> "LocalTransfer":
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64),  # noqa
                                      device=device)
        f = slice(rank * self.Bf, (rank + 1) * self.Bf)
        return LocalTransfer(
            n_dev=self.n_dev, Bf=self.Bf, Bc=self.Bc, Hr=self.Hr,
            Hp=self.Hp, bits=t(self.bits[f]),
            copy=torch.as_tensor(self.copy[f], device=device),
            r_send=t(self.r_send[rank]), r_recv=t(self.r_recv[rank]),
            child_rows=t(self.child_rows[rank]),
            p_send=t(self.p_send[rank]), p_recv=t(self.p_recv[rank]),
            parent_rows=t(self.parent_rows[rank]))


@dataclasses.dataclass
class LocalTransfer:
    """One rank's level-transfer tables, torch on its device."""

    n_dev: int
    Bf: int
    Bc: int
    Hr: int
    Hp: int
    bits: torch.Tensor  # [Bf, D, dim]
    copy: torch.Tensor  # [Bf]
    r_send: torch.Tensor  # [n, Kr]
    r_recv: torch.Tensor  # [n, Kr]
    child_rows: torch.Tensor  # [Bc, Kc]
    p_send: torch.Tensor  # [n, Kp]
    p_recv: torch.Tensor  # [n, Kp]
    parent_rows: torch.Tensor  # [Bf]


def build_level_transfer(level_map, layout_f: PaddedLayout,
                         layout_c: PaddedLayout, n_dev: int
                         ) -> LevelTransfer:
    """The transfer tables between a fine and a coarse level layout, from
    the hierarchy's `MGLevelMap` (JAX `build_level_transfer`)."""
    src = level_map.src_np  # [Ef] global coarse parent
    bits_g = level_map.bits_np  # [Ef, D, dim]
    copy_g = level_map.copy_np
    Ef = src.shape[0]
    D, dim = bits_g.shape[1], bits_g.shape[2]
    Bf, Bc = layout_f.Bmax, layout_c.Bmax

    fp = layout_f.src >= 0
    fpad_of = np.full(Ef, -1, np.int64)  # global fine -> fine padded row
    fpad_of[layout_f.src[fp]] = np.where(fp)[0]
    Ec = int(src.max(initial=-1)) + 1
    cp = layout_c.src >= 0
    cpad_of = np.full(max(Ec, 1), -1, np.int64)
    cpad_of[layout_c.src[cp]] = np.where(cp)[0]

    Rf = layout_f.padded_size
    bits = np.full((Rf, D, dim), 2, np.int32)
    copy = np.ones(Rf, bool)
    bits[fp] = bits_g[layout_f.src[fp]]
    copy[fp] = copy_g[layout_f.src[fp]]

    # the children of each coarse padded row, ascending fine ids
    children: list = [[] for _ in range(layout_c.padded_size)]
    for fine in range(Ef):
        children[cpad_of[src[fine]]].append(int(fpad_of[fine]))
    Kc = max([len(c) for c in children] + [1])

    # restrict exchange: fine rows whose parent lives on another rank
    need_r = [set() for _ in range(n_dev)]
    for j, ch in enumerate(children):
        s_c = j // Bc
        for fr in ch:
            if fr // Bf != s_c:
                need_r[s_c].add(fr)
    r_send, r_recv, Hr, ix_r = _exchange(n_dev, Bf, need_r)
    child_rows = np.full((n_dev, Bc, Kc), Bf + Hr, np.int32)  # trash row
    for j, ch in enumerate(children):
        s_c, jr = divmod(j, Bc)
        for k, fr in enumerate(ch):
            child_rows[s_c, jr, k] = (fr - s_c * Bf if fr // Bf == s_c
                                      else Bf + ix_r[s_c][fr])

    # prolong exchange: coarse rows needed by fine rows on another rank
    need_p = [set() for _ in range(n_dev)]
    parent_pad = np.full(Rf, -1, np.int64)
    parent_pad[fp] = cpad_of[src[layout_f.src[fp]]]
    for r in range(Rf):
        pj = parent_pad[r]
        if pj >= 0 and pj // Bc != r // Bf:
            need_p[r // Bf].add(int(pj))
    p_send, p_recv, Hp, ix_p = _exchange(n_dev, Bc, need_p)
    parent_rows = np.full((n_dev, Bf), Bc + Hp, np.int32)
    for r in range(Rf):
        s_f, rr = divmod(r, Bf)
        pj = parent_pad[r]
        if pj < 0:
            continue
        parent_rows[s_f, rr] = (pj - s_f * Bc if pj // Bc == s_f
                                else Bc + ix_p[s_f][int(pj)])

    return LevelTransfer(
        n_dev=n_dev, Bf=Bf, Bc=Bc, Hr=Hr, Hp=Hp, Kc=Kc, D=D, bits=bits,
        copy=copy, r_send=r_send, r_recv=r_recv, child_rows=child_rows,
        p_send=p_send, p_recv=p_recv, parent_rows=parent_rows)


def _receive(own, recv, recv_pos, H):
    """[own rows; H halo slots; a zero trash row] from one exchange."""
    shape = tuple(own.shape[1:])
    halo = own.new_zeros((H + 1,) + shape)
    halo.index_copy_(0, recv_pos.reshape(-1), recv.reshape((-1,) + shape))
    halo[H] = 0  # pad blocks landed in the trash slot
    return torch.cat([own, halo])


def restrict_sharded(tl: LocalTransfer, r_f, deg, dim, comm):
    """Fine residual rows [Bf, nl...] -> coarse rows [Bc, nl...]: the
    adjoint child transforms (local), one exchange of the contributions
    whose parent lives elsewhere, then each coarse row's children summed
    in one fixed order."""
    hpT = _hp_mats(deg, r_f.dtype, r_f.device).transpose(1, 2)
    out = r_f
    for k in range(tl.bits.shape[1] - 1, -1, -1):
        for d in range(dim):
            out = _apply_child(hpT, tl.bits[:, k, d], out, d)
    cshape = (-1,) + (1,) * dim
    contrib = torch.where(tl.copy.reshape(cshape), r_f, out)
    send = contrib[tl.r_send.reshape(-1)].reshape(
        (tl.n_dev, -1) + tuple(contrib.shape[1:]))
    ext = _receive(contrib, comm.exchange(send), tl.r_recv, tl.Hr)
    return ext[tl.child_rows].sum(1)


def prolong_sharded(tl: LocalTransfer, e_c, deg, dim, comm):
    """Coarse rows [Bc, nl...] -> fine rows [Bf, nl...]: one exchange of
    the coarse rows whose children live elsewhere, then each fine row's
    child transform (local)."""
    hp = _hp_mats(deg, e_c.dtype, e_c.device)
    send = e_c[tl.p_send.reshape(-1)].reshape(
        (tl.n_dev, -1) + tuple(e_c.shape[1:]))
    ext = _receive(e_c, comm.exchange(send), tl.p_recv, tl.Hp)
    vals = ext[tl.parent_rows]
    out = vals
    for k in range(tl.bits.shape[1]):
        for d in range(dim):
            out = _apply_child(hp, tl.bits[:, k, d], out, d)
    cshape = (-1,) + (1,) * dim
    return torch.where(tl.copy.reshape(cshape), vals, out)


@dataclasses.dataclass
class ShardedHierarchy:
    """The rank's part of every level of an `MGHierarchy`."""

    hier: MGHierarchy  # the global hierarchy (params, hp flag, meshes)
    comm: object
    layouts: list  # PaddedLayout per level
    meshes: list  # the rank's block of each level's padded mesh
    halos: list  # LocalHalo per level
    transfers: list  # LocalTransfer per level gap
    bounds: list | None = None  # [(lmin, lmax)] host floats per level

    @property
    def n_levels(self):
        return len(self.meshes)


def smoother_refusal(smoother: str) -> str | None:
    """Why the sharded V-cycle cannot run `smoother`, or None: it has no
    Schwarz smoother (the JAX module runs Chebyshev for one, ROADMAP C2).
    The driver refuses such options before any rank joins a group."""
    if smoother in ("schwarz", "schwarz_overlap"):
        return (f"[parallelism] with the multigrid smoother {smoother!r}: "
                "the distributed V-cycle has no Schwarz smoother (the JAX "
                "package runs Chebyshev instead, ROADMAP C2)")
    return None


def build_sharded_hierarchy(hier: MGHierarchy, comm) -> ShardedHierarchy:
    """Distribute every level: node-weighted layout, halo program (the
    reference's per-level ghost caches) and the level transfers.  The
    Newton-MG matrix operator (`nl_blocks`) has no sharded form: the
    driver refuses a preconditioned distributed Newton solve (C6)."""
    msg = smoother_refusal(hier.params.smoother)
    if msg:
        raise NotImplementedError(msg)
    assert hier.nl_blocks is None, "Newton-MG blocks are not sharded (C6)"
    n, rank, dev = comm.size, comm.rank, comm.device
    layouts, meshes, halos = [], [], []
    for m in hier.meshes:
        lay = PaddedLayout.build((m.deg_e.cpu().numpy() + 1) ** m.dim, n)
        mp = pad_mesh_to_layout(m, lay)
        halos.append(build_halo_program(mp, n).local(rank, dev))
        meshes.append(shard_mesh_data(mp, rank, n, dev))
        layouts.append(lay)
    transfers = [build_level_transfer(hier.maps[i], layouts[i],
                                      layouts[i + 1], n).local(rank, dev)
                 for i in range(len(hier.maps))]
    return ShardedHierarchy(hier=hier, comm=comm, layouts=layouts,
                            meshes=meshes, halos=halos, transfers=transfers)


def level_operator(sh: ShardedHierarchy, level: int):
    """The level's halo operator on the rank's rows (hp on hp
    hierarchies)."""
    mesh, halo = sh.meshes[level], sh.halos[level]
    apply = apply_sipg_hp_halo if sh.hier.hp else apply_sipg_halo
    return lambda v: apply(mesh, halo, v, sh.comm)


def mg_setup_sharded(sh: ShardedHierarchy, seed_field):
    """Per-level Chebyshev bounds from CG-Lanczos on the halo operator
    with global dots (JAX `mg_setup_sharded`); `seed_field(mesh)` makes the
    start vector on the level's global mesh, which is migrated into the
    level layout.  Bounds are estimated where a Chebyshev smoother or
    bottom needs them, as `solvers/multigrid.mg_setup` does."""
    p = sh.hier.params
    bounds = []
    for level in range(sh.n_levels):
        if p.smoother == "cheby" or p.bottom == "cheby":
            b = shard_field(migrate_field(seed_field(sh.hier.meshes[level]),
                                          sh.layouts[level]),
                            sh.comm.rank, sh.comm.size, sh.comm.device)
            _, lmax = cg_eigs(level_operator(sh, level), b, p.eigs_cg_iters,
                              dot=sh.comm.dot)
            lmax = lmax * p.lmax_multiplier
            bounds.append((lmax / p.lmax_lmin_ratio, lmax))
        else:
            bounds.append((0.0, 1.0))
    sh.bounds = bounds
    return bounds


def v_cycle_sharded(sh: ShardedHierarchy, b, x):
    """One V-cycle on the rank's rows of every level (JAX
    `v_cycle_sharded`): Chebyshev (or no) smoothing through the level halo
    programs, one exchange per level transfer, the bottom solve with
    global dots; no gather to global order anywhere."""
    p = sh.hier.params
    deg, dim = sh.hier.meshes[0].deg, sh.hier.meshes[0].dim
    comm = sh.comm

    def smooth(level, A_l, b_l, x_l):
        if p.smoother == "none":
            return x_l
        lmin, lmax = sh.bounds[level]
        return cheby_smooth(A_l, b_l, x_l, lmin, lmax, p.n_smooth)

    def bottom(level, A_l, b_l, x_l):
        if p.bottom == "reuse_smoother":
            return smooth(level, A_l, b_l, x_l)
        if p.bottom == "cheby":
            lmin, lmax = sh.bounds[level]
            return cheby_smooth(A_l, b_l, x_l, lmin, lmax, p.bottom_iters)
        # `bottom_cg`'s iterate, but stopped at its test: the global dots
        # read the host already, and the fixed loop would run them all
        return cg_solve(A_l, b_l, x0=x_l, atol=0.0, rtol=p.bottom_rtol,
                        max_iter=p.bottom_iters, dot=comm.dot).x

    def transfer_down(level, r):
        tl = sh.transfers[level]
        if not sh.hier.hp:
            return restrict_sharded(tl, r, deg, dim, comm)
        s = adjoint_restrict_to_storage(sh.meshes[level], r)
        return adjoint_to_own(sh.meshes[level + 1],
                              restrict_sharded(tl, s, deg, dim, comm))

    def transfer_up(level, e_c):
        tl = sh.transfers[level]
        if not sh.hier.hp:
            return prolong_sharded(tl, e_c, deg, dim, comm)
        e_s = prolong_sharded(tl, to_max(sh.meshes[level + 1], e_c), deg,
                              dim, comm)
        return restrict_to_own(sh.meshes[level], e_s)

    def cycle(level, b_l, x_l):
        A_l = level_operator(sh, level)
        if level == sh.n_levels - 1:
            return bottom(level, A_l, b_l, x_l)
        x_l = smooth(level, A_l, b_l, x_l)
        r_c = transfer_down(level, b_l - A_l(x_l))
        e_c = cycle(level + 1, r_c, torch.zeros_like(r_c))
        x_l = x_l + transfer_up(level, e_c)
        return smooth(level, A_l, b_l, x_l)

    return cycle(0, b, x)
