"""Forest of octrees as flat arrays — the p4est role, array-programmed.

The reference builds on p4est (`p4est_t`, refine/coarsen/balance/partition,
`src/pXest/pXest.h`); here a `Forest` is a struct-of-arrays of leaves
(tree id, level, integer anchor coordinates), always kept in space-filling
curve order (per-tree Morton order, trees ascending — identical traversal
order to p4est).  Construction, refinement and the sorted keys used for
leaf lookup are vectorized numpy host programs; they run once per mesh
epoch, not in the solver hot loop, exactly as p4est does for the reference.

Coordinates: each tree is a unit cube of side `ROOT = 2**MAXL` integer
units; a leaf at level l has side `ROOT >> l` and anchor on that lattice.
Child ordering within a refined cell is x-fastest (p4est's Morton child
order).

Port of `disco4est_tpu/mesh/tree.py` (host numpy): `Forest.uniform`,
`refine`, `coarsen`, 2:1 `balance` and leaf lookup.  `checksum` comes with
checkpoints (ROADMAP A14).

One deliberate difference from the JAX module: every leaf lookup
(`Forest.find_leaves`, and through it `find_leaf`, the balance test, the
created-parent mask of `coarsen` and `amr.element_lineage`) searches each
tree's own slice of the leaf order.  The JAX module packs the tree id above
bit 60 of the uint64 Morton key, so tree ids of 16 and above wrap and
bricks with more than 16 trees find wrong leaves there (ROADMAP C8).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from disco4est_tpu_torch.geometry.base import Connectivity

MAXL = 19
ROOT = 1 << MAXL


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread 19 bits of x so there are two zero bits between each."""
    x = x.astype(np.uint64)
    x &= np.uint64(0x7FFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def _part1by1(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x &= np.uint64(0xFFFFFFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def morton_key(anchor: np.ndarray, dim: int) -> np.ndarray:
    """Morton (z-order) key of anchor coords [..., dim]; x is the fastest
    (least significant) axis, matching p4est quadrant order."""
    if dim == 2:
        return _part1by1(anchor[..., 0]) | (_part1by1(anchor[..., 1]) << np.uint64(1))
    return (
        _part1by2(anchor[..., 0])
        | (_part1by2(anchor[..., 1]) << np.uint64(1))
        | (_part1by2(anchor[..., 2]) << np.uint64(2))
    )


@dataclasses.dataclass
class Forest:
    conn: Connectivity
    tree: np.ndarray  # [E] int32
    level: np.ndarray  # [E] int8
    anchor: np.ndarray  # [E, dim] int32

    @property
    def dim(self) -> int:
        return self.conn.dim

    @property
    def n_elements(self) -> int:
        return len(self.tree)

    def sorted(self) -> "Forest":
        key = morton_key(self.anchor, self.dim)
        order = np.lexsort((key, self.tree))
        return Forest(
            self.conn, self.tree[order], self.level[order], self.anchor[order]
        )

    # ------------------------------------------------------------------
    # Construction / refinement / coarsening
    # ------------------------------------------------------------------

    @staticmethod
    def uniform(conn: Connectivity, level: int) -> "Forest":
        dim = conn.dim
        n_per_tree = (1 << level) ** dim
        h = ROOT >> level
        coords = np.stack(
            np.meshgrid(*([np.arange(1 << level)] * dim), indexing="ij"),
            axis=-1,
        ).reshape(-1, dim)
        # meshgrid 'ij' makes the first axis slowest; we want x fastest in
        # morton order anyway since we sort below.
        anchor_1tree = (coords * h).astype(np.int32)
        T = conn.n_trees
        tree = np.repeat(np.arange(T, dtype=np.int32), n_per_tree)
        anchor = np.tile(anchor_1tree, (T, 1))
        level_arr = np.full(T * n_per_tree, level, np.int8)
        return Forest(conn, tree, level_arr, anchor).sorted()

    def refine(self, flags: np.ndarray) -> "Forest":
        """Replace each flagged leaf with its 2^dim children (in Morton
        child order). Returns a new SFC-sorted forest.
        Role of `p4est_refine_ext` in `hpAMR/d4est_amr.c:286`."""
        flags = np.asarray(flags, bool)
        dim = self.dim
        keep = ~flags
        child_off = _child_offsets(dim)  # [2^dim, dim] in {0,1}
        parents = np.where(flags)[0]
        h_half = (ROOT >> self.level[parents].astype(np.int32)) >> 1
        child_anchor = (
            self.anchor[parents][:, None, :]
            + child_off[None, :, :] * h_half[:, None, None]
        ).reshape(-1, dim)
        child_tree = np.repeat(self.tree[parents], 1 << dim)
        child_level = np.repeat(self.level[parents] + 1, 1 << dim)
        return Forest(
            self.conn,
            np.concatenate([self.tree[keep], child_tree]).astype(np.int32),
            np.concatenate([self.level[keep], child_level]).astype(np.int8),
            np.concatenate([self.anchor[keep], child_anchor]).astype(np.int32),
        ).sorted()

    def coarsen(self, flags: np.ndarray) -> tuple["Forest", np.ndarray]:
        """Coarsen complete sibling families whose members are all flagged
        (`p4est_coarsen_ext` semantics).  Returns (new forest,
        family_replaced[new_E] bool mask marking the created parents)."""
        dim = self.dim
        flags = np.asarray(flags, bool)
        E = self.n_elements
        nch = 1 << dim
        # A family is nch consecutive leaves (SFC order) with same tree,
        # same level, first one anchored at the parent anchor & child id 0.
        h = (ROOT >> self.level.astype(np.int32))[:, None]
        child_id = ((self.anchor // h) & 1).astype(np.int8)
        is_first = np.all(child_id == 0, axis=1)
        cand = np.where(is_first[: E - nch + 1] if E >= nch else [])[0]
        keep = np.ones(E, bool)
        new_parents = []
        for i in cand:
            j = i + nch
            lv = self.level[i]
            if not np.all(self.level[i:j] == lv):
                continue
            if not np.all(self.tree[i:j] == self.tree[i]):
                continue
            if not np.all(flags[i:j]):
                continue
            # verify siblings: same parent anchor
            hp = ROOT >> int(lv - 1)
            pa = self.anchor[i] - (self.anchor[i] % hp)
            if not np.all((self.anchor[i:j] - self.anchor[i:j] % hp) == pa):
                continue
            keep[i:j] = False
            new_parents.append((self.tree[i], lv - 1, pa))
        if not new_parents:
            return self, np.zeros(E, bool)
        pt = np.array([p[0] for p in new_parents], np.int32)
        pl = np.array([p[1] for p in new_parents], np.int8)
        pa = np.array([p[2] for p in new_parents], np.int32)
        out = Forest(
            self.conn,
            np.concatenate([self.tree[keep], pt]),
            np.concatenate([self.level[keep], pl]),
            np.concatenate([self.anchor[keep], pa]),
        ).sorted()
        # mark the created parents in the new ordering: each parent's
        # anchor lies in the parent itself
        mask = np.zeros(out.n_elements, bool)
        mask[out.find_leaves(pt, pa)] = True
        return out, mask

    # ------------------------------------------------------------------
    # Leaf lookup
    # ------------------------------------------------------------------

    def find_leaf(self, tree: np.ndarray, point: np.ndarray) -> np.ndarray:
        """Index of the leaf containing integer point coords [..., dim]
        inside `tree`.  Points must be inside the tree ([0, ROOT))."""
        point = np.asarray(point)
        tree = np.broadcast_to(np.asarray(tree), point.shape[:-1])
        idx = self.find_leaves(tree.reshape(-1),
                               point.reshape(-1, self.dim))
        return idx.reshape(point.shape[:-1])

    def find_leaves(self, tree: np.ndarray, point: np.ndarray) -> np.ndarray:
        """Index of the leaf of tree `tree[i]` whose cell holds lattice
        point `point[i]`, for in-tree points: the last leaf of that tree
        whose Morton key is not above the point's.  The search runs
        within each tree's own slice of the (tree-major, Morton-minor)
        leaf order, so it has no packed tree-and-key integer that more
        trees could overflow."""
        tree = np.asarray(tree)
        q = morton_key(np.asarray(point), self.dim)
        keys = morton_key(self.anchor, self.dim)
        starts = np.searchsorted(self.tree, np.arange(self.conn.n_trees + 1))
        idx = np.empty(len(tree), np.int64)
        for t in np.unique(tree):
            sel = tree == t
            lo, hi = starts[t], starts[t + 1]
            idx[sel] = lo + np.searchsorted(keys[lo:hi], q[sel],
                                            side="right") - 1
        return idx

    # ------------------------------------------------------------------
    # 2:1 balance
    # ------------------------------------------------------------------

    def balance(self) -> "Forest":
        """2:1 balance across faces, edges and corners (the reference uses
        `p4est_balance(CONNECT_FULL)`, `driver.c:154`).  Iterative fixpoint:
        refine any leaf more than one level coarser than a neighbor."""
        forest = self
        for _ in range(64):
            flags = forest._balance_violations()
            if not flags.any():
                return forest
            forest = forest.refine(flags)
        raise RuntimeError("2:1 balance did not converge")

    def _balance_violations(self) -> np.ndarray:
        E = self.n_elements
        flags = np.zeros(E, bool)
        if E == 0:
            return flags
        h = (ROOT >> self.level.astype(np.int32)).astype(np.int64)
        anchor = self.anchor.astype(np.int64)
        # All neighbor directions: offsets in {-1, 0, +1}^dim \ {0}
        for off in _neighbor_offsets(self.dim):
            # Point just outside e in direction off (one unit into the
            # neighbor cell at e's level).
            pt = anchor + np.where(
                off[None, :] < 0, -1, np.where(off[None, :] > 0, h[:, None], 0)
            )
            valid = np.ones(E, bool)
            pt, tree, valid = _canonicalize_points(
                self.conn, self.tree.astype(np.int32), pt, valid
            )
            if not valid.any():
                continue
            idx = self.find_leaves(tree[valid], pt[valid])
            # The found leaf contains the point; if it is >1 level coarser
            # than e, it must refine.
            lv_e = self.level[valid].astype(np.int32)
            lv_n = self.level[idx].astype(np.int32)
            flags[idx[lv_n < lv_e - 1]] = True
        return flags


def _child_offsets(dim: int) -> np.ndarray:
    c = np.arange(1 << dim)
    return np.stack([(c >> d) & 1 for d in range(dim)], axis=-1).astype(
        np.int64
    )


def _neighbor_offsets(dim: int):
    from itertools import product

    for off in product((-1, 0, 1), repeat=dim):
        if any(off):
            yield np.asarray(off[::-1], np.int64)  # index 0 = x axis


def _canonicalize_points(
    conn: Connectivity,
    tree: np.ndarray,
    pt: np.ndarray,
    valid: np.ndarray,
):
    """Map points that stepped outside their tree into the owning tree's
    coordinates via face connectivity transforms.

    The transform convention: for my face f the connectivity provides
    `axis_map` (my axis a ↦ neighbor axis axis_map[a]) and `axis_flip`
    (1 ⇒ my axis a runs opposite to its image), where the *normal* axis
    flip encodes whether the shared face is seen from the same side by
    both trees (flip = 1 iff my side == neighbor side).  With the normal
    coordinate first wrapped by ±ROOT, one uniform per-axis formula
    `val' = flip ? ROOT-1-val : val`, scattered through `axis_map`,
    handles normal and tangent axes alike.

    Points exiting through several faces (edge/corner cross-tree paths)
    are resolved by composing face transforms one exit-axis at a time;
    a path that hits a physical boundary marks the point invalid.  This
    covers brick/shell topologies exactly; exotic multi-valent corners
    (where the corner neighbor is not reachable by any face chain) are
    dropped conservatively.
    """
    pt = pt.copy()
    tree = tree.copy()
    valid = valid.copy()
    dim = conn.dim
    for _ in range(dim):
        out_low = pt < 0
        out_high = pt >= ROOT
        pending = valid & (out_low.any(axis=1) | out_high.any(axis=1))
        if not pending.any():
            break
        # first out-of-range axis per pending point
        outside = out_low | out_high
        first_axis = np.argmax(outside, axis=1)
        for axis in range(dim):
            for side in (0, 1):
                sel = (
                    pending
                    & (first_axis == axis)
                    & (out_high[:, axis] if side else out_low[:, axis])
                )
                if not sel.any():
                    continue
                idx = np.where(sel)[0]
                f = 2 * axis + side
                t = tree[idx]
                nbr_t = conn.nbr_tree[t, f]
                dead = nbr_t < 0
                valid[idx[dead]] = False
                live = idx[~dead]
                if len(live) == 0:
                    continue
                t = tree[live]
                amap = conn.axis_map[t, f].astype(np.int64)  # [k, dim]
                aflip = conn.axis_flip[t, f]
                p = pt[live].copy()
                p[:, axis] += -ROOT if side else ROOT
                newp = np.empty_like(p)
                for a in range(dim):
                    vals = p[:, a]
                    flipped = np.where(aflip[:, a] == 1, ROOT - 1 - vals, vals)
                    np.put_along_axis(
                        newp, amap[:, a][:, None], flipped[:, None], axis=1
                    )
                pt[live] = newp
                tree[live] = conn.nbr_tree[t, f]
    still_out = ((pt < 0) | (pt >= ROOT)).any(axis=1)
    valid &= ~still_out
    return pt, tree, valid
