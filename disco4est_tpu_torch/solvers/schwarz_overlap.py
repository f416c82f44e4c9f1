"""Overlapping additive Schwarz — vertex-patch subdomains with node strips.

Port of `disco4est_tpu/solvers/schwarz_overlap.py`, the materialized
variant and the K-slot one
(role of the reference's Schwarz subsystem: subdomain = center element +
every face/edge/corner neighbor with `num_nodes_overlap` 1D nodes of
overlap, `Solver/d4est_solver_schwarz_metadata.c:384-799`; quintic-hat
weights, `_schwarz_operators.c`; restricted SIPG subdomain operator;
per-subdomain CG; weighted correction, `_schwarz.c:172-280`):

- membership is found once per mesh epoch on the host, by probe points
  just outside every face, edge and corner of each element, located with
  the port's `Forest.find_leaves` (tree by tree: no packed tree-and-key
  integer, which wraps past 16 trees in the JAX module, ROADMAP C8);
- all subdomains are one replicated `MeshData` whose elements are the
  (subdomain, member) pairs plus one zero "dummy" element: faces leaving
  a subdomain point at the dummy, so one batched apply computes every
  restricted operator R_s A R_sᵀ at once;
- the subdomain solves are one batched masked CG with per-subdomain α/β
  and a fixed iteration count (no host read);
- the corrections are combined with the partition-of-unity weights.
  The JAX module adds them with `.at[].add`; here each element has a
  padded table of its (subdomain, slot) rows, built once per epoch, summed
  in one fixed order (ROADMAP C10).

The replicated mesh carries only the fields the apply reads: on a
conforming affine mesh without the pointwise penalty, the compact
factors; otherwise the per-point face and volume factors too.  The
JAX module's `optimization_barrier`s are TPU workarounds and have no
counterpart.  The K-slot variant (`build_overlapping_schwarz_kslot`,
`[d4est_solver_schwarz] subdomain_chunk > 0`, below) applies the same
operator chunk by chunk from resident integer tables.

The host builds every table once per epoch with vectorized numpy
(`_slots`, `_face_tables`, `_mortar_pairs`); the device part gathers the
factor rows the subdomain apply reads (`_gather_fields`,
`_gather_hanging`): once for the whole replicated mesh in the
materialized variant, per chunk inside each apply in the K-slot one.
"""

from __future__ import annotations

import dataclasses
from itertools import product

import numpy as np
import torch

from disco4est_tpu_torch.laplacian.sipg import apply_sipg
from disco4est_tpu_torch.mesh.builder import MeshData
from disco4est_tpu_torch.mesh.tree import ROOT, Forest, _canonicalize_points
from disco4est_tpu_torch.ops.operators import DB


# ---------------------------------------------------------------------------
# membership (host, once per epoch)
# ---------------------------------------------------------------------------


def _offsets(dim):
    """The probe directions in the JAX module's order, without 0."""
    return [off for off in product((-1, 0, 1), repeat=dim) if any(off)]


def _probe_hits(forest: Forest):
    """Every probe hit: arrays (e, n, off index, nnz, probe number), with
    element e seeing leaf n through direction `_offsets(dim)[off]` (off[a]
    ∈ {-1, 0, 1} along axis a, x = axis 0, in e's own frame)."""
    dim = forest.dim
    E = forest.n_elements
    anchor = forest.anchor.astype(np.int64)
    h = ROOT >> forest.level.astype(np.int64)
    hf = h // 2  # finest possible neighbor size (2:1 balance)
    hits = []
    probe = 0
    for oi, off in enumerate(_offsets(dim)):
        nnz = sum(1 for o in off if o)
        samples = []
        for a in range(dim):
            if off[a] < 0:
                samples.append([-(hf // 2)])
            elif off[a] > 0:
                samples.append([h + hf // 2])
            else:
                samples.append([hf // 2, h - hf // 2])
        for combo in product(*samples):
            pt = anchor + np.stack(combo, axis=1)
            pt2, tr, valid = _canonicalize_points(
                forest.conn, forest.tree.astype(np.int32), pt,
                np.ones(E, bool))
            live = np.where(valid)[0]
            if len(live):
                n = forest.find_leaves(tr[live], pt2[live])
                hits.append(np.stack([live, n, np.full(len(live), oi),
                                      np.full(len(live), nnz),
                                      np.full(len(live), probe)], axis=1))
            probe += 1
    return np.concatenate(hits) if hits else np.zeros((0, 5), np.int64)


def _best_offsets(forest: Forest, hits=None):
    """Unique (e, n) pairs (sorted) with the direction e sees n through:
    among several hits the one with the fewest nonzero axes, then the
    first probe (the reference classifies shared face over shared edge
    over shared corner, `_schwarz_metadata.c:276-360`)."""
    hits = _probe_hits(forest) if hits is None else hits
    E = forest.n_elements
    key = hits[:, 0] * E + hits[:, 1]
    order = np.lexsort((hits[:, 4], hits[:, 3], key))
    key_s = key[order]
    first = np.ones(len(order), bool)
    first[1:] = key_s[1:] != key_s[:-1]
    best = hits[order[first]]
    return best[:, 0], best[:, 1], best[:, 2]


def subdomain_members(forest: Forest, return_rel: bool = False):
    """For each element: sorted unique indices of it and every leaf
    sharing a face, edge or corner with it (the reference's vertex-patch
    membership, `d4est_solver_schwarz_metadata.c`).

    With `return_rel=True` also returns `rel`: (element, neighbor) -> the
    direction tuple (x first) through which the element sees the
    neighbor, the fewest nonzero axes winning."""
    E = forest.n_elements
    e, n, oi = _best_offsets(forest)
    members = [{i} for i in range(E)]
    for a, b in zip(e.tolist(), n.tolist()):
        members[a].add(b)
    out = [np.array(sorted(m), np.int64) for m in members]
    if not return_rel:
        return out
    offs = _offsets(forest.dim)
    rel = {(int(a), int(b)): offs[int(o)] for a, b, o in zip(e, n, oi)}
    return out, rel


# ---------------------------------------------------------------------------
# weights (the reference's quintic-hat partition of unity)
# ---------------------------------------------------------------------------


def _quintic_phi(r: np.ndarray) -> np.ndarray:
    """phi(r): quintic hat edge, clipped to sign(r) outside [-1, 1]
    (`d4est_solver_schwarz_operators.c:7-27`)."""
    r = np.asarray(r, np.float64)
    poly = (15.0 * r - 10.0 * r**3 + 3.0 * r**5) / 8.0
    return np.where(r < -1.0, -1.0, np.where(r > 1.0, 1.0, poly))


def _hat_weight(r: np.ndarray, d0: float) -> np.ndarray:
    """w(r) = ½(phi((r+1)/d0) − phi((r−1)/d0)); d0 = 0 (only the face
    layer overlaps) is taken in the limit: weight ½ on the shared face."""
    r = np.asarray(r, np.float64)
    if d0 == 0.0:
        return 0.5 * (np.sign(r + 1.0) - np.sign(r - 1.0))
    return 0.5 * (_quintic_phi((r + 1.0) / d0) - _quintic_phi((r - 1.0) / d0))


def _schwarz_weights_1d(nl: int, rs: int):
    """(w_core[nl], w_left[rs], w_right[rs]), `left`/`right` naming the
    member's position relative to the core; d0 = 1 − r_{nl−rs}
    (`d4est_solver_schwarz_operators_build_schwarz_weights_1d`)."""
    r = np.asarray(DB.ops(nl - 1).lobatto_nodes, np.float64)
    d0 = 1.0 - r[nl - rs]
    return (_hat_weight(r, d0), _hat_weight(r[nl - rs:] - 2.0, d0),
            _hat_weight(r[:rs] + 2.0, d0))


def _profiles(nl: int, ov: int):
    """[3, nl] mask and weight profiles: 0 = core (the axis does not
    touch the center), 1 = the center at my low side (keep my first ov
    layers), 2 = at my high side."""
    w_core, w_left, w_right = _schwarz_weights_1d(nl, ov)
    m = np.zeros((3, nl))
    w = np.zeros((3, nl))
    m[0], w[0] = 1.0, w_core
    m[1, :ov], w[1, :ov] = 1.0, w_right
    m[2, nl - ov:], w[2, nl - ov:] = 1.0, w_left
    return m, w


# ---------------------------------------------------------------------------
# the preconditioner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OverlappingSchwarz:
    """M r ≈ Σ_s R_sᵀ W_s A_s⁻¹ R_s r (additive, PoU-weighted)."""

    rep_mesh: MeshData  # replicated mesh, last element = zero dummy
    member: torch.Tensor  # [S, K] global element per slot (unused: E)
    valid: torch.Tensor  # [S, K] bool
    mask: torch.Tensor  # [S, K, nl...] hard DOF restriction
    weight: torch.Tensor  # [S, K, nl...] PoU weights
    inv: torch.Tensor  # [E, J] slots s·K+k holding each element, pad S·K
    iterations: int  # subdomain CG iterations
    shape: tuple  # (E, nl, ...) of the global field
    hp: bool = False  # subdomain operator = A_hp (mixed-degree meshes)

    def __call__(self, r):
        return _schwarz_apply(self, r)


def _slots(forest: Forest):
    """The subdomain slots, vectorized: member [S, K] (center first, then
    ascending; E pads), valid, and `off` [S, K, dim] in {-1, 0, 1}: the
    direction through which each member sees its center, in the member's
    own frame (zeros for the center and for unused slots)."""
    dim = forest.dim
    E = forest.n_elements
    e, n, oi = _best_offsets(forest)
    keep = e != n
    ps = np.concatenate([np.arange(E), e[keep]])
    px = np.concatenate([np.arange(E), n[keep]])
    center = np.zeros(len(ps), bool)
    center[:E] = True
    order = np.lexsort((px, ~center, ps))
    ps, px = ps[order], px[order]
    counts = np.bincount(ps, minlength=E)
    K = int(counts.max())
    slot = np.arange(len(ps)) - np.repeat(np.cumsum(counts) - counts, counts)
    member = np.full((E, K), E, np.int64)
    valid = np.zeros((E, K), bool)
    member[ps, slot] = px
    valid[ps, slot] = True

    offs = np.asarray(_offsets(dim) + [(0,) * dim], np.int64)
    pair_key = e * E + n  # sorted
    q = px * E + ps  # (member, center)
    found = np.zeros(len(q), bool)
    i = np.zeros(len(q), np.int64)
    if len(pair_key):
        i = np.clip(np.searchsorted(pair_key, q), 0, len(pair_key) - 1)
        found = (pair_key[i] == q) & (px != ps)
    off = np.zeros((E, K, dim), np.int64)
    off[ps, slot] = offs[np.where(found, oi[i] if len(oi) else 0,
                                  len(offs) - 1)]
    return member, valid, off


def _outer(prof, code, nl: int, dim: int):
    """Per-axis profiles prof [3, nl] picked by code [N, dim] (0 core, 1
    low, 2 high) -> their outer products [N, nl^dim], axis order
    (z, y, x): direction dim-1 is the slowest axis."""
    out = prof[code[:, dim - 1]]
    for a in range(dim - 2, -1, -1):
        out = out[..., None] * prof[code[:, a]].reshape(
            (-1,) + (1,) * (dim - 1 - a) + (nl,))
    return out


def _profile_code(off):
    """Direction {-1, 0, 1} -> profile row of `_profiles` (1, 0, 2)."""
    return np.where(off < 0, 1, np.where(off > 0, 2, 0))


def _tables(forest: Forest, nl: int, ov: int):
    """member [S, K] (center first, then ascending; E pads), valid, and
    the mask and weight [S, K, nl^dim] arrays."""
    dim = forest.dim
    member, valid, off = _slots(forest)
    pm, pw = _profiles(nl, ov)
    code = _profile_code(off[valid])
    mask = np.zeros(member.shape + (nl,) * dim)
    weight = np.zeros(member.shape + (nl,) * dim)
    mask[valid] = _outer(pm, code, nl, dim)
    weight[valid] = _outer(pw, code, nl, dim)
    return member, valid, mask, weight


def _inverse_table(member: np.ndarray, valid: np.ndarray, E: int):
    """[E, J]: the flat slots s·K+k holding each element, ascending,
    padded with S·K (a zero row)."""
    S, K = member.shape
    flat = np.where(valid.reshape(-1))[0]
    x = member.reshape(-1)[flat]
    order = np.lexsort((flat, x))
    x, flat = x[order], flat[order]
    counts = np.bincount(x, minlength=E)
    J = max(1, int(counts.max(initial=0)))
    pos = np.arange(len(x)) - np.repeat(np.cumsum(counts) - counts, counts)
    inv = np.full((E, J), S * K, np.int64)
    inv[x, pos] = flat
    return inv


_UNREAD = ("xyz_lobatto", "xyz_quad", "j_quad", "face_xyz_lobatto",
           "face_xyz_quad", "face_h", "volume", "area", "perm_l", "perm_q",
           "hang_code", "hang_sigma")
_FULL = ("wjgg", "face_sj", "face_n", "face_drst")
_ELEMENT = ("deg_e", "orient_code", "sigma", "sigma_q", "rad_interp",
            "rad_w", "j_c", "drdx_c", "wjgg_c", "face_sj_c", "face_n_c")
_HC = ("hc_face", "hc_fine_face", "hc_perm_l", "hc_perm_q", "hc_sj", "hc_n",
       "hc_drst_m", "hc_sigma", "hc_sigma_q")


def _slot_lookup(member: np.ndarray, valid: np.ndarray, E: int):
    """rep(s, x) -> the flat slot s·K+k of global element x in subdomain
    s, or -1 where x is not a member (vectorized; host numpy)."""
    K = member.shape[1]
    rows = np.where(valid.reshape(-1))[0]
    keys = (rows // K) * (E + 1) + member.reshape(-1)[rows]
    korder = np.argsort(keys)
    keys, krows = keys[korder], rows[korder]

    def rep(s, x):
        q = s * (E + 1) + x
        i = np.clip(np.searchsorted(keys, q), 0, len(keys) - 1)
        return np.where(keys[i] == q, krows[i], -1)

    return rep


def _mortar_pairs(mesh: MeshData, member: np.ndarray, valid: np.ndarray):
    """Every (subdomain, mortar) pair whose coarse or fine elements are
    members of the subdomain, sorted by subdomain then mortar: arrays
    (s, m)."""
    E = mesh.n_elements
    K = member.shape[1]
    M_g = mesh.hc_elem.shape[0]
    ce = mesh.hc_elem.cpu().numpy().astype(np.int64)
    cf = mesh.hc_fine.cpu().numpy().astype(np.int64)
    elems = np.concatenate([ce[:, None], cf], axis=1)  # [M, 1+Kc]
    rows = np.where(valid.reshape(-1))[0]
    # the subdomains holding each global element
    xs = member.reshape(-1)[rows]
    xorder = np.argsort(xs, kind="stable")
    x_sorted, s_sorted = xs[xorder], (rows // K)[xorder]
    starts = np.searchsorted(x_sorted, np.arange(E + 1))
    m_rep = np.repeat(np.arange(M_g), elems.shape[1])
    x_rep = elems.reshape(-1)
    cnt = starts[x_rep + 1] - starts[x_rep]
    m_hit = np.repeat(m_rep, cnt)
    first = np.repeat(starts[x_rep], cnt)
    within = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    s_hit = s_sorted[first + within]
    pair = np.unique(s_hit * M_g + m_hit)
    return pair // M_g, pair % M_g


def _face_tables(mesh: MeshData, member: np.ndarray, valid: np.ndarray,
                 rep):
    """Per slot and face: the flat slot of the conforming neighbor within
    the subdomain (-1 outside it, the slot itself on the boundary), and
    the boundary and conforming-or-boundary flags [S, K, 2d]."""
    S, K = member.shape
    nfaces = 2 * mesh.dim
    bnd_g = mesh.bnd_mask.cpu().numpy()
    conf_g = mesh.conf_mask.cpu().numpy() & ~bnd_g
    nbr_g = mesh.nbr_elem.cpu().numpy().astype(np.int64)
    rows = np.where(valid.reshape(-1))[0]
    e = member.reshape(-1)[rows]
    b, c = bnd_g[e], conf_g[e]
    nbr = np.full((S * K, nfaces), -1, np.int64)
    bnd = np.zeros((S * K, nfaces), bool)
    conf = np.zeros((S * K, nfaces), bool)
    s_of = np.broadcast_to((rows // K)[:, None], b.shape)
    nbr[rows] = np.where(b, rows[:, None],
                         np.where(c, rep(s_of, nbr_g[e]), -1))
    bnd[rows] = b
    conf[rows] = b | c
    shape = (S, K, nfaces)
    return nbr.reshape(shape), bnd.reshape(shape), conf.reshape(shape)


def _gather_fields(mesh: MeshData, src, live):
    """The fields the subdomain apply reads, for the rows of `src` (global
    elements; rows where `live` is False are zero) plus one zero dummy row
    at the end (device part: torch gathers)."""
    compact_only = (mesh.affine and mesh.wjgg_c is not None
                    and mesh.sigma_q is None and mesh.hc_elem.shape[0] == 0)

    def g(t):
        x = t[src]
        keep = live.reshape(live.shape + (1,) * (x.ndim - 1))
        x = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
        return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])

    fields = {}
    for f in dataclasses.fields(MeshData):
        t = getattr(mesh, f.name)
        if f.name in _UNREAD or (f.name in _FULL and compact_only):
            fields[f.name] = None
        elif f.name in _ELEMENT or f.name in _FULL:
            fields[f.name] = None if t is None else g(t)
    return fields


def _gather_hanging(mesh: MeshData, m, live):
    """The mortar rows `m` of the global mesh (rows where `live` is False
    are zero), with the fine-side permutations [len(m)·Kc, ...]."""
    Kc = 1 << (mesh.dim - 1)
    out = {}

    def g(t):
        x = t[m]
        keep = live.reshape(live.shape + (1,) * (x.ndim - 1))
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))

    for k in _HC:
        t = getattr(mesh, k)
        out[k] = None if t is None else g(t)
    M_g = mesh.hc_elem.shape[0]
    for k in ("hf_perm_l", "hf_perm_q"):
        t = getattr(mesh, k)
        out[k] = g(t.reshape((M_g, Kc) + t.shape[1:])).reshape(
            (-1,) + t.shape[1:])
    return out


def _replicate_mesh(mesh: MeshData, member: np.ndarray,
                    valid: np.ndarray) -> MeshData:
    """One `MeshData` of the S·K (subdomain, member) elements plus a zero
    dummy element at index R = S·K.  Conforming faces between two members
    of a subdomain keep their coupling, faces leaving it point at the
    dummy; each subdomain's mortars are replicated with the elements
    outside it mapped to the dummy."""
    S, K = member.shape
    E = mesh.n_elements
    nfaces = 2 * mesh.dim
    R = S * K
    dev = mesh.device
    rep = _slot_lookup(member, valid, E)
    nbr, bnd, conf = _face_tables(mesh, member, valid, rep)
    nbr_elem = np.full((R + 1, nfaces), R, np.int64)
    nbr_elem[:R] = np.where(nbr.reshape(R, nfaces) < 0, R,
                            nbr.reshape(R, nfaces))
    pad = np.zeros((1, nfaces), bool)
    nbf = mesh.nbr_face.cpu().numpy().astype(np.int64)
    nbr_face = np.zeros((R + 1, nfaces), np.int64)
    val_flat = valid.reshape(-1)
    nbr_face[:R][val_flat] = nbf[member.reshape(-1)[val_flat]]

    i32 = dict(dtype=torch.int32, device=dev)
    hc = {}
    if mesh.hc_elem.shape[0]:
        s_m, m_idx = _mortar_pairs(mesh, member, valid)
        ce = mesh.hc_elem.cpu().numpy().astype(np.int64)
        cf = mesh.hc_fine.cpu().numpy().astype(np.int64)
        rc = rep(s_m, ce[m_idx])
        rf = rep(s_m[:, None], cf[m_idx])
        mi = torch.as_tensor(m_idx, device=dev)
        hc = _gather_hanging(mesh, mi, torch.ones(len(m_idx), dtype=bool,
                                                  device=dev))
        hc["hc_elem"] = torch.as_tensor(np.where(rc < 0, R, rc), **i32)
        hc["hc_fine"] = torch.as_tensor(np.where(rf < 0, R, rf), **i32)

    src = torch.as_tensor(np.minimum(member.reshape(-1), E - 1), device=dev)
    fields = _gather_fields(mesh, src,
                            torch.as_tensor(val_flat, device=dev))
    return dataclasses.replace(
        mesh, **fields, **hc,
        nbr_elem=torch.as_tensor(nbr_elem, **i32),
        nbr_face=torch.as_tensor(nbr_face, **i32),
        bnd_mask=torch.as_tensor(np.concatenate([bnd.reshape(R, nfaces),
                                                 pad]), device=dev),
        conf_mask=torch.as_tensor(np.concatenate([conf.reshape(R, nfaces),
                                                  pad]), device=dev),
    )


def schwarz_from_numpy(mesh: MeshData, member, valid, mask, weight,
                       iterations: int = 15, hp: bool = False):
    """The preconditioner on given tables (numpy `member` [S, K] with E
    in unused slots, `valid`, `mask` and `weight` [S, K, nl...], e.g. the
    JAX package's): the replicated mesh and the combine table are built
    from `mesh` here."""
    member = np.array(member, np.int64)
    valid = np.array(valid, bool)
    dev = mesh.device
    E = mesh.n_elements
    kw = dict(dtype=mesh.sigma.dtype, device=dev)
    return OverlappingSchwarz(
        rep_mesh=_replicate_mesh(mesh, member, valid),
        member=torch.as_tensor(member, device=dev),
        valid=torch.as_tensor(valid, device=dev),
        mask=torch.as_tensor(np.asarray(mask), **kw),
        weight=torch.as_tensor(np.asarray(weight), **kw),
        inv=torch.as_tensor(_inverse_table(member, valid, E), device=dev),
        iterations=int(iterations),
        shape=(E,) + (mesh.nl,) * mesh.dim,
        hp=hp,
    )


def build_overlapping_schwarz(mesh: MeshData, num_nodes_overlap: int = 1,
                              iterations: int = 15,
                              hp: bool = False) -> OverlappingSchwarz:
    """The replicated-subdomain preconditioner of one epoch."""
    member, valid, mask, weight = _tables(mesh.forest, mesh.nl,
                                          int(num_nodes_overlap))
    return schwarz_from_numpy(mesh, member, valid, mask, weight,
                              iterations=iterations, hp=hp)


def _subdomain_op(hp: bool):
    if hp:
        from disco4est_tpu_torch.laplacian.hp import apply_sipg_hp
        return apply_sipg_hp
    return apply_sipg


def _row_sums(x):
    """Σ over each row of x [S, L], as a fixed pairwise tree of
    elementwise adds: each row's sum is the same bits whatever S is (a
    library reduction picks its order from the shape, so the K-slot
    variant's chunks and the materialized variant's whole batch would
    round differently)."""
    n = x.shape[1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.cat([x, x.new_zeros((x.shape[0], width - n))], dim=1)
    while width > 1:
        width //= 2
        x = x[:, :width] + x[:, width:]
    return x[:, 0]


def _add_slots(out, rows):
    """out + Σ_j rows[:, j], added one slot at a time in j order (the
    order both variants share, so their combines round alike)."""
    for j in range(rows.shape[1]):
        out = out + rows[:, j]
    return out


def _subdomain_cg(op, rep_mesh: MeshData, b, mask, iterations: int):
    """The batched masked subdomain CG: b, mask [S, K, nl...] on the
    replicated mesh of S·K elements plus its dummy; a fixed count of
    steps with per-subdomain α/β and no host read."""
    S = b.shape[0]
    dim_shape = b.shape[2:]
    zero_row = b.new_zeros((1,) + dim_shape)

    def A(v):
        v_rep = torch.cat([v.reshape((-1,) + dim_shape), zero_row])
        return op(rep_mesh, v_rep)[:-1].reshape(v.shape) * mask

    def dot(a, c):  # per-subdomain dots [S]
        return _row_sums((a * c).reshape(S, -1))

    def bcast(al):
        return al.reshape((S,) + (1,) * (b.ndim - 1))

    x = torch.zeros_like(b)
    rs, p = b, b
    rr = dot(b, b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    for _ in range(iterations):
        Ap = A(p)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp > 0, rr / torch.where(pAp > 0, pAp, one),
                            0.0)
        x = x + bcast(alpha) * p
        rs = rs - bcast(alpha) * Ap
        rr_new = dot(rs, rs)
        beta = torch.where(rr > 0, rr_new / torch.where(rr > 0, rr, one),
                           0.0)
        p = rs + bcast(beta) * p
        rr = rr_new
    return x


def _schwarz_apply(s: OverlappingSchwarz, r):
    """Restrict → batched masked subdomain CG (fixed count, per-subdomain
    α/β) → weighted combine in the fixed order of `s.inv`."""
    S, K = s.member.shape
    dim_shape = r.shape[1:]
    dtype = r.dtype
    zero_row = r.new_zeros((1,) + dim_shape)
    mask = s.mask.to(dtype)
    b = torch.cat([r, zero_row])[s.member] * mask  # [S, K, nl...]
    x = _subdomain_cg(_subdomain_op(s.hp), s.rep_mesh, b, mask,
                      s.iterations)
    contrib = (x * s.weight.to(dtype)).reshape((S * K,) + dim_shape)
    return _add_slots(torch.zeros_like(r), torch.cat([contrib, zero_row])[s.inv])


def overlap_schwarz_smooth(A, M: OverlappingSchwarz, b, x,
                           iterations: int = 2, damping: float = 1.0):
    """Schwarz-smoothed iterations (`multigrid_smoother_schwarz` role)."""
    for _ in range(iterations):
        x = x + damping * M(b - A(x))
    return x


# ---------------------------------------------------------------------------
# the K-slot variant: resident integer tables, factors gathered per chunk
# ---------------------------------------------------------------------------
#
# Port of the JAX module's `SchwarzKSlot` (`build_overlapping_schwarz_kslot`,
# `_kslot_apply`).  The materialized variant above holds every factor array
# S·K ≈ 27x (884,736 replicated elements at level 5, deg 3).  This one
# keeps index tables and per-(s, k) mask/weight CODES into a
# [3^dim + 1, nl^dim] table, and gathers each chunk's factor rows from the
# global mesh inside the apply: the transient is chunk·K factor rows,
# independent of E.  The host builds every table once, vectorized (the
# JAX module fills them in Python loops over S·K·2d and S × mortar rows);
# the tables equal the JAX module's.  Each chunk's corrections are summed
# into their elements through a padded slot table built once per chunk, and
# the chunks are added in their fixed order (the JAX module's
# `.at[].add` would run as atomics on CUDA, ROADMAP C10).


@dataclasses.dataclass
class SchwarzKSlot:
    """Chunked K-slot overlapping Schwarz: the operator of
    `OverlappingSchwarz`, with O(S·K) integers resident instead of
    O(S·K·nq^dim) floats."""

    mesh: MeshData  # the GLOBAL mesh (shared, not copied)
    member: torch.Tensor  # [S_pad, K] global element (E = unused)
    valid: torch.Tensor  # [S_pad, K] bool
    codes: torch.Tensor  # [S_pad, K] int32 mask/weight code (3^dim unused)
    mask_table: torch.Tensor  # [3^dim+1, nl...]
    weight_table: torch.Tensor  # [3^dim+1, nl...]
    nbr_slot: torch.Tensor  # [S_pad, K, 2d] int32 in [0, K] (K = outside)
    bnd: torch.Tensor  # [S_pad, K, 2d] bool
    conf: torch.Tensor  # [S_pad, K, 2d] bool
    # hanging mortar rows grouped per chunk, chunk-local slots (C·K =
    # the dummy): hc_m [nchunk, Mc] global mortar row (-1 pads),
    # hc_elem [nchunk, Mc], hc_fine [nchunk, Mc, Kc]; empty without mortars
    hc: dict
    # the fixed-order combine of each chunk: (elements [U], slots [U, J]
    # chunk-local, C·K pads)
    combine: list
    chunk: int
    iterations: int
    shape: tuple
    hp: bool = False

    def __call__(self, r):
        return _kslot_apply(self, r)


def _code_tables(nl: int, ov: int, dim: int):
    """Mask and weight [3^dim + 1, nl...] of each code Σ_a (off_a + 1)·3^a
    (the last row, unused slots, zero)."""
    n = 3**dim
    codes = np.arange(n)
    off = np.stack([(codes // 3**a) % 3 - 1 for a in range(dim)], axis=1)
    pm, pw = _profiles(nl, ov)
    shape = (n + 1,) + (nl,) * dim
    mask, weight = np.zeros(shape), np.zeros(shape)
    mask[:n] = _outer(pm, _profile_code(off), nl, dim)
    weight[:n] = _outer(pw, _profile_code(off), nl, dim)
    return mask, weight


def build_overlapping_schwarz_kslot(mesh: MeshData,
                                    num_nodes_overlap: int = 1,
                                    iterations: int = 15, chunk: int = 128,
                                    hp: bool = False) -> SchwarzKSlot:
    """The K-slot preconditioner of one epoch (JAX
    `build_overlapping_schwarz_kslot`): `chunk` subdomains per batch."""
    dim, nl = mesh.dim, mesh.nl
    E = mesh.n_elements
    dev = mesh.device
    member0, valid0, off = _slots(mesh.forest)
    S, K = member0.shape
    C = min(int(chunk), S)
    S_pad = -(-S // C) * C
    nchunk = S_pad // C
    member = np.full((S_pad, K), E, np.int64)
    valid = np.zeros((S_pad, K), bool)
    codes = np.full((S_pad, K), 3**dim, np.int32)
    member[:S], valid[:S] = member0, valid0
    codes[:S][valid0] = (off[valid0] + 1) @ (3 ** np.arange(dim))

    rep = _slot_lookup(member, valid, E)
    nbr, bnd, conf = _face_tables(mesh, member, valid, rep)
    nbr_slot = np.where(nbr < 0, K, nbr - (np.arange(S_pad) * K)[:, None,
                                                                  None])
    nbr_slot = nbr_slot.astype(np.int32)

    i64 = dict(dtype=torch.int64, device=dev)
    hc = {}
    if mesh.hc_elem.shape[0]:
        s_m, m_idx = _mortar_pairs(mesh, member, valid)
        c_m = s_m // C
        counts = np.bincount(c_m, minlength=nchunk)
        Mc = int(counts.max())
        pos = np.arange(len(c_m)) - np.repeat(np.cumsum(counts) - counts,
                                              counts)
        TRASH = C * K
        ce = mesh.hc_elem.cpu().numpy().astype(np.int64)
        cf = mesh.hc_fine.cpu().numpy().astype(np.int64)
        base = c_m * C * K
        rc = rep(s_m, ce[m_idx])
        rf = rep(s_m[:, None], cf[m_idx])
        Kc = cf.shape[1]
        hc_m = np.full((nchunk, Mc), -1, np.int64)
        hc_elem = np.full((nchunk, Mc), TRASH, np.int64)
        hc_fine = np.full((nchunk, Mc, Kc), TRASH, np.int64)
        hc_m[c_m, pos] = m_idx
        hc_elem[c_m, pos] = np.where(rc < 0, TRASH, rc - base)
        hc_fine[c_m, pos] = np.where(rf < 0, TRASH, rf - base[:, None])
        hc = dict(hc_m=torch.as_tensor(hc_m, **i64),
                  hc_elem=torch.as_tensor(hc_elem, **i64),
                  hc_fine=torch.as_tensor(hc_fine, **i64))

    # the combine: per chunk, each touched element's local slots ascending
    flat = np.where(valid.reshape(-1))[0]
    x = member.reshape(-1)[flat]
    c_of = flat // (C * K)
    order = np.lexsort((flat, x, c_of))
    flat, x, c_of = flat[order], x[order], c_of[order]
    combine = []
    bounds = np.searchsorted(c_of, np.arange(nchunk + 1))
    for c in range(nchunk):
        fl, xs = flat[bounds[c]:bounds[c + 1]], x[bounds[c]:bounds[c + 1]]
        U, start, cnt = np.unique(xs, return_index=True, return_counts=True)
        J = int(cnt.max())
        slots = np.full((len(U), J), C * K, np.int64)
        slots[np.repeat(np.arange(len(U)), cnt),
              np.arange(len(xs)) - np.repeat(start, cnt)] = fl - c * C * K
        combine.append((torch.as_tensor(U, **i64),
                        torch.as_tensor(slots, **i64)))

    mask_t, weight_t = _code_tables(nl, int(num_nodes_overlap), dim)
    kw = dict(dtype=mesh.sigma.dtype, device=dev)
    return SchwarzKSlot(
        mesh=mesh,
        member=torch.as_tensor(member, **i64),
        valid=torch.as_tensor(valid, device=dev),
        codes=torch.as_tensor(codes, device=dev),
        mask_table=torch.as_tensor(mask_t, **kw),
        weight_table=torch.as_tensor(weight_t, **kw),
        nbr_slot=torch.as_tensor(nbr_slot, device=dev),
        bnd=torch.as_tensor(bnd, device=dev),
        conf=torch.as_tensor(conf, device=dev),
        hc=hc,
        combine=combine,
        chunk=C,
        iterations=int(iterations),
        shape=(E,) + (nl,) * dim,
        hp=hp,
    )


def _chunk_mesh(s: SchwarzKSlot, c: int) -> MeshData:
    """The replicated mesh of chunk c: C·K slots plus the dummy row C·K,
    its factor rows gathered from the global mesh (device part)."""
    mesh = s.mesh
    C, K = s.chunk, s.member.shape[1]
    nfaces = 2 * mesh.dim
    E = mesh.n_elements
    R = C * K
    rows = slice(c * C, (c + 1) * C)
    mem = s.member[rows].reshape(-1)
    live = s.valid[rows].reshape(-1)
    src = mem.clamp(max=E - 1)
    fields = _gather_fields(mesh, src, live)
    nsl = s.nbr_slot[rows].long()  # [C, K, 2d]
    offs = (torch.arange(C, device=mem.device) * K)[:, None, None]
    nbr_local = torch.where(nsl < K, offs + nsl, R).reshape(R, nfaces)
    no = torch.zeros((1, nfaces), dtype=torch.bool, device=mem.device)
    nbf = torch.where(live[:, None], mesh.nbr_face[src],
                      torch.zeros((), dtype=mesh.nbr_face.dtype,
                                  device=mem.device))
    i32 = dict(dtype=torch.int32)
    hc = {}
    if s.hc:
        m = s.hc["hc_m"][c]
        hc = _gather_hanging(mesh, m.clamp(min=0), m >= 0)
        hc["hc_elem"] = s.hc["hc_elem"][c].to(**i32)
        hc["hc_fine"] = s.hc["hc_fine"][c].to(**i32)
    return dataclasses.replace(
        mesh, **fields, **hc,
        nbr_elem=torch.cat([nbr_local, nbr_local.new_full((1, nfaces), R)]
                           ).to(**i32),
        nbr_face=torch.cat([nbf, nbf.new_zeros((1, nfaces))]).to(**i32),
        bnd_mask=torch.cat([s.bnd[rows].reshape(R, nfaces), no]),
        conf_mask=torch.cat([s.conf[rows].reshape(R, nfaces), no]),
    )


def _kslot_apply(s: SchwarzKSlot, r):
    """M r chunk by chunk (JAX `_kslot_apply`): gather the chunk's factor
    rows, restrict, run the batched masked subdomain CG, and add the
    weighted corrections into their elements through the chunk's slot
    table; the chunks in their fixed order, no accumulation out of
    order."""
    C, K = s.chunk, s.member.shape[1]
    dim_shape = r.shape[1:]
    dtype = r.dtype
    zero_row = r.new_zeros((1,) + dim_shape)
    r_pad = torch.cat([r, zero_row])
    op = _subdomain_op(s.hp)
    out = torch.zeros_like(r)
    for c, (elems, slots) in enumerate(s.combine):
        rows = slice(c * C, (c + 1) * C)
        codes = s.codes[rows].long()
        mask = s.mask_table.to(dtype)[codes]  # [C, K, nl...]
        b = r_pad[s.member[rows]] * mask
        x = _subdomain_cg(op, _chunk_mesh(s, c), b, mask, s.iterations)
        contrib = (x * s.weight_table.to(dtype)[codes]).reshape(
            (C * K,) + dim_shape)
        part = _add_slots(out.index_select(0, elems),
                          torch.cat([contrib, zero_row])[slots])
        out = out.index_copy(0, elems, part)
    return out
