"""Overlapping additive Schwarz — vertex-patch subdomains with node strips.

Port of the materialized variant of `disco4est_tpu/solvers/schwarz_overlap.py`
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
`subdomain_chunk > 0`) is ROADMAP A13b.
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


def _tables(forest: Forest, nl: int, ov: int):
    """member [S, K] (center first, then ascending; E pads), valid, and
    the mask and weight [S, K, nl^dim] arrays."""
    dim = forest.dim
    E = forest.n_elements
    e, n, oi = _best_offsets(forest)
    keep = e != n
    ps = np.concatenate([np.arange(E), e[keep]])
    px = np.concatenate([np.arange(E), n[keep]])
    center = np.concatenate([np.zeros(E, bool), np.zeros(keep.sum(), bool)])
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

    # per-axis profile codes of each (s, k): the direction through which
    # the member sees the center, in the member's own frame
    offs = np.asarray(_offsets(dim) + [(0,) * dim], np.int64)
    pair_key = e * E + n  # sorted
    q = px * E + ps  # (member, center)
    found = np.zeros(len(q), bool)
    i = np.zeros(len(q), np.int64)
    if len(pair_key):
        i = np.clip(np.searchsorted(pair_key, q), 0, len(pair_key) - 1)
        found = (pair_key[i] == q) & (px != ps)
    off = offs[np.where(found, oi[i] if len(oi) else 0, len(offs) - 1)]
    code = np.where(off < 0, 1, np.where(off > 0, 2, 0))
    pm, pw = _profiles(nl, ov)

    def outer(prof):
        # axis order (z, y, x): direction dim-1 is the slowest axis
        out = prof[code[:, dim - 1]]
        for a in range(dim - 2, -1, -1):
            out = out[..., None] * prof[code[:, a]].reshape(
                (-1,) + (1,) * (dim - 1 - a) + (nl,))
        return out

    mask = np.zeros((E, K) + (nl,) * dim)
    weight = np.zeros((E, K) + (nl,) * dim)
    mask[ps, slot] = outer(pm)
    weight[ps, slot] = outer(pw)
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


def _replicate_mesh(mesh: MeshData, member: np.ndarray,
                    valid: np.ndarray) -> MeshData:
    """One `MeshData` of the S·K (subdomain, member) elements plus a zero
    dummy element at index R = S·K.  Conforming faces between two members
    of a subdomain keep their coupling, faces leaving it point at the
    dummy; each subdomain's mortars are replicated with the elements
    outside it mapped to the dummy."""
    S, K = member.shape
    E = mesh.n_elements
    dim, nl, nq = mesh.dim, mesh.nl, mesh.nq
    nfaces = 2 * dim
    R = S * K
    dev = mesh.device
    mem_flat = member.reshape(-1)
    val_flat = valid.reshape(-1)
    gather_src = torch.as_tensor(np.concatenate([mem_flat, [E]]), device=dev)

    def g(t):
        pad = torch.cat([t, t.new_zeros((1,) + t.shape[1:])])
        return pad[gather_src]

    # (subdomain, global element) -> replicated row, R where absent
    rows = np.where(val_flat)[0]
    keys = (rows // K) * (E + 1) + mem_flat[rows]
    korder = np.argsort(keys)
    keys, krows = keys[korder], rows[korder]

    def rep_idx(s, x):
        q = s * (E + 1) + x
        i = np.clip(np.searchsorted(keys, q), 0, len(keys) - 1)
        return np.where(keys[i] == q, krows[i], R)

    bnd_g = mesh.bnd_mask.cpu().numpy()
    conf_g = mesh.conf_mask.cpu().numpy() & ~bnd_g
    nbr_g = mesh.nbr_elem.cpu().numpy().astype(np.int64)
    nbf_g = mesh.nbr_face.cpu().numpy().astype(np.int64)
    nbr_elem = np.full((R + 1, nfaces), R, np.int64)
    nbr_face = np.zeros((R + 1, nfaces), np.int64)
    bnd_mask = np.zeros((R + 1, nfaces), bool)
    conf_mask = np.zeros((R + 1, nfaces), bool)
    e = mem_flat[rows]
    s_of = np.repeat(rows // K, nfaces).reshape(-1, nfaces)
    nbr_face[rows] = nbf_g[e]
    b, c = bnd_g[e], conf_g[e]
    bnd_mask[rows] = b
    conf_mask[rows] = b | c
    nbr_elem[rows] = np.where(b, rows[:, None],
                              np.where(c, rep_idx(s_of, nbr_g[e]), R))

    # mortars: one row per (subdomain, mortar) touching the subdomain
    Kc = 1 << (dim - 1)
    M_g = mesh.hc_elem.shape[0]
    hc = {}
    if M_g:
        ce = mesh.hc_elem.cpu().numpy().astype(np.int64)
        cf = mesh.hc_fine.cpu().numpy().astype(np.int64)
        elems = np.concatenate([ce[:, None], cf], axis=1)  # [M, 1+Kc]
        # the subdomains holding each global element
        xs = mem_flat[rows]
        xorder = np.argsort(xs, kind="stable")
        x_sorted, s_sorted = xs[xorder], (rows // K)[xorder]
        starts = np.searchsorted(x_sorted, np.arange(E + 1))
        m_rep = np.repeat(np.arange(M_g), 1 + Kc)
        x_rep = elems.reshape(-1)
        cnt = starts[x_rep + 1] - starts[x_rep]
        m_hit = np.repeat(m_rep, cnt)
        first = np.repeat(starts[x_rep], cnt)
        within = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        s_hit = s_sorted[first + within]
        pair = np.unique(s_hit * M_g + m_hit)
        s_m, m_idx = pair // M_g, pair % M_g
        mi = torch.as_tensor(m_idx, device=dev)
        mik = torch.as_tensor(
            (m_idx[:, None] * Kc + np.arange(Kc)).reshape(-1), device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        hc = dict(
            hc_elem=torch.as_tensor(rep_idx(s_m, ce[m_idx]), **i32),
            hc_fine=torch.as_tensor(rep_idx(s_m[:, None], cf[m_idx]), **i32),
            hf_perm_l=mesh.hf_perm_l[mik], hf_perm_q=mesh.hf_perm_q[mik],
        )
        for k in ("hc_face", "hc_fine_face", "hc_perm_l", "hc_perm_q",
                  "hc_sj", "hc_n", "hc_drst_m", "hc_sigma", "hc_sigma_q"):
            t = getattr(mesh, k)
            hc[k] = None if t is None else t[mi]
    else:
        for k in ("hc_elem", "hc_face", "hc_fine", "hc_fine_face",
                  "hc_perm_l", "hc_perm_q", "hc_sj", "hc_n", "hc_drst_m",
                  "hc_sigma", "hf_perm_l", "hf_perm_q", "hc_sigma_q"):
            hc[k] = getattr(mesh, k)

    # the per-point factors are read off the fast path, or by the mortars
    compact_only = (mesh.affine and mesh.wjgg_c is not None
                    and mesh.sigma_q is None and M_g == 0)
    fields = {}
    for f in dataclasses.fields(MeshData):
        t = getattr(mesh, f.name)
        if f.name in _UNREAD or (f.name in _FULL and compact_only):
            fields[f.name] = None
        elif f.name in _ELEMENT or f.name in _FULL:
            fields[f.name] = None if t is None else g(t)
    i32 = dict(dtype=torch.int32, device=dev)
    return dataclasses.replace(
        mesh, **fields, **hc,
        nbr_elem=torch.as_tensor(nbr_elem, **i32),
        nbr_face=torch.as_tensor(nbr_face, **i32),
        bnd_mask=torch.as_tensor(bnd_mask, device=dev),
        conf_mask=torch.as_tensor(conf_mask, device=dev),
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


def _schwarz_apply(s: OverlappingSchwarz, r):
    """Restrict → batched masked subdomain CG (fixed count, per-subdomain
    α/β) → weighted combine in the fixed order of `s.inv`."""
    S, K = s.member.shape
    dim_shape = r.shape[1:]
    dtype = r.dtype
    zero_row = r.new_zeros((1,) + dim_shape)
    mask = s.mask.to(dtype)
    b = torch.cat([r, zero_row])[s.member] * mask  # [S, K, nl...]
    if s.hp:
        from disco4est_tpu_torch.laplacian.hp import apply_sipg_hp as op
    else:
        op = apply_sipg

    def A(v):
        v_rep = torch.cat([v.reshape((S * K,) + dim_shape), zero_row])
        return op(s.rep_mesh, v_rep)[:-1].reshape(v.shape) * mask

    def dot(a, c):  # per-subdomain dots [S]
        return (a * c).reshape(S, -1).sum(1)

    def bcast(al):
        return al.reshape((S,) + (1,) * (b.ndim - 1))

    x = torch.zeros_like(b)
    rs, p = b, b
    rr = dot(b, b)
    one = torch.ones((), dtype=dtype, device=r.device)
    for _ in range(s.iterations):
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

    contrib = (x * s.weight.to(dtype)).reshape((S * K,) + dim_shape)
    return torch.cat([contrib, zero_row])[s.inv].sum(1)


def overlap_schwarz_smooth(A, M: OverlappingSchwarz, b, x,
                           iterations: int = 2, damping: float = 1.0):
    """Schwarz-smoothed iterations (`multigrid_smoother_schwarz` role)."""
    for _ in range(iterations):
        x = x + damping * M(b - A(x))
    return x
