"""Node-weighted SFC repartition, padded layouts and field migration.

Port of `disco4est_tpu/parallel/repartition.py` (role of the reference's
`d4est_amr_load_balance`, `hpAMR/d4est_amr.c:774-860`: repartition along
the space-filling curve weighted by node count, then ship every nodal
field to its new owner with `p4est_transfer_custom`, :846-852).

Elements stay in global SFC (Morton) order, so a partition is a set of
contiguous cuts.  As in the JAX package a weighted partition is a PADDED
layout: rank s owns the rows [s·Bmax, (s+1)·Bmax), its `counts[s]` real
elements first, then pad rows; `src[s·Bmax + j]` is the global element id
of a row, -1 on a pad row.  The tables are host numpy and equal the JAX
package's entry by entry; the field gathers are torch on the field's
device.  `pad_mesh_to_layout` turns pad rows into isolated zero-geometry
boundary elements, so Au = 0 there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from disco4est_tpu_torch.amr.amr import element_lineage
from disco4est_tpu_torch.mesh.builder import MeshData
from disco4est_tpu_torch.mesh.tree import ROOT, Forest
from disco4est_tpu_torch.ops.operators import DB


def sfc_partition(weights: np.ndarray, n_dev: int) -> np.ndarray:
    """Contiguous SFC partition balancing `weights`: counts[n_dev] with
    sum = len(weights).  Element e goes to the rank whose window of the
    cumulative weight holds its midpoint (`p4est_partition_ext` with a
    weight callback, `d4est_amr.c:788`)."""
    w = np.asarray(weights, np.float64)
    E = len(w)
    total = w.sum()
    if total <= 0 or n_dev <= 1:
        base = E // n_dev
        counts = np.full(n_dev, base, np.int64)
        counts[: E - base * n_dev] += 1
        return counts
    c = np.cumsum(w)
    mid = c - 0.5 * w
    owner = np.minimum((mid * n_dev / total).astype(np.int64), n_dev - 1)
    return np.bincount(owner, minlength=n_dev).astype(np.int64)


@dataclasses.dataclass(eq=False)
class PaddedLayout:
    """A weighted SFC partition as a padded layout of n_dev·Bmax rows."""

    n_dev: int
    Bmax: int
    counts: np.ndarray  # [n_dev] real elements per rank
    src: np.ndarray  # [n_dev*Bmax] global element id, -1 on pad rows

    @property
    def padded_size(self) -> int:
        return self.n_dev * self.Bmax

    @staticmethod
    def build(weights: np.ndarray, n_dev: int) -> "PaddedLayout":
        counts = sfc_partition(weights, n_dev)
        Bmax = int(counts.max())
        src = np.full(n_dev * Bmax, -1, np.int64)
        start = 0
        for s in range(n_dev):
            c = int(counts[s])
            src[s * Bmax: s * Bmax + c] = np.arange(start, start + c)
            start += c
        return PaddedLayout(n_dev=n_dev, Bmax=Bmax, counts=counts, src=src)


def _rows(t, idx_np):
    return t[torch.as_tensor(idx_np, device=t.device)]


def migrate_field(u, layout: PaddedLayout):
    """A global-SFC-ordered field [E, ...] -> the padded layout
    [n·Bmax, ...], zero on pad rows."""
    vals = _rows(u, np.maximum(layout.src, 0))
    valid = torch.as_tensor(layout.src >= 0, device=u.device)
    return torch.where(valid.reshape((-1,) + (1,) * (u.ndim - 1)), vals,
                       torch.zeros((), dtype=u.dtype, device=u.device))


def unmigrate_field(u_padded, layout: PaddedLayout, E: int):
    """The inverse of `migrate_field`: padded layout -> global SFC order."""
    dst = np.zeros(E, np.int64)
    dst[layout.src[layout.src >= 0]] = np.where(layout.src >= 0)[0]
    return _rows(u_padded, dst)


def _amr_transfer_plan(old: Forest, new: Forest):
    """For each new element: its old source element and the per-generation
    child bits (balance cascades up to depth `max_dl`), host numpy."""
    src, _, dl = element_lineage(old, new)
    # the child-bit prolongation assumes pure refinement lineages (as in
    # JAX): a coarsening would copy one descendant's field
    assert (dl >= 0).all(), "migrate_after_amr: coarsening not supported"
    max_dl = int(dl.max()) if len(dl) else 0
    Enew = new.n_elements
    dim = old.dim
    bits = np.zeros((Enew, max(max_dl, 1), dim), np.int64)
    for g in range(max_dl):
        h_old = ROOT >> (old.level[src].astype(np.int64) + g)
        rel = new.anchor.astype(np.int64) - old.anchor[src].astype(np.int64)
        sub = (rel % h_old[:, None]) >= (h_old // 2)[:, None]
        bits[:, g] = np.where((dl > g)[:, None], sub.astype(np.int64), 0)
    active = np.zeros((Enew, max(max_dl, 1)), bool)
    for g in range(max_dl):
        active[:, g] = dl > g
    return src, bits, active, max_dl


def migrate_after_amr(u_old, old: Forest, new: Forest, deg: int,
                      layout: PaddedLayout):
    """The AMR transfer and the repartition at once: hp-prolong the old
    field [E_old, nl...] onto the new forest's elements and land it in the
    new layout with one gather (the reference's refine-interp followed by
    `p4est_transfer_custom`)."""
    dim = old.dim
    nl = deg + 1
    src, bits, active, max_dl = _amr_transfer_plan(old, new)
    lsrc = np.maximum(layout.src, 0)
    row_src = src[lsrc]
    # per generation and axis: matrix 0 (copy) or 1 + child bit
    sel = np.where(active[lsrc][:, :, None], 1 + bits[lsrc], 0)
    dev, dtype = u_old.device, u_old.dtype
    mats = torch.as_tensor(
        np.concatenate([np.eye(nl)[None],
                        np.stack([DB.hp_prolong(deg, deg, c)
                                  for c in (0, 1)])]),
        dtype=dtype, device=dev)  # [3, nl, nl]
    sel_t = torch.as_tensor(sel, device=dev)
    vals = _rows(u_old, row_src)  # the one gather
    for g in range(max_dl):
        for d in range(dim):
            ax = vals.ndim - 1 - d
            v = torch.movedim(vals, ax, -1)
            v = torch.einsum("bij,b...j->b...i", mats[sel_t[:, g, d]], v)
            vals = torch.movedim(v, -1, ax)
    valid = torch.as_tensor(layout.src >= 0, device=dev)
    return torch.where(valid.reshape((-1,) + (1,) * (vals.ndim - 1)), vals,
                       torch.zeros((), dtype=dtype, device=dev))


# element-major tensors whose pad rows copy row 0 (index tables that must
# stay valid) rather than zero
_COPY_PAD = ("perm_l", "perm_q", "orient_code")
# tables indexed by mortar, not by element
MORTAR_FIELDS = ("hc_elem", "hc_face", "hc_fine", "hc_fine_face",
                 "hc_perm_l", "hc_perm_q", "hc_sj", "hc_n", "hc_drst_m",
                 "hc_sigma", "hf_perm_l", "hf_perm_q", "hc_sigma_q")
# element-major tensors with their own rules below
_SPECIAL = ("deg_e", "nbr_elem", "nbr_face", "bnd_mask", "conf_mask")


def element_fields(mesh: MeshData):
    """Names of the element-major tensor fields of `mesh` (None fields
    left out)."""
    return [f.name for f in dataclasses.fields(mesh)
            if isinstance(getattr(mesh, f.name), torch.Tensor)
            and f.name not in MORTAR_FIELDS]


def pad_mesh_to_layout(mesh: MeshData, layout: PaddedLayout) -> MeshData:
    """Reorder and pad every element-major array of `mesh` into the padded
    layout, with the neighbor and mortar element ids remapped: pad rows
    become isolated zero-geometry boundary elements (their own neighbors,
    Au = 0 there).  The repartition's "rebuild" half (`p4est_partition_ext`,
    `d4est_amr.c:788`); `migrate_after_amr` is the field half.

    The host forest is not remapped: the padded mesh carries a guard that
    raises on access, so host-side consumers (the estimator, the penalty
    report, VTK, the structured views) must take the unpadded mesh."""
    E = mesh.n_elements
    R = layout.padded_size
    src = np.maximum(layout.src, 0)
    pad = layout.src < 0
    new_of_old = np.zeros(E, np.int64)
    new_of_old[layout.src[~pad]] = np.where(~pad)[0]
    dev = mesh.device
    pad_t = torch.as_tensor(pad, device=dev)

    def g(t, zero_pad=True):
        out = _rows(t, src)
        if zero_pad:
            out[pad_t] = 0
        return out

    repl = {}
    for name in element_fields(mesh):
        if name not in _SPECIAL:
            repl[name] = g(getattr(mesh, name), name not in _COPY_PAD)

    host = lambda t: t.cpu().numpy()  # noqa: E731
    nbr_elem = new_of_old[host(mesh.nbr_elem)][src]
    nbr_face = host(mesh.nbr_face)[src]
    rows = np.arange(R)
    nbr_elem[pad] = rows[pad, None]  # pad rows: their own neighbors
    nbr_face[pad] = np.arange(nbr_face.shape[1])[None, :]
    bnd = host(mesh.bnd_mask)[src]
    bnd[pad] = True
    conf = host(mesh.conf_mask)[src]
    conf[pad] = True
    deg_e = host(mesh.deg_e)[src].copy()
    deg_e[pad] = mesh.deg  # pads carry the storage degree (hp embeddings)
    as_t = lambda a, dt: torch.as_tensor(a.astype(dt), device=dev)  # noqa
    repl.update(
        deg_e=as_t(deg_e, np.int32),
        nbr_elem=as_t(nbr_elem, np.int32),
        nbr_face=as_t(nbr_face, np.int32),
        bnd_mask=torch.as_tensor(bnd, device=dev),
        conf_mask=torch.as_tensor(conf, device=dev),
        hc_elem=as_t(new_of_old[host(mesh.hc_elem)], np.int32),
        hc_fine=as_t(new_of_old[host(mesh.hc_fine)], np.int32),
        forest=_PaddedAux(),
    )
    return dataclasses.replace(mesh, **repl)


class _PaddedAux:
    """The host forest of a padded mesh: its element-major arrays were
    reordered and the forest was not, so any access raises instead of
    returning a stale ordering."""

    def __getattr__(self, name):
        raise AttributeError(
            "padded MeshData has no host forest (element ordering was "
            f"remapped by pad_mesh_to_layout); forest.{name} requested — "
            "use the unpadded mesh for host-side consumers")

    def __eq__(self, other):
        return isinstance(other, _PaddedAux)

    def __hash__(self):
        return 1
