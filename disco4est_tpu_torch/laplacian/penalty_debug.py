"""SIPG penalty debugger.

Port of `disco4est_tpu/laplacian/penalty_debug.py` (role of the reference's
`dGMath/d4est_laplacian_flux_sipg_penalty_debugger.c:1-484`): the penalty σ
over every face of the mesh, reported as min/max/mean per face class — the
tool for diagnosing penalty blowup on stretched or compactified elements
and for tuning `sipg_penalty_prefactor`.

The penalties are per-epoch tensors of `MeshData` (sigma / sigma_q /
hc_sigma / hc_sigma_q), so the debugger is a host reduction pass: each
array it reads is copied back from the device once.
"""

from __future__ import annotations

import numpy as np

from disco4est_tpu_torch.mesh.builder import MeshData


def _stats(arr: np.ndarray) -> dict:
    if arr.size == 0:
        return {"min": None, "max": None, "mean": None, "count": 0}
    return {
        "min": float(arr.min()),
        "max": float(arr.max()),
        "mean": float(arr.mean()),
        "count": int(arr.size),
    }


def penalty_report(mesh: MeshData) -> dict:
    """Penalty statistics per face class (`debugger_get_min_penalty` /
    `_get_max_penalty` roles, aggregated in one pass).

    Returns {"interior": .., "boundary": .., "mortar": .., "pointwise":
    bool}, each entry with min/max/mean/count of σ over the faces of that
    class.  With the pointwise penalty (j_div_sj_quad) the statistics run
    over every face quadrature point, as the reference evaluates its
    per-point penalty."""
    bnd = mesh.bnd_mask.cpu().numpy()
    # conf_mask holds conforming and boundary faces (CONF | BOUNDARY in
    # `mesh/builder.py`), so the interior faces are conf_mask & ~bnd_mask
    conf = mesh.conf_mask.cpu().numpy() & ~bnd
    pointwise = mesh.sigma_q is not None
    if pointwise:
        sq = mesh.sigma_q.cpu().numpy()  # [E, 2d, nfq...]
        flat = sq.reshape(sq.shape[0], sq.shape[1], -1)
        interior, boundary = flat[conf], flat[bnd]
    else:
        s = mesh.sigma.cpu().numpy()
        interior, boundary = s[conf], s[bnd]
    mortar = (mesh.hc_sigma_q if mesh.hc_sigma_q is not None
              else mesh.hc_sigma).cpu().numpy().reshape(-1)
    return {
        "pointwise": pointwise,
        "interior": _stats(interior),
        "boundary": _stats(boundary),
        "mortar": _stats(mortar),
    }


def print_penalty_report(mesh: MeshData) -> dict:
    """Print the report in the reference's debugger style."""
    rep = penalty_report(mesh)
    for cls in ("interior", "boundary", "mortar"):
        st = rep[cls]
        if st["count"]:
            print(
                f"[PENALTY_DEBUGGER] {cls}: min = {st['min']:.12e} "
                f"max = {st['max']:.12e} mean = {st['mean']:.12e} "
                f"(n = {st['count']})"
            )
        else:
            print(f"[PENALTY_DEBUGGER] {cls}: no faces")
    return rep
