"""Host tables of the fused SIPG apply: the lane layout of W_vol, W_tr and
W_lift.

Port of the host half of `disco4est_tpu/laplacian/pallas_sipg.py`
(`_mats`; its `_drstn_n` is `laplacian/fast.py:drstn_normal`, which the
f64 apply shares).  The face-mass matrix is folded into the lift rows,
and lanes are laid out per directed face as [t13 (nfl) | s2n (nfl)], so a
fused kernel forms its face terms on a flat [E, 2d·2·nfl] tile with
per-face scalars.  The structured kernel (`laplacian/structured.py`,
`csrc/structured_apply.cu`) reads these tables; the gather-based fused
kernel of `pallas_sipg.py` (`apply_sipg_pallas`, ROADMAP B2) will land
in this module.
"""

from __future__ import annotations

import functools

import numpy as np

from disco4est_tpu_torch.laplacian import fast as F


@functools.lru_cache(maxsize=None)
def _mats(deg: int, deg_quad: int, quad_key, dim: int, iso: bool):
    """Host-side f64 fixed matrices in the fused lane layout."""
    bm = F._base_mats(deg, deg_quad, quad_key, dim)
    Mt, Kt = bm["Mt"], bm["Kt"]
    kron_dirs = bm["kron_dirs"]
    nfaces, nv, nfl = bm["nfaces"], bm["nv"], bm["nfl"]

    diag_blocks = [
        kron_dirs([Kt if a == l else Mt for a in range(dim)])
        for l in range(dim)
    ]
    if iso:
        W_vol = sum(diag_blocks)
        nblk = 1
    else:
        W_vol = np.concatenate(diag_blocks, axis=1)
        nblk = dim

    # trace columns, per directed face: [u_f (nfl) | raw dn (nfl)]
    tr_cols = []
    for f in range(nfaces):
        tr_cols.append(bm["sels"][f].T)
        tr_cols.append(bm["dvol"][f // 2][bm["sel_rows"][f]].T)
    W_tr = np.concatenate(tr_cols, axis=1)  # [nv, nfaces*2*nfl]

    # lift rows, per directed face: [t13 (nfl) | s2n (nfl)]; face mass
    # folded into BOTH lane groups (no separate mj GEMM)
    Mf = bm["Mf"]
    rows = []
    for f in range(nfaces):
        rows.append(Mf @ bm["sels"][f])  # t13 lanes
        rows.append(Mf @ bm["sels"][f] @ bm["dvol"][f // 2])  # s2n lanes
    W_lift = np.concatenate(rows, axis=0)  # [nfaces*2*nfl, nv]

    return dict(
        W_vol=W_vol, nblk=nblk, W_tr=W_tr, W_lift=W_lift,
        nv=nv, nfl=nfl, nfaces=nfaces,
    )

