"""Global statistics over the per-element estimator η².

Port of `disco4est_tpu/estimators/stats.py` (role of the reference's
`Estimators/d4est_estimator_stats.c:227-330`: sum/mean/max and a global
percentile found by a sorted rank walk).  Marking runs on the host between
mesh epochs, so these take and return numpy.
"""

from __future__ import annotations

import numpy as np


def estimator_stats(eta2):
    """dict of total/mean/max/sorted-array for percentile queries."""
    eta2 = np.asarray(eta2)
    total = eta2.sum()
    return {
        "total": total,
        "mean": total / eta2.shape[0],
        "max": eta2.max(),
        "sorted": np.sort(eta2),
    }


def percentile(stats, pct: float):
    """η² value such that `pct` percent of elements lie ABOVE it
    (`d4est_estimator_stats_get_percentile`: e.g. pct=5 → the 5% largest
    elements are marked)."""
    s = stats["sorted"]
    n = s.shape[0]
    k = int(np.clip((n * (100.0 - pct)) // 100, 0, n - 1))
    return s[k]


def estimator_stats_per_region(eta2, regions, n_regions: int):
    """Per-region stats (`d4est_estimator_stats_compute_per_region`,
    `Estimators/d4est_estimator_stats.h:25`; the per-bin variant the
    flagship TP driver marks with, `two_punctures_cactus.c:391-392` where
    bin == element region).  Returns a list of `n_regions` dicts shaped
    like `estimator_stats`, plus each region's element count —
    `percentile(stats[r], pct)` gives the region-local marking threshold
    (`two_punctures_cactus.c:196` `stats[elem_data->region]`)."""
    eta2 = np.asarray(eta2)
    regions = np.asarray(regions)
    out = []
    for r in range(n_regions):
        vals = eta2[regions == r]
        total = float(vals.sum())
        out.append(
            {
                "total": total,
                "mean": total / max(len(vals), 1),
                "max": float(vals.max()) if len(vals) else 0.0,
                "count": int(len(vals)),
                "sorted": np.sort(vals),
            }
        )
    return out


def element_regions(mesh):
    """[E] region id per element via the geometry's tree→region map
    (`d4est_geometry.h:118` get_region)."""
    return mesh.geom.tree_region(np.asarray(mesh.forest.tree))
