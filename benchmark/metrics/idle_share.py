"""Share of the run's wall time in which the card runs nothing:
1 - device busy per profiled run / the median wall of the plain runs of
the same process (the profiler's own host cost stays out of the
denominator)."""

from benchmark.harness import median


def read(rec):
    prof = rec.get("profile") or {}
    wall = median([r["wall_s"] for r in rec.get("runs", [])])
    if not prof.get("runs") or not wall or prof.get("busy_s", 0) <= 0:
        return None
    return 1.0 - prof["busy_s"] / prof["runs"] / wall
