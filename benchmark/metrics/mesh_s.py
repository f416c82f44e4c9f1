"""Seconds of the mesh build per run (median over the runs with
synchronized spans): the span around `driver.build_mesh`."""

from benchmark.harness import median


def read(rec):
    runs = rec.get("span_runs") or []
    return median([r["seconds"].get("build_mesh") for r in runs])
