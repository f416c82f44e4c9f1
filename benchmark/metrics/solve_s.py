"""Seconds of the solves per run (median over the plain runs):
`SolveInfo.seconds`, or the sum of `NewtonInfo.seconds` over levels."""

from benchmark.harness import median


def read(rec):
    if "span_runs" not in rec:
        return None
    return median([r["solve_s"] for r in rec.get("runs", [])])
