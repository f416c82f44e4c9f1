"""Krylov iterations per run (median over the plain runs):
`SolveInfo.iterations` (the inner f32 iterations on the mixed path), or
the sum of `NewtonInfo.krylov`, over levels."""

from benchmark.harness import median


def read(rec):
    if "span_runs" not in rec:
        return None
    return median([r["krylov_iters"] for r in rec.get("runs", [])])
