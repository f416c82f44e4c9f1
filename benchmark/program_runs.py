"""The program's own records of the cell's runs.

`disco4est_tpu_torch.util.trace.runs()` keeps one record per driver run
of this process: its spans (name, start, end, parent) and counters.  A
trace-mode process makes, in this order, the warm-up run, the plain runs
(`rec["runs"]`), the runs with synchronized spans (`rec["span_runs"]`)
and the profiled runs (`rec["profile"]["runs"]`), so the cell's records
are the last K = 1 + those counts, and its plain runs are records 1 ..
len(rec["runs"]) of them.  Earlier records belong to other work of the
process (a test process may hold some).
"""

from benchmark.harness import median


def plain_records(rec):
    """The program's records of the plain runs of `rec`, in order; None
    where the program keeps none (a version without the tracer), where
    fewer than K records are kept, or where a record's Krylov iterations
    differ from those of the plain run at its place, which ties every
    record to its run."""
    try:
        from disco4est_tpu_torch.util import trace
    except ImportError:
        return None
    plain = rec.get("runs") or []
    if "span_runs" not in rec or not plain:
        return None
    k = (1 + len(plain) + len(rec["span_runs"])
         + (rec.get("profile") or {}).get("runs", 0))
    store = trace.runs()
    if len(store) < k:
        return None
    mine = store[len(store) - k:][1:1 + len(plain)]
    for record, run in zip(mine, plain):
        if record["counters"].get("krylov.iterations") != run["krylov_iters"]:
            return None
    return mine


def span_seconds(record, name):
    """Seconds of the spans called `name` in one record, one a span."""
    return [(s["end_ns"] - s["start_ns"]) * 1e-9 for s in record["spans"]
            if s["name"] == name]


def per_run(rec, value):
    """Median over the plain runs of `value(record)`; None where the
    records do not line up with the runs or no run has a value."""
    records = plain_records(rec)
    if records is None:
        return None
    return median([value(r) for r in records])


def per_iteration(record, counter, scale=1.0):
    """A counter of one record over its Krylov iterations, times
    `scale`; None without iterations."""
    c = record["counters"]
    n = c.get("krylov.iterations", 0)
    return c[counter] / n * scale if n else None
