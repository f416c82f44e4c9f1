"""Milliseconds of one multigrid V-cycle (median over the plain runs of
each run's mean): the program's span `d4est.mg.vcycle` around each
`solvers/multigrid.v_cycle` call.  The V-cycle reads nothing back, so
the span holds the host's enqueue of one cycle, and the card's time too
where the launch queue fills.  Nothing where the runs take no V-cycle.
Extras: the V-cycles a run (counter `mg.vcycles`), the level operators'
applies a V-cycle on the finest and on the coarser levels (counters
`mg.applies.fine`, `mg.applies.coarse`), and the mean span of the first
and of the last epoch of a run (the same in a run of one epoch)."""

import statistics

from benchmark import program_runs as P

SPAN = "d4est.mg.vcycle"


def _mean_ms(record):
    spans = P.span_seconds(record, SPAN)
    return statistics.fmean(spans) * 1e3 if spans else None


def _epochs(record):
    """The V-cycle spans' seconds grouped by the top-level span they lie
    in (`d4est.solve`, one an epoch), in order."""
    spans = record["spans"]
    groups = {}
    for s in spans:
        if s["name"] != SPAN:
            continue
        top = s
        while top["parent"] >= 0:
            top = spans[top["parent"]]
        groups.setdefault(top["start_ns"], []).append(
            (s["end_ns"] - s["start_ns"]) * 1e-9)
    return [groups[k] for k in sorted(groups)]


def _epoch_ms(index):
    def value(record):
        epochs = _epochs(record)
        return statistics.fmean(epochs[index]) * 1e3 if epochs else None
    return value


def _per_vcycle(counter):
    def value(record):
        c = record["counters"]
        n = c.get("mg.vcycles", 0)
        return c[counter] / n if n and counter in c else None
    return value


def read(rec):
    return P.per_run(rec, _mean_ms)


def extra(rec):
    return dict(
        vcycles=P.per_run(rec, lambda r: r["counters"].get("mg.vcycles")),
        fine_applies_per_vcycle=P.per_run(
            rec, _per_vcycle("mg.applies.fine")),
        coarse_applies_per_vcycle=P.per_run(
            rec, _per_vcycle("mg.applies.coarse")),
        first_epoch_ms=P.per_run(rec, _epoch_ms(0)),
        last_epoch_ms=P.per_run(rec, _epoch_ms(-1)))
