"""Milliseconds of one f64 outer step of the mixed solve (median over the
plain runs of each run's mean): the program's span `d4est.mixed.outer`,
from the start of each b - A(x) to the return of its norm's read, the
initial residual included.  The inner solve before it ended on a read,
so the span holds the f64 apply's device time and its launches.
Nothing where the runs take no mixed solve.  Extra: the spans a run."""

import statistics

from benchmark import program_runs as P

SPAN = "d4est.mixed.outer"


def _mean_ms(record):
    spans = P.span_seconds(record, SPAN)
    return statistics.fmean(spans) * 1e3 if spans else None


def read(rec):
    return P.per_run(rec, _mean_ms)


def extra(rec):
    return dict(outer_steps=P.per_run(
        rec, lambda r: len(P.span_seconds(r, SPAN)) or None))
