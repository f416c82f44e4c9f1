"""Share of a run's V-cycles that ran as a CUDA graph launch (median over
the plain runs): the program's counter `mg.graph.replays` (launches of
the epoch's captured V-cycle, the one right after the capture included)
over `mg.vcycles`.  The rest are the first call of each epoch, which runs
eagerly, and any cycle of an epoch whose capture failed.  Nothing where
the program keeps no `mg.graph.*` counter (a version without the graph,
a CPU run, or runs that take no V-cycle).  Extras: the captures and the
failed captures a run (`mg.graph.captures`, `mg.graph.fallbacks`), and
the mean milliseconds of the span `d4est.mg.graph.capture` (the
capture, the instantiation and the first launch)."""

import statistics

from benchmark import program_runs as P

PREFIX = "mg.graph."


def _graphed(record):
    return any(k.startswith(PREFIX) for k in record["counters"])


def share(record):
    c = record["counters"]
    n = c.get("mg.vcycles", 0)
    if not n or not _graphed(record):
        return None
    return c.get("mg.graph.replays", 0) / n


def _counter(name):
    def value(record):
        return (record["counters"].get(name, 0) if _graphed(record)
                else None)
    return value


def _capture_ms(record):
    spans = P.span_seconds(record, "d4est.mg.graph.capture")
    return statistics.fmean(spans) * 1e3 if spans else None


def read(rec):
    return P.per_run(rec, share)


def extra(rec):
    return dict(captures=P.per_run(rec, _counter("mg.graph.captures")),
                fallbacks=P.per_run(rec, _counter("mg.graph.fallbacks")),
                capture_ms=P.per_run(rec, _capture_ms))
