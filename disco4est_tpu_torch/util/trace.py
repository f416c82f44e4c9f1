"""The program's tracer: spans and counters of each driver run, in memory.

A driver entry wrapped by `traced_run` (`driver.run_poisson`,
`run_nonlinear`) opens one record when it is called and closes it when it
returns.  The closed record is attached to the result as
`DriverResult.trace` and appended to a bounded process-wide list,
`runs()`; a run that raises appends nothing.  A record is a plain dict:

- `id` (unique in the process), `entry` (the driver entry's name),
  `start_ns`, `end_ns` (`time.perf_counter_ns`);
- `spans`: one dict a span in the order they opened, with `name`,
  `start_ns`, `end_ns`, `parent` (the index of the span open around it
  in this list, -1 at the top) and `run` (the record's `id`);
- `counters`: `krylov.iterations`, `krylov.reads`, `krylov.host_ns`,
  `krylov.wait_ns` (see `krylov`) and the deltas over the run of the
  counters the entry passes to `traced_run` (the driver's B1 and B2
  launches).

Two tiers:

1. Always on.  Spans read the host clock at layer boundaries only (a few
   tens a run, never one per Krylov iteration); the Krylov loops add to
   integer accumulators.  No synchronize, no `record_function`, no
   tensor.
2. While a `torch.profiler` records (its own enabled flag, read once per
   span), each span also opens a `record_function` range of its name, so
   the program's phases lie on the device trace's clock.

Span names start with `d4est.`.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time

import torch

RUNS_KEPT = 1024  # records kept; a 51-s benchmark window makes ~50-100 runs
_RUNS: collections.deque = collections.deque(maxlen=RUNS_KEPT)
_IDS = itertools.count(1)
_LOCAL = threading.local()  # `run`: the record open in this thread
_now = time.perf_counter_ns


def runs() -> list:
    """The closed records of this process's driver runs, oldest first
    (the last `RUNS_KEPT`)."""
    return list(_RUNS)


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


class _Run:
    """The open record of one driver run."""

    def __init__(self, entry: str, counters):
        self.id = next(_IDS)
        self.entry = entry
        self.spans = []  # [name, start_ns, end_ns, parent]
        self.open = []  # indices of the spans open, innermost last
        self.krylov = [0, 0, 0, 0]  # iterations, reads, host_ns, wait_ns
        self.krylov_depth = 0
        self.counters = counters
        self.counters0 = counters() if counters else {}
        self.start_ns = _now()

    def close(self) -> dict:
        end = _now()
        counters = dict(zip(("krylov.iterations", "krylov.reads",
                             "krylov.host_ns", "krylov.wait_ns"),
                            self.krylov))
        if self.counters:
            counters.update((k, v - self.counters0[k])
                            for k, v in self.counters().items())
        return dict(
            id=self.id, entry=self.entry, start_ns=self.start_ns,
            end_ns=end, counters=counters,
            spans=[dict(name=n, start_ns=a, end_ns=b, parent=p, run=self.id)
                   for n, a, b, p in self.spans])


def traced_run(counters=None):
    """Decorator of a driver entry: one record a call.  `counters()`
    returns process-wide counts ({name: int}) whose deltas over the run the
    record keeps.  The result gets the closed record as `.trace`."""

    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            run = _Run(fn.__name__, counters)
            outer = getattr(_LOCAL, "run", None)
            _LOCAL.run = run
            try:
                res = fn(*args, **kwargs)
            finally:
                _LOCAL.run = outer
            res.trace = run.close()
            _RUNS.append(res.trace)
            return res

        return entry

    return wrap


class span:
    """`with span("d4est.<layer>"):` records one span of the current run
    (nothing outside a run).  `sync`, a callable, runs at both ends inside
    the span's clock (`[driver] print_timings` passes a device
    synchronize); `seconds` is the span's duration once it has closed."""

    __slots__ = ("name", "sync", "run", "index", "rf", "start_ns", "end_ns")

    def __init__(self, name: str, sync=None):
        self.name, self.sync = name, sync
        self.rf = None

    def __enter__(self):
        if self.sync is not None:
            self.sync()
        if _profiling():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.run = run = getattr(_LOCAL, "run", None)
        self.start_ns = _now()
        if run is not None:
            self.index = len(run.spans)
            run.spans.append([self.name, self.start_ns, None,
                              run.open[-1] if run.open else -1])
            run.open.append(self.index)
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            self.sync()
        self.end_ns = _now()
        if self.run is not None:
            self.run.spans[self.index][2] = self.end_ns
            self.run.open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Krylov:
    """The stopping-test reads of one Krylov call, added to the run's
    counters when the call ends: `host_ns` is the host's time from the
    call's start or the end of its previous read to the start of the next
    read (enqueuing one iteration), `wait_ns` its time blocked inside the
    reads."""

    __slots__ = ("run", "last", "reads", "host", "wait", "iterations")

    def __init__(self, run):
        self.run = run
        self.reads = self.host = self.wait = self.iterations = 0

    def __enter__(self):
        self.run.krylov_depth += 1
        self.last = _now()
        return self

    def read(self, value) -> float:
        """`float(value)`: the host's read of a device scalar."""
        t0 = _now()
        out = float(value)
        t1 = _now()
        self.host += t0 - self.last
        self.wait += t1 - t0
        self.reads += 1
        self.last = t1
        return out

    def __exit__(self, *exc):
        run = self.run
        run.krylov_depth -= 1
        acc = run.krylov
        acc[0] += self.iterations
        acc[1] += self.reads
        acc[2] += self.host
        acc[3] += self.wait
        return False


class _Untraced:
    """The probe of a Krylov call that is not counted: outside a run, or
    nested in another Krylov call (a solve inside a preconditioner, whose
    time the outer call's counters already hold)."""

    __slots__ = ("iterations",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def read(value) -> float:
        return float(value)


def krylov():
    """The probe of one Krylov call: `with krylov() as probe:` around the
    solve, `probe.read(x)` for each stopping-test read of the device
    scalar `x`, and `probe.iterations` set to the call's iterations before
    it ends.  Only the outermost Krylov call of a run is counted."""
    run = getattr(_LOCAL, "run", None)
    if run is None or run.krylov_depth:
        return _Untraced()
    return _Krylov(run)
