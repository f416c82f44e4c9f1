"""The readers of the program's run records (`program_runs.py` and the
metrics `krylov_host_us`, `krylov_wait_us`, `outer_apply_ms`,
`mesh_faces_s`) on planted records."""

import collections
import sys

import pytest

from benchmark import program_runs as P
from benchmark.metrics import (
    krylov_host_us,
    krylov_wait_us,
    mesh_faces_s,
    outer_apply_ms,
)
from disco4est_tpu_torch import util
from disco4est_tpu_torch.util import trace


def _record(iters, *, host_us=100.0, wait_us=10.0, outer_ms=(), faces_s=0.5,
            b1=0):
    spans, t = [], 0
    for name, seconds in ([("d4est.mesh.faces", faces_s),
                           ("d4est.mesh.h2d", 0.25),
                           ("d4est.mesh.h2d", 0.125)]
                          + [("d4est.mixed.outer", ms * 1e-3)
                             for ms in outer_ms]):
        spans.append(dict(name=name, start_ns=t, end_ns=t + int(seconds * 1e9),
                          parent=-1, run=7))
        t += int(seconds * 1e9)
    return dict(id=7, entry="run_poisson", start_ns=0, end_ns=t, spans=spans,
                counters={"krylov.iterations": iters,
                          "krylov.reads": iters + 2,
                          "krylov.host_ns": int(host_us * 1e3 * iters),
                          "krylov.wait_ns": int(wait_us * 1e3 * iters),
                          "launches.b1": b1, "launches.b2": 0})


def _rec(iters, span_runs=2, profiled=0):
    rec = dict(runs=[dict(krylov_iters=n) for n in iters],
               span_runs=[{}] * span_runs)
    if profiled:
        rec["profile"] = dict(runs=profiled)
    return rec


@pytest.fixture
def store(monkeypatch):
    runs = collections.deque()
    monkeypatch.setattr(trace, "_RUNS", runs)
    return runs


def test_the_plain_runs_are_picked_after_earlier_records(store):
    # records of other work, the warm-up, three plain runs, two synced,
    # one profiled
    store.extend([_record(999), _record(5), _record(40)])
    store.extend([_record(10, host_us=200, wait_us=30, outer_ms=(1, 3),
                          b1=20),
                  _record(20, host_us=100, wait_us=10, outer_ms=(2,),
                          faces_s=0.25, b1=40),
                  _record(30, host_us=300, wait_us=50, outer_ms=(4, 4, 4),
                          b1=60)])
    store.extend([_record(11), _record(12), _record(13)])
    rec = _rec([10, 20, 30], profiled=1)
    assert [r["counters"]["krylov.iterations"]
            for r in P.plain_records(rec)] == [10, 20, 30]
    assert krylov_host_us.read(rec) == pytest.approx(200.0)
    assert krylov_host_us.extra(rec) == dict(
        b1_launches_per_iter=pytest.approx(2.0), b2_launches_per_iter=0.0)
    assert krylov_wait_us.read(rec) == pytest.approx(30.0)
    # the medians: of 12/10, 22/20, 32/30 reads an iteration
    assert krylov_wait_us.extra(rec)["reads_per_iter"] == pytest.approx(
        22 / 20)
    assert outer_apply_ms.read(rec) == pytest.approx(2.0)
    assert outer_apply_ms.extra(rec) == dict(outer_steps=2)
    assert mesh_faces_s.read(rec) == pytest.approx(0.5)
    extra = mesh_faces_s.extra(rec)
    assert extra["h2d_s"] == pytest.approx(0.375)
    assert extra["factors_s"] is None  # no such span planted


def test_records_that_do_not_line_up_give_nothing(store):
    store.extend([_record(n, outer_ms=(1,)) for n in (5, 10, 21, 30, 1, 1)])
    rec = _rec([10, 20, 30])  # the second record has 21
    assert P.plain_records(rec) is None
    for m in (krylov_host_us, krylov_wait_us, outer_apply_ms, mesh_faces_s):
        assert m.read(rec) is None
    # one record short of K (no warm-up): nothing either
    store.clear()
    store.extend([_record(n) for n in (10, 20, 30, 1, 1)])
    assert P.plain_records(rec) is None
    store.appendleft(_record(5))
    assert len(P.plain_records(rec)) == 3
    # the profiled runs count in K
    store.append(_record(1))
    assert P.plain_records(rec) is None
    assert len(P.plain_records(_rec([10, 20, 30], profiled=1))) == 3


def test_no_mixed_solve_no_outer_apply(store):
    store.extend([_record(n) for n in (5, 10, 20, 30, 1, 1)])
    rec = _rec([10, 20, 30])
    assert krylov_host_us.read(rec) == pytest.approx(100.0)
    assert outer_apply_ms.read(rec) is None


def test_a_program_without_the_tracer_gives_nothing(store, monkeypatch):
    store.extend([_record(n) for n in (5, 10, 20, 30, 1, 1)])
    rec = _rec([10, 20, 30])
    assert krylov_host_us.read(rec) is not None
    monkeypatch.delattr(util, "trace")
    monkeypatch.setitem(sys.modules, "disco4est_tpu_torch.util.trace", None)
    for m in (krylov_host_us, krylov_wait_us, outer_apply_ms, mesh_faces_s):
        assert m.read(rec) is None
    # and the harness's records without a trace phase give nothing
    assert P.plain_records(dict(runs=[dict(krylov_iters=1)])) is None
