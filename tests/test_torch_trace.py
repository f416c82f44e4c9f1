"""The port's tracer (`disco4est_tpu_torch/util/trace.py`) on the CPU.

- spans nest with the right parents and share their run's id; a run that
  raises keeps no record; only the outermost Krylov call is counted;
- the Krylov counters of a run equal the driver's own iteration counts
  (`SolveInfo.iterations`, Σ `NewtonInfo.krylov`);
- with no profiler recording and `print_timings` off, a run enters no
  `record_function` and calls no synchronize beyond its solves' own;
- under a CPU `torch.profiler` the `d4est.*` ranges appear, nested as in
  the record;
- toy trace-mode cells of the benchmark report the four metrics that
  read the tracer (in a fresh interpreter: the benchmark refuses a
  process in which JAX is loaded, as this one is).
"""

import json
import pathlib
import subprocess
import sys
import types

import pytest
import torch

from disco4est_tpu_torch import driver
from disco4est_tpu_torch.problems.poisson import SinxProblem
from disco4est_tpu_torch.solvers.cg import cg_solve
from disco4est_tpu_torch.util import trace
from disco4est_tpu_torch.util.config import Options

ROOT = pathlib.Path(__file__).resolve().parents[1]

LINEAR = """
[geometry]
name = brick
[problem]
name = sinx
[initial_mesh]
min_level = 1
region0_deg = 2
[amr]
scheme = uniform_h
num_of_amr_steps = {steps}
[d4est_solver_krylov_petsc]
use_structured = 1
{extra}
"""

CDS = """
[problem]
name = constant_density_star
[initial_mesh]
min_level = 1
region0_deg = 2
[mesh_parameters]
face_h_type = FACE_H_EQ_TREE_H
[amr]
scheme = uniform_h
num_of_amr_steps = 1
[geometry]
name = brick
[d4est_solver_newton]
snes_atol = 1e-12
[d4est_solver_krylov_petsc]
ksp_type = {ksp}
"""


def _poisson(extra="", steps=1):
    return driver.run_poisson(
        Options.load(LINEAR.format(extra=extra, steps=steps)), SinxProblem,
        device="cpu")


def _names(record):
    return [s["name"] for s in record["spans"]]


def test_spans_nest_with_parents_and_run_ids():
    @trace.traced_run()
    def entry(fail=False):
        with trace.span("d4est.a"):
            with trace.span("d4est.b"):
                pass
            with trace.span("d4est.c") as c:
                if fail:
                    raise RuntimeError("planted")
        return types.SimpleNamespace(c=c)

    res = entry()
    rec = res.trace
    assert trace.runs()[-1] is rec
    assert _names(rec) == ["d4est.a", "d4est.b", "d4est.c"]
    assert [s["parent"] for s in rec["spans"]] == [-1, 0, 0]
    assert {s["run"] for s in rec["spans"]} == {rec["id"]}
    a, b, c = rec["spans"]
    assert a["start_ns"] <= b["start_ns"] <= b["end_ns"] <= c["start_ns"]
    assert c["end_ns"] <= a["end_ns"] <= rec["end_ns"]
    assert res.c.seconds == (c["end_ns"] - c["start_ns"]) * 1e-9
    with pytest.raises(RuntimeError, match="planted"):
        entry(fail=True)
    assert trace.runs()[-1] is rec  # the raising run kept nothing

    # a driver run: phases at the top, the build's parts under d4est.mesh,
    # the outer applies under d4est.solve
    run = _poisson().trace
    assert trace.runs()[-1] is run and run["id"] > rec["id"]
    assert {s["run"] for s in run["spans"]} == {run["id"]}
    spans = run["spans"]
    for s in spans:
        parent = spans[s["parent"]]["name"] if s["parent"] >= 0 else None
        want = {"d4est.mesh": None, "d4est.solve": None, "d4est.amr": None,
                "d4est.mixed.outer": "d4est.solve"}.get(s["name"],
                                                        "d4est.mesh")
        assert parent == want, s
        if parent is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
    assert _names(run).count("d4est.mesh") == 2
    assert _names(run).count("d4est.mesh.faces") == 2


def test_only_the_outermost_krylov_call_is_counted():
    """A CG inside another CG's preconditioner adds nothing: the outer
    call's clock already holds its time."""
    A = torch.diag(torch.arange(1.0, 33.0, dtype=torch.float64))
    b = torch.ones(32, dtype=torch.float64)
    inner = []

    def M(r):
        res = cg_solve(lambda v: A @ v, r, atol=0.0, rtol=1e-3)
        inner.append(res.iterations)
        return res.x

    @trace.traced_run()
    def entry():
        return types.SimpleNamespace(
            res=cg_solve(lambda v: A @ v, b, M=M, atol=1e-12, rtol=0.0))

    out = entry()
    c = out.trace["counters"]
    assert sum(inner) > 0
    assert c["krylov.iterations"] == out.res.iterations > 0
    # one read a loop test, plus ‖b‖: the nested calls' reads are not here
    assert c["krylov.reads"] == out.res.iterations + 2
    assert c["krylov.host_ns"] > 0 and c["krylov.wait_ns"] > 0
    # outside a run nothing is counted and nothing fails
    assert cg_solve(lambda v: A @ v, b, atol=1e-12).iterations > 0


def test_krylov_counters_equal_the_drivers_counts():
    res = _poisson()
    c = res.trace["counters"]
    assert [s.path for s in res.solves] == ["mixed-structured"] * 2
    assert c["krylov.iterations"] == sum(s.iterations for s in res.solves)
    assert c["launches.b1"] == c["launches.b2"] == 0  # no card
    outer = _names(res.trace).count("d4est.mixed.outer")
    # one outer apply a refinement step, and the initial residual's
    assert outer == sum(s.outer_iterations + 1 for s in res.solves)

    for ksp in ("cg", "fcg"):
        opts = Options.load(CDS.format(ksp=ksp))
        res = driver.run_nonlinear(opts, driver.CDSProblem(opts),
                                   device="cpu")
        krylov = [k for s in res.solves for k in s.krylov]
        assert len(krylov) >= 2
        assert res.trace["counters"]["krylov.iterations"] == sum(krylov)
        assert "d4est.solve" not in _names(res.trace)
        assert _names(res.trace).count("d4est.mesh.faces") == 2


def test_untraced_tier_adds_no_sync_and_no_record_function(monkeypatch):
    """Off (no profiler, no print_timings) a run synchronizes only where
    its solves did before the tracer (`_solve`: twice a level) and opens
    no `record_function`; print_timings adds two a phase."""
    calls = dict(sync=0, cuda_sync=0, rf=0)

    def count(key, fn=None):
        def counted(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs) if fn else None
        return counted

    rf_init = torch.autograd.profiler.record_function.__init__
    monkeypatch.setattr(driver, "_sync", count("sync", driver._sync))
    monkeypatch.setattr(torch.cuda, "synchronize", count("cuda_sync"))
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        count("rf", rf_init))
    res = _poisson()
    assert calls == dict(sync=2 * len(res.solves), cuda_sync=0, rf=0)
    assert res.timings == []

    calls.update(sync=0)
    res = _poisson("[driver]\nprint_timings = 1")
    phases = sum(len(row) - 1 for row in res.timings)
    assert phases == 5  # mesh, solve, amr; mesh, solve
    assert calls == dict(sync=2 * len(res.solves) + 2 * phases,
                         cuda_sync=0, rf=0)
    for row in res.timings:
        for name, seconds in row.items():
            if name != "level":
                spans = [s for s in res.trace["spans"]
                         if s["name"] == f"d4est.{name}"]
                assert seconds in [(s["end_ns"] - s["start_ns"]) * 1e-9
                                   for s in spans]


def test_profiler_tier_ranges_nest_as_in_the_record():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = _poisson(steps=0).trace
    events = sorted((e for e in prof.events()
                     if e.name.startswith("d4est.")),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in events] == _names(rec)

    def traced_parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("d4est."):
            p = p.cpu_parent
        return p

    index = {id(e): i for i, e in enumerate(events)}
    for e, s in zip(events, rec["spans"]):
        p = traced_parent(e)
        assert (-1 if p is None else index[id(p)]) == s["parent"], e.name


def _toy_lines():
    """Toy trace-mode runs of three cells (one per solve path: mixed,
    Newton CG, plain FCG) in one fresh interpreter."""
    script = (
        "import copy, json, sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark import harness\n"
        "out = {}\n"
        "for name in ('sinx_brick_l5_deg3', 'cds_brick_l5_deg2',\n"
        "             'sinx_brick_l5_deg3_f64'):\n"
        "    cell = copy.deepcopy(harness.load_cell(name)[0])\n"
        "    over = {'initial_mesh': {'min_level': 1}}\n"
        "    if name.startswith('sinx'):\n"
        "        over['d4est_solver_krylov_petsc'] = {'use_structured': 1}\n"
        "    cell['options'] = harness.merge(cell['options'], over)\n"
        "    code, line = harness.run_cell(name, 2**31 + 5, 0.2, True,\n"
        "        t_start=time.perf_counter(), device='cpu', cell=cell)\n"
        "    out[name] = dict(code=code, line=line)\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def toy_lines():
    return _toy_lines()


@pytest.mark.parametrize("name", ["sinx_brick_l5_deg3", "cds_brick_l5_deg2",
                                  "sinx_brick_l5_deg3_f64"])
def test_trace_mode_cell_reports_the_tracer_metrics(toy_lines, name):
    out = toy_lines[name]
    assert out["code"] == 0 and out["line"]["correct"], out
    metrics = out["line"]["metrics"]
    want = {"krylov_host_us", "krylov_wait_us", "mesh_faces_s"}
    if name != "sinx_brick_l5_deg3_f64":
        assert metrics["krylov_host_us"]["b1_launches_per_iter"] == 0.0
    if name == "sinx_brick_l5_deg3":
        want.add("outer_apply_ms")
        assert metrics["outer_apply_ms"]["outer_steps"] >= 2
    else:
        assert "outer_apply_ms" not in metrics
    assert want <= set(metrics), metrics
    for m in want:
        assert metrics[m]["value"] > 0, (m, metrics[m])
    assert 1.0 < metrics["krylov_wait_us"]["reads_per_iter"] < 1.5
    parts = metrics["mesh_faces_s"]
    assert all(parts[f"{p}_s"] > 0
               for p in ("factors", "orient", "mortars", "h2d"))
