"""The multigrid deployment (`benchmark/configs/poisson_sinx_brick_mg.json`)
on the CPU, against the benchmark's plain references.

- the port's `v_cycle`, set up by `driver._build_pc` from the
  configuration's options, against `benchmark/reference/vcycle.py` at
  levels 2-3, deg 2-3, on seeded random residuals;
- `mg_setup`'s λmax against the dense spectrum of the reference operator
  at every level of the level-2 hierarchy;
- planted faults in the port's V-cycle that the same comparison must
  catch: one level in f32, the restriction scaled by 2, one smoothing
  pass dropped;
- toy runs of both cells' jobs through `run_poisson` (0 and 1 uniform_h
  steps): every epoch on `fcg-mg`, the answer within the cells' limits of
  `reference/brick.py`, the tracer's Krylov iterations equal to
  `harness.summary`'s (the tie by which the benchmark finds a run's
  record), the V-cycle's counters, and `SolveInfo.setup` equal to the
  seconds of the set-up spans (for every pc type);
- toy trace-mode cells of both workloads through `harness.run_cell` in a
  fresh interpreter (the benchmark refuses a process in which JAX is
  loaded, as this one is): `vcycle_ms` and `mg_setup_s` reported.

The tolerance of the V-cycle comparison, `TOL`, is 1e-11 relative (max
|port - reference| over max |reference|).  f64 against f64 the two sit at
2e-15 to 1.3e-13: contractions of the same operator in another order,
amplified by 16 Chebyshev steps a level and the bottom CG.  One level in
f32 moves the cycle by 4e-11 (the coarsest level's CG, whose share of the
answer is smallest) to 5e-8 (the finest level), so each such fault fails.
The bottom CG stops where ‖r‖ ≤ 1e-10‖b‖; two implementations whose
residuals differ by rounding may stop one step apart, which moves the
cycle by up to ~1e-13 (one step) or ~1e-11 (two).  The comparison pins
the reference's bottom to the step at which the port's stopped (read by
running the stopped `cg_solve` on the bottom's own inputs), and asserts
that the reference's own test stops within one step of it.
"""

import copy
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.reference.brick import Brick
from benchmark.reference.vcycle import VCycle, dense_matrix
from disco4est_tpu_torch import driver
from disco4est_tpu_torch.mesh.builder import build_mesh
from disco4est_tpu_torch.mesh.tree import Forest
from disco4est_tpu_torch.problems.poisson import SinxProblem
from disco4est_tpu_torch.solvers import multigrid as MG
from disco4est_tpu_torch.solvers.cg import cg_solve
from disco4est_tpu_torch.util.config import Options

from torch_threads import torch_worker_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = ("sinx_brick_l5_deg3_mg", "sinx_brick_l5to6_deg3_mg")
TOL = 1e-11
# Lanczos from a smooth start vector underestimates λmax: 10 steps fall
# 0-12 % short on the level-2 hierarchies (deg 2 and 3), and never above
# it beyond rounding
LMAX_SHORT = 0.15


def _options(level, deg, steps=0, pc_type="multigrid"):
    _, config = harness.load_cell(CELLS[0])
    return Options.load(harness.options_text(harness.merge(
        config["options"],
        {"initial_mesh": {"min_level": level, "region0_deg": deg},
         "amr": {"num_of_amr_steps": steps},
         "d4est_solver_krylov_petsc": {"pc_type": pc_type}})))


_PORT = {}


def port(level, deg):
    """(mesh, preconditioner) of the configuration at `level`, `deg`:
    the mesh and `driver._build_pc` as `run_poisson` makes them."""
    if (level, deg) not in _PORT:
        opts = _options(level, deg)
        geom = driver.geometry_from_options(opts)
        kw = dict(penalty_prefactor=2.0, penalty_fcn="maxp_sqr_over_minh",
                  face_h_type=driver.face_h_from_options(opts))
        mesh = build_mesh(geom, Forest.uniform(geom.conn, level), deg=deg,
                          device="cpu", **kw)
        pc = driver._build_pc(
            mesh, None, hp=False, pc_type="multigrid",
            mg_params=driver.mg_params_from_options(opts), mesh_kwargs=kw,
            overlap=1, subdomain_iter=15, chunk=0, eigs_iters=10, ratio=30.0)
        _PORT[level, deg] = mesh, pc
    return _PORT[level, deg]


def _residual(mesh, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((mesh.n_elements,) + (mesh.nl,) * 3,
                       dtype=torch.float64, generator=g)


def compare(level, deg, seed, monkeypatch):
    """(relative gap, the port's bottom steps, the reference's own): one
    V-cycle of the port and of the reference on the same residual, the
    reference's bottom pinned to the port's step."""
    mesh, pc = port(level, deg)
    steps = []
    bottom = MG.bottom_cg

    def recorded(A, b, x, rtol, iters):
        steps.append(cg_solve(A, b, x0=x, atol=0.0, rtol=rtol,
                              max_iter=iters).iterations)
        return bottom(A, b, x, rtol, iters)

    monkeypatch.setattr(MG, "bottom_cg", recorded)
    r = _residual(mesh, seed)
    e = pc.M(r)
    ref = VCycle(level, deg, pc.state.bounds)
    ref(r)
    own = ref.last_bottom_steps
    assert len(steps) == 1
    ref.bottom_steps = steps[0]
    e_ref = ref(r)
    gap = float((e - e_ref).abs().max() / e_ref.abs().max())
    return gap, steps[0], own


@pytest.mark.parametrize("level,deg,seed", [(2, 2, 11), (2, 3, 12),
                                            (3, 2, 13), (3, 3, 14),
                                            (3, 3, 15)])
def test_vcycle_matches_the_reference(level, deg, seed, monkeypatch):
    gap, steps, own = compare(level, deg, seed, monkeypatch)
    assert gap < TOL, gap
    assert abs(own - steps) <= 1, (own, steps)
    assert steps < 100  # the bottom converged


@pytest.mark.parametrize("deg", [2, 3])
def test_lanczos_lmax_lies_below_the_dense_spectrum(deg):
    level = 2
    _, pc = port(level, deg)
    assert len(pc.state.bounds) == level + 1
    for k, (lmin, lmax) in enumerate(pc.state.bounds):
        true = float(torch.linalg.eigvalsh(
            dense_matrix(Brick.build(level - k, deg)))[-1])
        assert (1 - LMAX_SHORT) * true <= lmax <= true * (1 + 1e-10), (
            k, lmax, true)
        assert lmin == pytest.approx(lmax / 30.0, rel=1e-15)


def _round32(v):
    return v.float().double()


def _f32_level(monkeypatch, level):
    """Level `level`'s operator applied to and returning f32 values."""
    orig = MG.level_operator

    def patched(hier, A, k):
        op = orig(hier, A, k)
        return (lambda v: _round32(op(_round32(v)))) if k == level else op

    monkeypatch.setattr(MG, "level_operator", patched)


def _f32_bottom(monkeypatch):
    """The bottom CG run in f32 (its dense matrix cast to f32 with it)."""
    orig = MG.bottom_cg
    monkeypatch.setattr(MG, "bottom_cg", lambda A, b, x, rtol, iters: orig(
        A, b.float(), x.float(), rtol, iters).double())


def _restrict_x2(monkeypatch):
    orig = MG.restrict
    monkeypatch.setattr(MG, "restrict", lambda *a: 2.0 * orig(*a))


def _drop_one_pass(monkeypatch):
    """The finest level's first smoothing pass left out."""
    orig, calls = MG.cheby_smooth, []

    def smooth(A, b, x, lmin, lmax, n):
        calls.append(1)
        return x if len(calls) == 1 else orig(A, b, x, lmin, lmax, n)

    monkeypatch.setattr(MG, "cheby_smooth", smooth)


FAULTS = {
    "f32_level0": lambda mp: _f32_level(mp, 0),
    "f32_level1": lambda mp: _f32_level(mp, 1),
    "f32_bottom": _f32_bottom,
    "restrict_x2": _restrict_x2,
    "drop_one_pass": _drop_one_pass,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_vcycle_fault_fails(fault, monkeypatch):
    port(2, 3)
    FAULTS[fault](monkeypatch)
    gap, _, _ = compare(2, 3, 12, monkeypatch)
    assert gap > TOL, (fault, gap)


def _toy_job(name, level):
    cell, config = harness.load_cell(name)
    cell = copy.deepcopy(cell)
    cell["options"] = harness.merge(cell.get("options", {}),
                                    {"initial_mesh": {"min_level": level}})
    return cell, harness.Job(cell, config, 2**31 + 7, "cpu")


def _spans(res, name):
    return [s for s in res.trace["spans"] if s["name"] == name]


@pytest.mark.parametrize("name,level", [(CELLS[0], 2), (CELLS[1], 1)])
def test_toy_fcg_mg_run_meets_the_reference(name, level):
    cell, job = _toy_job(name, level)
    res = job(1)
    steps = int(cell["options"].get("amr", {}).get("num_of_amr_steps", 0))
    assert [s.path for s in res.solves] == ["fcg-mg"] * (steps + 1)
    final, deg = harness.final_shape(job.sections)
    assert final == level + steps and res.mesh.n_elements == 8**final

    # the answer, judged as the benchmark judges it
    s = harness.summary(res)
    brick = Brick.build(final, deg)
    nums = job.kind.reference(job.data(1), job.sections).numbers(
        brick, res.u, s["l2"])
    for k, limit in cell["check"]["limits"].items():
        assert nums[k] <= limit, (k, nums[k], limit)

    # the tracer's counters: the benchmark's tie, and the V-cycle's
    c = res.trace["counters"]
    assert c["krylov.iterations"] == s["krylov_iters"] > 0
    cycles = [si.iterations + 1 for si in res.solves]  # M(r0), then one
    assert c["mg.vcycles"] == sum(cycles) == len(_spans(res,
                                                        "d4est.mg.vcycle"))
    levels = [lv + 1 for lv in range(level, final + 1)]
    assert c["mg.levels"] == levels[-1]
    # 8 Chebyshev applies before and after, one residual, at each level
    # but the coarsest, whose CG takes the dense matrix
    assert c["mg.applies.fine"] == 17 * sum(cycles)
    assert c["mg.applies.coarse"] == sum(17 * (n - 2) * k
                                         for n, k in zip(levels, cycles))
    solves = _spans(res, "d4est.solve")
    for v in _spans(res, "d4est.mg.vcycle"):
        assert res.trace["spans"][v["parent"]]["name"] == "d4est.solve"
    assert len(solves) == steps + 1


@pytest.mark.parametrize("pc_type,names", [
    ("multigrid", ["hierarchy", "mg_setup"]), ("cheby", ["eigs"]),
    ("schwarz", ["schwarz"])])
def test_setup_seconds_are_the_spans(pc_type, names):
    """`SolveInfo.setup` keeps its steps, each the seconds of its span
    `d4est.pc.<step>`, which lies in the epoch's `d4est.pc`."""
    res = driver.run_poisson(_options(1, 2, pc_type=pc_type), SinxProblem,
                             device="cpu")
    spans = res.trace["spans"]
    tops = _spans(res, "d4est.pc")
    assert len(tops) == len(res.solves) == 1
    for info, top in zip(res.solves, tops):
        assert list(info.setup) == names
        index = spans.index(top)
        kids = [s for s in spans if s["parent"] == index]
        assert [s["name"] for s in kids] == [f"d4est.pc.{n}" for n in names]
        for n, s in zip(names, kids):
            assert info.setup[n] == (s["end_ns"] - s["start_ns"]) * 1e-9
            assert top["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= top["end_ns"]


def _toy_trace_lines():
    script = (
        "import copy, json, sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import torch\n"
        "from benchmark import harness\n"
        "from disco4est_tpu_torch.util import trace\n"
        "out = {}\n"
        f"for name in {CELLS!r}:\n"
        "    cell = copy.deepcopy(harness.load_cell(name)[0])\n"
        "    cell['options'] = harness.merge(cell['options'],\n"
        "        {'initial_mesh': {'min_level': 1}})\n"
        "    code, line = harness.run_cell(name, 2**31 + 9, 0.1, True,\n"
        "        t_start=time.perf_counter(), device='cpu', cell=cell)\n"
        "    spans = sorted({s['name'] for s in trace.runs()[-1]['spans']})\n"
        "    out[name] = dict(code=code, line=line, spans=spans)\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def toy_trace_lines():
    return _toy_trace_lines()


@pytest.mark.parametrize("name", CELLS)
def test_trace_mode_cell_reports_the_multigrid_metrics(toy_trace_lines,
                                                       name):
    out = toy_trace_lines[name]
    assert out["code"] == 0 and out["line"]["correct"], out
    metrics = out["line"]["metrics"]
    assert set(metrics) == {"vcycle_ms", "mg_setup_s"}, metrics
    v, s = metrics["vcycle_ms"], metrics["mg_setup_s"]
    # the readers tie the program's records to the plain runs by the
    # Krylov iterations: a value means the tie held
    assert v["value"] > 0 and v["vcycles"] > 0
    assert v["fine_applies_per_vcycle"] == 17.0
    assert v["first_epoch_ms"] > 0 and v["last_epoch_ms"] > 0
    if name == CELLS[0]:
        assert v["first_epoch_ms"] == v["last_epoch_ms"]
    # level 1 has two levels, the coarser the bottom's (no level-operator
    # apply); level 2, the second epoch of the other cell, has three
    coarse = v["coarse_applies_per_vcycle"]
    assert coarse == 0.0 if name == CELLS[0] else 0.0 < coarse < 17.0
    assert s["value"] >= max(s["hierarchy_s"], s["eigs_s"]) > 0
    assert {"d4est.pc", "d4est.pc.hierarchy", "d4est.pc.mg_setup",
            "d4est.mg.vcycle"} <= set(out["spans"])
