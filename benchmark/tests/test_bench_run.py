"""Whole runs of the harness at toy sizes on the CPU: each entry, the
data-driven discovery of new files, and the guards on what a run loads."""

import ast
import json
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "disco4est_tpu"}


@pytest.mark.parametrize("name", ["sinx_brick_l5_deg3",
                                  "cds_brick_l5_deg2"])
@pytest.mark.parametrize("trace_on", [False, True])
def test_whole_run_of_each_entry(name, trace_on, toy):
    code, line = harness.run_cell(name, 2**31 + 77, 0.3, trace_on,
                                  t_start=time.perf_counter(), device="cpu",
                                  cell=toy(name))
    assert code == 0 and line["correct"], line
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "check"
    for v in line["check"].values():
        assert v["value"] <= v["limit"]
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    want = {n for n, _ in harness.metric_names(spec, name, trace_on)}
    # the trace's device metrics need the card; the rest are all there
    device_only = {"inner_apply_roofline", "idle_share", "peak_mem_gib"}
    assert want - device_only <= set(line["metrics"]), line["metrics"]


def test_same_seed_same_inputs():
    from benchmark.problems import sinx_phases

    cell, config = harness.load_cell("sinx_brick_l5_deg3")
    a = harness.Job(cell, config, 2**40 + 3, "cpu")
    b = harness.Job(cell, config, 2**40 + 3, "cpu")
    c = harness.Job(cell, config, 2**40 + 4, "cpu")
    runs = range(1, 1 + int(cell["data"]["set"]))
    assert [a.data(i) for i in runs] == [b.data(i) for i in runs]
    # every seed runs the same set of problems, in its own order
    key = lambda d: tuple(d["phases"])
    assert sorted(map(key, map(a.data, runs))) == sorted(
        map(key, map(c.data, runs)))
    assert [a.data(i) for i in runs] != [c.data(i) for i in runs]
    assert sinx_phases.options(a.data(1)) == {}


def test_new_files_are_picked_up(tmp_path):
    """A configuration, a cell and a per-layer metric added as files alone
    (and named in BENCHMARK.json) run without an edit to the harness."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    config = harness.load_json(BENCH / "configs" / "poisson_sinx_brick.json")
    config["name"] = "toy_brick"
    config["options"]["initial_mesh"].update(min_level=1, region0_deg=2)
    (tmp_path / "benchmark/configs/toy_brick.json").write_text(
        json.dumps(config))
    cell = dict(config="toy_brick", traffic="toy", entry="run_poisson",
                options={"d4est_solver_krylov_petsc": {"use_structured": 1}},
                data={"kind": "sinx_phases", "set": 3},
                check={"limits": {"residual": 1e-10, "l2_gap": 1e-12}},
                chips=1, why="a toy cell")
    (tmp_path / "benchmark/workloads/toy_cell.json").write_text(
        json.dumps(cell))
    (tmp_path / "benchmark/metrics/toy_runs.py").write_text(
        "def read(rec):\n    return len(rec['runs'])\n")
    spec["workloads"].append(dict(name="toy_cell", config="toy_brick",
                                  traffic="toy", chips=1, why="toy"))
    spec["per_layer"].append(dict(name="toy_runs", unit="runs",
                                  better="higher", source="host_clock",
                                  layer="toy", moves="run_s",
                                  workloads=["toy_cell"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    script = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from benchmark import harness\n"
        f"assert harness.ROOT == __import__('pathlib').Path({str(tmp_path)!r})\n"
        "code, line = harness.run_cell('toy_cell', 5, 0.2, True, "
        "t_start=time.perf_counter(), device='cpu')\n"
        "print(json.dumps(line))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert line["metrics"]["toy_runs"]["value"] >= 3
    assert line["metrics"]["toy_runs"]["unit"] == "runs"


def _top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_in_what_the_benchmark_runs():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for path in files:
        names = set(_top_imports(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        # the top-level name is compared whole: the port's name begins
        # with the JAX package's
        if path.parent.name == "reference":
            assert "disco4est_tpu_torch" not in names, path
            assert names <= {"__future__", "dataclasses", "math", "numpy",
                             "torch", "benchmark"}, (path, names)


def test_no_jax_loaded_after_a_run(toy):
    script = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark import harness\n"
        "sys.path.insert(0, harness.BENCH.joinpath('tests').as_posix())\n"
        "from conftest import toy_cell\n"
        "code, line = harness.run_cell('sinx_brick_l5_deg3', 9, 0.1, False, "
        "t_start=time.perf_counter(), device='cpu', "
        "cell=toy_cell('sinx_brick_l5_deg3'))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "disco4est_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_a_run_that_loads_jax_prints_nothing(monkeypatch, toy, capsys):
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    code, line = harness.run_cell("sinx_brick_l5_deg3", 3, 0.1, False,
                                  t_start=time.perf_counter(), device="cpu",
                                  cell=toy("sinx_brick_l5_deg3"))
    assert code != 0 and line is None
    assert "jax" in capsys.readouterr().err


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sinx_brick_l5_deg3", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_program_missing_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sinx_brick_l5_deg3", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
