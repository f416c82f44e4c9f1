"""The benchmark's CPU tests: the checkout's root on the import path,
small cells (a toy level of each cell, `toy_cell`), and a cell run as N
ranks through the launcher (`launch_cell`)."""

import copy
import json
import pathlib
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a level of each cell that the CPU runs in about a second
TOY = {
    "sinx_brick_l5_deg3": {"initial_mesh": {"min_level": 2}},
    "sinx_brick_l5_deg3_f64": {"initial_mesh": {"min_level": 2}},
    "sinx_brick_l4_deg7": {"initial_mesh": {"min_level": 1}},
    "sinx_brick_l6_deg3": {"initial_mesh": {"min_level": 2}},
    "cds_brick_l5_deg2": {"initial_mesh": {"min_level": 2}},
}


def toy_cell(name):
    """The cell's file with its level cut to the CPU's size; the CPU takes
    the structured apply's plain version where the card takes B1."""
    from benchmark import harness

    cell, _ = harness.load_cell(name)
    cell = copy.deepcopy(cell)
    over = dict(TOY[name])
    if cell["config"] == "poisson_sinx_brick":
        over["d4est_solver_krylov_petsc"] = {"use_structured": 1}
    cell["options"] = harness.merge(cell.get("options", {}), over)
    return cell


@pytest.fixture
def toy():
    return toy_cell


def launch_cell(name, cell, n, *, seed=0, seconds=0.0, trace=0,
                device="cpu", prelude="", call=None, timeout=900):
    """Cell `name` (its file replaced by `cell`) as `n` ranks through
    `ranks.launch`, in a launcher process of its own, each rank running
    `prelude` (source; `RANK` is its rank) before `ranks.run_rank` (or the
    source `call`, with the cell as `CELL`); the launcher's
    `CompletedProcess` and its seconds."""
    call = call or (
        f"ranks.run_rank({name!r}, {seed!r}, {seconds!r}, {bool(trace)!r}, "
        f"{device!r}, t_start=0.0, cell=CELL)")
    rank = (
        "import json, os, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "RANK = int(os.environ['RANK'])\n"
        f"{prelude}\n"
        "from benchmark import ranks\n"
        f"CELL = json.loads({json.dumps(cell)!r})\n"
        f"{call}\n")
    launcher = (
        "import sys, time\n"
        "t0 = time.perf_counter()\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark import ranks\n"
        f"raise SystemExit(ranks.launch([sys.executable, '-c', {rank!r}], "
        f"{n}, t_start=t0))\n")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", launcher], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    return out, time.perf_counter() - t0


@pytest.fixture
def launch():
    return launch_cell
