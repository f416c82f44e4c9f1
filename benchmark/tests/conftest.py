"""The benchmark's CPU tests: the checkout's root on the import path, and
small cells (a toy level of each cell, `toy_cell`)."""

import copy
import pathlib
import sys

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
