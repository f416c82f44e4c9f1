"""The control fails the check: the reference put in the program's place
and computed in float32, one precision below the configurations' float64,
exceeds a cell's limits, while the program's runs on every problem of the
set stay inside them (here at toy sizes; PERF.md gives the readings at
the cells' own sizes on the card)."""

import pytest

from benchmark import control, harness


@pytest.mark.parametrize("name", ["sinx_brick_l5_deg3",
                                  "sinx_brick_l5_deg3_f64",
                                  "sinx_brick_l4_deg7",
                                  "sinx_brick_l6_deg3",
                                  "cds_brick_l5_deg2"])
def test_control_fails_and_program_passes(name, toy):
    cell = toy(name)
    limits = cell["check"]["limits"]
    rows = control.readings(name, 3, "cpu", cell=cell, out=lambda s: None)
    program = [r for r in rows if r["side"] == "program"]
    ctrl = [r for r in rows if r["side"] == "control"]
    assert len(program) == int(cell["data"]["set"]) and len(ctrl) == 3
    for r in program:
        assert all(r[k] <= v for k, v in limits.items()), r
    for r in ctrl:
        assert any(r[k] > v for k, v in limits.items()), r
    assert harness.final_shape(harness.merge(
        harness.load_cell(name)[1]["options"], cell["options"]))


def test_control_over_ranks(launch):
    """A cell on two cards: the program's readings as two gloo ranks, every
    problem of the set judged once by rank 0, then the early stop and the
    control (on rank 0 alone)."""
    import json

    cell, _ = harness.load_cell("sinx_brick_l5_deg3")
    cell = dict(cell, chips=2, options=harness.merge(cell.get("options", {}), {
        "initial_mesh": {"min_level": 2, "region0_deg": 2},
        "parallelism": {"enable": 1, "backend": "gloo"}}))
    out, _ = launch("sinx_brick_l5_deg3", cell, 2, call=(
        "from benchmark import control\n"
        "control.as_rank('sinx_brick_l5_deg3', 1, 'cpu', cell=CELL, "
        "early=1)"))
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(t) for t in out.stdout.strip().splitlines()]
    sides = [r["side"] for r in rows]
    assert sides == ["program"] * int(cell["data"]["set"]) + [
        "early", "control"], sides
    limits = cell["check"]["limits"]
    for r in rows:
        inside = all(r[k] <= v for k, v in limits.items())
        assert inside == (r["side"] == "program"), r
