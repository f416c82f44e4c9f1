"""On the card: one short run of each cell through `benchmark/run.py`, and
its result line's keys and metrics; and two rehearsals of a four-card
cell over four NCCL ranks.  Skips without a card (the rehearsals without
four)."""

import json
import pathlib
import re
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ["sinx_brick_l5_deg3", "cds_brick_l5_deg2",
         "sinx_brick_l5_deg3_f64", "sinx_brick_l4_deg7", "sinx_brick_l6_deg3"]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2**31 + 11), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    group = spec["per_layer"] if trace else spec["end_to_end"]
    want = {m["name"] for m in group if name in m.get("workloads", [name])}
    assert set(line["metrics"]) == want
    roof = line["metrics"].get("inner_apply_roofline")
    if roof is not None:
        assert 0 < roof["value"] <= 100
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10


# a four-card cell rehearsed as data: the cell's file on the port's
# distributed path, one NCCL rank a card
FOUR = ["sinx_brick_l5_deg3", "sinx_brick_l5_deg3_mg"]


def four_card_cell(name):
    cell, _ = harness.load_cell(name)
    return dict(cell, chips=4, options=harness.merge(cell.get("options", {}), {
        "parallelism": {"enable": 1, "n_devices": 4, "backend": "nccl"}}))


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", FOUR)
def test_four_card_rehearsal(name, trace, launch):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    out, _ = launch(name, four_card_cell(name), 4, seed=2**31 + 13,
                    seconds=3.0, trace=trace, device="cuda", timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 4
    assert len(dev["memory_peak_bytes_by_rank"]) == 4
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_by_rank"])
    attempted = re.findall(r"^\[rank (\d)\] rank \d of 4: attempted (\d+),",
                           out.stderr, re.M)
    assert sorted(r for r, _ in attempted) == ["0", "1", "2", "3"]
    assert {a for _, a in attempted} == {str(line["attempted"])}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        # rank 0's readers: the file cell's per-layer metrics that find
        # something on the distributed path
        assert line["metrics"] and set(line["metrics"]) <= {
            m["name"] for m in spec["per_layer"]
            if name in m.get("workloads", [name])}
    else:
        assert set(line["metrics"]) == {
            m["name"] for m in spec["end_to_end"]
            if name in m.get("workloads", [name])}
