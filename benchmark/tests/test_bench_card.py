"""On the card: one short run of each cell through `benchmark/run.py`, and
its result line's keys and metrics.  Skips without a card."""

import json
import pathlib
import subprocess
import sys

import pytest

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
