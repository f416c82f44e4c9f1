"""A cell on N cards as N ranks: the launcher, the agreed window and the
one result line, driven on the CPU as N gloo ranks at a toy size (the
sinx brick at level 2, deg 2, through the port's distributed path)."""

import json
import os
import re
import time

import pytest

from benchmark import harness

# the program's collective timeout in these runs: a rank waiting on one
# that failed gives up after this many seconds (the card's is 300)
TIMEOUT_S = 10
SEED = 2**31 + 41


def dist_cell(n):
    cell, _ = harness.load_cell("sinx_brick_l5_deg3")
    return dict(cell, chips=n, options=harness.merge(cell.get("options", {}), {
        "initial_mesh": {"min_level": 2, "region0_deg": 2},
        "parallelism": {"enable": 1, "backend": "gloo"}}))


def prelude(plant=""):
    """Each rank's source before its run: the short collective timeout,
    then `plant` (a fault or a reading planted in the program or the
    harness)."""
    return ("import os, signal, sys, time, types\n"
            "from disco4est_tpu_torch.parallel import comm\n"
            f"comm.COLLECTIVE_TIMEOUT_S = {TIMEOUT_S}\n"
            "from benchmark import harness\n"
            "from disco4est_tpu_torch import driver\n"
            "call = harness.Job.__call__\n" + plant)


def rank_lines(err, pattern):
    """{rank: the groups of `pattern`} of the launcher's `[rank k] ...`
    lines."""
    found = {}
    for text in err.splitlines():
        m = re.match(r"\[rank (\d+)\] " + pattern, text)
        if m:
            found[int(m.group(1))] = m.groups()[1:]
    return found


def assert_no_rank_left(err, n):
    pids = rank_lines(err, r"rank \d+ of \d+: pid (\d+)")
    assert sorted(pids) == list(range(n)), err[-3000:]
    for (pid,) in pids.values():
        assert not os.path.exists(f"/proc/{pid}"), pid


def result(out):
    lines = out.stdout.strip().splitlines()
    assert lines, out.stderr[-3000:]
    line = json.loads(lines[-1])
    assert isinstance(line, dict)
    return line


# the last rank sleeps after each run, so that its wall is the largest;
# rank r reads a peak of r + 1 MiB
DELAY_S = 0.4
PLANTED = (
    "harness.memory_peak = lambda on_card: (RANK + 1) * 2**20\n"
    "def delayed(self, index):\n"
    "    res = call(self, index)\n"
    f"    time.sleep({DELAY_S})\n"
    "    return res\n"
    "if RANK == int(os.environ['WORLD_SIZE']) - 1:\n"
    "    harness.Job.__call__ = delayed\n")


@pytest.mark.parametrize("n,trace", [(2, 0), (2, 1), (4, 0)])
def test_ranks_share_one_window(n, trace, launch):
    out, _ = launch("sinx_brick_l5_deg3", dist_cell(n), n, seed=SEED,
                    seconds=2.0, trace=trace, device="cpu",
                    prelude=prelude(PLANTED))
    assert out.returncode == 0, out.stderr[-4000:]
    line = result(out)
    assert line["correct"] is True and line["failed"] == 0, line
    assert list(line)[-1] == "check"
    # every rank attempted the same runs
    ends = rank_lines(out.stderr, r"rank \d+ of \d+: attempted (\d+), "
                                  r"failed (\d+)")
    assert sorted(ends) == list(range(n))
    assert {a for a, _ in ends.values()} == {str(line["attempted"])}
    assert line["attempted"] >= (3 + 2 if trace else 1)
    # a run's wall is the slowest rank's: rank 0 reads the last rank's delay
    walls = rank_lines(out.stderr, r"run walls \(s\): (.*)")
    assert sorted(walls) == list(range(n))
    w0 = [float(v) for v in walls[0][0].split()]
    assert w0 and min(w0) >= DELAY_S
    assert len(set(walls.values())) == 1
    # the peaks are gathered: the fullest card's, and each rank's
    mib = 2**20
    assert line["device"]["count"] == n
    assert line["device"]["memory_peak_bytes"] == n * mib
    assert line["device"]["memory_peak_bytes_by_rank"] == [
        (r + 1) * mib for r in range(n)]
    # the cell's metrics (per layer, those that find something on the
    # distributed path); its run wall (`run_wall_s`) the slowest rank's
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    want = {m for m, _ in harness.metric_names(spec, "sinx_brick_l5_deg3",
                                                trace)}
    assert (set(line["metrics"]) <= want) if trace else (
        set(line["metrics"]) == want)
    if not trace:
        assert line["metrics"]["peak_mem_gib"]["value"] == n * mib / 2**30
        assert line["metrics"]["setup_s"]["value"] > 0
    else:
        assert line["metrics"]["run_wall_s"]["value"] >= DELAY_S
    # the check's numbers are the last lines of standard error
    tail = out.stderr.strip().splitlines()[-len(line["check"]):]
    assert all(t.startswith("check ") for t in tail), tail
    assert_no_rank_left(out.stderr, n)


def test_a_rank_that_raises_fails_every_rank(launch):
    """Rank 1 raises in its third run, inside the distributed solve; rank
    0 waits in the program's collective until its timeout, and both count
    one failed run."""
    plant = ("solve, calls = driver._solve_dist, []\n"
             "def failing(*a, **kw):\n"
             "    calls.append(1)\n"
             "    if len(calls) == 4:\n"
             "        raise RuntimeError('planted fault')\n"
             "    return solve(*a, **kw)\n"
             "if RANK == 1:\n"
             "    driver._solve_dist = failing\n")
    out, wall = launch("sinx_brick_l5_deg3", dist_cell(2), 2, seed=SEED,
                       seconds=300.0, trace=0, device="cpu",
                       prelude=prelude(plant))
    assert out.returncode == 0, out.stderr[-4000:]
    line = result(out)
    assert line["failed"] == 1 and line["correct"] is False, line
    assert line["attempted"] == 3
    assert "planted fault" in out.stderr
    # the window would have run 300 s: the fault ended it, after one
    # collective timeout
    assert wall < TIMEOUT_S + 60 + 60, wall
    assert_no_rank_left(out.stderr, 2)


def test_a_rank_left_hanging_ends_the_cell(launch):
    """Rank 1 raises in its third run; rank 0 hangs there outside any
    collective, as an NCCL rank waiting on its card does.  The harness's
    agreement gives up and the cell ends, with no line, within the
    program's collective timeout + 60 s of the fault."""
    plant = ("solve, calls = driver._solve_dist, []\n"
             "def faulty(*a, **kw):\n"
             "    calls.append(1)\n"
             "    if len(calls) == 4 and RANK == 1:\n"
             "        print('fault at', time.monotonic(), file=sys.stderr)\n"
             "        raise RuntimeError('planted fault')\n"
             "    if len(calls) == 4:\n"
             "        time.sleep(3600)\n"
             "    return solve(*a, **kw)\n"
             "driver._solve_dist = faulty\n")
    out, _ = launch("sinx_brick_l5_deg3", dist_cell(2), 2, seed=SEED,
                    seconds=300.0, trace=0, device="cpu",
                    prelude=prelude(plant))
    end = time.monotonic()
    assert out.returncode != 0 and out.stdout.strip() == "", out.stdout
    fault = float(re.search(r"\[rank 1\] fault at (\S+)", out.stderr)[1])
    assert end - fault < TIMEOUT_S + 60, (end - fault, out.stderr[-3000:])
    assert_no_rank_left(out.stderr, 2)


def test_a_killed_rank_ends_every_rank(launch):
    plant = ("def killed(self, index):\n"
             "    if index == 3:\n"
             "        os.kill(os.getpid(), signal.SIGKILL)\n"
             "    return call(self, index)\n"
             "if RANK == 1:\n"
             "    harness.Job.__call__ = killed\n")
    out, wall = launch("sinx_brick_l5_deg3", dist_cell(2), 2, seed=SEED,
                       seconds=300.0, trace=0, device="cpu",
                       prelude=prelude(plant))
    assert out.returncode != 0 and out.stdout.strip() == "", out.stdout
    assert "rank 1 ended with code -9" in out.stderr
    assert wall < 120, wall
    assert_no_rank_left(out.stderr, 2)


def test_a_rank_that_loads_jax_prints_nothing(launch):
    plant = ("if RANK == 1:\n"
             "    sys.modules['jax'] = types.ModuleType('jax')\n")
    out, _ = launch("sinx_brick_l5_deg3", dist_cell(2), 2, seed=SEED,
                    seconds=1.0, trace=0, device="cpu",
                    prelude=prelude(plant))
    assert out.returncode == 4, out.stderr[-3000:]
    assert out.stdout.strip() == ""
    assert "forbidden modules loaded: jax" in out.stderr
    assert_no_rank_left(out.stderr, 2)
