"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to a configuration, a cell or a metric is a file
that this module finds by name (see README.md):

- `configs/<config>.json`: the options sections of a deployment;
- `workloads/<cell>.json`: its configuration, the driver entry, option
  overrides, the seeded data (`problems/<kind>.py` draws it), and the
  limits of the check;
- `metrics/<metric>.py`: a `read(rec)` that returns the metric's value
  from the run's record, or None where the record holds nothing for it.

The window is a closed loop with one client: the cell's job (one call of
the driver entry, with fresh options and fresh seeded data) runs back to
back until `seconds` have passed, the run in progress finishing.  The
trace mode measures the per-layer metrics in three phases of one process:
plain runs (their wall times and solver counts), runs with synchronized
spans (layer times), and runs under `torch.profiler` (device busy,
kernel time inside spans, idle gaps).

A cell on N > 1 cards runs as N ranks (`ranks.py`), each this module in
a process of its own, all with the same job sequence.  After every run
the ranks agree (`ranks.Team`) on the seconds since their window began,
the run's wall and whether it failed anywhere, and take the largest of
each: they end the window together, a run's wall is the slowest rank's,
and a run that failed on one rank is a failed run on every rank and ends
the window.  Rank 0 alone runs the profiler and the check, and prints the
result line; the peaks are gathered from every rank.
"""

from __future__ import annotations

import importlib
import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from benchmark import tracing as trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "disco4est_tpu")
SAMPLE = 2  # runs of the window that the check compares


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict]:
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    return cell, config


def metric_names(spec: dict, cell: str, trace_on: bool) -> list:
    """The metrics of `BENCHMARK.json` that this cell reports in this
    mode: end to end without the trace, per layer with it."""
    group = spec["per_layer"] if trace_on else spec["end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if cell in m.get("workloads", [cell])]


def options_text(sections: dict) -> str:
    return "".join(
        f"[{sec}]\n" + "".join(f"{k} = {v}\n" for k, v in keys.items())
        for sec, keys in sections.items())


def merge(*parts: dict) -> dict:
    out = {}
    for part in parts:
        for sec, keys in part.items():
            out.setdefault(sec, {}).update({k: str(v) for k, v in
                                            keys.items()})
    return out


def final_shape(sections: dict) -> tuple[int, int]:
    """(level, degree) of the last epoch of a uniform brick run."""
    level = int(sections["initial_mesh"]["min_level"])
    deg = int(sections["initial_mesh"]["region0_deg"])
    amr = sections.get("amr", {})
    steps = int(amr.get("num_of_amr_steps", 0))
    if steps and amr.get("scheme") != "uniform_h":
        raise ValueError("the reference covers uniform_h steps only")
    return level + steps, deg


# Every seed runs the same set of problems, in its own order: the data of
# a problem moves the solver's iterations by some 10 %, so data drawn anew
# for each seed would move a window's work with the seed
TABLE_SEED = 20261017


def order(seed: int, size: int) -> np.ndarray:
    """The seed's order of the cell's `size` problems."""
    return np.random.default_rng(seed % 2**64).permutation(size)


class Job:
    """The cell's job: the driver entry with the options and data of
    run `index`."""

    def __init__(self, cell: dict, config: dict, seed: int, device: str):
        from disco4est_tpu_torch import driver
        from disco4est_tpu_torch.util.config import Options

        self.driver, self.Options = driver, Options
        self.cell, self.seed, self.device = cell, seed, device
        self.kind = importlib.import_module(
            f"benchmark.problems.{cell['data']['kind']}")
        self.sections = merge(config["options"], cell.get("options", {}))
        self.entry = getattr(driver, cell["entry"])
        self.order = order(seed, int(cell["data"]["set"]))

    def data(self, index: int) -> dict:
        """The data of run `index` (0: the warm-up)."""
        k = int(self.order[(index - 1) % len(self.order)])
        return self.kind.draw(np.random.default_rng([TABLE_SEED, k]),
                              self.cell["data"])

    def __call__(self, index: int):
        data = self.data(index)
        opts = self.Options.load(options_text(
            merge(self.sections, self.kind.options(data))))
        problem = self.kind.port_problem(self.driver, opts, data)
        res = self.entry(opts, problem, device=self.device)
        if self.device == "cuda":
            torch.cuda.synchronize()
        return res


def summary(res) -> dict:
    """Host numbers of one driver result: solve seconds and Krylov
    iterations over its levels, the last level's L2 error."""
    solve_s = sum(s.seconds for s in res.solves)
    iters = sum(sum(s.krylov) if hasattr(s, "krylov") else s.iterations
                for s in res.solves)
    return dict(solve_s=solve_s, krylov_iters=iters,
                l2=float(res.norms.rows[-1]["L_2"]))


class Window:
    """Runs the job back to back and keeps a seeded sample of the results
    for the check (reservoir sampling over all runs of the process)."""

    def __init__(self, job: Job, team=None):
        self.job, self.team = job, team
        self.ended = False  # a failed run ended an agreed window
        self.index = 1
        self.rng = np.random.default_rng([job.seed % 2**64, 1])
        self.sample = []  # (index, u, l2, n_elements, deg)
        self.attempted = self.failed = 0
        self.errors = []

    def run_one(self, wrap=None):
        i = self.index
        self.index += 1
        self.attempted += 1
        t0, c0 = time.perf_counter(), time.process_time()
        try:
            res = self.job(i) if wrap is None else wrap(lambda: self.job(i))
        except Exception:  # noqa: BLE001 - a failed run is counted, not fatal
            self.failed += 1
            self.errors.append(traceback.format_exc())
            return None
        wall = time.perf_counter() - t0
        out = dict(summary(res), wall_s=wall,
                   cpu_s=time.process_time() - c0)
        item = (i, res.u, out["l2"], res.mesh.n_elements, res.mesh.deg)
        seen = self.attempted - self.failed
        if len(self.sample) < SAMPLE:
            self.sample.append(item)
        else:
            j = int(self.rng.integers(0, seen))
            if j < SAMPLE:
                self.sample[j] = item
        return out

    def loop(self, seconds: float, wrap=None, min_runs=1, max_runs=None):
        """Runs until `seconds` have passed (and at least `min_runs`);
        (their records, the window's wall seconds)."""
        if self.team is not None:
            return self._agreed_loop(seconds, wrap, min_runs, max_runs)
        runs = []
        t0 = time.perf_counter()
        while True:
            out = self.run_one(wrap)
            if out is None:
                break
            runs.append(out)
            if max_runs is not None and len(runs) >= max_runs:
                break
            if (len(runs) >= min_runs
                    and time.perf_counter() - t0 >= seconds):
                break
        return runs, time.perf_counter() - t0

    def _agreed_loop(self, seconds, wrap, min_runs, max_runs):
        """`loop` over the ranks: after each run, the largest of every
        rank's seconds since the window began, wall and failed flag decide
        for all; the window's wall is the slowest rank's, to the end of
        its last run."""
        runs, elapsed = [], 0.0
        if self.ended:
            return runs, elapsed
        t0 = time.perf_counter()
        while True:
            out = self.run_one(wrap)
            elapsed, wall, failed = self.team.max(
                [time.perf_counter() - t0,
                 0.0 if out is None else out["wall_s"], out is None])
            if failed:
                if out is not None:
                    self.failed += 1
                    self.errors.append(f"run {self.index - 1} failed on "
                                       "another rank")
                self.ended = True
                break
            runs.append(dict(out, wall_s=wall))
            if max_runs is not None and len(runs) >= max_runs:
                break
            if len(runs) >= min_runs and elapsed >= seconds:
                break
        return runs, elapsed


def check(job: Job, window: Window, device: str) -> tuple[bool, dict]:
    """Compare the sampled results with the plain reference; the worst of
    each number against the cell's limit."""
    from benchmark.reference.brick import Brick

    limits = job.cell["check"]["limits"]
    level, deg = final_shape(job.sections)
    prefactor = float(job.sections.get("flux", {}).get(
        "sipg_penalty_prefactor", 2.0))
    brick = Brick.build(level, deg, prefactor=prefactor, device=device)
    worst = {k: 0.0 for k in limits}
    ok = window.failed == 0 and bool(window.sample)
    for index, u, l2, n_elements, mesh_deg in window.sample:
        if n_elements != brick.N**3 or mesh_deg != deg:
            ok = False
            continue
        ref = job.kind.reference(job.data(index), job.sections)
        nums = ref.numbers(brick, u, l2)
        for k in limits:
            worst[k] = max(worst[k], nums[k])
    numbers = {k: dict(value=worst[k], limit=float(limits[k]))
               for k in limits}
    ok = ok and all(v["value"] <= v["limit"] for v in numbers.values())
    return ok, numbers


def gpu_state() -> dict:
    """The card's power limit, SM clock, power draw and temperature, as
    `nvidia-smi` reads them (empty where it cannot)."""
    keys = ("power.limit", "clocks.sm", "power.draw", "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.strip().splitlines()[0]
        return {k: float(v) for k, v in zip(keys, out.split(","))}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}


def traced(window: Window, seconds: float, on_card: bool) -> dict:
    """The trace mode's three phases: plain runs for half the window, runs
    with synchronized spans for a quarter, then at most two runs under
    `torch.profiler` (on the card; on rank 0 alone, the other ranks making
    the same runs unprofiled)."""
    plain, _ = window.loop(seconds / 2, min_runs=3)
    recorder = trace.Recorder()
    span_runs = []

    def synced(call):
        with trace.spans("sync", recorder):
            out = call()
        span_runs.append(recorder.take())
        return out

    window.loop(seconds / 4, wrap=synced, min_runs=2)
    prof_rec = trace.Recorder()
    prof_out = {}
    if on_card and window.team is not None and not window.team.lead:
        window.loop(seconds / 4, min_runs=1, max_runs=2)
    elif on_card:
        from torch.profiler import ProfilerActivity, profile, record_function

        def profiled(call):
            with record_function(trace.RUN):
                return call()

        with trace.spans("profile", prof_rec), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            prof_runs, prof_wall = window.loop(
                seconds / 4, wrap=profiled, min_runs=1, max_runs=2)
        prof_out = trace.reduce_profile(prof.events())
        prof_out.update(window_s=prof_wall, runs=len(prof_runs),
                        calls=prof_rec.take()["calls"])
    return dict(runs=plain, span_runs=span_runs, profile=prof_out,
                shapes=dict(recorder.shapes, **prof_rec.shapes))


def forbidden_loaded() -> list:
    """The modules of `FORBIDDEN` that this process has loaded (named on
    standard error), compared by whole top-level names."""
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
    return found


def memory_peak(on_card: bool) -> int:
    """This process's peak of allocated device memory, in bytes."""
    return torch.cuda.max_memory_allocated() if on_card else 0


def read_metrics(names, rec: dict) -> dict:
    """Each metric's reader over the run's record; a reader that finds
    nothing leaves its metric out."""
    metrics = {}
    for mname, unit in names:
        reader = importlib.import_module(f"benchmark.metrics.{mname}")
        value = reader.read(rec)
        if value is None:
            continue
        entry = dict(value=value, unit=unit)
        extra = getattr(reader, "extra", None)
        if extra is not None:
            entry.update(extra(rec))
        metrics[mname] = entry
    return metrics


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, *,
             t_start: float, device: str = "cuda",
             cell: dict | None = None) -> tuple[int, dict | None]:
    """One process's run of cell `name`; (exit code, result line).
    `cell` replaces the cell's file (tests run a cell at a toy size).  A
    cell on N > 1 cards runs in each of N ranks (`ranks.run_rank`); rank
    0 returns the line, the others None."""
    spec = load_json(ROOT / "BENCHMARK.json")
    file_cell, config = load_cell(name)
    cell = cell or file_cell
    job = Job(cell, config, seed, device)
    chips = int(cell.get("chips", 1))
    team = None
    if chips > 1:
        from benchmark.ranks import Team

        team = Team.join(job.sections, device, chips)
    lead = team is None or team.lead
    window = Window(job, team)
    on_card = device == "cuda"
    if on_card:
        torch.empty(1, device="cuda")  # the CUDA context
    t_warm = time.perf_counter()

    # set-up: the library load and the compile of the first run are in
    # the warm-up run of the cell's own job (run index 0)
    job(0)
    setup_s = time.perf_counter() - t_start
    print(f"setup: {t_warm - t_start:.3f} s imports and device, "
          f"{setup_s - (t_warm - t_start):.3f} s warm-up run",
          file=sys.stderr)
    if team is not None:
        setup_s = team.max([setup_s])[0]  # to the slowest rank's warm-up
    setup_peak = memory_peak(on_card)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state = [gpu_state()] if on_card and lead else []

    rec = dict(cell=name, setup_s=setup_s, seconds=seconds,
               options=job.sections)
    if trace_on:
        rec.update(traced(window, seconds, on_card))
    else:
        runs, wall = window.loop(seconds)
        rec.update(runs=runs, window_s=wall, runs_done=len(runs))
    print("run walls (s): " + " ".join(f"{r['wall_s']:.4f}"
                                       for r in rec["runs"]), file=sys.stderr)
    print("run CPU (s): " + " ".join(f"{r['cpu_s']:.4f}"
                                     for r in rec["runs"]), file=sys.stderr)
    window_peak = memory_peak(on_card)
    peaks = [(setup_peak, window_peak)]
    if team is not None:
        peaks = team.gather([setup_peak, window_peak])
        print(f"rank {team.rank} of {team.size}: attempted "
              f"{window.attempted}, failed {window.failed}; peak bytes "
              f"set-up {setup_peak}, window {window_peak}", file=sys.stderr)
        window_peak = max(w for _, w in peaks)  # the fullest card's
    rec["window_peak_bytes"] = window_peak
    if state:
        state.append(gpu_state())
        print(f"card before / after the window: {state}", file=sys.stderr)
    rec["power_limit_w"] = state[-1].get("power.limit") if state else None
    if lead:
        metrics = read_metrics(metric_names(spec, name, trace_on), rec)
        ok, numbers = check(job, window, device)
    found = bool(forbidden_loaded())
    if team is not None:  # on any rank
        found = bool(team.max([found])[0])
    if found:
        return 4, None
    for err in window.errors[-1:]:
        print(err, file=sys.stderr)
    if not lead:
        return 0, None
    device_info = dict(
        platform="gpu" if on_card else "cpu",
        kind=torch.cuda.get_device_name() if on_card else "cpu",
        count=chips,
        memory_peak_bytes=int(max(max(p) for p in peaks)),
    )
    if team is not None:
        device_info["memory_peak_bytes_by_rank"] = [int(max(p))
                                                    for p in peaks]
    line = dict(correct=ok, attempted=window.attempted,
                failed=window.failed, metrics=metrics, device=device_info)
    prof = rec.get("profile")
    if prof:
        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = dict(device_ops=prof["device_ops"],
                                 idle_gaps=prof["idle_gaps"])
    line["check"] = numbers
    for k, v in numbers.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    return 0, line


def median(values):
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None
