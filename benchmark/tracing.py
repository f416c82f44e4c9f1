"""Spans around the port driver's calls into each layer, and the
reduction of a `torch.profiler` trace.

The spans wrap module attributes of the program from the outside, so the
program itself carries no instrumentation.  `SPANS` names them: the
driver's calls into the mesh build, the RHS, the solvers, the norms,
the estimator and the AMR step, and the structured (B1) apply that the
mixed solve's inner CG calls.  Two ways to record them:

- "sync": the device is synchronized at both ends and the host clock
  read, so a span's time is its own work (and the syncs perturb the run);
- "profile": each call is a `record_function` range, with no sync, for a
  run under `torch.profiler`.

Device busy time is the union of the device intervals (kernels, copies,
sets) with the annotation ranges left out.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import importlib
import time

import torch

# (module, attribute): the calls into each layer, named by the attribute
SPANS = (
    ("disco4est_tpu_torch.driver", "build_mesh"),
    ("disco4est_tpu_torch.driver", "build_rhs_with_strong_bc"),
    ("disco4est_tpu_torch.driver", "mixed_refine_solve"),
    ("disco4est_tpu_torch.driver", "cg_solve"),
    ("disco4est_tpu_torch.driver", "fcg_solve"),
    ("disco4est_tpu_torch.driver", "newton_solve"),
    ("disco4est_tpu_torch.driver", "norm_L2"),
    ("disco4est_tpu_torch.driver", "estimate_bi"),
    ("disco4est_tpu_torch.driver", "refine_and_balance"),
    ("disco4est_tpu_torch.driver", "transfer_field"),
    ("disco4est_tpu_torch.laplacian.structured", "apply_structured"),
)
RUN = "driver_run"  # the range around one whole driver call
NAMES = frozenset([a for _, a in SPANS] + [RUN])


class Recorder:
    """Per-run span sums (seconds and calls by name), and the shape of the
    structured apply's first argument."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.shapes = {}

    def take(self):
        out = dict(seconds=dict(self.seconds), calls=dict(self.calls))
        self.seconds.clear()
        self.calls.clear()
        return out


def _note_shape(rec, name, args):
    if name == "apply_structured" and name not in rec.shapes and args:
        sb = args[0]
        rec.shapes[name] = dict(E=int(sb.n_elements), dim=int(sb.dim),
                                deg=int(sb.deg))


@contextlib.contextmanager
def spans(mode: str, rec: Recorder):
    """Wrap every attribute of `SPANS` for the duration ("sync" or
    "profile"); restore them after."""
    from torch.profiler import record_function

    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else (lambda: None))
    saved = []
    for mod_name, attr in SPANS:
        mod = importlib.import_module(mod_name)
        inner = getattr(mod, attr)

        def wrapped(*args, _inner=inner, _name=attr, **kwargs):
            rec.calls[_name] += 1
            _note_shape(rec, _name, args)
            if mode == "profile":
                with record_function(_name):
                    return _inner(*args, **kwargs)
            sync()
            t0 = time.perf_counter()
            try:
                return _inner(*args, **kwargs)
            finally:
                sync()
                rec.seconds[_name] += time.perf_counter() - t0

        saved.append((mod, attr, inner))
        setattr(mod, attr, wrapped)
    try:
        yield rec
    finally:
        for mod, attr, inner in saved:
            setattr(mod, attr, inner)


def union(intervals):
    """Total length of a union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _clip(intervals, windows):
    """The parts of the sorted `intervals` inside the sorted, disjoint
    `windows`."""
    out, j = [], 0
    for a, b in intervals:
        while j < len(windows) and windows[j][1] <= a:
            j += 1
        k = j
        while k < len(windows) and windows[k][0] < b:
            lo, hi = windows[k]
            if min(b, hi) > max(a, lo):
                out.append((max(a, lo), min(b, hi)))
            k += 1
    return out


def _inside(t, windows, starts):
    """Whether t lies in one of the sorted, disjoint `windows`."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < windows[i][1]


def reduce_profile(events, top: int = 10) -> dict:
    """From `prof.events()` of profiled driver runs: device busy seconds,
    the device seconds of each span's kernels, the device time by
    operation name, and the idle gaps by the host span open
    during them (times in seconds)."""
    from torch.autograd import DeviceType

    def is_mark(e):
        return e.name in NAMES or bool(getattr(e, "is_user_annotation",
                                               False))

    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    work = [e for e in dev if not is_mark(e)]
    intervals = sorted((e.time_range.start, e.time_range.end) for e in work)
    by_op = collections.defaultdict(float)
    for e in work:
        by_op[e.name] += (e.time_range.end - e.time_range.start) * 1e-6

    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name in NAMES]
    runs = sorted((e.time_range.start, e.time_range.end) for e in host
                  if e.name == RUN)

    # device time of each span's kernels: the device work whose launch
    # (the CUDA API call with the same correlation id) lies inside one of
    # the span's host ranges.  Where fewer than 90 % of the device work's
    # launches are found, no span gets a device time, and the metrics that
    # read it report nothing
    launch = {e.id: e.time_range.start for e in events
              if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    matched = sum(e.id in launch for e in work)
    span_dev = {}
    for name in NAMES - {RUN}:
        ranges = sorted((e.time_range.start, e.time_range.end) for e in host
                        if e.name == name)
        if not ranges or not work or matched < 0.9 * len(work):
            continue
        starts = [lo for lo, _ in ranges]
        span_dev[name] = sum(
            e.time_range.end - e.time_range.start for e in work
            if e.id in launch and _inside(launch[e.id], ranges, starts)
        ) * 1e-6

    # idle gaps within the driver runs, labelled by the innermost host
    # span open at their middle (the spans nest on the host thread)
    found = []
    for lo, hi in runs:
        t = lo
        for a, b in sorted(_clip(intervals, [(lo, hi)])) + [(hi, hi)]:
            if a > t:
                found.append((0.5 * (a + t), a - t))
            t = max(t, b)
    edges = sorted([(e.time_range.start, 1, e.name) for e in host
                    if e.name != RUN]
                   + [(e.time_range.end, 0, e.name) for e in host
                      if e.name != RUN])
    gaps = collections.defaultdict(float)
    stack, j = [], 0
    for mid, length in sorted(found):
        while j < len(edges) and edges[j][0] <= mid:
            _, opens, name = edges[j]
            if opens:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            j += 1
        gaps[stack[-1] if stack else "outside spans"] += length * 1e-6

    return dict(
        busy_s=union(intervals) * 1e-6,
        span_device_s=span_dev,
        launches_matched=(matched / len(work)) if work else None,
        device_ops=sorted(([n, s] for n, s in by_op.items()),
                          key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(([n, s] for n, s in gaps.items()),
                         key=lambda kv: -kv[1])[:top],
    )
