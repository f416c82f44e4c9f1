"""The benchmark of disco4est_tpu_torch: one cell, one process a card.

From the root of a checkout, on a machine with the card(s) the cell asks
for:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `check`, the numbers compared with the reference beside their
limits (also the last lines of standard error).  It exits non-zero with
no result line when there is no card, fewer cards than the cell asks
for, no program beside the benchmark, or when JAX or the JAX package is
loaded after the window.

A cell whose `chips` is N > 1 runs as N ranks of the port's distributed
path, one process a card: this process starts N copies of itself with
torchrun's variables (`ranks.launch`), and prints rank 0's result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _caches():
    """Every compile cache at a fixed path inside the checkout, so that
    only a cell's first run there compiles (the port's own kernel
    libraries go to `build/kernels/`, also inside the checkout)."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    # the checkout's root, not this folder, is where imports resolve
    sys.path[:] = [p for p in sys.path
                   if pathlib.Path(p or ".").resolve() != ROOT / "benchmark"]
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness

    cell = harness.load_json(ROOT / "benchmark" / "workloads"
                             / f"{args.workload}.json")
    need = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import disco4est_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program under test is missing: {exc}", file=sys.stderr)
        return 3
    if need > 1:
        from benchmark import ranks

        if ranks.is_rank():  # never returns
            ranks.run_rank(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", t_start=T_START)
        return ranks.launch(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--workload", args.workload, "--seed", str(args.seed),
             "--seconds", repr(args.seconds), "--trace", str(args.trace)],
            need, t_start=T_START)
    torch.cuda.set_device(0)
    code, line = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
    if line is not None:
        print(json.dumps(line), flush=True)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
