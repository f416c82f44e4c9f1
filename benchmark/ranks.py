"""A cell on N > 1 cards: N ranks, one process a card, one result line.

The port's distributed path runs one process per rank with torchrun's
environment (`disco4est_tpu_torch/parallel/comm.py`, `world_from_env`).
`launch` is the launcher: it starts N copies of a command, each with
`RANK` = `LOCAL_RANK` = 0 .. N-1, `WORLD_SIZE` = `LOCAL_WORLD_SIZE` = N,
`MASTER_ADDR` = 127.0.0.1 and a free `MASTER_PORT` (and, as torchrun
does, `OMP_NUM_THREADS` = 1 unless it is set).  It opens no CUDA context.
Rank 0's standard output is held back and printed, its result line last,
only when rank 0 ends with code 0; every other output goes to standard
error with a `[rank k]` prefix.  A rank that exits non-zero before rank 0
has ended makes the launcher end every rank and exit with that rank's
code and no result; so does a signal to the launcher.  Each rank asks the
kernel to kill it when the launcher dies (`enter`), so no rank outlives
the launcher.

`Team` is what the harness agrees on between ranks: the port's process
group, formed before the warm-up (the program reuses it), and a gloo
group of the harness's own beside it, so that a broken NCCL communicator
cannot hold up the agreement.  Its collectives take the larger of every
rank's numbers (`max`) or every rank's numbers (`gather`).
"""

from __future__ import annotations

import datetime
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

# the launcher's start on the host's monotonic clock (`time.perf_counter`
# is CLOCK_MONOTONIC on Linux, one clock for every process), and its pid
T0_ENV = "D4EST_BENCH_T0"
LAUNCHER_ENV = "D4EST_BENCH_LAUNCHER"
GRACE_S = 60.0  # how long the other ranks may take to end after rank 0
# The harness's group waits the program's collective timeout and this
# much more: ranks that the program's timeout sends to a failed run still
# join the agreement, and a rank that raised, whose peers hang on their
# card in an NCCL wait (NCCL's watchdog ends them only a minute after the
# timeout), gives up and ends the cell within the timeout + 60 s
AGREE_EXTRA_S = 50
OFF = ("0", "false", "no", "off")


def is_rank() -> bool:
    """Whether this process is one rank of a launched world."""
    return "WORLD_SIZE" in os.environ


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pump(stream, label, keep, lock):
    """Copy a rank's stream to standard error line by line, each prefixed
    with its rank, or keep the lines (rank 0's standard output)."""
    for text in iter(stream.readline, ""):
        if keep is not None:
            keep.append(text)
            continue
        with lock:
            sys.stderr.write(f"[{label}] {text}")
            sys.stderr.flush()
    stream.close()


def _code(rc: int) -> int:
    """A shell's exit code for a return code (128 + n for signal n)."""
    return 128 - rc if rc < 0 else rc


class _Ended(Exception):
    def __init__(self, signum):
        super().__init__(f"signal {signum}")
        self.signum = signum


def _watch(procs) -> tuple[int, int | None]:
    """Wait until rank 0 ends or another rank fails first; (rank, its
    return code) of the process that decided it."""
    while True:
        for r, p in enumerate(procs):
            rc = p.poll()
            if rc is not None and (r == 0 or rc != 0):
                return r, rc
        time.sleep(0.1)


def _end(procs, grace: float):
    """End every rank still running: wait `grace` seconds, then SIGTERM,
    then SIGKILL, and reap each one."""
    deadline = time.monotonic() + grace
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            print(f"ending rank {procs.index(p)} (pid {p.pid})",
                  file=sys.stderr)
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=5)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(cmd, n: int, *, t_start: float) -> int:
    """Run `cmd` as `n` ranks and return the launcher's exit code; rank
    0's standard output is printed when it ends with code 0, and with the
    result line's `check` numbers repeated as the last lines of standard
    error."""
    base = dict(os.environ)
    base.setdefault("OMP_NUM_THREADS", "1")
    base.update(WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    base[T0_ENV], base[LAUNCHER_ENV] = repr(t_start), str(os.getpid())
    lock, out0, procs, pumps = threading.Lock(), [], [], []

    def on_signal(signum, _frame):
        raise _Ended(signum)

    caught = (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)
    saved = ({s: signal.signal(s, on_signal) for s in caught}
             if threading.current_thread() is threading.main_thread()
             else {})
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                cmd, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, errors="replace"))
        for r, p in enumerate(procs):
            for stream, keep in ((p.stdout, out0 if r == 0 else None),
                                 (p.stderr, None)):
                pumps.append(threading.Thread(
                    target=_pump, args=(stream, f"rank {r}", keep, lock),
                    daemon=True))
                pumps[-1].start()
        who, rc = _watch(procs)
        if who != 0:
            print(f"rank {who} ended with code {rc} before rank 0: ending "
                  "every rank, no result", file=sys.stderr)
        _end(procs, GRACE_S if who == 0 and rc == 0 else 0.0)
    except _Ended as e:
        _end(procs, 0.0)
        print(f"launcher ended by {e}: every rank ended, no result",
              file=sys.stderr)
        return 128 + e.signum
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for s, h in saved.items():
            signal.signal(s, h)
    for t in pumps:
        t.join(timeout=10)
    if who != 0 or rc != 0:
        for text in out0:
            sys.stderr.write(f"[rank 0] {text}")
        return _code(rc) or 1
    from benchmark.harness import forbidden_loaded

    if forbidden_loaded():
        return 4
    sys.stdout.write("".join(out0))
    sys.stdout.flush()
    try:
        check = json.loads(out0[-1]).get("check", {}) if out0 else {}
    except (ValueError, AttributeError):
        check = {}
    for k, v in check.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    return 0


def enter(device: str):
    """This process as a rank: killed with its launcher, on the card of
    its `LOCAL_RANK`; (rank, world size, the launcher's start or None)."""
    parent = os.environ.get(LAUNCHER_ENV)
    if parent is not None and sys.platform.startswith("linux"):
        import ctypes

        PR_SET_PDEATHSIG = 1
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG,
                                               signal.SIGKILL)
        if os.getppid() != int(parent):  # the launcher died before
            os._exit(1)
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device == "cuda":
        import torch

        torch.cuda.set_device(local)
    print(f"rank {rank} of {size}: pid {os.getpid()}, device {device}"
          f"{':' + str(local) if device == 'cuda' else ''}", file=sys.stderr)
    t0 = os.environ.get(T0_ENV)
    return rank, size, (float(t0) if t0 is not None else None)


def run_rank(name, seed, seconds, trace_on, device, *, t_start, cell=None):
    """One rank of cell `name`: `harness.run_cell` as this rank, rank 0's
    result line on standard output; ends the process with its code."""
    from benchmark import harness

    _, _, t0 = enter(device)
    code, line = harness.run_cell(name, seed, seconds, trace_on,
                                  t_start=t_start if t0 is None else t0,
                                  device=device, cell=cell)
    if line is not None:
        print(json.dumps(line))
    sys.stdout.flush()
    sys.stderr.flush()
    # no teardown of the process groups: a rank whose window failed may
    # hold a broken communicator, whose teardown can hang; the rank's
    # work is done and its output flushed
    os._exit(code)


class Team:
    """This rank among the cell's ranks, with the harness's gloo group."""

    def __init__(self, rank: int, size: int, group):
        self.rank, self.size, self.group = rank, size, group

    @classmethod
    def join(cls, sections: dict, device: str, chips: int) -> "Team":
        """Form the port's process group as the program would (the backend
        of `[parallelism] backend`, the program's collective timeout) and
        the harness's gloo group beside it."""
        import torch.distributed as dist

        from disco4est_tpu_torch.parallel import comm

        par = sections.get("parallelism", {})
        if str(par.get("enable", "auto")).lower() in OFF:
            raise ValueError(f"a cell on {chips} cards runs the port's "
                             "distributed path: [parallelism] enable = 0")
        world = comm.world_from_env()
        if world.size != chips:
            raise ValueError(f"a cell on {chips} cards runs as {chips} ranks, "
                             f"not {world.size}: start it through "
                             "benchmark/run.py")
        dev = comm.rank_device(device, world)
        comm.init_process_group(
            comm.resolve_backend(par.get("backend", "auto"), dev, world),
            world, dev)
        group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=comm.COLLECTIVE_TIMEOUT_S + AGREE_EXTRA_S))
        return cls(world.rank, world.size, group)

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def gather(self, values) -> list:
        """Every rank's `values` (floats), by rank."""
        import torch
        import torch.distributed as dist

        mine = torch.tensor([float(v) for v in values], dtype=torch.float64)
        out = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(out, mine, group=self.group)
        return [t.tolist() for t in out]

    def max(self, values) -> list:
        """The largest of every rank's `values`, item by item."""
        return [max(col) for col in zip(*self.gather(values))]
