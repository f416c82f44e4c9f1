"""The distributed driver through the port's CLI: real gloo process groups.

The reference's driver is the MPI program (`driver.c:13-313`) and
`d4est_test_mpi.sh` requires `-np 1` and `-np 8` to print the same norm.
Here 2 and 4 CPU ranks of `python -m disco4est_tpu_torch --device=cpu`
(torchrun's variables on 127.0.0.1, one process per rank) run the
configurations of `tests/test_driver_distributed.py:58-173`; rank 0's norm
lines are held to the one-process port run and to the JAX distributed
driver's values (8 virtual devices, `refcheck/dist_smoke_pins.py`):
that test's tolerances as relative bounds, 1e-11 for the f64 CG runs and
1e-10 for mixed precision and multigrid, and CDS to 2e-12 absolute (the
Newton stop at ‖F‖ ≤ 1e-12 leaves ~1e-12 in u; that test's own bound,
1e-10·max(1, |a|), is absolute there too).  Every rank process has a
timeout and is killed in a `finally`, so a deadlock fails one test.

In process (no group is formed): the refusals of `[parallelism]` —
`backend = nccl` without a card per rank, the combinations the JAX driver
runs on one device without a word (ROADMAP C6) or with Chebyshev for a
Schwarz multigrid smoother (C2), `enable = 1` on one rank, `n_devices`
against the world size — all raise before any rank joins a group.
"""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

from disco4est_tpu_torch import driver
from disco4est_tpu_torch.problems.poisson import SinxProblem
from disco4est_tpu_torch.util.config import Options

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "refcheck"))
import dist_smoke_pins as P  # noqa: E402  (options text only, no JAX)
from torch_threads import (  # noqa: E402, F401
    rank_threads, torch_worker_threads)

RANK_TIMEOUT_S = 120
# the JAX distributed driver, 8 virtual CPU devices
# (`python refcheck/dist_smoke_pins.py`)
JAX_L2 = {
    "sinx_hp": [0.015208529424303185, 0.0019464036376921176,
                0.0009024578431378494],
    "sinx_mixed": [0.015208529424303188, 0.0019464036376921092],
    "mg": [0.015208529424303199, 0.001946403637692102],
    "cds": [6.255098159867211e-06],
}
# (relative, absolute): |a − b| ≤ max(rel·|b|, abs)
BOUND = {"sinx_hp": (1e-11, 0.0), "sinx_mixed": (1e-10, 0.0),
         "mg": (1e-10, 0.0), "cds": (0.0, 2e-12)}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n, texts, tmp_path, problem="sinx"):
    """Run n rank processes of the CLI (rank r reads `texts[r]`), each with
    an equal share of this process's torch threads; returns
    [(returncode, stdout, stderr)] by rank."""
    port = _free_port()
    threads = rank_threads(n)
    procs = []
    try:
        for r in range(n):
            path = tmp_path / f"rank{r}.input"
            path.write_text(texts[r])
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       OMP_NUM_THREADS=str(threads), PYTHONPATH=str(ROOT))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "disco4est_tpu_torch", str(path),
                 f"--problem={problem}", "--device=cpu"],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        out = []
        for p in procs:
            stdout, stderr = p.communicate(timeout=RANK_TIMEOUT_S)
            out.append((p.returncode, stdout, stderr))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _norms(lines):
    return [float(x.split()[3]) for x in lines
            if len(x.split()) == 4 and x.split()[0].isdigit()]


_ONE = {}


def one_process(name):
    """The one-process port run of a configuration (in process)."""
    if name not in _ONE:
        opts = Options.load(P.options(name, 1))
        if name == "cds":
            res = driver.run_nonlinear(opts, driver.CDSProblem(opts),
                                       device="cpu")
        else:
            res = driver.run_poisson(opts, SinxProblem, device="cpu")
        _ONE[name] = [r["L_2"] for r in res.norms.rows]
    return _ONE[name]


@pytest.mark.parametrize("name,n", [
    ("sinx_hp", 2), ("sinx_hp", 4), ("sinx_mixed", 2), ("mg", 2),
    ("cds", 2), ("cds", 4),
])
def test_ranks_print_the_one_process_norms(name, n, tmp_path):
    out = run_ranks(n, [P.options(name, n)] * n, tmp_path,
                    problem="cds" if name == "cds" else "sinx")
    for r, (code, stdout, stderr) in enumerate(out):
        assert code == 0, (r, stderr[-3000:])
        if r:  # only rank 0 prints
            assert stdout == "", (r, stdout)
    lines = out[0][1].splitlines()
    # backend = auto (the default) takes gloo for CPU ranks and says so
    assert lines[0] == (f"parallelism: {n} ranks, backend = gloo (auto: {n} "
                        "ranks on this host, 0 CUDA cards)"), lines[0]
    got = _norms(lines)
    ref, pin, (rel, absolute) = one_process(name), JAX_L2[name], BOUND[name]
    assert len(got) == len(ref) == len(pin)
    for a, b, c in zip(ref, got, pin):
        assert abs(a - b) <= max(rel * abs(a), absolute), (a, b)
        assert abs(c - b) <= max(rel * abs(c), absolute), (c, b)
    step = "newton level" if name == "cds" else "solve level"
    solves = [x for x in lines if x.startswith(step)]
    assert len(solves) == len(got)
    if name != "cds":  # every solve went through the halo program
        assert all("-halo " in x for x in solves), solves


def test_a_failing_rank_ends_every_rank(tmp_path):
    """Rank 1 fails after the group has formed (its options name no known
    geometry); rank 0 then fails in its next collective instead of
    hanging."""
    good = P.options("sinx_hp", 2)
    bad = good.replace("name = brick", "name = no_such_geometry")
    out = run_ranks(2, [good, bad], tmp_path)
    assert out[1][0] != 0 and "no_such_geometry" in out[1][2]
    assert out[0][0] != 0


def _in_world(monkeypatch, n, rank=0):
    monkeypatch.setenv("WORLD_SIZE", str(n))
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("LOCAL_RANK", str(rank))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")  # never reached: they raise first


LINEAR = P.options("sinx_hp", 2)
C6_LINEAR = {
    "schwarz": "pc_type = schwarz",
    "cheby": "pc_type = cheby",
    "midsolve": "\n[checkpoint]\nprefix = {tmp}/ck\n"
                "checkpoint_every_n_krylov_its = 5",
}


@pytest.mark.parametrize("case", sorted(C6_LINEAR))
def test_c6_linear_combinations_raise(case, monkeypatch, tmp_path):
    _in_world(monkeypatch, 2)
    extra = C6_LINEAR[case].format(tmp=tmp_path)
    text = (LINEAR.replace("use_mixed_precision = 0",
                           "use_mixed_precision = 0\n" + extra)
            if case != "midsolve" else LINEAR + extra)
    with pytest.raises(NotImplementedError, match="C6"):
        driver.run_poisson(Options.load(text), SinxProblem, device="cpu")


@pytest.mark.parametrize("pc", ["multigrid", "schwarz", "cheby"])
def test_c6_nonlinear_preconditioners_raise(pc, monkeypatch):
    _in_world(monkeypatch, 4, rank=3)
    opts = Options.load(P.options("cds", 4).replace(
        "ksp_type = cg", f"ksp_type = fcg\npc_type = {pc}"))
    with pytest.raises(NotImplementedError, match="C6"):
        driver.run_nonlinear(opts, driver.CDSProblem(opts), device="cpu")


@pytest.mark.parametrize("smoother", ["mg_smoother_schwarz", "schwarz",
                                      "schwarz_overlap"])
def test_c2_schwarz_smoother_raises(smoother, monkeypatch):
    _in_world(monkeypatch, 2)
    text = P.options("mg", 2) + f"\n[multigrid]\nsmoother_name = {smoother}\n"
    with pytest.raises(NotImplementedError, match="C2"):
        driver.run_poisson(Options.load(text), SinxProblem, device="cpu")


def test_nccl_without_a_card_per_rank_raises(monkeypatch):
    _in_world(monkeypatch, 2)
    text = LINEAR + "backend = nccl\n"
    with pytest.raises(ValueError, match="backend = gloo"):
        driver.run_poisson(Options.load(text), SinxProblem, device="cpu")


def test_world_size_checks(monkeypatch):
    # enable = 1 on one rank (JAX `driver.py:487-490`)
    text = LINEAR.replace("enable = auto", "enable = 1").replace(
        "n_devices = 2", "n_devices = 1")
    with pytest.raises(ValueError, match="more than one rank"):
        driver.run_poisson(Options.load(text), SinxProblem, device="cpu")
    # n_devices must be the world size
    with pytest.raises(ValueError, match="n_devices = 2"):
        driver.run_poisson(Options.load(LINEAR), SinxProblem, device="cpu")
    _in_world(monkeypatch, 4)
    with pytest.raises(ValueError, match="n_devices = 2"):
        driver.run_poisson(Options.load(LINEAR), SinxProblem, device="cpu")
    # enable = 0 runs one process's solve whatever the world
    text = LINEAR.replace("enable = auto", "enable = 0")
    res = driver.run_poisson(Options.load(text), SinxProblem, device="cpu")
    assert [s.path for s in res.solves] == ["cg", "cg", "cg-hp"]
