"""The port's tests' one thread policy (`tests/torch_threads.py`).

- every `tests/test_torch_*.py` takes the policy's fixture and sets no
  thread count of its own;
- inside a module that takes it, torch runs with one thread when there
  are as many xdist workers as cores, and on every core the process may
  run on without xdist; the next module finds the count from before;
- n thread ranks share the count they are started with, at least one
  thread each, and the count is back after the group.

Each case runs pytest on small test modules in a child process, whose
torch count and xdist worker count it sets.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parent
CORES = len(os.sched_getaffinity(0))

TAKES_THE_POLICY = """
import torch
from torch_threads import torch_worker_threads  # noqa: F401


def test_inside():
    assert torch.get_num_threads() == {inside}
"""

AFTER = """
import torch


def test_after():
    assert torch.get_num_threads() == {before}
"""

THREAD_RANKS = """
import torch
from torch_threads import run_thread_ranks


def count(comm):
    return torch.get_num_threads()


def test_ranks():
    assert run_thread_ranks(2, count) == [2, 2]
    assert run_thread_ranks(3, count) == [1, 1, 1]
    assert run_thread_ranks(8, count) == [1] * 8
    assert torch.get_num_threads() == 4
"""

CASES = {
    "as-many-workers-as-cores": (
        dict(PYTEST_XDIST_WORKER_COUNT=str(CORES), OMP_NUM_THREADS="2"),
        {"test_a.py": TAKES_THE_POLICY.format(inside=1),
         "test_b.py": AFTER.format(before=2)}),
    "without-xdist": (
        dict(OMP_NUM_THREADS=str(max(1, CORES - 1))),
        {"test_a.py": TAKES_THE_POLICY.format(inside=CORES),
         "test_b.py": AFTER.format(before=max(1, CORES - 1))}),
    "thread-ranks": (
        dict(OMP_NUM_THREADS="4"),
        {"test_c.py": THREAD_RANKS}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_policy_in_a_child_run(case, tmp_path):
    env_set, modules = CASES[case]
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    for name, text in modules.items():
        (tmp_path / name).write_text(text)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "OMP_", "MKL_"))}
    env.update(env_set, PYTHONPATH=os.pathsep.join([str(TESTS), str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "no:xdist", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert f"{len(modules)} passed" in proc.stdout, proc.stdout[-3000:]


def test_every_port_test_file_takes_the_policy():
    def takes_it(text):
        return "torch_worker_threads" in {
            a.name for node in ast.parse(text).body
            if isinstance(node, ast.ImportFrom)
            and node.module == "torch_threads" for a in node.names}

    texts = {p.name: p.read_text() for p in TESTS.glob("test_torch_*.py")}
    assert texts
    assert [n for n, t in texts.items() if not takes_it(t)] == []
    assert [n for n, t in texts.items() if "set_num_threads" in t] == []
