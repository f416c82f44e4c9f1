"""The port's tests' one thread policy for torch on the CPU.

Every `tests/test_torch_*.py` takes it with one line,

    from torch_threads import torch_worker_threads  # noqa: F401

and defines no thread fixture of its own.  A child process or a thread
rank a test starts is given its share of the worker's count
(`rank_threads`).  The JAX tests and their `conftest.py` are left as they
are: XLA keeps its own CPU thread pool.
"""

import os

import pytest
import torch

from disco4est_tpu_torch.parallel import comm as C


@pytest.fixture(autouse=True, scope="module")
def torch_worker_threads():
    """Each worker's share of the cores for torch's intra-op threads: all
    the cores this process may run on without xdist, an equal share for
    each of the `PYTEST_XDIST_WORKER_COUNT` workers under it, at least one;
    the count found is put back after the module.

    The tier-1 run shares the host's cores among its xdist workers; a
    worker that starts one OpenMP thread per core then spins against the
    others, and small tensors take many times longer than alone.  Module
    scope, so that a test module's own module-scoped fixtures run under
    the share as well.
    """
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def rank_threads(n):
    """Each of `n` ranks' share of this process's torch threads, at least
    one."""
    return max(1, torch.get_num_threads() // n)


def run_thread_ranks(n, fn):
    """`C.ThreadGroup(n).run(fn)` with `rank_threads(n)` torch threads on
    each rank.  torch holds one count for the process, which a new thread
    takes up, so it is set once around the group and put back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(rank_threads(n))
    try:
        return C.ThreadGroup(n).run(fn)
    finally:
        torch.set_num_threads(before)
