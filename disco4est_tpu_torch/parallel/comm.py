"""Ranks, the process group and the collectives of the distributed driver.

The port's stand-in for the collectives that the JAX package leaves to
GSPMD and `shard_map` (`jax.lax.all_to_all`, `psum`) and for
`disco4est_tpu/parallel/multihost.py` (the role of the reference's
`PetscInitialize` / MPI world, `driver.c:17`):

- one process per rank (the reference's MPI model); the ranks come from
  torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
  `LOCAL_WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`) or from the JAX
  package's names (`DISCO4EST_COORDINATOR` = host:port,
  `DISCO4EST_NUM_PROCESSES`, `DISCO4EST_PROCESS_ID`);
- a rank's device is `cuda:LOCAL_RANK % device_count`, or the CPU when the
  caller asks for it;
- NCCL between cards, gloo for CPU ranks.  `backend = auto` (the
  default) takes NCCL when every rank on the host has a card of its own
  and gloo otherwise (CPU ranks, or several ranks on one card: NCCL
  refuses two ranks on one GPU), and the driver prints which it took.  An
  explicit `nccl` that cannot be served raises (`check_backend`) and is
  never switched.  gloo takes CUDA tensors in every
  collective used here (`all_to_all_single`, `all_gather`, `broadcast`;
  checked on an H100 with torch 2.11, `chip_smoke.py` phase 15 prints the
  check) and stages them through host memory itself, so this module hands
  it the rank's tensors as they are.

Operations (`_Comm`): `exchange` (all-to-all of [n, K, ...] blocks: block
j of the result is rank j's block for this rank), `dot` and `sum` (global
reductions), `all_gather_rows` and `broadcast`.  A global reduction
gathers the n partial sums and adds them in a fixed pairwise order on
every rank, so every rank gets the same bits on every run, which
`all_reduce` does not promise: the Krylov stopping tests, the mixed
solve's outer test and Newton's line search are host decisions, and two
ranks that saw different bits would take different branches and deadlock
in the next collective.

`ThreadGroup` runs n ranks as threads of one process in lockstep through
a barrier, with the same reductions: the process group's stand-in for
tests and for debugging on one host.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import threading

import torch

# every collective of a process group ends within this many seconds or
# raises, so a rank that stops answering cannot hang the others forever
COLLECTIVE_TIMEOUT_S = 300
BACKENDS = ("auto", "nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the ranks, from its environment."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1  # ranks on this host
    init_method: str | None = None  # tcp://host:port of the rendezvous


def world_from_env(environ=None) -> World:
    """The ranks torchrun (or N plain processes with its variables, or the
    JAX package's `DISCO4EST_*` names) describe; one rank without them."""
    env = os.environ if environ is None else environ
    if "WORLD_SIZE" in env:
        size = int(env["WORLD_SIZE"])
        rank = int(env.get("RANK", "0"))
        local_rank = int(env.get("LOCAL_RANK", str(rank)))
        local_size = int(env.get("LOCAL_WORLD_SIZE", str(size)))
        port = env.get("MASTER_PORT")
        init = (f"tcp://{env.get('MASTER_ADDR', '127.0.0.1')}:{port}"
                if port else None)
    elif "DISCO4EST_NUM_PROCESSES" in env:
        size = int(env["DISCO4EST_NUM_PROCESSES"])
        rank = int(env.get("DISCO4EST_PROCESS_ID", "0"))
        local_rank, local_size = rank, size
        coord = env.get("DISCO4EST_COORDINATOR")
        init = f"tcp://{coord}" if coord else None
    else:
        return World()
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a world of {size}")
    if size > 1 and init is None:
        raise ValueError(
            f"a world of {size} ranks needs a rendezvous: set MASTER_ADDR "
            "and MASTER_PORT (or DISCO4EST_COORDINATOR = host:port)")
    return World(rank, size, local_rank, local_size, init)


def rank_device(requested, world: World) -> torch.device:
    """The rank's device: `cuda:LOCAL_RANK % device_count` when the caller
    asks for CUDA, else the CPU."""
    requested = torch.device(requested)
    if requested.type != "cuda":
        return requested
    return torch.device("cuda", world.local_rank % torch.cuda.device_count())


def _cards(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 0


def resolve_backend(backend: str, device: torch.device, world: World) -> str:
    """The backend of these ranks: `auto` takes NCCL when every rank on
    this host has a card of its own, else gloo; an explicit name is
    checked (`check_backend`) and kept."""
    if backend == "auto":
        return "nccl" if 0 < world.local_size <= _cards(device) else "gloo"
    check_backend(backend, device, world)
    return backend


def check_backend(backend: str, device: torch.device, world: World):
    """Refuse a backend that cannot serve these ranks (never switch)."""
    if backend not in BACKENDS[1:]:
        raise ValueError(f"[parallelism] backend = {backend!r}: not one of "
                         f"{BACKENDS}")
    if backend != "nccl":
        return
    cards = _cards(device)
    if device.type != "cuda" or world.local_size > cards:
        raise ValueError(
            f"[parallelism] backend = nccl with {world.local_size} ranks on "
            f"this host and {cards} visible CUDA cards: NCCL needs one card "
            "per rank; CPU ranks, or several ranks on one card, take "
            "[parallelism] backend = gloo (or auto)")


def init_process_group(backend: str, world: World, device: torch.device
                       ) -> "DistComm":
    """Join the ranks' process group (once per process) and return its
    collectives on `device`."""
    import torch.distributed as dist

    check_backend(backend, device, world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != world.size or dist.get_backend() != backend:
            raise ValueError(
                f"a process group of {dist.get_world_size()} ranks "
                f"({dist.get_backend()}) already exists; this run asks for "
                f"{world.size} ({backend})")
    else:
        dist.init_process_group(
            backend, init_method=world.init_method,
            rank=world.rank, world_size=world.size,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return DistComm(world.rank, world.size, device, backend)


def shutdown():
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def pairwise_sum(parts):
    """Σ of a [n] tensor in a fixed pairwise order (neighbours first): the
    same bits on every rank, device and run."""
    while parts.shape[0] > 1:
        if parts.shape[0] % 2:
            parts = torch.cat([parts, parts.new_zeros(1)])
        parts = parts[0::2] + parts[1::2]
    return parts[0]


class _Comm:
    """The collectives on top of a group's all-gather and all-to-all."""

    def __init__(self, rank: int, size: int, device):
        self.rank, self.size = rank, size
        self.device = torch.device(device)

    def _all_gather(self, t) -> list:
        raise NotImplementedError

    def _all_to_all(self, send):
        raise NotImplementedError

    def exchange(self, send):
        """send [n, K, ...] (block j goes to rank j) -> recv [n, K, ...]
        (block j came from rank j): `jax.lax.all_to_all(split_axis=0,
        concat_axis=0)` over the ranks."""
        if send.shape[0] != self.size:
            raise ValueError(f"exchange: {send.shape[0]} blocks for "
                             f"{self.size} ranks")
        return self._all_to_all(send.contiguous())

    def sum(self, x):
        """The global sum of a local 0-d tensor, the same bits on every
        rank."""
        parts = torch.stack([p.reshape(()) for p in
                             self._all_gather(x.reshape(()))])
        return pairwise_sum(parts).to(x.device)

    def dot(self, a, b):
        """The global dot product of two row-distributed fields."""
        return self.sum(torch.dot(a.reshape(-1), b.reshape(-1)))

    def all_gather_rows(self, x):
        """[B, ...] on every rank -> [n·B, ...], rank-major."""
        return torch.cat([p.to(x.device) for p in self._all_gather(x)])

    def broadcast(self, obj):
        """Rank 0's picklable host object (e.g. a numpy array) on every
        rank."""
        raise NotImplementedError


class DistComm(_Comm):
    """The collectives of a `torch.distributed` process group."""

    def __init__(self, rank, size, device, backend):
        super().__init__(rank, size, device)
        self.backend = backend

    def _all_gather(self, t):
        import torch.distributed as dist

        t = t.detach().contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t)
        return out

    def _all_to_all(self, send):
        import torch.distributed as dist

        out = torch.empty_like(send)
        dist.all_to_all_single(out, send)
        return out

    def broadcast(self, obj):
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


class ThreadGroup:
    """n ranks as threads of one process, in lockstep through a barrier:
    `run(fn)` calls `fn(comm)` on every rank's thread and returns the
    results by rank; an exception on any rank aborts the others' barriers
    and is raised."""

    def __init__(self, size: int):
        self.size = size
        self._barrier = threading.Barrier(size)
        self._slots = [None] * size

    def comm(self, rank: int, device="cpu") -> "ThreadComm":
        return ThreadComm(self, rank, device)

    def run(self, fn, device="cpu"):
        results, errors = [None] * self.size, []

        def target(rank):
            try:
                results[rank] = fn(self.comm(rank, device))
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=target, args=(r,))
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            self._barrier.reset()
            raise next((e for e in errors
                        if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return results


class ThreadComm(_Comm):
    """One rank of a `ThreadGroup`."""

    def __init__(self, group: ThreadGroup, rank: int, device):
        super().__init__(rank, group.size, device)
        self.group = group

    def _all_gather(self, t):
        g = self.group
        g._slots[self.rank] = t
        g._barrier.wait()
        out = list(g._slots)
        g._barrier.wait()
        return out

    def _all_to_all(self, send):
        blocks = self._all_gather(send)
        return torch.stack([b[self.rank].to(send.device) for b in blocks])

    def broadcast(self, obj):
        return self._all_gather(obj)[0]
