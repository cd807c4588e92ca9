"""The device mesh, the collective dispatch lock and the exchanges.

Counterpart of the reference's ``parallel/mesh.py``. The reference runs
one process over every device and splits its mesh kernels with
``shard_map``; the port runs one rank per device on ``torch.distributed``
(NCCL for CUDA tensors, gloo for CPU ones) and splits each distributed
dispatch into three steps: the **local step** over the rank's page shard
(K6, K1/K1s/K4, K7, K2/K2r, as on one device), the **exchange**
(``all_reduce`` of counts, inspected and aggregate histograms,
``all_gather`` of the per-shard top-k candidates or of the probe's hit
masks) and the **merge** (K9, ``kernels/dist.py``).

The exchange is an object the engines are given:

- ``ShardExchange`` wraps the 1-D DeviceMesh's process group; this
  process is one rank. It is the only exchange ``TempoDB`` uses.
- ``LocalExchange(world)`` runs the local step of ranks ``0..world-1`` in
  turn in one process on one device and stacks their outputs as
  ``all_gather`` would. It holds the arithmetic of S > 1 shards on a
  single card or CPU; the tests and ``chip_smoke.py`` use it, never a
  database.

Collectives must be issued in one order on every rank, so every
collective dispatch of a process runs under one lock (``dispatch_lock``)
whose wait is bounded: a timeout raises ``DispatchLockTimeout``. The port
has no host route, so unlike the reference it books no breaker fault. A
dispatch takes the lock before its launch window opens, and books the
wait as its record's ``lock_wait`` stage.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from ..observability import metrics as obs
from ..search.kernels import LaunchCount

SCAN_AXIS = "shards"

# every collective a ShardExchange issues (an all_reduce or an all_gather)
COLLECTIVES = LaunchCount()

# one process-wide lock over every collective dispatch site (the batched
# scans, the single-block engine and the dictionary probe that runs while a
# query compiles): two threads issuing collectives concurrently could
# issue them in different orders on two ranks and hang both
dispatch_lock = threading.Lock()


class DispatchLockTimeout(RuntimeError):
    """The collective dispatch lock was not acquired in time: another
    dispatch is wedged while holding it."""


# the depth at which this thread holds dispatch_lock: a dispatch that
# takes the lock around its launch window holds it through the exchange
# step inside (kernels.dist.exchange_merge), which re-enters without a wait
_held = threading.local()


@contextlib.contextmanager
def locked_collective(timeout_s: float = 60.0, rec=None):
    """Hold ``dispatch_lock``, waiting at most `timeout_s` seconds for it
    (``TempoDBConfig.search_dispatch_lock_timeout_s``; <= 0 waits
    forever). Raises DispatchLockTimeout when the wait runs out. The wait
    is booked as the `lock_wait` stage of `rec` (a profiler record), host
    wall time, as the reference books it. A thread that already holds the
    lock through an enclosing ``locked_collective`` re-enters at once."""
    depth = getattr(_held, "depth", 0)
    if depth:
        _held.depth = depth + 1
        try:
            yield
        finally:
            _held.depth = depth
        return
    t0 = time.perf_counter()
    if timeout_s and timeout_s > 0:
        ok = dispatch_lock.acquire(timeout=timeout_s)
    else:
        ok = dispatch_lock.acquire()
    if not ok:
        obs.dispatch_lock_timeouts.inc()
        raise DispatchLockTimeout(
            f"collective dispatch lock not acquired within {timeout_s:.1f}s"
            " -- another dispatch is wedged while holding it")
    _held.depth = 1
    try:
        if rec is not None:
            rec.add_stage("lock_wait", time.perf_counter() - t0)
        yield
    finally:
        _held.depth = 0
        dispatch_lock.release()


def make_mesh(world: int | None = None, device_type: str | None = None):
    """The 1-D DeviceMesh over the first `world` ranks of the initialized
    default process group (all of them by default), its one dimension
    named ``SCAN_AXIS``. `device_type` defaults to ``cuda`` on an NCCL
    group and ``cpu`` otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(multihost.init_distributed)")
    world = dist.get_world_size() if world is None else int(world)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(SCAN_AXIS,))


class ShardExchange:
    """The exchange over a DeviceMesh's process group: this process runs
    rank ``rank`` of ``world``. Raises ValueError when the group's backend
    cannot carry tensors of `device` (NCCL for CUDA, gloo for the CPU)."""

    def __init__(self, mesh, device: torch.device,
                 lock_timeout_s: float = 60.0):
        import torch.distributed as dist

        self.group = mesh.get_group(SCAN_AXIS)
        kind = torch.device(device).type
        backend = str(dist.get_backend(self.group)).lower()
        want = "nccl" if kind == "cuda" else "gloo"
        if backend != want:
            raise ValueError(
                f"a {kind} database needs a {want} process group; the "
                f"mesh's group runs {backend}")
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.ranks = (self.rank,)
        self.lock_timeout_s = lock_timeout_s

    def locked(self, rec=None):
        """The collective dispatch lock, its wait booked as `rec`'s
        lock_wait."""
        return locked_collective(self.lock_timeout_s, rec)

    def all_reduce(self, parts: list) -> torch.Tensor:
        """The sum over ranks of this rank's one part (in place)."""
        import torch.distributed as dist

        (t,) = parts
        dist.all_reduce(t, group=self.group)
        COLLECTIVES.bump()
        return t

    def all_gather(self, parts: list) -> torch.Tensor:
        """Every rank's part stacked along a new leading rank axis."""
        import torch.distributed as dist

        (t,) = parts
        t = t.contiguous()
        wire = t.view(torch.uint8) if t.dtype == torch.bool else t
        out = torch.empty((self.world,) + tuple(wire.shape), dtype=wire.dtype,
                          device=wire.device)
        dist.all_gather(list(out.unbind(0)), wire, group=self.group)
        COLLECTIVES.bump()
        return out.view(torch.bool) if t.dtype == torch.bool else out


class LocalExchange:
    """All `world` ranks in one process on one device: the local step runs
    for each rank in turn, and the exchange stacks and sums their outputs
    as the collectives would. Issues no collective."""

    def __init__(self, world: int):
        if world < 1:
            raise ValueError("world must be >= 1")
        self.world = int(world)
        self.ranks = tuple(range(self.world))

    def locked(self, rec=None):
        return contextlib.nullcontext()

    def all_reduce(self, parts: list) -> torch.Tensor:
        return torch.stack(parts).sum(0, dtype=parts[0].dtype)

    def all_gather(self, parts: list) -> torch.Tensor:
        return torch.stack([p.contiguous() for p in parts])
