"""Multi-process wiring: torch.distributed initialisation and helpers.

Counterpart of the reference's ``parallel/multihost.py``. Processes join
one ``torch.distributed`` process group and the "shards" mesh spans its
ranks. Config/env contract, the reference's names:

    coordinator       "10.0.0.1:8476"   or $TEMPO_COORDINATOR
    num_processes     8                 or $TEMPO_NUM_PROCESSES
    process_id        0..7              or $TEMPO_PROCESS_ID
    cpu_devices_per_host  0             > 0: gloo ranks on the CPU

One process is one device here (the reference's process holds every chip
of its host): ``num_processes`` counts ranks, and a rank runs on its CUDA
card (``LOCAL_RANK`` or the process id modulo the card count) over NCCL,
or with ``cpu_devices_per_host > 0`` on the CPU over gloo, where a
dryrun of ``n`` hosts with ``m`` devices each launches ``n * m`` rank
processes (``multihost_dryrun``).
"""

from __future__ import annotations

import os


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     cpu_devices_per_host: int | str | None = 0) -> bool:
    """Join the process group at ``tcp://<coordinator>``. Arguments fall
    back to TEMPO_COORDINATOR / TEMPO_NUM_PROCESSES / TEMPO_PROCESS_ID.
    Returns False, and initializes nothing, when no coordinator is
    configured (single-process mode, the common case); True once the
    group is up. With `cpu_devices_per_host` > 0 the group is gloo on the
    CPU, else NCCL with this process on its card."""
    coordinator = coordinator or os.environ.get("TEMPO_COORDINATOR", "")
    if not coordinator:
        return False
    # YAML env substitution delivers strings: coerce
    if num_processes is None or num_processes == "":
        num_processes = int(os.environ.get("TEMPO_NUM_PROCESSES", "0")) or 1
    else:
        num_processes = int(num_processes)
    if process_id is None or process_id == "":
        process_id = int(os.environ.get("TEMPO_PROCESS_ID", "0") or 0)
    else:
        process_id = int(process_id)
    cpu_devices_per_host = int(cpu_devices_per_host or 0)

    import torch
    import torch.distributed as dist

    init = dict(init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id)
    if cpu_devices_per_host:
        dist.init_process_group("gloo", **init)
    else:
        local = int(os.environ.get("LOCAL_RANK", process_id))
        dev = torch.device("cuda", local % max(1, torch.cuda.device_count()))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **init)
    return True


def ownership_members() -> tuple[list[str], str]:
    """(fleet member ids, this process's id) for the HBM ownership map,
    derived from the distributed env contract without touching
    torch.distributed. Single-process (no TEMPO_NUM_PROCESSES) is a
    one-member fleet that owns everything; every process derives the
    identical ordered list."""
    n = int(os.environ.get("TEMPO_NUM_PROCESSES", "0") or 0)
    pid = int(os.environ.get("TEMPO_PROCESS_ID", "0") or 0)
    if n > 1:
        return [f"host-{i}" for i in range(n)], f"host-{pid}"
    return ["self"], "self"


def is_multiprocess() -> bool:
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0
