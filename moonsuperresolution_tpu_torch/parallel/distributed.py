"""Multi-process runtime (counterpart of moonsuperresolution_tpu/parallel/
distributed.py).

The reference has no distributed execution: SLURM launches independent
single-GPU jobs (run_GAN.sh:2-11).  Here every process of a run calls
``initialize`` against one coordinator (``host:port``, the TCP store of
``torch.distributed``), with the run's process count and its own index.
Nothing is detected from a cluster's environment: the arguments, or the
``MOONSR_COORDINATOR`` / ``MOONSR_NUM_PROCESSES`` / ``MOONSR_PROCESS_ID``
variables, say it all.

Each process drives one device, ``cuda:{local_rank}`` (``LOCAL_RANK``, else
the process index modulo the card count), or the CPU when asked.  The
backend is NCCL on cards and gloo on the CPU; ``backend="gloo"`` on cards
runs the collectives through gloo on CUDA tensors, which is what two
processes sharing one card need (NCCL refuses two ranks on one device).

Division of labour per process:
- training: each process of the data axis loads a disjoint slice of the
  dataset (``TileSampler(process_index=, process_count=)``) and contributes
  its local rows of the global batch (``global_batch``);
- inference: the tile list is sharded by process
  (``DEMSuperResolution.generate_tile_list(shard_index, num_shards)``) and
  the shards are merged by cli/merge_maps.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from moonsuperresolution_tpu_torch.device import process_device

BACKENDS = ("nccl", "gloo")
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               backend: Optional[str] = None) -> torch.device:
    """Joins the run's process group (idempotent); returns this process's
    device.

    ``coordinator_address`` is ``host:port`` of the rendezvous, which
    process 0 serves; the arguments may also come from
    ``MOONSR_COORDINATOR`` / ``MOONSR_NUM_PROCESSES`` / ``MOONSR_PROCESS_ID``.
    ``device`` is ``None`` (this process's card) or "cpu"; ``backend``
    overrides the device's default (NCCL on cards, gloo on the CPU).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "MOONSR_COORDINATOR")
    if num_processes is None and os.environ.get("MOONSR_NUM_PROCESSES"):
        num_processes = int(os.environ["MOONSR_NUM_PROCESSES"])
    if process_id is None and os.environ.get("MOONSR_PROCESS_ID"):
        process_id = int(os.environ["MOONSR_PROCESS_ID"])
    if dist.is_initialized():
        return process_device(device, dist.get_rank())
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator's host:port, the "
            "process count and this process's index (--coordinator, "
            "--num_processes, --process_id or MOONSR_COORDINATOR, "
            "MOONSR_NUM_PROCESSES, MOONSR_PROCESS_ID)")
    dev = process_device(device, process_id)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return dev


def shutdown() -> None:
    """Leaves the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> tuple[int, int]:
    """(process_index, process_count); (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def barrier() -> None:
    """Waits for every process of the group; nothing outside one."""
    if dist.is_initialized():
        dist.barrier()


def global_batch(local_batch, mesh):
    """A process's local rows of the global batch, as tensors on its device.

    Global row ``r * b_local + i`` is row ``i`` of the process at index
    ``r`` on the mesh's data axis (the order of JAX's
    ``make_array_from_process_local_data`` over a data-axis mesh); the
    processes of one model group hold the same rows.  The rows stay where
    they are: each process computes on its own, and the models' moment
    all-reduces and the trainers' gradient averages make the step the
    global batch's.  ``local_batch`` is an array or a tuple/list of them.
    """
    def put(x):
        return torch.as_tensor(x).to(mesh.device)

    if isinstance(local_batch, (tuple, list)):
        return type(local_batch)(put(x) for x in local_batch)
    return put(local_batch)
