"""Multi-process bootstrap on ``torch.distributed``: one process per device.

The port's counterpart of ``gpu_bpe_tpu/parallel/multihost.py``. Every
process runs the same program; ``init_multihost`` joins it to the process
group, and the data-parallel trainer's collectives (``parallel/mesh.py``)
ride NCCL between cards, or gloo on the CPU. The stream split is
deterministic, so every process computes it and uploads only its own row;
the merge log is replicated, so every process rebuilds the same vocabulary.

Launch recipe (N processes, one per GPU; every process runs the same
command and differs only in its process id)::

    GPU_BPE_TPU_COORDINATOR=host0:9876 GPU_BPE_TPU_NUM_PROCESSES=N \\
    GPU_BPE_TPU_PROCESS_ID=$RANK python train_script.py

where the script calls ``init_multihost()``, then
``api.train(corpus, TrainConfig(backend="dist"))``, then
``shutdown_multihost()``. The three values may also be passed as
arguments. ``device="cpu"`` runs the same program over gloo on the CPU.
The CLI takes the same recipe, as flags or as the environment variables::

    python -m gpu_bpe_tpu_torch.cli train corpus/ --backend dist \\
        --coordinator host0:9876 --num-processes N --process-id $RANK
"""

from __future__ import annotations

import contextlib
import os
from datetime import timedelta

import torch
import torch.distributed as dist

ENV_COORDINATOR = "GPU_BPE_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "GPU_BPE_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "GPU_BPE_TPU_PROCESS_ID"


def multihost_requested(args=None) -> bool:
    """True when a multi-process launch is configured, by a ``coordinator``
    attribute of ``args`` (the CLI's flags) or by the environment."""
    if args is not None and getattr(args, "coordinator", None):
        return True
    return bool(os.environ.get(ENV_COORDINATOR))


# A rank that never arrives, or a collective that never completes, fails
# the run after this long instead of hanging it.
DEFAULT_TIMEOUT_S = 300.0


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> tuple[int, int]:
    """Join the process group; returns (rank, world size).

    Arguments default to the ``GPU_BPE_TPU_*`` environment variables above.
    ``device="cuda"`` takes NCCL and makes card ``process_id % cards`` the
    current device (one process per card on each host);
    ``device="cpu"`` takes gloo. Idempotent: with a group already set up,
    or with nothing configured, it reports the current topology."""
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not coordinator_address:
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("init_multihost: a coordinator needs num_processes and process_id")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=timedelta(seconds=timeout_s),
    )
    return dist.get_rank(), dist.get_world_size()


def shutdown_multihost() -> None:
    """Wait until every process reaches this point (so that rank 0 may
    finish writing artifacts), then leave the process group."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


@contextlib.contextmanager
def one_rank_group(device: str | torch.device = "cuda"):
    """A process group of this process alone for the block (NCCL on a card,
    gloo with ``device="cpu"``), torn down afterwards; an in-process store,
    so no port is opened. Yields the block's ``DataGroup`` on ``device``.
    With a group already set up it yields that group's and tears nothing
    down."""
    from .mesh import DataGroup

    device = torch.device(device)
    if dist.is_initialized():
        yield DataGroup.current(device)
        return
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=dist.HashStore(),
                            rank=0, world_size=1, timeout=timedelta(seconds=DEFAULT_TIMEOUT_S))
    try:
        yield DataGroup.current(device)
    finally:
        dist.destroy_process_group()
