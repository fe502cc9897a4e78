"""The data group: the port's counterpart of the 1-D ``data`` mesh.

One process drives one device, so the mesh of the JAX package
(``gpu_bpe_tpu/parallel/mesh.py``) becomes a ``DataGroup``: this process's
rank, the world size, the rank's ``torch.device`` and the
``torch.distributed`` process group. The collectives keep the JAX names so
that the two trainers map line by line: ``psum``, ``pmax`` and ``pmin`` are
``all_reduce`` with SUM, MAX and MIN; ``all_gather`` concatenates every
rank's tensor in rank order (``all_gather_into_tensor``, or the list form
under gloo). They always go through ``torch.distributed``, at world size 1
too.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class DataGroup:
    """A process group of ranks that each hold one shard on one device.
    Under gloo the tensors may lie on a card too (gloo copies them through
    host memory itself)."""

    def __init__(self, rank: int, world_size: int, device: torch.device, group=None):
        self.rank = rank
        self.world_size = world_size
        self.device = torch.device(device)
        self.group = group
        self.backend = dist.get_backend(group)

    @classmethod
    def current(cls, device: str | torch.device | None = None) -> "DataGroup":
        """The group of the initialized default process group. ``device``
        defaults to ``cuda:{rank % device_count}`` under NCCL and to the CPU
        under gloo."""
        if not dist.is_initialized():
            raise RuntimeError("no torch.distributed process group: call parallel.init_multihost first")
        rank, world = dist.get_rank(), dist.get_world_size()
        if device is None:
            cuda = dist.get_backend() == "nccl"
            device = f"cuda:{rank % torch.cuda.device_count()}" if cuda else "cpu"
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return cls(rank, world, device)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=op, group=self.group)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the ranks, as a new tensor (``x`` is left as
        it is); ``pmax`` and ``pmin`` alike."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's 1-D ``x`` (equal lengths), concatenated in rank order."""
        x = x.contiguous()
        if self.backend == "nccl":
            out = x.new_empty(self.world_size * x.shape[0])
            dist.all_gather_into_tensor(out, x, group=self.group)
            return out
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)
