"""Data-parallel training over ``torch.distributed``: one shard per rank, the
exact global argmax.

The names of ``gpu_bpe_tpu.parallel``, mapped onto the port's: ``make_mesh``
becomes ``DataGroup`` (rank, world size, device, process group, and the
collectives ``psum``/``pmax``/``pmin``/``all_gather``), and
``make_dist_train_batch(mesh)`` becomes ``dist_train_batch(group, state,
batch_merges)``, which every rank calls with its own state.
``one_rank_group`` sets up a group of this process alone.
"""

from .dist_train import DistState, dist_train_batch, init_dist_state, shard_stream
from .mesh import DataGroup
from .multihost import init_multihost, multihost_requested, one_rank_group, shutdown_multihost
from .trainer import DistributedTrainer

__all__ = [
    "DataGroup",
    "DistState",
    "DistributedTrainer",
    "dist_train_batch",
    "init_dist_state",
    "init_multihost",
    "multihost_requested",
    "one_rank_group",
    "shard_stream",
    "shutdown_multihost",
]
