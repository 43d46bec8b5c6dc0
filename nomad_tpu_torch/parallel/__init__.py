"""Data-parallel and 2-D sharded work over ``torch.distributed``
(counterpart of ``nomad_tpu.parallel``)."""

from .mesh import (
    data_mesh,
    gather_blocks,
    gather_rows,
    grid_mesh,
    init_process_group,
    launch,
    pad_to_multiple,
    rank_rows,
    replicate,
    shard_rows,
    sharded_cdist,
)

__all__ = [
    "data_mesh",
    "gather_blocks",
    "gather_rows",
    "grid_mesh",
    "init_process_group",
    "launch",
    "pad_to_multiple",
    "rank_rows",
    "replicate",
    "shard_rows",
    "sharded_cdist",
]
