"""Cutting work over several devices: the batch (`mesh`) and the rows of
one image (`spatial`).  Torch twin of `mulut_tpu.parallel`."""

from .mesh import (
    data_parallel_grads,
    data_parallel_step,
    make_mesh,
    mesh_for,
    pad_batch,
    replicate_tree,
    shard_batch,
    sync_replicas,
    tree_leaves,
    tree_to,
)
from .spatial import (
    cascade_row_sharded,
    net_row_sharded,
    row_sharding,
    shard_image_rows,
)

__all__ = [
    "cascade_row_sharded",
    "data_parallel_grads",
    "data_parallel_step",
    "make_mesh",
    "mesh_for",
    "net_row_sharded",
    "pad_batch",
    "replicate_tree",
    "row_sharding",
    "shard_batch",
    "shard_image_rows",
    "sync_replicas",
    "tree_leaves",
    "tree_to",
]
