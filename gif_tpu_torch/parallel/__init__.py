"""Data-parallel training over ``torch.distributed`` (port of
``gif_tpu.parallel``): one process per GPU, per-rank batch slices, mean
gradient all-reduce, rank-0 job duties."""

from gif_tpu_torch.parallel.collectives import allgather_rows, differentiable_mean, mean_all_reduce
from gif_tpu_torch.parallel.mesh import (
    choose_data_mesh_size,
    host_local_tree,
    initialize_distributed,
    is_main_process,
    local_device,
    process_count,
    process_index,
    replicate,
    shard_batch,
)

__all__ = [
    "allgather_rows",
    "choose_data_mesh_size",
    "differentiable_mean",
    "host_local_tree",
    "initialize_distributed",
    "is_main_process",
    "local_device",
    "mean_all_reduce",
    "process_count",
    "process_index",
    "replicate",
    "shard_batch",
]
