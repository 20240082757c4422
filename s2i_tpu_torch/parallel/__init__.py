"""Data parallelism over processes (``torchrun``), the counterpart of
``s2i_tpu/parallel/``: one process per card, the batch split by rows,
BatchNorm statistics, gradients and metrics averaged over the ranks."""

from s2i_tpu_torch.parallel.mesh import (
    DataAxis,
    destroy,
    launched_world_size,
    local_device,
    make_mesh,
    make_mesh_if_configured,
    make_parallel_encoder_step,
    make_parallel_sample_fn,
    make_parallel_train_step,
    maybe_initialize_distributed,
    mesh_rank,
    replicate_state,
    shard_batch,
)

__all__ = [
    "DataAxis",
    "destroy",
    "launched_world_size",
    "local_device",
    "make_mesh",
    "make_mesh_if_configured",
    "make_parallel_encoder_step",
    "make_parallel_sample_fn",
    "make_parallel_train_step",
    "maybe_initialize_distributed",
    "mesh_rank",
    "replicate_state",
    "shard_batch",
]
