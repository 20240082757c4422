"""Utilities of the port: checkpoints, image grids, scalar logging and
profiling hooks: ``profile_steps`` and the host spans of ``span`` (the
counterpart of ``s2i_tpu/utils/``)."""

from s2i_tpu_torch.utils.checkpoint import CheckpointManager
from s2i_tpu_torch.utils.images import make_image_grid, save_image_grid, save_images, to_uint8
from s2i_tpu_torch.utils.logging import ScalarLogger, clear_spans, profile_steps, span, span_records

__all__ = [
    "CheckpointManager",
    "clear_spans",
    "make_image_grid",
    "profile_steps",
    "save_image_grid",
    "save_images",
    "span",
    "span_records",
    "to_uint8",
    "ScalarLogger",
]
