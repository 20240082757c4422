"""Scalar logging and profiling hooks, the counterpart of
``s2i_tpu/utils/logging.py``.

JSONL is the one sink. ``TRAIN.TENSORBOARD`` writes no event files: the
JAX package's logger does the same when it cannot import its writer, and
the card's machine has no TensorBoard. ``profile_steps`` wraps a block in a
``torch.profiler`` trace written as a Chrome trace (chrome://tracing,
Perfetto).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Any, Iterator

import torch


class ScalarLogger:
    """JSONL scalars, one line per ``log`` call: ``{"step", "time", **scalars}``
    in ``<run_dir>/scalars.jsonl``. Non-finite values are written as
    strings: bare NaN/Infinity tokens are not valid JSON. A logger that is
    not the ``writer`` (a rank other than 0) writes nothing."""

    def __init__(self, run_dir: str, writer: bool = True):
        self._f = None
        if writer:
            os.makedirs(run_dir, exist_ok=True)
            self._f = open(os.path.join(run_dir, "scalars.jsonl"), "a", buffering=1)

    def log(self, step: int, scalars: dict[str, Any]) -> None:
        if self._f is None:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (f if math.isfinite(f) else str(f))
                    for k, v in scalars.items() for f in (float(v),)})
        self._f.write(json.dumps(rec) + "\n")

    def log_image(self, step: int, tag: str, image) -> None:
        """The JAX logger mirrors an image into TensorBoard; with no event
        files this does nothing (the PNG on disk is the sink)."""

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


@contextlib.contextmanager
def profile_steps(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` trace of the block (host and, with a card, device
    activity), written to ``log_dir/trace_<time>.json`` as it ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))
