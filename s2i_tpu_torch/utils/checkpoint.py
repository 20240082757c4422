"""Checkpoints of a run's full train state, the counterpart of
``s2i_tpu/utils/checkpoint.py`` (Orbax there, ``torch.save`` here).

A checkpoint is one file per step, ``<directory>/<step>.pt``, holding what
the state's ``state_dict()`` returns (nested dicts and lists of tensors and
Python scalars) with every tensor copied to the host first, so a checkpoint
written on the card restores on the CPU and the reverse. A save writes
``<step>.pt.tmp`` and renames it into place: a torn write is never taken for
the latest checkpoint. The newest ``max_to_keep`` are kept.

Saves are synchronous: the JAX package's Orbax saves run in the background,
but at ``TRAIN.SNAPSHOT_INTERVAL`` 2000 a save is a small share of a run
(``PERF.md`` §5 has its time on the card).
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

_NAME = re.compile(r"(\d+)\.pt")


def to_host(obj: Any) -> Any:
    """``obj`` with every tensor detached and copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def load_optimizer(opt: torch.optim.Optimizer, sd: dict, what: str) -> None:
    """``opt.load_state_dict(sd)`` after checking that every per-parameter
    state tensor has its parameter's shape (torch checks only the counts)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    n_saved = sum(len(group["params"]) for group in sd["param_groups"])
    if n_saved != len(params):
        raise ValueError(f"{what}: the checkpoint has {n_saved} parameters, the optimizer {len(params)}")
    for i, st in sd["state"].items():
        for k, v in st.items():
            if torch.is_tensor(v) and v.ndim and v.shape != params[int(i)].shape:
                raise ValueError(f"{what}: {k} of parameter {i} has shape {tuple(v.shape)}, "
                                 f"the parameter {tuple(params[int(i)].shape)}")
    opt.load_state_dict(sd)


class CheckpointManager:
    """Checkpoints of one state in ``directory``, by step."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
        self._dir = os.path.abspath(directory)
        self._keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def steps(self) -> list[int]:
        """The steps that have a checkpoint, oldest first."""
        found = (_NAME.fullmatch(name) for name in os.listdir(self._dir))
        return sorted(int(m.group(1)) for m in found if m)

    def path(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.pt")

    @property
    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Write ``state`` (an object with ``state_dict()``, or the dict
        itself) as the checkpoint of ``step``. A step no newer than the
        latest checkpoint is written only with ``force`` (as Orbax's
        ``should_save``); returns whether it was written."""
        latest = self.latest_step
        if latest is not None and step <= latest and not force:
            return False
        sd = state.state_dict() if hasattr(state, "state_dict") else state
        tmp = self.path(step) + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(to_host(sd), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path(step))
        for old in self.steps()[: -self._keep]:
            os.remove(self.path(old))
        return True

    def wait(self) -> None:
        """Nothing to wait for: saves are synchronous (the JAX package's
        are not, and its callers wait here)."""

    def restore_latest(self, template: Any) -> tuple[Any, int] | None:
        """Load the newest checkpoint into ``template`` (an object with
        ``load_state_dict``, e.g. a train state, whose tensors stay on their
        device) and return (template, step), or None when there is none."""
        raw = self.restore_latest_raw()
        if raw is None:
            return None
        template.load_state_dict(raw[0])
        return template, raw[1]

    def restore_latest_raw(self, device: str | torch.device = "cpu") -> tuple[dict, int] | None:
        """The newest checkpoint as saved, its tensors on ``device``, and its
        step; None when there is none. For consumers that check the contents
        themselves (the encoder warm start's graft, the pipeline)."""
        step = self.latest_step
        if step is None:
            return None
        return torch.load(self.path(step), map_location=device, weights_only=True), step

    def close(self) -> None:
        """Nothing to release (kept for the JAX package's surface)."""
