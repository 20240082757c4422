"""Inspect a checkpoint directory of the port (``<dir>/<step>.pt``,
``s2i_tpu_torch/utils/checkpoint.py``): its steps, and the tensor elements
under each top-level group of the newest state (parameters, buffers,
optimizer state and EMA alike), and their total. The port's counterpart of
tools/inspect_ckpt.py, which reads Orbax.

    python tools_torch/inspect_ckpt.py --ckpt output/<run>/ckpt
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from s2i_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402


def elements(obj) -> int:
    """The elements of every tensor in ``obj`` (nested dicts, lists, tuples)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel()
    if isinstance(obj, dict):
        return sum(elements(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(elements(v) for v in obj)
    return 0


def inspect(ckpt: str) -> dict:
    """``{"steps": [...], "groups": {top-level key: elements}, "total": n}``
    of the newest checkpoint under ``ckpt`` (no groups when there is none)."""
    mgr = CheckpointManager(ckpt)
    steps = mgr.steps()
    if not steps:
        return {"steps": [], "groups": {}, "total": 0}
    sd = torch.load(mgr.path(steps[-1]), map_location="cpu", weights_only=True)
    groups = {str(k): elements(v) for k, v in sd.items()}
    groups = {k: n for k, n in groups.items() if n}
    return {"steps": steps, "groups": groups, "total": sum(groups.values())}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True)
    args = p.parse_args(argv)
    if not os.path.isdir(args.ckpt):
        p.error(f"no checkpoint directory {args.ckpt}")
    info = inspect(args.ckpt)
    print(f"steps: {info['steps']}")
    if not info["steps"]:
        return 0
    for k, n in sorted(info["groups"].items()):
        print(f"  {k:14s} {n / 1e6:9.2f}M params ({n} elements)")
    print(f"  {'TOTAL':14s} {info['total'] / 1e6:9.2f}M ({info['total']} elements)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
