"""Seeded weights made on the device in a few large calls.

Every tensor of a state_dict is drawn by its name and shape: a kernel of
two or more dims N(0, 1/fan_in) (fan_in = elements / rows), a 1-dim
``weight`` (a BatchNorm scale) N(1, 0.02²), a bias 0, a running mean 0
and a running variance 1. The names are sorted and the whole set comes
from one normal draw of a generator on the device seeded with the run's
seed, so the same seed gives the same weights to the program and to the
reference, whichever modules hold them.
"""

from __future__ import annotations

import math

import torch


def _rule(name: str, shape: tuple) -> tuple[float, float]:
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape) // shape[0]), 0.0
    if leaf == "weight":
        return 0.02, 1.0
    if leaf == "running_var":
        return 0.0, 1.0
    return 0.0, 0.0  # biases, running means


def seeded_state(shapes: dict[str, tuple], seed: int, device) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` on ``device`` for ``{name: shape}``."""
    names = sorted(shapes)
    counts = [math.prod(shapes[n]) for n in names]
    rules = torch.tensor([_rule(n, tuple(shapes[n])) for n in names], dtype=torch.float32, device=device)
    reps = torch.tensor(counts, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(counts), generator=gen, device=device)
    flat.mul_(rules[:, 0].repeat_interleave(reps)).add_(rules[:, 1].repeat_interleave(reps))
    return {n: t.view(shapes[n]) for n, t in zip(names, flat.split(counts))}


def shapes_of(prefix: str, module: torch.nn.Module) -> dict[str, tuple]:
    return {f"{prefix}{k}": tuple(v.shape) for k, v in module.state_dict().items()}


def load(module: torch.nn.Module, state: dict[str, torch.Tensor], prefix: str) -> torch.nn.Module:
    """Copy the tensors of ``state`` under ``prefix`` into ``module`` (every key
    of the module, none more)."""
    module.load_state_dict({k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}, strict=True)
    return module


def materialize(module: torch.nn.Module, state: dict[str, torch.Tensor], prefix: str, device) -> torch.nn.Module:
    """A module built on the meta device, given storage on ``device`` and the
    tensors of ``state`` under ``prefix``."""
    return load(module.to_empty(device=device), state, prefix)
