"""Operand precision of the reference's products.

By default every product runs in float32, TF32 off: the reference. Inside
``with computed_in("control"):`` runs the control that the comparison has to
fail: each product in the next precision below what the configuration
states for that part, forward and backward. The convolutions and dense
layers, which the configurations run in bfloat16 (``DTYPE.COMPUTE``), take
float8 operands with a per-tensor scale (e4m3 forward, e5m2 for the
gradient that flows back into the product, as float8 training does); the
log-mel and the GRU recurrence, which run in float32 in every
configuration, take bfloat16 operands and gradients.
"""

from __future__ import annotations

import contextlib

import torch

_MODE = {"name": "float32"}
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def computed_in(name: str):
    """The reference's products in ``name`` ("float32" or "control") for the
    body, TF32 off; the previous mode comes back afterwards."""
    if name not in ("float32", "control"):
        raise ValueError(f"precision mode {name!r}: float32 or control")
    saved = (_MODE["name"], torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    _MODE["name"] = name
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        _MODE["name"], torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _round(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    dtype, top = (torch.float8_e4m3fn, E4M3_MAX) if kind == "e4m3" else (torch.float8_e5m2, E5M2_MAX)
    scale = x.abs().amax().float().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Rounded(torch.autograd.Function):
    """Forward: ``x`` rounded to ``fwd``; backward: the incoming gradient
    rounded to ``bwd``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


def low(x: torch.Tensor) -> torch.Tensor:
    """An operand of a convolution or dense layer (bfloat16 in the cfgs)."""
    return _Rounded.apply(x, "e4m3", "e5m2") if _MODE["name"] == "control" else x


def f32(x: torch.Tensor) -> torch.Tensor:
    """An operand of the log-mel or GRU products (float32 in the cfgs)."""
    return _Rounded.apply(x, "bf16", "bf16") if _MODE["name"] == "control" else x
