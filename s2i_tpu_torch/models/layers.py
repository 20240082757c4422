"""Generator building blocks (NCHW), the counterpart of the generator subset
of ``s2i_tpu/models/layers.py``.

The modules use the StackGAN-v2 torch layout (``nn.Sequential`` indices
included), so a state_dict written by ``bridge.gnet_state_dict`` loads with
``strict=True``. Every ``GAN.UPSAMPLE_MODE`` of the JAX package is the same
math as nearest-2x followed by a 3x3 conv, which is the one form here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Gated linear unit: split channels in half, gate with sigmoid."""
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


class GLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu(x, 1)


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 of [B, C] or [B, C, H, W], with the
    JAX package's formula: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``
    from the running statistics. Its state_dict keys are those of
    ``nn.BatchNorm{1,2}d`` minus ``num_batches_tracked``; training-mode
    statistics belong to the training slice of the port."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class Upsample2x(nn.Module):
    """Nearest-neighbour ×2 upsampling (no parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2, mode="nearest")


def conv3x3(in_ch: int, out_ch: int) -> nn.Conv2d:
    """3×3 'same' conv, no bias (BN follows in every use)."""
    return nn.Conv2d(in_ch, out_ch, 3, stride=1, padding=1, bias=False)


def up_block_glu(in_ch: int, out_ch: int) -> nn.Sequential:
    """Nearest ×2 → 3×3 conv(2·out) → BN → GLU (G upsampling unit)."""
    return nn.Sequential(
        Upsample2x(), conv3x3(in_ch, out_ch * 2), BatchNorm(out_ch * 2), GLU()
    )


def block3x3_glu(in_ch: int, out_ch: int) -> nn.Sequential:
    """3×3 conv(2·out) → BN → GLU (same-resolution G unit)."""
    return nn.Sequential(conv3x3(in_ch, out_ch * 2), BatchNorm(out_ch * 2), GLU())


class ResBlockGLU(nn.Module):
    """conv(2c) → BN → GLU → conv(c) → BN, additive skip."""

    def __init__(self, channels: int):
        super().__init__()
        self.block = nn.Sequential(
            conv3x3(channels, channels * 2),
            BatchNorm(channels * 2),
            GLU(),
            conv3x3(channels, channels),
            BatchNorm(channels),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x)
