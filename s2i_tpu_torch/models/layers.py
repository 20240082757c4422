"""Generator and discriminator building blocks (NCHW), the counterpart of
``s2i_tpu/models/layers.py``.

The modules use the StackGAN-v2 torch layout (``nn.Sequential`` indices
included), so a state_dict written by ``bridge.gnet_state_dict`` or
``bridge.dnet_state_dict`` loads with ``strict=True``. Every
``GAN.UPSAMPLE_MODE`` of the JAX package is the same math as nearest-2x
followed by a 3x3 conv, and every ``GAN.S2D`` layout the same math as the
plain one, which is the one form here.
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
    """BatchNorm over dim 1 of [B, C], [B, C, T] or [B, C, H, W], with Flax
    ``nn.BatchNorm``'s formula: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``. In eval mode mean/var are the running statistics. In train mode
    they are the batch's, over every dim but 1, with Flax's fast biased
    variance ``max(0, E[x²] - E[x]²)``, and the running statistics move by
    ``running = momentum * running + (1 - momentum) * batch`` (Flax's
    momentum 0.9 is torch's 0.1; the running variance stays biased). Its
    state_dict keys are those of ``nn.BatchNorm{1,2}d`` minus
    ``num_batches_tracked``."""

    momentum = 0.9  # Flax nn.BatchNorm(momentum=0.9), as every BN of the JAX package

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = [0, *range(2, x.ndim)]
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


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


def down_block(in_ch: int, out_ch: int) -> nn.Sequential:
    """4×4 stride-2 conv → BN → LeakyReLU(0.2) (D downsampling unit)."""
    return nn.Sequential(
        nn.Conv2d(in_ch, out_ch, 4, stride=2, padding=1, bias=False),
        BatchNorm(out_ch),
        nn.LeakyReLU(0.2),
    )


def block3x3_leaky_relu(in_ch: int, out_ch: int) -> nn.Sequential:
    """3×3 conv → BN → LeakyReLU(0.2) (D same-resolution unit)."""
    return nn.Sequential(conv3x3(in_ch, out_ch), BatchNorm(out_ch), nn.LeakyReLU(0.2))
