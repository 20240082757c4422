"""Generator and discriminator building blocks (NCHW), the counterpart of
``s2i_tpu/models/layers.py``.

The modules use the StackGAN-v2 torch layout (``nn.Sequential`` indices
included), so a state_dict written by ``bridge.gnet_state_dict`` or
``bridge.dnet_state_dict`` loads with ``strict=True``.

Mixed precision as the JAX package's Flax modules have it: every parameter
stays float32, and a module's ``dtype`` (``DTYPE.COMPUTE``) is the type it
computes in. A conv or linear layer casts its input and kernel to ``dtype``
and returns ``dtype``; BatchNorm takes its statistics in float32 and casts
its output to ``dtype``; GLU and LeakyReLU run on what they are given.

``GAN.UPSAMPLE_MODE`` picks the numerics of the up-convolution
(:class:`UpConv3x3`): ``naive`` upsamples, casts and convolves with the
3×3 kernel; every other mode first sums the kernel's taps in float32 into
a 4×4 phase kernel and casts that. The two are the same math, but in
bfloat16 the cast tap sums are other numbers than the sums of cast taps.
In float32 the port takes the upsample form for every mode (there the two
differ by float32 rounding only). Every ``GAN.S2D`` layout is the same math
as the plain one, which is the one form here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

UP_MODES = ("naive", "transpose", "transpose_cvjp", "fused", "fused4")

# Rows [W0, W0+W1, W1+W2, W2]: the 3 taps of conv3x3(nearest2x(x)) along one
# axis collapsed onto the 4 taps of one stride-2 transposed conv
# (``_PHASE_M4`` of the JAX package).
_PHASE_M4 = ((1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (0.0, 1.0, 1.0), (0.0, 0.0, 1.0))


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Gated linear unit: split channels in half, gate with sigmoid. Below
    float32 the sigmoid is XLA's expansion of it, ``1 / (1 + exp(-b))``
    rounded to the type at each step, where ``torch.sigmoid`` would round
    once: the JAX package's bfloat16 GLU."""
    a, b = x.chunk(2, dim=dim)
    if x.dtype == torch.float32:
        return a * torch.sigmoid(b)
    return a * (1.0 / (1.0 + torch.exp(-b)))


class GLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu(x, 1)


class LeakyReLU(nn.LeakyReLU):
    """``nn.LeakyReLU`` whose slope is ``negative_slope`` rounded to
    ``dtype``: in the JAX package ``leaky_relu(x, 0.2)`` of a bfloat16 ``x``
    multiplies by the bfloat16 constant 0.2001953125."""

    def __init__(self, negative_slope: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__(torch.tensor(negative_slope, dtype=dtype).item())


def _add_bias(y: torch.Tensor, bias: torch.Tensor | None, dim: int = 1) -> torch.Tensor:
    """``y + bias`` along ``dim`` in ``y``'s type: Flax adds a layer's bias
    to its product after the product is rounded to the compute type."""
    if bias is None:
        return y
    shape = [1] * y.ndim
    shape[dim] = -1
    return y + bias.to(y.dtype).view(shape)


class _CastConv:
    """A torch conv that computes in ``dtype`` (Flax ``nn.Conv(dtype=)``):
    input and kernel cast to it, the bias added to the rounded product; the
    parameters stay float32. In float32 it is the torch conv."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return self._conv_forward(x, self.weight, self.bias)
        return _add_bias(self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype), None), self.bias)


class Conv1d(_CastConv, nn.Conv1d):
    pass


class Conv2d(_CastConv, nn.Conv2d):
    pass


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (Flax ``nn.Dense(dtype=)``)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return F.linear(x, self.weight, self.bias)
        return _add_bias(F.linear(x.to(self.dtype), self.weight.to(self.dtype)), self.bias, -1)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of [B, C], [B, C, T] or [B, C, H, W], with Flax
    ``nn.BatchNorm``'s formula: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``, in float32, cast to ``dtype`` at the end. In eval mode mean/var
    are the running statistics. In train mode they are the batch's, over
    every dim but 1, in float32 whatever the input's type, with Flax's fast
    biased variance ``max(0, E[x²] - E[x]²)``, and the running statistics
    move by ``running = momentum * running + (1 - momentum) * batch``
    (Flax's momentum 0.9 is torch's 0.1; the running variance stays
    biased). Its state_dict keys are those of ``nn.BatchNorm{1,2}d`` minus
    ``num_batches_tracked``."""

    momentum = 0.9  # Flax nn.BatchNorm(momentum=0.9), as every BN of the JAX package

    def __init__(self, num_features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        x = x.float()
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
        return ((x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)).to(self.dtype)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class UpConv3x3(Conv2d):
    """3×3 'same' conv of the nearest-neighbour ×2 upsample of the input,
    no bias, in ``dtype`` (the JAX package's ``UpConv3x3``). Its parameter
    is the 3×3 kernel whatever the form. ``mode`` "naive", or any mode in
    float32: upsample, then the conv. Every other mode in a lower
    precision: the kernel's taps summed in float32 into the 4×4 phase
    kernel, cast, and one stride-2 transposed conv (16 products per output
    pixel and input channel against the naive 36)."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32, mode: str = "naive"):
        if mode not in UP_MODES:
            raise ValueError(f"unknown GAN.UPSAMPLE_MODE {mode!r}: one of {UP_MODES}")
        super().__init__(in_ch, out_ch, 3, stride=1, padding=1, bias=False, dtype=dtype)
        self.phase = mode != "naive" and dtype != torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.phase:
            return super().forward(upsample_nearest_2x(x))
        m = self.weight.new_tensor(_PHASE_M4)
        kt = torch.einsum("rp,sq,oipq->oirs", m, m, self.weight)  # [out, in, 4, 4], float32 tap sums
        # the lhs-dilated correlation with kt is conv_transpose2d with kt
        # flipped and its channel axes swapped
        w = kt.flip(2, 3).transpose(0, 1).to(self.dtype)
        return F.conv_transpose2d(x.to(self.dtype), w, stride=2, padding=1)


def conv3x3(in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32) -> Conv2d:
    """3×3 'same' conv, no bias (BN follows in every use)."""
    return Conv2d(in_ch, out_ch, 3, stride=1, padding=1, bias=False, dtype=dtype)


def up_block_glu(in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32, mode: str = "naive") -> nn.Sequential:
    """Nearest ×2 → 3×3 conv(2·out) → BN → GLU (G upsampling unit). Index 0
    held the upsample in the StackGAN-v2 layout; :class:`UpConv3x3` does it
    now, and the index stays so that the parameters keep their names."""
    return nn.Sequential(
        nn.Identity(), UpConv3x3(in_ch, out_ch * 2, dtype, mode), BatchNorm(out_ch * 2, dtype=dtype), GLU()
    )


def block3x3_glu(in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """3×3 conv(2·out) → BN → GLU (same-resolution G unit)."""
    return nn.Sequential(conv3x3(in_ch, out_ch * 2, dtype), BatchNorm(out_ch * 2, dtype=dtype), GLU())


class ResBlockGLU(nn.Module):
    """conv(2c) → BN → GLU → conv(c) → BN, additive skip."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block = nn.Sequential(
            conv3x3(channels, channels * 2, dtype),
            BatchNorm(channels * 2, dtype=dtype),
            GLU(),
            conv3x3(channels, channels, dtype),
            BatchNorm(channels, dtype=dtype),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x)


def down_block(in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """4×4 stride-2 conv → BN → LeakyReLU(0.2) (D downsampling unit)."""
    return nn.Sequential(
        Conv2d(in_ch, out_ch, 4, stride=2, padding=1, bias=False, dtype=dtype),
        BatchNorm(out_ch, dtype=dtype),
        LeakyReLU(0.2, dtype),
    )


def block3x3_leaky_relu(in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """3×3 conv → BN → LeakyReLU(0.2) (D same-resolution unit)."""
    return nn.Sequential(conv3x3(in_ch, out_ch, dtype), BatchNorm(out_ch, dtype=dtype), LeakyReLU(0.2, dtype))
