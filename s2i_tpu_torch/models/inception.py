"""InceptionV3 for the Inception Score and FID, the counterpart of
``s2i_tpu/models/inception.py``.

The block structure and module names are torchvision's ``inception_v3``
(``BasicConv2d`` = conv + BN(eps=1e-3) + ReLU; ``InceptionA``-``E``;
``Mixed_5b.branch1x1.conv.weight``, ``...bn.running_var``, ``fc.weight``),
so a torchvision or pytorch-fid state_dict loads by name
(``eval/weights.py``). The forward is the JAX module's, not torchvision's:
no ``transform_input``, no auxiliary head, no dropout before ``fc``; BN is
the port's Flax-formula :class:`~s2i_tpu_torch.models.layers.BatchNorm`
(momentum 0.9, biased running variance), and the 3×3 average pools count
their zero padding, as Flax ``nn.avg_pool`` does.

Input: [B, H, W, 3] NHWC in [-1, 1] (299 px for the IS/FID protocol; the
network takes any size from 75 px). It runs NCHW inside. Output:
``{"pool3": [B, 2048], "logits": [B, num_classes]}``, both float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from s2i_tpu_torch.models.layers import BatchNorm, Conv2d, lecun_normal_


class BasicConv2d(nn.Module):
    """Conv (no bias) → BN(eps=1e-3) → ReLU, computing in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False, dtype=dtype)
        self.bn = BatchNorm(out_ch, eps=1e-3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 average with the zero padding counted (Flax ``nn.avg_pool``)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-2 max over VALID windows (Flax ``nn.max_pool``)."""
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dtype
        self.branch1x1 = BasicConv2d(in_ch, 64, 1, dtype=d)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1, dtype=d)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2, dtype=d)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1, dtype=d)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, dtype=d)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1, dtype=d)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1, dtype=d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dtype
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2, dtype=d)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1, dtype=d)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, dtype=d)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2, dtype=d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, c7 = dtype, channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1, dtype=d)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1, dtype=d)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), dtype=d)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0), dtype=d)
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1, dtype=d)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), dtype=d)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), dtype=d)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), dtype=d)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3), dtype=d)
        self.branch_pool = BasicConv2d(in_ch, 192, 1, dtype=d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(avg_pool_same(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dtype
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1, dtype=d)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2, dtype=d)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1, dtype=d)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3), dtype=d)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0), dtype=d)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2, dtype=d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dtype
        self.branch1x1 = BasicConv2d(in_ch, 320, 1, dtype=d)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1, dtype=d)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), dtype=d)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), dtype=d)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1, dtype=d)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1, dtype=d)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), dtype=d)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), dtype=d)
        self.branch_pool = BasicConv2d(in_ch, 192, 1, dtype=d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(avg_pool_same(x))
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3(nn.Module):
    """NHWC images in [-1, 1] → ``{"pool3": [B, 2048], "logits": [B, num_classes]}``."""

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = self.dtype = dtype
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, dtype=d)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, dtype=d)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1, dtype=d)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, dtype=d)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, dtype=d)
        self.Mixed_5b = InceptionA(192, 32, d)
        self.Mixed_5c = InceptionA(256, 64, d)
        self.Mixed_5d = InceptionA(288, 64, d)
        self.Mixed_6a = InceptionB(288, d)
        self.Mixed_6b = InceptionC(768, 128, d)
        self.Mixed_6c = InceptionC(768, 160, d)
        self.Mixed_6d = InceptionC(768, 160, d)
        self.Mixed_6e = InceptionC(768, 192, d)
        self.Mixed_7a = InceptionD(768, d)
        self.Mixed_7b = InceptionE(1280, d)
        self.Mixed_7c = InceptionE(2048, d)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool(x)
        x = max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
                     "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool = x.mean((2, 3)).float()  # [B, 2048]
        return {"pool3": pool, "logits": self.fc(pool)}


@torch.no_grad()
def init_weights(model: InceptionV3, gen: torch.Generator) -> None:
    """The JAX module's init (Flax's defaults), every draw from ``gen``:
    lecun-normal conv and ``fc`` kernels, a zero ``fc`` bias, BN scale 1
    and bias 0, running statistics 0 and 1."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, gen)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
