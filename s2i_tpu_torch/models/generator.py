"""Multi-stage generator, the counterpart of ``s2i_tpu/models/generator.py``,
in the StackGAN-v2 torch layout (``ca_net``, ``h_net{i}``, ``img_net{i}``).

  init stage : (c ‖ z) → fc → BN → GLU → view (16·gf, 4, 4) → 4 up-blocks
  next stage : tile c over h×w, concat (c ‖ h) → 3×3 GLU block
               → R_NUM res-blocks → up-block (channels halve, size doubles)
  to-RGB     : 3×3 conv → tanh, one head per stage

The JAX module concatenates (z, c) and (h, c) and views the fc output as
(4, 4, C); ``bridge.gnet_state_dict`` permutes the weights to this layout,
so both compute the same images.

``dtype`` (``DTYPE.COMPUTE``) is what every layer computes in; the images
come out in float32 (tanh of the last conv cast to float32), as in the JAX
package. ``up_mode`` is ``GAN.UPSAMPLE_MODE`` (``layers.UpConv3x3``).
"""

from __future__ import annotations

import torch
from torch import nn

from s2i_tpu_torch.models.ca_net import CANet
from s2i_tpu_torch.models.layers import (
    GLU,
    BatchNorm,
    Linear,
    ResBlockGLU,
    block3x3_glu,
    conv3x3,
    up_block_glu,
)

F32 = torch.float32


class InitStageG(nn.Module):
    def __init__(self, ngf: int, z_dim: int, c_dim: int, dtype: torch.dtype = F32, up_mode: str = "naive"):
        super().__init__()
        self.ngf = ngf  # channels of the 4×4 map == 16 * GF_DIM
        self.fc = nn.Sequential(
            Linear(z_dim + c_dim, ngf * 4 * 4 * 2, bias=False, dtype=dtype),
            BatchNorm(ngf * 4 * 4 * 2, dtype=dtype),
            GLU(),
        )
        self.upsample1 = up_block_glu(ngf, ngf // 2, dtype, up_mode)
        self.upsample2 = up_block_glu(ngf // 2, ngf // 4, dtype, up_mode)
        self.upsample3 = up_block_glu(ngf // 4, ngf // 8, dtype, up_mode)
        self.upsample4 = up_block_glu(ngf // 8, ngf // 16, dtype, up_mode)

    def forward(self, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        # (c ‖ z) in z's type (float32), as the JAX package concatenates
        x = self.fc(torch.cat([c.to(z.dtype), z], dim=1)).view(-1, self.ngf, 4, 4)
        x = self.upsample2(self.upsample1(x))
        return self.upsample4(self.upsample3(x))  # [B, ngf/16, 64, 64]


class NextStageG(nn.Module):
    def __init__(self, ngf: int, c_dim: int, num_res: int = 2, dtype: torch.dtype = F32,
                 up_mode: str = "naive"):
        super().__init__()
        self.jointConv = block3x3_glu(ngf + c_dim, ngf, dtype)
        self.residual = nn.Sequential(*[ResBlockGLU(ngf, dtype) for _ in range(num_res)])
        self.upsample = up_block_glu(ngf, ngf // 2, dtype, up_mode)

    def forward(self, h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        c_tiled = c.to(h.dtype)[:, :, None, None].expand(-1, -1, h.shape[2], h.shape[3])
        x = self.jointConv(torch.cat([c_tiled, h], dim=1))
        return self.upsample(self.residual(x))  # [B, ngf/2, 2H, 2W]


class Tanh32(nn.Module):
    """tanh of the input cast to float32: the images are float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x.float())


class ToRGB(nn.Module):
    def __init__(self, ngf: int, dtype: torch.dtype = F32):
        super().__init__()
        self.img = nn.Sequential(conv3x3(ngf, 3, dtype), Tanh32())

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.img(h)


class GNet(nn.Module):
    """CA net + joint multi-stage generator. ``forward(z, c)`` returns one
    NCHW float32 image per stage, [B, 3, S, S] in [-1, 1] with S = 64·2^i."""

    def __init__(
        self,
        gf_dim: int = 64,
        z_dim: int = 100,
        c_dim: int = 128,
        t_dim: int = 1024,
        branch_num: int = 3,
        num_res: int = 2,
        dtype: torch.dtype = F32,
        up_mode: str = "naive",
    ):
        super().__init__()
        if not 1 <= branch_num <= 3:
            raise ValueError(f"branch_num must be 1..3, got {branch_num}")
        self.branch_num = branch_num
        self.z_dim = z_dim
        self.ca_net = CANet(t_dim, c_dim, dtype)
        self.h_net1 = InitStageG(gf_dim * 16, z_dim, c_dim, dtype, up_mode)
        self.img_net1 = ToRGB(gf_dim, dtype)
        ngf = gf_dim
        for i in range(2, branch_num + 1):
            setattr(self, f"h_net{i}", NextStageG(ngf, c_dim, num_res, dtype, up_mode))
            setattr(self, f"img_net{i}", ToRGB(ngf // 2, dtype))
            ngf //= 2

    def forward(
        self, z: torch.Tensor, c: torch.Tensor, n_stages: int | None = None
    ) -> list[torch.Tensor]:
        """Images of the first ``n_stages`` stages (default: all)."""
        h = self.h_net1(z, c)
        imgs = [self.img_net1(h)]
        for i in range(2, (n_stages or self.branch_num) + 1):
            h = getattr(self, f"h_net{i}")(h, c)
            imgs.append(getattr(self, f"img_net{i}")(h))
        return imgs
