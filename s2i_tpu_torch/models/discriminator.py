"""Per-scale discriminators, the counterpart of
``s2i_tpu/models/discriminator.py``, in the StackGAN-v2 torch layout that
``bridge.dnet_state_dict`` writes (``img_code_s16``, ``img_code_s32``,
``img_code_s64``, ``img_code_s32_1``, ``img_code_s64_1/2``,
``logits.jointConv``, ``logits.outlogits``, ``uncond_logits.outlogits``).

Each D has a trunk that downsamples its scale to a 4×4 × (8·df) code and two
heads over that code: the conditional logit (the condition tiled over 4×4
and concatenated AFTER the code, ``(h, c)``, then a 3×3 block and a 4×4
valid conv) and the unconditional logit (a 4×4 valid conv). The generator's
stages concatenate the other way, ``(c, h)``. Heads return raw logits; the
trainer uses BCE-with-logits.

``GAN.D_TRUNK_BATCH`` (one dispatch over real|fake with per-segment BN
statistics) and ``GAN.S2D`` (a space-to-depth first conv) are the same math
as the sequential passes here.

``dtype`` (``DTYPE.COMPUTE``): the trunk and the heads compute in it (the
condition is cast to the code's type before it is tiled), and the logits
come out in float32, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from s2i_tpu_torch.models.layers import Conv2d, LeakyReLU, block3x3_leaky_relu, down_block

F32 = torch.float32


def encode_image_by_16times(ndf: int, dtype: torch.dtype = F32) -> nn.Sequential:
    """[B, 3, S, S] → [B, 8·ndf, S/16, S/16]; the first conv has no BN."""
    return nn.Sequential(
        Conv2d(3, ndf, 4, stride=2, padding=1, bias=False, dtype=dtype),
        LeakyReLU(0.2, dtype),
        *down_block(ndf, ndf * 2, dtype),
        *down_block(ndf * 2, ndf * 4, dtype),
        *down_block(ndf * 4, ndf * 8, dtype),
    )


class DLogits(nn.Module):
    """One logit head over the 4×4 code: with a condition, tile it, put it
    after the code channels and run a 3×3 block first."""

    def __init__(self, ndf: int, nef: int, b_condition: bool, dtype: torch.dtype = F32):
        super().__init__()
        if b_condition:
            self.jointConv = block3x3_leaky_relu(ndf * 8 + nef, ndf * 8, dtype)
        self.outlogits = nn.Sequential(Conv2d(ndf * 8, 1, 4, stride=4, dtype=dtype))

    def forward(self, code: torch.Tensor, c: torch.Tensor | None = None) -> torch.Tensor:
        if c is not None:
            c_tiled = c.to(code.dtype)[:, :, None, None].expand(-1, -1, code.shape[2], code.shape[3])
            code = self.jointConv(torch.cat([code, c_tiled], dim=1))
        return self.outlogits(code).view(-1).float()


# the trunk's modules after img_code_s16, in call order, per scale
_TRUNK_TAIL = {
    64: (),
    128: ("img_code_s32", "img_code_s32_1"),
    256: ("img_code_s32", "img_code_s64", "img_code_s64_1", "img_code_s64_2"),
}


class DNet(nn.Module):
    """D for one scale (64, 128 or 256 px). ``forward(img, c)`` returns
    ``(cond, uncond)`` float32 logits [B] (``cond`` None without a condition);
    BatchNorm follows ``train()``/``eval()``."""

    def __init__(self, scale: int, df_dim: int = 64, ef_dim: int = 128,
                 b_condition: bool = True, dtype: torch.dtype = F32):
        super().__init__()
        if scale not in _TRUNK_TAIL:
            raise ValueError(f"scale must be 64, 128 or 256, got {scale}")
        ndf = df_dim
        self.scale, self.ef_dim, self.b_condition = scale, ef_dim, b_condition
        self.img_code_s16 = encode_image_by_16times(ndf, dtype)
        if scale >= 128:
            self.img_code_s32 = down_block(ndf * 8, ndf * 16, dtype)
        if scale == 128:
            self.img_code_s32_1 = block3x3_leaky_relu(ndf * 16, ndf * 8, dtype)
        if scale == 256:
            self.img_code_s64 = down_block(ndf * 16, ndf * 32, dtype)
            self.img_code_s64_1 = block3x3_leaky_relu(ndf * 32, ndf * 16, dtype)
            self.img_code_s64_2 = block3x3_leaky_relu(ndf * 16, ndf * 8, dtype)
        if b_condition:
            self.logits = DLogits(ndf, ef_dim, True, dtype)
        self.uncond_logits = DLogits(ndf, ef_dim, False, dtype)

    def _check_c(self, c: torch.Tensor | None) -> None:
        if c is not None and c.shape[-1] != self.ef_dim:
            raise ValueError(
                f"condition dim {c.shape[-1]} != ef_dim {self.ef_dim} (GAN.EMBEDDING_DIM)"
            )

    def trunk(self, img: torch.Tensor) -> torch.Tensor:
        x = self.img_code_s16(img)
        for name in _TRUNK_TAIL[self.scale]:
            x = getattr(self, name)(x)
        return x  # [B, 8·ndf, 4, 4]

    def heads(self, code: torch.Tensor, c: torch.Tensor | None = None):
        uncond = self.uncond_logits(code)
        if not (self.b_condition and c is not None):
            return None, uncond
        return self.logits(code, c), uncond

    def forward(self, img: torch.Tensor, c: torch.Tensor | None = None):
        self._check_c(c)
        return self.heads(self.trunk(img), c)

    def train_logits(self, real, fake, c, c_wrong):
        """The six logit groups of one D step with two trunk passes, in the
        JAX package's call order (BN running averages fold in call order):
        trunk(real), trunk(fake), heads(real, c), heads(real, c_wrong),
        heads(fake, c). Returns (cond_real, uncond_real, cond_wrong,
        uncond_wrong, cond_fake, uncond_fake); uncond_wrong IS uncond_real,
        since the wrong pair's image is the real one."""
        self._check_c(c)
        self._check_c(c_wrong)
        code_real = self.trunk(real)
        code_fake = self.trunk(fake)
        cond_real, uncond_real = self.heads(code_real, c)
        cond_wrong = self.logits(code_real, c_wrong) if cond_real is not None else None
        cond_fake, uncond_fake = self.heads(code_fake, c)
        return cond_real, uncond_real, cond_wrong, uncond_real, cond_fake, uncond_fake


def build_discriminators(branch_num: int, df_dim: int = 64, ef_dim: int = 128,
                         b_condition: bool = True, dtype: torch.dtype = F32) -> list[DNet]:
    """One D per scale, smallest first."""
    return [DNet(64 * 2**i, df_dim, ef_dim, b_condition, dtype) for i in range(branch_num)]
