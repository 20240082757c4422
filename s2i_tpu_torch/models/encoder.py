"""Speech encoder, the counterpart of ``s2i_tpu/models/encoder.py``: strided
Conv1d + BN + ReLU stack over the log-mel frames → bi-GRU → masked
mean/max pooling → Linear → embedding [B, emb_dim] (+ class logits).

State_dict keys follow the reference torch topology (``convs.{i}``,
``bns.{i}``, ``rnn.weight_ih_l0[_reverse]``, ``head``, ``cls``), so
``s2i_tpu.port.port_encoder`` reads them and ``bridge.encoder_state_dict``
writes them. The GRU's input projection for every step is one
``F.linear``; the recurrence runs in ``ops.gru_kernel`` (the CUDA kernel on
the card).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from s2i_tpu_torch.models.layers import BatchNorm
from s2i_tpu_torch.ops.gru_kernel import gru_scan


def conv_pads(t: int, kernel: int, stride: int, mode: str) -> tuple[int, int]:
    """(lo, hi) padding of a length-``t`` input. "SAME" is XLA's split
    (out = ceil(t/stride), the odd pad sample at the end: (1, 2) for t=1024,
    k=5, s=2); "torch" is symmetric ``kernel // 2``."""
    if mode == "SAME":
        out = -(-t // stride)
        total = max((out - 1) * stride + kernel - t, 0)
        return total // 2, total - total // 2
    if mode == "torch":
        return kernel // 2, kernel // 2
    raise ValueError(f"unknown conv_padding {mode!r}")


class BiGRU(nn.Module):
    """Stacked (bi)directional GRU with ``nn.GRU``'s parameter names and
    layouts (gates r|z|n, ``weight_ih`` [3H, in], ``weight_hh`` [3H, H]).
    The reverse direction flips the whole padded sequence and its mask, so
    its leading masked steps keep h = 0 (no packed sequences)."""

    def __init__(self, input_size: int, hidden: int, num_layers: int = 1,
                 bidirectional: bool = True):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        self.directions = ("", "_reverse") if bidirectional else ("",)
        bound = 1.0 / math.sqrt(hidden)
        for layer in range(num_layers):
            n_in = input_size if layer == 0 else hidden * len(self.directions)
            for sfx in self.directions:
                for name, shape in (
                    ("weight_ih", (3 * hidden, n_in)),
                    ("weight_hh", (3 * hidden, hidden)),
                    ("bias_ih", (3 * hidden,)),
                    ("bias_hh", (3 * hidden,)),
                ):
                    p = nn.Parameter(torch.empty(shape).uniform_(-bound, bound))
                    self.register_parameter(f"{name}_l{layer}{sfx}", p)

    def _direction(self, x, mask_t, layer: int, sfx: str) -> torch.Tensor:
        g = lambda name: getattr(self, f"{name}_l{layer}{sfx}")  # noqa: E731
        xw = F.linear(x, g("weight_ih"), g("bias_ih"))  # [B, T, 3H]: one product
        xw = xw.transpose(0, 1)  # [T, B, 3H]
        if sfx:
            xw = xw.flip(0)
            mask_t = mask_t.flip(0)
        h0 = x.new_zeros((x.shape[0], self.hidden))
        ys = gru_scan(xw.contiguous(), g("weight_hh").t().contiguous(), g("bias_hh"), mask_t, h0)
        if sfx:
            ys = ys.flip(0)
        return ys.transpose(0, 1)  # [B, T, H]

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        mask_t = mask.t().float().contiguous()  # [T, B]
        for layer in range(self.num_layers):
            x = torch.cat(
                [self._direction(x, mask_t, layer, sfx) for sfx in self.directions],
                dim=-1,
            )
        return x


class SpeechEncoder(nn.Module):
    """feats [B, T, n_mels] (+ mask [B, T]) → emb [B, emb_dim], or
    (emb, logits) when ``n_classes`` > 0. Inference only (BN running stats)."""

    def __init__(
        self,
        n_mels: int = 40,
        emb_dim: int = 1024,
        conv_channels: tuple[int, ...] = (64, 128, 256),
        conv_kernel: int = 5,
        conv_stride: int = 2,
        conv_padding: str = "SAME",
        rnn_hidden: int = 512,
        rnn_layers: int = 1,
        bidirectional: bool = True,
        pool: str = "mean_max",
        n_classes: int = 0,
        norm_out: bool = False,
    ):
        super().__init__()
        if pool not in ("mean", "max", "mean_max"):
            raise ValueError(f"unknown pool {pool!r}")
        conv_pads(1, conv_kernel, conv_stride, conv_padding)  # validates mode
        self.conv_kernel = conv_kernel
        self.conv_stride = conv_stride
        self.conv_padding = conv_padding
        self.pool = pool
        self.norm_out = norm_out
        chans = (n_mels, *conv_channels)
        self.convs = nn.ModuleList(
            nn.Conv1d(i, o, conv_kernel, stride=conv_stride, bias=False)
            for i, o in zip(chans[:-1], chans[1:])
        )
        self.bns = nn.ModuleList(BatchNorm(o) for o in conv_channels)
        self.rnn = BiGRU(chans[-1], rnn_hidden, rnn_layers, bidirectional)
        rnn_out = rnn_hidden * (2 if bidirectional else 1)
        pooled = 2 * rnn_out if pool == "mean_max" else rnn_out
        self.head = nn.Linear(pooled, emb_dim)
        self.cls = nn.Linear(pooled, n_classes) if n_classes else None

    def forward(self, feats: torch.Tensor, mask: torch.Tensor | None = None):
        b, t, _ = feats.shape
        if mask is None:
            mask = torch.ones((b, t), dtype=torch.bool, device=feats.device)
        # zero padded frames so they cannot leak through the receptive field
        x = (feats * mask[:, :, None].to(feats.dtype)).transpose(1, 2)  # [B, C, T]
        for conv, bn in zip(self.convs, self.bns):
            lo, hi = conv_pads(x.shape[-1], self.conv_kernel, self.conv_stride,
                               self.conv_padding)
            x = torch.relu(bn(conv(F.pad(x, (lo, hi)))))
            # a pooled step is valid if its first source frame was valid
            mask = mask[:, :: self.conv_stride][:, : x.shape[-1]]
        x = self.rnn(x.transpose(1, 2), mask)  # [B, T', 2H]

        m = mask[:, :, None].to(x.dtype)
        nvalid = m.sum(dim=1)  # 0 for an all-masked utterance
        mean = (x * m).sum(dim=1) / torch.clamp(nvalid, min=1.0)
        mx = torch.where(m > 0, x, torch.full_like(x, -1e30)).amax(dim=1)
        mx = torch.where(nvalid > 0, mx, torch.zeros_like(mx))  # all-masked → 0
        pooled = {"mean": mean, "max": mx}.get(self.pool)
        if pooled is None:
            pooled = torch.cat([mean, mx], dim=-1)

        emb = self.head(pooled)
        if self.norm_out:
            emb = emb / torch.clamp(emb.norm(dim=-1, keepdim=True), min=1e-8)
        if self.cls is not None:
            return emb, self.cls(pooled)
        return emb
