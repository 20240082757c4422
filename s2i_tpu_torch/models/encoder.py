"""Speech encoder, the counterpart of ``s2i_tpu/models/encoder.py``: strided
Conv1d + BN + ReLU stack over the log-mel frames → bi-GRU → masked
mean/max pooling → Linear → embedding [B, emb_dim] (+ class logits).

State_dict keys follow the reference torch topology (``convs.{i}``,
``bns.{i}``, ``rnn.weight_ih_l0[_reverse]``, ``head``, ``cls``), so
``s2i_tpu.port.port_encoder`` reads them and ``bridge.encoder_state_dict``
writes them. The GRU's input projection for every step is one
``F.linear``; the recurrence runs in ``ops.gru_kernel`` (the CUDA kernel on
the card).

``dtype`` (``DTYPE.COMPUTE``) is what the masked input, the convs, the BNs
and the GRU's input projection compute in. As in the JAX package, the
projection is cast to float32 before the recurrence, which runs in float32
(its kernels take nothing else), its outputs go back to ``dtype``, and the
pooling and the dense heads run in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from s2i_tpu_torch.models.layers import BatchNorm, Conv1d
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
    Each layer is one ``gru_scan`` call over its directions stacked; the
    reverse direction runs backwards in time over the whole padded sequence
    and its mask, so its leading masked steps keep h = 0 (no packed
    sequences)."""

    def __init__(self, input_size: int, hidden: int, num_layers: int = 1,
                 bidirectional: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
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

    def _layer(self, x, mask_t, layer: int) -> torch.Tensor:
        stack = lambda name: [getattr(self, f"{name}_l{layer}{sfx}") for sfx in self.directions]  # noqa: E731
        b, t, _ = x.shape
        n_dir = len(self.directions)
        d = self.dtype
        # every direction's input projection in one product, in the compute
        # type (a bias added to the rounded product, as Flax's Dense), then
        # float32 for the recurrence: [B, T, D*3H]
        w_i, b_i = torch.cat(stack("weight_ih")), torch.cat(stack("bias_ih"))
        xw = F.linear(x, w_i, b_i) if d == torch.float32 else F.linear(x.to(d), w_i.to(d)) + b_i.to(d)
        xw = xw.float()
        xw = xw.view(b, t, n_dir, 3 * self.hidden).permute(2, 1, 0, 3).contiguous()  # [D, T, B, 3H]
        w_h = torch.stack([w.t() for w in stack("weight_hh")])  # [D, H, 3H]
        h0 = xw.new_zeros((n_dir, b, self.hidden))
        ys = gru_scan(xw, w_h, torch.stack(stack("bias_hh")), mask_t, h0)  # [D, T, B, H]
        return ys.permute(2, 1, 0, 3).reshape(b, t, n_dir * self.hidden).to(d)  # [B, T, D*H]

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        mask_t = mask.t().float().contiguous()  # [T, B]
        for layer in range(self.num_layers):
            x = self._layer(x, mask_t, layer)
        return x


class SpeechEncoder(nn.Module):
    """feats [B, T, n_mels] (+ mask [B, T]) → emb [B, emb_dim], or
    (emb, logits) when ``n_classes`` > 0. ``eval()`` normalizes with the BN
    running statistics; ``train()`` with the batch's, updating the running
    ones as Flax's ``apply(..., train=True, mutable=["batch_stats"])``
    does. Gradients reach every parameter, the recurrence's through
    ``GRUScan``."""

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
        dtype: torch.dtype = torch.float32,
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
        self.dtype = dtype
        chans = (n_mels, *conv_channels)
        self.convs = nn.ModuleList(
            Conv1d(i, o, conv_kernel, stride=conv_stride, bias=False, dtype=dtype)
            for i, o in zip(chans[:-1], chans[1:])
        )
        self.bns = nn.ModuleList(BatchNorm(o, dtype=dtype) for o in conv_channels)
        self.rnn = BiGRU(chans[-1], rnn_hidden, rnn_layers, bidirectional, dtype)
        rnn_out = rnn_hidden * (2 if bidirectional else 1)
        pooled = 2 * rnn_out if pool == "mean_max" else rnn_out
        self.head = nn.Linear(pooled, emb_dim)
        self.cls = nn.Linear(pooled, n_classes) if n_classes else None

    def forward(self, feats: torch.Tensor, mask: torch.Tensor | None = None):
        b, t, _ = feats.shape
        if mask is None:
            mask = torch.ones((b, t), dtype=torch.bool, device=feats.device)
        # zero padded frames so they cannot leak through the receptive field
        x = (feats.to(self.dtype) * mask[:, :, None].to(self.dtype)).transpose(1, 2)  # [B, C, T]
        for conv, bn in zip(self.convs, self.bns):
            lo, hi = conv_pads(x.shape[-1], self.conv_kernel, self.conv_stride,
                               self.conv_padding)
            x = torch.relu(bn(conv(F.pad(x, (lo, hi)))))
            # a pooled step is valid if its first source frame was valid
            mask = mask[:, :: self.conv_stride][:, : x.shape[-1]]
        x = self.rnn(x.transpose(1, 2), mask).float()  # [B, T', 2H], pooled in float32

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
