"""Conditioning Augmentation, the counterpart of ``s2i_tpu/models/ca_net.py``.

emb [B, t_dim] → fc(4·c_dim) → GLU → (μ, logσ²). Serving uses μ (the JAX
package's eval mode); the reparameterized sample belongs to training.
"""

from __future__ import annotations

import torch
from torch import nn

from s2i_tpu_torch.models.layers import glu


class CANet(nn.Module):
    def __init__(self, t_dim: int, c_dim: int):
        super().__init__()
        self.c_dim = c_dim
        self.fc = nn.Linear(t_dim, c_dim * 4)

    def forward(self, emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(μ, logσ²), each [B, c_dim]."""
        x = glu(self.fc(emb), dim=-1)
        return x[:, : self.c_dim], x[:, self.c_dim :]
