"""Conditioning Augmentation, the counterpart of ``s2i_tpu/models/ca_net.py``.

emb [B, t_dim] → fc(4·c_dim) → GLU → (μ, logσ²). Serving uses μ (the JAX
package's eval mode); training draws the reparameterized sample
``c = μ + eps · exp(logσ² / 2)`` (:meth:`CANet.sample`, ``eps`` given by the
caller) and adds :func:`kl_divergence` to the generator loss.

In ``dtype`` (``DTYPE.COMPUTE``) the dense layer and the GLU run in it,
and so μ and logσ² come out in it; the sample's arithmetic and the KL run
in float32, and ``c`` is cast back to μ's type, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from s2i_tpu_torch.models.layers import Linear, glu


class CANet(nn.Module):
    def __init__(self, t_dim: int, c_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c_dim = c_dim
        self.fc = Linear(t_dim, c_dim * 4, dtype=dtype)

    def forward(self, emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(μ, logσ²), each [B, c_dim]."""
        x = glu(self.fc(emb), dim=-1)
        return x[:, : self.c_dim], x[:, self.c_dim :]

    def sample(self, emb: torch.Tensor, eps: torch.Tensor):
        """(c, μ, logσ²) with ``c = μ + eps · exp(logσ² / 2)``, eps [B, c_dim]."""
        mu, logvar = self(emb)
        c = mu.float() + eps.float() * torch.exp(0.5 * logvar.float())
        return c.to(mu.dtype), mu, logvar


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(μ, σ) ‖ N(0, 1)) as the StackGAN lineage's ``KL_loss``: the mean
    of the per-element integrand over batch AND condition dims, in float32."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * torch.mean(1.0 + logvar - mu.square() - logvar.exp())
