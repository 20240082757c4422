"""The general traffic generator: every input of a cell, made from the
run's seed and the traffic file's parameters, on the device in bulk.

Sizes are a fixed set that the seed only reorders, so that two seeds give
the same work in another order:
  * utterance lengths: ``wav_samples`` [lo, hi] spaced evenly over the pool,
    permuted by the seed; the samples are a seeded noise carrier under a
    slow seeded envelope, zero past each length, in batches padded to ``hi``;
  * images: uniform random bytes, NHWC at ``image_size``;
  * embeddings and teachers: standard normal rows of the configuration's
    TEXT.DIMENSION; class ids uniform over ENCODER.N_CLASSES.
"""

from __future__ import annotations

import math

import torch


class Feed:
    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cpu_gen = torch.Generator().manual_seed(seed)

    def perm(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.cpu_gen)

    def lengths(self, n: int, lo: int, hi: int) -> torch.Tensor:
        """n lengths evenly over [lo, hi], in the seed's order (CPU int64)."""
        even = torch.linspace(lo, hi, n, dtype=torch.float64).round().long()
        return even[self.perm(n)]

    def wavs(self, lengths: torch.Tensor, width: int) -> torch.Tensor:
        """[n, width] float32 on the device, zero past each length."""
        n = lengths.shape[0]
        x = 0.1 * torch.randn(n, width, generator=self.gen, device=self.device)
        t = torch.arange(width, device=self.device, dtype=torch.float32) / 16000.0
        rate = 1.0 + 4.0 * torch.rand(n, 1, generator=self.gen, device=self.device)
        x *= 0.6 + 0.4 * torch.sin(2 * math.pi * rate * t)
        x *= torch.arange(width, device=self.device)[None, :] < lengths.to(self.device)[:, None]
        return x

    def images(self, n: int, size: int) -> torch.Tensor:
        return torch.randint(0, 256, (n, size, size, 3), generator=self.gen, device=self.device, dtype=torch.uint8)

    def normal(self, n: int, dim: int) -> torch.Tensor:
        return torch.randn(n, dim, generator=self.gen, device=self.device)

    def classes(self, n: int, n_classes: int) -> torch.Tensor:
        return torch.randint(0, n_classes, (n,), generator=self.gen, device=self.device)


def batches(pool: dict, batch: int, count: int):
    """The pool's rows cut into ``count`` batches of ``batch`` (views)."""
    return [{k: v[i * batch:(i + 1) * batch] for k, v in pool.items()} for i in range(count)]
