"""Deterministic synthetic speech-encoder corpus, the port's own numpy copy
of ``SyntheticSpeechDataset`` in ``s2i_tpu/data/synthetic.py``: from the same
seed it gives the same arrays (``tests/test_torch_train_encoder.py`` holds
them equal)."""

from __future__ import annotations

import numpy as np


class SyntheticSpeechDataset:
    """Yields speech-encoder batches: mel-like features + teacher embeddings
    + class labels. Feature sequences are class-dependent tones so the
    distillation task is actually learnable."""

    def __init__(
        self,
        num_classes: int = 8,
        examples_per_class: int = 16,
        max_frames: int = 128,
        n_mels: int = 40,
        emb_dim: int = 1024,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self.n = num_classes * examples_per_class
        self.class_id = np.repeat(np.arange(num_classes), examples_per_class)
        emb_protos = rng.normal(size=(num_classes, emb_dim)).astype(np.float32)
        self.teacher = (
            emb_protos[self.class_id]
            + 0.05 * rng.normal(size=(self.n, emb_dim)).astype(np.float32)
        ).astype(np.float32)

        # class-dependent spectral ridge + noise, variable lengths
        t = np.arange(max_frames)
        self.lengths = rng.integers(max_frames // 2, max_frames + 1, self.n)
        mel_idx = np.arange(n_mels)
        feats = np.zeros((self.n, max_frames, n_mels), np.float32)
        for i in range(self.n):
            k = self.class_id[i]
            center = (k + 1) * n_mels / (num_classes + 1)
            ridge = np.exp(-0.5 * ((mel_idx[None, :] - center) / 3.0) ** 2)
            wobble = 1.0 + 0.2 * np.sin(2 * np.pi * t / (20 + k))[:, None]
            feats[i] = ridge * wobble + 0.1 * rng.normal(size=(max_frames, n_mels))
            feats[i, self.lengths[i] :] = 0.0
        self.feats = feats
        self.mask = t[None, :] < self.lengths[:, None]

    def batch(self, idx: np.ndarray) -> dict:
        return {
            "feats": self.feats[idx],
            "feat_mask": self.mask[idx],
            "teacher": self.teacher[idx],
            "class_id": self.class_id[idx],
        }

    def batches(self, batch_size: int, steps: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            yield self.batch(rng.integers(0, self.n, size=batch_size))
