"""Deterministic synthetic corpora, the port's own numpy copies of
``SyntheticSpeechDataset`` and ``SyntheticGanDataset`` in
``s2i_tpu/data/synthetic.py``: from the same seed they give the same arrays
(``tests/test_torch_train_encoder.py`` and ``tests/test_torch_train_gan.py``
hold them equal). :func:`synthetic_wavs` adds ragged spoken-caption
stand-ins for the joint finetune, which featurizes wavs on the device."""

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


def _downscale(img: np.ndarray, factor: int) -> np.ndarray:
    """Mean-pool [H, W, C] by an integer factor (area resize)."""
    h, w, c = img.shape
    return img.reshape(h // factor, factor, w // factor, factor, c).mean(axis=(1, 3))


class SyntheticGanDataset:
    """Yields GAN batches: class-structured images (smooth per-class
    patterns plus noise) at the top scale or every scale, float [-1, 1] or
    uint8 [0, 255] (``DATA.IMAGE_DTYPE``, ``DATA.SHIP_SCALES``), 1024-d
    embeddings around per-class prototypes, and class ids."""

    def __init__(
        self,
        num_classes: int = 8,
        examples_per_class: int = 16,
        branch_num: int = 3,
        base_size: int = 64,
        emb_dim: int = 1024,
        seed: int = 0,
        image_dtype: str = "float32",
        ship_scales: str = "all",
    ):
        self.image_dtype = image_dtype
        self.ship_scales = ship_scales
        self.branch_num = branch_num
        self.sizes = [base_size * 2**i for i in range(branch_num)]
        self.emb_dim = emb_dim
        self.n = num_classes * examples_per_class
        rng = np.random.default_rng(seed)
        top = self.sizes[-1]
        freq = rng.normal(size=(num_classes, 2, 3)) * 4.0
        phase = rng.uniform(0, 2 * np.pi, size=(num_classes, 3))
        yy, xx = np.meshgrid(np.linspace(0, 1, top), np.linspace(0, 1, top), indexing="ij")
        protos = np.stack([
            np.tanh(np.sin(
                2 * np.pi * (freq[k, 0, None, None, :] * yy[..., None]
                             + freq[k, 1, None, None, :] * xx[..., None])
                + phase[k]
            ))
            for k in range(num_classes)
        ]).astype(np.float32)  # [K, top, top, 3]
        emb_protos = rng.normal(size=(num_classes, emb_dim)).astype(np.float32)
        self.class_id = np.repeat(np.arange(num_classes), examples_per_class)
        noise_img = 0.1 * rng.normal(size=(self.n, top, top, 3)).astype(np.float32)
        self.images_top = np.clip(protos[self.class_id] + noise_img, -1, 1)
        self.embeddings = (
            emb_protos[self.class_id] + 0.1 * rng.normal(size=(self.n, emb_dim)).astype(np.float32)
        ).astype(np.float32)

    def batch(self, idx: np.ndarray) -> dict:
        top = self.images_top[idx]
        if self.ship_scales == "top":
            images = [top]
        else:
            images = []
            factor = 2 ** (self.branch_num - 1)
            for _ in range(self.branch_num):
                images.append(top if factor == 1 else np.stack(
                    [_downscale(im, factor) for im in top]).astype(np.float32))
                factor //= 2
        if self.image_dtype == "uint8":
            images = [((im + 1.0) * 127.5 + 0.5).clip(0, 255).astype(np.uint8) for im in images]
        return {"images": tuple(images), "embedding": self.embeddings[idx], "class_id": self.class_id[idx]}


def synthetic_wavs(class_id: np.ndarray, max_samples: int, seed: int = 0,
                   min_samples: int = 3000, sample_rate: int = 16000) -> tuple[np.ndarray, np.ndarray]:
    """One zero-padded wav per example, [N, max_samples] float32, and its
    length [N]: a chirp whose pitch follows the example's class plus a noise
    floor (so every mel bin carries energy), lengths spread evenly from
    ``max_samples`` down to ``min_samples`` in a seeded order."""
    rng = np.random.default_rng(seed)
    n = len(class_id)
    lens = rng.permutation(np.linspace(max_samples, min_samples, n).round().astype(np.int32))
    t = np.arange(max_samples) / sample_rate
    wavs = np.zeros((n, max_samples), np.float32)
    for i, (k, m) in enumerate(zip(class_id, lens)):
        x = 0.3 * np.sin(2 * np.pi * 180.0 * (k + 1) * t[:m] * (1 + 0.5 * t[:m]))
        wavs[i, :m] = x + 0.02 * rng.standard_normal(m)
    return wavs, lens
