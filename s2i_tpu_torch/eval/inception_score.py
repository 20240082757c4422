"""Inception Score, StackGAN protocol, the port's copy of
``s2i_tpu/eval/inception_score.py``: mean ± std of
exp(E_x KL(p(y|x) ‖ p(y))) over ``splits`` equal chunks."""

from __future__ import annotations

import numpy as np

from s2i_tpu_torch.eval.features import InceptionFeatures


def inception_score_from_probs(
    probs: np.ndarray, splits: int = 10
) -> tuple[float, float]:
    probs = np.asarray(probs, dtype=np.float64)
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits : (i + 1) * n // splits]
        if part.shape[0] == 0:
            continue
        marginal = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(marginal + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def softmax(logits: np.ndarray) -> np.ndarray:
    """Row softmax of host logits, as the JAX package's IS callers take it."""
    logits = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(logits)
    return e / e.sum(axis=1, keepdims=True)


def inception_score(
    images: np.ndarray,
    extractor: InceptionFeatures,
    splits: int = 10,
    batch_size: int = 64,
) -> tuple[float, float]:
    """images [N,H,W,3] in [-1,1] → (IS mean, IS std)."""
    _, logits = extractor.extract(images, batch_size)
    return inception_score_from_probs(softmax(logits), splits)
