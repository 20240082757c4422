"""Training losses, the counterpart of ``s2i_tpu/train/losses.py``: the
per-scale D loss over real / wrong-pair / fake logits, the generator's
adversarial term, the StackGAN-v2 color-consistency regularizer and the
distillation loss. Logits are raw: BCE-with-logits is the reference's
sigmoid + BCE in a stable form. Every loss computes in float32 whatever
type its inputs come in, as in the JAX package."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross-entropy against a constant 0/1 target."""
    logits = logits.float()
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


def discriminator_loss(cond_real, uncond_real, cond_wrong, uncond_wrong, cond_fake,
                       uncond_fake, uncond_coeff: float = 1.0) -> tuple[torch.Tensor, dict]:
    """One scale's D loss. The wrong pair (a real image with a mismatched
    condition) counts as fake for the conditional head and as real for the
    unconditional one. Metrics ``real_acc`` / ``fake_acc`` of the
    unconditional head."""
    loss = uncond_real.new_zeros((), dtype=torch.float32)
    if cond_real is not None:
        loss = bce_logits(cond_real, 1.0) + bce_logits(cond_wrong, 0.0) + bce_logits(cond_fake, 0.0)
    if uncond_coeff > 0.0:
        loss = loss + uncond_coeff * (
            bce_logits(uncond_real, 1.0) + bce_logits(uncond_wrong, 1.0) + bce_logits(uncond_fake, 0.0)
        )
    aux = {"real_acc": (uncond_real > 0).float().mean(), "fake_acc": (uncond_fake < 0).float().mean()}
    return loss, aux


def generator_adversarial_loss(cond_fake, uncond_fake, uncond_coeff: float = 1.0) -> torch.Tensor:
    """One scale's adversarial G term (non-saturating BCE toward 'real')."""
    loss = uncond_fake.new_zeros((), dtype=torch.float32)
    if cond_fake is not None:
        loss = bce_logits(cond_fake, 1.0)
    if uncond_coeff > 0.0:
        loss = loss + uncond_coeff * bce_logits(uncond_fake, 1.0)
    return loss


def _channel_stats(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image channel mean [B, 3] and covariance [B, 3, 3] over the
    pixels of an NCHW image (divisor h·w − 1)."""
    b, c, h, w = img.shape
    x = img.reshape(b, c, h * w).float()
    mu = x.mean(dim=2)
    xc = x - mu[:, :, None]
    return mu, torch.einsum("bcp,bdp->bcd", xc, xc) / (h * w - 1)


def color_consistency_loss(imgs: list[torch.Tensor], lambda_mu: float = 1.0,
                           lambda_cov: float = 5.0) -> torch.Tensor:
    """StackGAN-v2 color consistency between consecutive stages: match the
    per-image channel means and covariances."""
    loss = imgs[0].new_zeros((), dtype=torch.float32)
    stats = [_channel_stats(i) for i in imgs]
    for (mu1, cov1), (mu2, cov2) in zip(stats[:-1], stats[1:]):
        loss = loss + lambda_mu * (mu1 - mu2).square().sum(-1).mean() \
            + lambda_cov * (cov1 - cov2).square().sum((-2, -1)).mean()
    return loss


def distillation_loss(
    emb: torch.Tensor,
    teacher: torch.Tensor,
    logits: torch.Tensor | None = None,
    labels: torch.Tensor | None = None,
    ce_coeff: float = 0.0,
) -> tuple[torch.Tensor, dict]:
    """Speech-encoder pretraining loss: MSE to the teacher embedding plus
    ``ce_coeff`` times the integer-label softmax cross-entropy of the class
    head, when there is one. Metrics ``mse``, and ``ce``/``cls_acc`` with the
    class term, as in the JAX package."""
    mse = torch.mean(torch.square(emb.float() - teacher.float()))
    metrics = {"mse": mse}
    loss = mse
    if ce_coeff > 0.0 and logits is not None and labels is not None:
        ce = F.cross_entropy(logits.float(), labels.long())
        loss = loss + ce_coeff * ce
        metrics["ce"] = ce
        metrics["cls_acc"] = (logits.argmax(-1) == labels).float().mean()
    return loss, metrics
