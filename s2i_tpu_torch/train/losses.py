"""Training losses, the counterpart of ``s2i_tpu/train/losses.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
