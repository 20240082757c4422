"""Speech-encoder distillation pretraining and embedding extraction, the
counterpart of ``s2i_tpu/train/encoder.py``.

One step: encoder forward in train mode on (features, mask) → MSE to the
teacher embedding (+ ``CE_COEFF`` × class CE) → backward (the recurrence's
through the op ``s2i::gru_scan``'s registered backward: K3 on the card) →
Adam with optax ``adam``'s defaults.
Extraction runs the eval-mode encoder over a corpus in fixed-size batches.
Both compute in ``DTYPE.COMPUTE`` (``pipeline.build_encoder``); the
optimizer is plain Adam whatever ``TRAIN.MOMENT_DTYPE`` says, as in the JAX
package.

    state = init_encoder_state(cfg)                    # on the card
    metrics = encoder_train_step(state, batch)         # {"loss", "mse", ...}
    emb = extract_all(state.model, feats, masks, 64)   # [N, emb_dim]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from s2i_tpu_torch.device import resolve_device
from s2i_tpu_torch.models.encoder import BiGRU, SpeechEncoder
from s2i_tpu_torch.models.layers import BatchNorm, lecun_normal_
from s2i_tpu_torch.pipeline import build_encoder
from s2i_tpu_torch.train.losses import distillation_loss
from s2i_tpu_torch.utils.checkpoint import load_optimizer


@torch.no_grad()
def init_weights(model: SpeechEncoder, gen: torch.Generator) -> None:
    """The JAX package's init scheme, every draw from ``gen``: lecun-normal
    conv, dense and GRU input kernels with zero biases; an orthogonal
    recurrent kernel with a zero recurrent bias; BN scale 1, bias 0."""
    for m in model.modules():
        if isinstance(m, nn.Conv1d):
            lecun_normal_(m.weight, m.in_channels * m.kernel_size[0], gen)
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, gen)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, BiGRU):
            for name, p in m.named_parameters():
                if name.startswith("weight_ih"):
                    lecun_normal_(p, p.shape[1], gen)
                elif name.startswith("weight_hh"):
                    nn.init.orthogonal_(p, generator=gen)  # = W_h^T: W_h's rows orthonormal
                else:
                    p.zero_()


@dataclasses.dataclass
class EncoderTrainState:
    model: SpeechEncoder
    opt: torch.optim.Adam
    ce_coeff: float
    step: int = 0

    def state_dict(self) -> dict:
        """The model's parameters and buffers (``"model"``: the encoder's
        state_dict, class head included), Adam's state and the step: all an
        exact resume needs, as the step draws no noise."""
        return {"step": self.step, "model": self.model.state_dict(), "opt": self.opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Load what :meth:`state_dict` returned (from any device)."""
        self.model.load_state_dict(sd["model"])
        load_optimizer(self.opt, sd["opt"], "encoder Adam")
        self.step = int(sd["step"])


def init_encoder_state(cfg, device: str | torch.device = "cuda") -> EncoderTrainState:
    """The encoder of ``cfg`` on ``device`` in train mode, with weights drawn
    from a ``torch.Generator`` seeded with ``cfg.SEED`` (the same weights on
    every device), and a fresh Adam. Other weights load with
    ``state.model.load_state_dict`` (e.g. from ``bridge.encoder_state_dict``)
    before the first step."""
    model = build_encoder(cfg)
    init_weights(model, torch.Generator().manual_seed(int(cfg.SEED)))
    model.to(resolve_device(device)).train()
    opt = torch.optim.Adam(model.parameters(), lr=float(cfg.ENCODER.LR), betas=(0.9, 0.999), eps=1e-8)
    e = cfg.ENCODER
    return EncoderTrainState(model, opt, float(e.CE_COEFF) if bool(e.CLS_HEAD) else 0.0)


def encoder_train_step(state: EncoderTrainState, batch: dict) -> dict:
    """One distillation step on ``{"feats" [B, T, D], "feat_mask" [B, T],
    "teacher" [B, emb_dim], "class_id" [B]}`` (numpy or tensors); updates
    ``state`` in place and returns ``{"loss", "mse"[, "ce", "cls_acc"]}`` as
    0-d tensors on the device. The gradients stay on the parameters until
    the next step."""
    model = state.model
    dev = next(model.parameters()).device
    feats = torch.as_tensor(batch["feats"], dtype=torch.float32, device=dev)
    mask = batch.get("feat_mask")
    mask = None if mask is None else torch.as_tensor(mask, device=dev).bool()
    teacher = torch.as_tensor(batch["teacher"], dtype=torch.float32, device=dev)
    labels = batch.get("class_id")
    labels = None if labels is None else torch.as_tensor(labels, device=dev).long()
    model.train()
    out = model(feats, mask)
    emb, logits = out if isinstance(out, tuple) else (out, None)
    loss, mets = distillation_loss(emb, teacher, logits, labels, state.ce_coeff)
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    state.opt.step()
    state.step += 1
    return {"loss": loss.detach(), **{k: v.detach() for k, v in mets.items()}}


@torch.no_grad()
def extract_all(model: SpeechEncoder, feats, masks, batch_size: int = 64) -> np.ndarray:
    """Eval-mode embeddings [N, emb_dim] of a corpus, ``batch_size`` at a
    time; the tail batch is padded with all-masked rows so every batch has
    the same shape, and their outputs are dropped."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    out = []
    try:
        for i in range(0, feats.shape[0], batch_size):
            fb = np.asarray(feats[i : i + batch_size], np.float32)
            mb = np.asarray(masks[i : i + batch_size], bool)
            pad = batch_size - fb.shape[0]
            if pad:
                fb = np.concatenate([fb, np.zeros((pad,) + fb.shape[1:], fb.dtype)])
                mb = np.concatenate([mb, np.zeros((pad,) + mb.shape[1:], mb.dtype)])
            emb = model(torch.from_numpy(fb).to(dev), torch.from_numpy(mb).to(dev))
            emb = (emb[0] if isinstance(emb, tuple) else emb).cpu().numpy()
            out.append(emb[: batch_size - pad])
    finally:
        model.train(was_training)
    return np.concatenate(out, axis=0)
