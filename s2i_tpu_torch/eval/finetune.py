"""Fine-tune the InceptionV3 classifier on a dataset's classes, the
counterpart of ``s2i_tpu/eval/finetune.py``: the StackGAN IS protocol
scores with an Inception fine-tuned on CUB or Oxford, and this trainer
lets a user make one from the dataset itself.

One step: the images resized to ``image_size`` (the JAX package's
bilinear resize, :func:`features.preprocess`) → train-mode forward (BN on
the batch's statistics, running statistics moved) → mean cross-entropy and
accuracy → backward → Adam with optax ``adam``'s defaults. No dropout, no
auxiliary head, as in the JAX module. A warm start (``eval/weights.py``
from a torchvision state_dict) takes every weight and BN statistic but the
class head.

    state = init_inception_state(num_classes, seed=0)     # on the card
    step = make_inception_train_step(image_size=299)
    metrics = step(state, images, labels)                 # {"ce", "acc"}
    CheckpointManager(dir).save(state.step, state)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from s2i_tpu_torch.device import resolve_device
from s2i_tpu_torch.eval.features import preprocess
from s2i_tpu_torch.models.inception import InceptionV3, init_weights
from s2i_tpu_torch.utils.checkpoint import load_optimizer


@dataclasses.dataclass
class InceptionTrainState:
    model: InceptionV3
    opt: torch.optim.Adam
    step: int = 0

    def state_dict(self) -> dict:
        """The model's parameters and BN statistics (``"model"``: what
        ``eval --finetuned_ckpt`` loads), Adam's state and the step."""
        return {"step": self.step, "model": self.model.state_dict(), "opt": self.opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        load_optimizer(self.opt, sd["opt"], "Inception Adam")
        self.step = int(sd["step"])


def init_inception_state(
    num_classes: int,
    seed: int = 0,
    lr: float = 1e-4,
    warm_start: dict | None = None,
    device: str | torch.device = "cuda",
) -> InceptionTrainState:
    """An InceptionV3 of ``num_classes`` on ``device`` in train mode, with
    the JAX scheme's weights drawn from a ``torch.Generator`` seeded with
    ``seed`` (the same on every device), and a fresh Adam. ``warm_start``
    (a port state_dict, e.g. :func:`eval.weights.load_torch_inception`'s)
    replaces every tensor but ``fc.*``, BN statistics included."""
    dev = resolve_device(device)
    model = InceptionV3(num_classes=num_classes)
    init_weights(model, torch.Generator().manual_seed(seed))
    if warm_start is not None:
        graft = {k: v for k, v in warm_start.items() if not k.startswith("fc.")}
        missing, unexpected = model.load_state_dict(graft, strict=False)
        if unexpected or any(not k.startswith("fc.") for k in missing):
            raise ValueError(f"the warm start does not fit InceptionV3: missing "
                             f"{[k for k in missing if not k.startswith('fc.')][:8]}, unexpected {unexpected[:8]}")
    model.to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return InceptionTrainState(model, opt)


def make_inception_train_step(image_size: int = 299) -> Callable[..., dict]:
    """``step(state, images, labels)``: images [B, H, W, 3] in [-1, 1] and
    integer labels [B] (numpy or tensors) → one supervised step on
    ``state``, in place; returns ``{"ce", "acc"}`` as 0-d tensors on the
    device."""

    def step(state: InceptionTrainState, images, labels) -> dict:
        model = state.model
        dev = next(model.parameters()).device
        x = preprocess(torch.as_tensor(images, dtype=torch.float32, device=dev), image_size)
        y = torch.as_tensor(labels, device=dev).long()
        model.train()
        logits = model(x)["logits"]
        ce = F.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
        state.opt.zero_grad(set_to_none=True)
        ce.backward()
        state.opt.step()
        state.step += 1
        return {"ce": ce.detach(), "acc": acc.detach()}

    return step
