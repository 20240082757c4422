"""How far one InceptionV3 finetune step's gradients move under rounding,
the measurement behind the gate of
``tests/test_torch_gpu.py::test_inception_finetune_step_on_the_card_matches_cpu``.

From the same seeded init and batch (8 images, 3 classes), one train-mode
step on the CPU is the reference. The script prints the whole-network
gradient distance ‖g − g_ref‖ / ‖g_ref‖ of: the CPU with oneDNN off (the
same float32 step in other convolution code), the CPU with every conv
kernel multiplied by (1 + eps·N(0, 1)) for a few eps (the step's own
sensitivity), and, where a card is present, the card with cuDNN off and
with cuDNN on. At 75 and 299 px:

    python3 tools_torch/inception_grad_spread.py            # CPU and, if present, the card
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from s2i_tpu_torch.eval.finetune import init_inception_state, make_inception_train_step  # noqa: E402

EPS = (1e-6, 1e-5, 1e-4)


def distance(a: torch.nn.Module, b: torch.nn.Module) -> float:
    """‖grad(a) − grad(b)‖ / ‖grad(b)‖ over every parameter."""
    num = sum((pa.grad.cpu().double() - pb.grad.double()).pow(2).sum().item()
              for pa, pb in zip(a.parameters(), b.parameters()))
    return (num / sum(pb.grad.double().pow(2).sum().item() for pb in b.parameters())) ** 0.5


def stepped(size: int, device: str, eps: float = 0.0) -> torch.nn.Module:
    """The model after one step at ``size`` px on ``device``; its conv
    kernels scaled by (1 + eps·N(0, 1)) first when eps > 0."""
    rng = np.random.default_rng(5)
    imgs = rng.uniform(-1, 1, (8, 64, 64, 3)).astype(np.float32)
    st = init_inception_state(3, seed=0, lr=1e-3, device=device)
    if eps:
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in st.model.parameters():
                if p.ndim == 4:
                    p.mul_(1 + eps * torch.randn(p.shape, generator=gen).to(p.device))
    make_inception_train_step(size)(st, imgs, np.arange(8) % 3)
    return st.model


def main() -> None:
    card = torch.cuda.is_available()
    if card:
        print(torch.cuda.get_device_name(0))
    for size in (75, 299):
        ref = stepped(size, "cpu")
        with torch.backends.mkldnn.flags(enabled=False):
            row = {"cpu, oneDNN off": distance(stepped(size, "cpu"), ref)}
        for eps in EPS:
            row[f"cpu, kernels x (1 + {eps:g} N)"] = distance(stepped(size, "cpu", eps), ref)
        if card:
            with torch.backends.cudnn.flags(enabled=False):
                row["card, cuDNN off"] = distance(stepped(size, "cuda"), ref)
            row["card, cuDNN on"] = distance(stepped(size, "cuda"), ref)
        print(f"{size} px: " + "; ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)


if __name__ == "__main__":
    main()
