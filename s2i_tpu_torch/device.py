"""Where the port's work runs."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    the CPU. A CUDA request without a card raises; nothing drifts to the
    CPU on its own.

    On the card it also turns TF32 off for matmuls and cuDNN convolutions
    (both process-wide switches): the port computes in float32, and the
    log-mel's log amplifies the error of TF32 products in near-zero bins.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
