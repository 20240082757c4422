"""Where the port's work runs, and in which floating-point types."""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(value, key: str, aliases: tuple[str, ...] = ()) -> torch.dtype:
    name = str(value).lower()
    if name in aliases:
        return torch.float32
    if name not in DTYPES:
        raise ValueError(f"{key}={value!r}: the port takes {' or '.join(DTYPES)}")
    return DTYPES[name]


def compute_dtype(cfg) -> torch.dtype:
    """``DTYPE.COMPUTE``: the type the encoder, CA, G and the Ds compute in
    (parameters, the frontend, the recurrence, pooling and losses stay
    float32, as in the JAX package). bfloat16 in every shipped cfg but
    ``cfg/debug_tiny.yml``."""
    return _dtype(cfg.DTYPE.COMPUTE, "DTYPE.COMPUTE")


def moment_dtype(cfg) -> torch.dtype:
    """``TRAIN.MOMENT_DTYPE``: the type of the GAN Adam's moments on leaves
    of at least ``TRAIN.MOMENT_DTYPE_MIN_SIZE`` elements ("" and "fp32"
    mean float32, as in the JAX package)."""
    return _dtype(cfg.TRAIN.MOMENT_DTYPE, "TRAIN.MOMENT_DTYPE", aliases=("", "fp32"))


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    the CPU. A CUDA request without a card raises; nothing drifts to the
    CPU on its own.

    On the card it also sets three process-wide switches. TF32 goes off
    for matmuls and cuDNN convolutions: a float32 computation stays
    float32, as XLA's is, and the log-mel's log amplifies the error of TF32
    products in near-zero bins. cuBLAS's bfloat16 products accumulate in
    float32 with no reduced-precision reductions, as XLA's bfloat16 dots
    do (``DTYPE.COMPUTE`` bfloat16).
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
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
