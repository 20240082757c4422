"""Image grids and PNG trees, the counterpart of ``s2i_tpu/utils/images.py``:
the training loop's snapshot grids and the sampling output."""

from __future__ import annotations

import os

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float image(s) → uint8, with the quantization the pipeline's
    ``output_dtype="uint8"`` applies on the device."""
    img = np.asarray(img, dtype=np.float32)
    return np.clip((img + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)


def make_image_grid(images: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """[N, H, W, 3] images in [-1, 1] → one uint8 grid image, ``nrow`` per row."""
    images = to_uint8(images)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    rows = (n + ncol - 1) // ncol
    grid = np.zeros((rows * (h + pad) - pad, ncol * (w + pad) - pad, c), np.uint8)
    for i, im in enumerate(images):
        r, col = divmod(i, ncol)
        grid[r * (h + pad): r * (h + pad) + h, col * (w + pad): col * (w + pad) + w] = im
    return grid


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """Save [N, H, W, 3] images in [-1, 1] as one PNG grid; returns the grid."""
    from PIL import Image

    grid = make_image_grid(images, nrow=nrow, pad=pad)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(grid).save(path)
    return grid


def save_images(images: np.ndarray, directory: str, names: list[str]) -> None:
    """Save each [H, W, 3] image in [-1, 1] as ``directory/<name>``."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    for im, name in zip(to_uint8(images), names):
        Image.fromarray(im).save(os.path.join(directory, name))
