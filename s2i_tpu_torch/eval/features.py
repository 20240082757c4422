"""Batched Inception feature and logit extraction for IS and FID, the
counterpart of ``s2i_tpu/eval/features.py``.

Images come in as [-1, 1] NHWC at any of the GAN scales and are resized on
the device to ``image_size`` (299 px) before the InceptionV3 pass, with the
JAX package's resize (:func:`preprocess`). ``quantize_input`` first rounds
them through uint8, pytorch-fid's "features of the saved PNG" protocol.

Extraction runs in fixed batches, the tail padded, pipelined one batch
deep on the card: batch i's outputs are copied into pinned host buffers
behind its forward and an event is recorded; batch i+1 is staged and
queued; only then does the host wait on batch i's event. A plain ``.cpu()``
of batch i issued after batch i+1 is queued would wait for batch i+1 too.
The features are bitwise those of the serial loop: the same program runs on
the same batches, only the waits move.

With ``mesh`` (a ``parallel.DataAxis``) each rank runs its rows of each
batch (the batch rounded up to a multiple of the world size) and the
features and logits are gathered, so every rank returns those of every
image (``s2i_tpu/eval/features.py``'s ``mesh``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from s2i_tpu_torch.device import resolve_device
from s2i_tpu_torch.parallel import DataAxis
from s2i_tpu_torch.models.inception import InceptionV3, init_weights


def _resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize with ``jax.image.resize``'s numerics: its
    triangle kernel widens on an axis that shrinks (antialiasing) and is
    the plain half-pixel interpolation on one that grows. ``F.interpolate``
    antialiases both axes or neither, so an image that shrinks on one axis
    and grows on the other is resized one axis at a time (the resize is
    separable, as jax's is)."""
    (h, w), (oh, ow) = x.shape[-2:], size
    if (oh < h) == (ow < w) or oh == h or ow == w:
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=oh < h or ow < w)
    x = F.interpolate(x, size=(oh, w), mode="bilinear", align_corners=False, antialias=oh < h)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=ow < w)


def preprocess(imgs: torch.Tensor, image_size: int = 299, quantize_input: bool = False) -> torch.Tensor:
    """[-1, 1] NHWC at any scale → [-1, 1] NHWC at (image_size, image_size),
    float32. ``quantize_input`` rounds through uint8 first (round half up,
    as ``utils.images.to_uint8``), then maps back as pytorch-fid's
    ``2 * (u / 255) - 1``: the file on disk is quantized, the interpolation
    is not, so quantization comes before the resize."""
    imgs = imgs.float()
    if quantize_input:
        imgs = torch.clamp(torch.floor((imgs + 1.0) * 127.5 + 0.5), 0.0, 255.0) / 127.5 - 1.0
    if tuple(imgs.shape[1:3]) == (image_size, image_size):
        return imgs
    x = _resize(imgs.permute(0, 3, 1, 2), (image_size, image_size))
    return x.permute(0, 2, 3, 1)


class InceptionFeatures:
    """An InceptionV3 in eval mode on a device, and batched extraction.

    ``state_dict``: the port's InceptionV3 state_dict (``eval/weights.py``
    turns a torchvision one into it); None draws seeded random weights
    (metric plumbing only). The model computes in float32 whatever
    ``DTYPE.COMPUTE`` says, as the JAX extractor does.
    """

    def __init__(
        self,
        state_dict: dict | None = None,
        num_classes: int = 1000,
        rng_seed: int = 0,
        image_size: int = 299,
        quantize_input: bool = False,
        device: str | torch.device = "cuda",
        mesh: DataAxis | None = None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = InceptionV3(num_classes=num_classes)
        if state_dict is None:
            init_weights(self.model, torch.Generator().manual_seed(rng_seed))
        else:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.image_size = image_size
        self.quantize_input = quantize_input
        self.num_classes = num_classes

    @torch.no_grad()
    def forward(self, imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One batch on the device → (pool3, logits) on the device; over the
        mesh, this rank's rows of the batch run and every row's come back."""
        if self.mesh is not None:
            imgs = imgs[self.mesh.rows(imgs.shape[0])]
        out = self.model(preprocess(imgs, self.image_size, self.quantize_input))
        if self.mesh is not None:
            return self.mesh.all_gather(out["pool3"]), self.mesh.all_gather(out["logits"])
        return out["pool3"], out["logits"]

    def extract(self, images: np.ndarray, batch_size: int = 64) -> tuple[np.ndarray, np.ndarray]:
        """[N, H, W, 3] in [-1, 1] → (pool3 [N, 2048], logits [N, C]) as
        float32 numpy, ``batch_size`` images a pass (over the mesh rounded
        up to a multiple of the world size), the tail batch padded with zeros
        and its rows dropped."""
        if self.mesh is not None:
            batch_size = -(-batch_size // self.mesh.size) * self.mesh.size
        n = images.shape[0]
        pools = np.empty((n, 2048), np.float32)
        logits = np.empty((n, self.num_classes), np.float32)
        cuda = self.device.type == "cuda"
        slots = [self._slot(images.shape[1:], batch_size) if cuda else None for _ in range(2)]
        pending = None

        def finish(job) -> None:
            (i, m, event, out) = job
            if event is not None:
                event.synchronize()
            pools[i:i + m] = out[0][:m].numpy()
            logits[i:i + m] = out[1][:m].numpy()

        for k, i in enumerate(range(0, n, batch_size)):
            x = torch.from_numpy(np.asarray(images[i:i + batch_size], np.float32))
            m = x.shape[0]
            if cuda:
                slot = slots[k % 2]  # free: the batch that used it two passes ago is finished
                slot["in"][:m].copy_(x)
                slot["in"][m:].zero_()
                p, lg = self.forward(slot["in"].to(self.device, non_blocking=True))
                out = (slot["pool"], slot["logits"])
                out[0].copy_(p, non_blocking=True)
                out[1].copy_(lg, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                if m < batch_size:
                    x = torch.cat([x, x.new_zeros((batch_size - m, *x.shape[1:]))])
                out, event = self.forward(x), None
            if pending is not None:
                finish(pending)
            pending = (i, m, event, out)
        if pending is not None:
            finish(pending)
        return pools, logits

    def _slot(self, image_shape: tuple, batch_size: int) -> dict[str, torch.Tensor]:
        """Pinned host buffers of one batch in flight: its input and its outputs."""
        return {
            "in": torch.empty((batch_size, *image_shape), dtype=torch.float32, pin_memory=True),
            "pool": torch.empty((batch_size, 2048), dtype=torch.float32, pin_memory=True),
            "logits": torch.empty((batch_size, self.num_classes), dtype=torch.float32, pin_memory=True),
        }
