"""AOT deployment artifacts of the speech → image pipeline, the counterpart of
``s2i_tpu/export.py``: the whole wav → image program, its weights inside,
saved with ``torch.export`` and served without the model code.

    pipe = SpeechToImage.from_checkpoints(cfg, enc_ckpt, gan_ckpt)
    export_pipeline(pipe, "/models/s2i_v1", batch_sizes=(1, 8))

    loaded = load("/models/s2i_v1")          # no cfg, no checkpoints, no model code
    imgs = loaded.generate(wavs, wav_lens, seed=0)

The artifact directory holds ``program.pt2`` (``torch.export.save`` of
``pipeline.ServeProgram``: frontend → encoder → CA μ → G at one stage,
quantized to uint8 unless exported as float) and ``meta.json`` (shapes,
stage, output type, the device type it was exported on, format and torch
versions). The program has one dynamic batch dimension, so its weights are
stored, loaded and held on the device once; ``batch_sizes`` is the serving
policy, as the JAX package's ``model_b{N}`` files are: a request pads to
the smallest exported batch ≥ its size, and a larger one splits into
chunks of the largest. ``files`` maps each batch size to the program file
(all to the one program), as the JAX package's meta does.

The kernels are ``torch.library`` custom ops (``s2i::logmel``,
``s2i::gru_scan``; ``s2i_tpu_torch/ops``), so they appear in the saved
graph as single nodes and run through the same registrations as the live
pipeline: K1 and K2 on the card, their plain versions on the CPU. Loading
imports those registrations and nothing of ``models``, ``pipeline``,
``train`` or ``data``.

The noise z is an input: ``torch.export`` cannot trace a
``torch.Generator``. The loaded pipeline draws it as the live one does
(``device.draw_z``), so an artifact call equals a live call with the same
seed at the same padded batch: bitwise on the CPU, where the two run the
same ATen ops in the same order, and on the card, where they run the same
kernels.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import torch

import s2i_tpu_torch.ops  # noqa: F401  (registers the s2i:: custom ops the program calls)
from s2i_tpu_torch.device import draw_z, resolve_device

FORMAT_VERSION = 1
PROGRAM = "program.pt2"
CHUNK_SEED_STRIDE = 2654435761  # odd, near 2^32 / golden ratio: chunk seeds of adjacent user seeds never meet


def chunk_seed(seed: int, i: int) -> int:
    """The seed of chunk ``i`` of a request seeded with ``seed``:
    ``int32(uint32(seed & 0xFFFFFFFF) + uint32(i) * 2654435761)``, as the
    JAX package derives it. Chunk 0 keeps any int32 seed; ``seed + i``
    would make chunk 1 of seed k reuse chunk 0 of seed k + 1."""
    v = ((int(seed) & 0xFFFFFFFF) + i * CHUNK_SEED_STRIDE) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def export_pipeline(pipe, out_dir: str, batch_sizes: tuple[int, ...] = (1, 8), stage: int = -1,
                    quantize: bool = True) -> dict:
    """Save ``pipe``'s (a ``SpeechToImage``) serve program at ``stage`` on
    its device to ``out_dir``; returns the meta it writes beside it."""
    sizes = sorted({int(b) for b in batch_sizes})
    if not sizes or sizes[0] < 1:
        raise ValueError(f"batch_sizes {batch_sizes}: give one or more sizes >= 1")
    p = pipe.p
    stage %= pipe.branch_num
    output_dtype = "uint8" if quantize else "float32"
    # a batch of 2 traces the batch dimension as a symbol (1 would specialize it)
    example = (torch.zeros((2, p.max_samples), device=pipe.device),
               torch.full((2,), p.max_samples, dtype=torch.int32, device=pipe.device),
               torch.zeros((2, pipe.z_dim), device=pipe.device))
    batch = torch.export.Dim("batch", min=1)
    with torch.no_grad():
        program = torch.export.export(pipe.program(stage, output_dtype), example,
                                      dynamic_shapes=({0: batch},) * 3, strict=False)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, PROGRAM))
    meta = {
        "format_version": FORMAT_VERSION,
        "platforms": [pipe.device.type],
        "batch_sizes": sizes,
        "files": {str(b): PROGRAM for b in sizes},
        "max_samples": int(p.max_samples),
        "sample_rate": int(p.sample_rate),
        # the frame geometry, for the `.p` that serving.Batcher reads
        "max_frames": int(p.max_frames),
        "hop_length": int(p.hop_length),
        "win_length": int(p.win_length),
        "stage": stage,
        "image_size": 64 * 2**stage,
        "output_dtype": output_dtype,
        "z_dim": int(pipe.z_dim),
        "torch_version": torch.__version__,
    }
    if pipe.device.type == "cuda":
        meta["device_name"] = torch.cuda.get_device_name(pipe.device)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def read_meta(path: str) -> dict:
    """An artifact's ``meta.json``, its format version checked."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"artifact format {meta['format_version']} != supported {FORMAT_VERSION}")
    return meta


class LoadedPipeline:
    """A saved artifact with ``SpeechToImage``'s serving surface (``.p``,
    ``.device``, ``generate``, ``generate_async``): a drop-in for
    ``serving.make_server``'s pipeline. Runs on ``device`` (the card unless
    the caller passes "cpu"), which must be of the type the artifact was
    exported on; a CUDA request without a card raises."""

    def __init__(self, path: str, device: str | torch.device = "cuda"):
        self.meta = read_meta(path)
        kind = torch.device(device).type
        if kind not in self.meta["platforms"]:
            raise ValueError(f"artifact exported for {self.meta['platforms']}, asked to run on {kind!r}: "
                             f"re-export on a {kind} device")
        self.device = resolve_device(device)
        try:
            self.program = torch.export.load(os.path.join(path, PROGRAM)).module()
        except Exception as e:  # the saved format is torch's own: name both versions
            raise RuntimeError(f"cannot load {PROGRAM}, exported with torch {self.meta['torch_version']}, "
                               f"into torch {torch.__version__}: {type(e).__name__}: {e}") from e
        self.batch_sizes = sorted(int(b) for b in self.meta["batch_sizes"])
        self.max_samples = int(self.meta["max_samples"])
        self.z_dim = int(self.meta["z_dim"])
        self.p = SimpleNamespace(
            sample_rate=int(self.meta["sample_rate"]),
            max_frames=int(self.meta["max_frames"]),
            hop_length=int(self.meta["hop_length"]),
            win_length=int(self.meta["win_length"]),
            max_samples=self.max_samples,
        )

    def generate(self, wavs, wav_lens=None, seed: int = 0, stage: int = -1, output_dtype: str | None = None,
                 z=None) -> np.ndarray:
        """wavs [B, n] → images on the host; see :meth:`generate_async`."""
        return self.generate_async(wavs, wav_lens, seed, stage, output_dtype, z).cpu().numpy()

    @torch.inference_mode()
    def generate_async(self, wavs, wav_lens=None, seed: int = 0, stage: int = -1,
                       output_dtype: str | None = None, z=None) -> torch.Tensor:
        """wavs [B, n] float32 → images [B, S, S, 3] on the device, once the
        work is queued. The wavs are cut or zero-padded to the exported
        length and the batch to the smallest exported size ≥ B; a larger
        batch runs in chunks of the largest size, chunk i with noise seeded
        :func:`chunk_seed`(seed, i), and the chunks are joined on the device.
        ``z`` [B, Z_DIM] replaces the noise. ``stage`` and ``output_dtype``
        are the artifact's: another value raises."""
        if stage != -1 and stage != int(self.meta["stage"]):
            raise ValueError(f"artifact was exported at stage {self.meta['stage']}; re-export for stage {stage}")
        if output_dtype and output_dtype != self.meta["output_dtype"]:
            raise ValueError(f"artifact emits {self.meta['output_dtype']}; re-export for {output_dtype}")
        wavs = np.asarray(wavs, np.float32)
        b, n = wavs.shape
        lens = np.full(b, n) if wav_lens is None else np.asarray(wav_lens)
        lens = np.minimum(lens, self.max_samples).astype(np.int32)
        if z is not None:
            z = np.asarray(z, np.float32)
            if z.shape != (b, self.z_dim):
                raise ValueError(f"z: expected shape {(b, self.z_dim)}, got {z.shape}")
        fits = [size for size in self.batch_sizes if size >= b]
        size = fits[0] if fits else self.batch_sizes[-1]
        m = min(n, self.max_samples)
        parts = []
        for i, start in enumerate(range(0, b, size)):
            rows = min(size, b - start)
            if rows == size and n == self.max_samples:
                chunk = wavs[start:start + size]  # as it is: no host copy for a full batch at full length
            else:
                chunk = np.zeros((size, self.max_samples), np.float32)
                chunk[:rows, :m] = wavs[start:start + rows, :m]
            chunk_lens = np.full(size, self.max_samples, np.int32)
            chunk_lens[:rows] = lens[start:start + rows]
            if z is None:
                chunk_z = draw_z(chunk_seed(seed, i), size, self.z_dim, self.device)
            else:
                zs = np.zeros((size, self.z_dim), np.float32)
                zs[:rows] = z[start:start + rows]
                chunk_z = torch.from_numpy(zs).to(self.device)
            img = self.program(torch.from_numpy(chunk).to(self.device, non_blocking=True),
                               torch.from_numpy(chunk_lens).to(self.device), chunk_z)
            parts.append(img if rows == size else img[:rows])
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def load(path: str, device: str | torch.device = "cuda") -> LoadedPipeline:
    return LoadedPipeline(path, device)
