"""K1, ``s2i::logmel`` (``csrc/mel_fused.cu``): the log-mel of every frame of
a [B, n] batch. The work its shapes need, whatever computes it, at the
float32 peak: per frame the window (win products), a real FFT of n_fft
points (2.5 · n_fft · log2 n_fft), the power (3 a bin), the mel projection
(2 per non-zero filterbank weight) and the log of mel + offset (2 a mel).
Bytes: the framed samples read once, the [B, frames, n_mels] float32 output
written once, the filterbank read once."""

from __future__ import annotations

import math

import numpy as np

from roofline import shapes

PATTERNS = ("mel_fused_fft_kernel", "mel_fused_dft_kernel")
PEAK = "fp32_flops"


def filterbank_nonzeros(g: dict) -> int:
    from reference.audio import tables

    return int(np.count_nonzero(tables(g["sample_rate"], g["win"], g["n_fft"], g["n_mels"], g["fmin"], g["fmax"])[2]))


def cost(cfg: dict, rec: dict):
    if not rec.get("logmel"):
        return None
    b, n = rec["logmel"]
    g = shapes.frame_geometry(cfg)
    f = shapes.frames(n, g)
    bins = g["n_fft"] // 2 + 1
    nnz = filterbank_nonzeros(g)
    per_frame = g["win"] + 2.5 * g["n_fft"] * math.log2(g["n_fft"]) + 3 * bins + 2 * nnz + 2 * g["n_mels"]
    read = min(n, (f - 1) * g["hop"] + g["win"]) if f else 0
    return b * f * per_frame, 4.0 * (b * read + b * f * g["n_mels"] + nnz)
