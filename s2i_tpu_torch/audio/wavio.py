"""Minimal WAV reading (PCM16/PCM8/PCM24/PCM32) via the stdlib ``wave``
module + numpy: the port's own copy of ``s2i_tpu/audio/wavio.py``. The only
thing the reference used librosa's IO for is loading 16 kHz mono speech
captions, so librosa/soundfile are not dependencies.

Format note: stdlib ``wave`` only opens WAVE_FORMAT_PCM (integer) files and
raises ``wave.Error: unknown format: 3`` on IEEE-float WAVs, so a 4-byte
sample width here is ALWAYS int32 PCM — decoding it as float32 (the round-2
behavior) silently turned int32 samples into ~1e-40 denormals, i.e. silence.
"""

from __future__ import annotations

import wave
from typing import IO

import numpy as np


def read_wav(path: str | IO[bytes]) -> tuple[np.ndarray, int]:
    """Returns (mono float32 samples in [-1, 1], sample_rate).

    ``path`` may be a filename or a binary file-like object (the serving
    layer passes ``io.BytesIO`` of the request body).
    """
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        # int32 PCM: `wave` rejects IEEE-float files (format tag 3), so a
        # 4-byte width can only be WAVE_FORMAT_PCM int32 (see module note)
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        # int24 PCM: widen each 3-byte little-endian sample to int32
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        i32 = (i32 << 8) >> 8  # sign-extend bit 23
        x = i32.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono PCM16 (test fixtures / synthesis hook output)."""
    x = np.clip(np.asarray(samples, dtype=np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Cheap linear resampling for off-rate wavs (host-side).

    The sample grid is uniform, so a direct floor/lerp in float32 stands
    in for the general-grid ``np.interp``. An off-rate corpus should be
    resampled offline once rather than per request.
    """
    if sr_in == sr_out:
        return x
    x = np.asarray(x, dtype=np.float32)
    n_out = int(round(len(x) * sr_out / sr_in))
    t = np.linspace(0.0, len(x) - 1.0, n_out)
    idx = t.astype(np.int64)  # == floor(t): t is non-negative
    frac = (t - idx).astype(np.float32)
    idx1 = np.minimum(idx + 1, len(x) - 1)
    return (1.0 - frac) * x[idx] + frac * x[idx1]
