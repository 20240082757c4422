"""Log-mel frontend: wav [B, n] → (features [B, max_frames, n_mels], mask).

Frames of ``win`` samples every ``hop``, no centering, a periodic Hann
window, the power of an ``n_fft``-point real DFT (as two float32 products
against window-folded cosine and sine tables), a Slaney mel filterbank
with area normalization, ``log(mel + offset)``, a crop or zero pad to
``max_frames``, the frames whose window fits the utterance marked valid,
and a per-utterance mean and variance normalization over the valid frames.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from reference import precision


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3.0)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), m * (200.0 / 3.0))


@functools.lru_cache(maxsize=4)
def tables(sample_rate: int, win: int, n_fft: int, n_mels: int, fmin: float, fmax: float):
    """(cos [win, bins], sin [win, bins], mel filterbank [n_mels, bins]) in float64."""
    n = np.arange(win)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win))
    bins = n_fft // 2 + 1
    ang = 2.0 * np.pi * n[:, None] * np.arange(bins)[None, :] / n_fft
    cos, sin = np.cos(ang) * window[:, None], np.sin(ang) * window[:, None]
    freqs = np.linspace(0.0, sample_rate / 2.0, bins)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, bins))
    for i in range(n_mels):
        lower = (freqs - hz[i]) / max(hz[i + 1] - hz[i], 1e-10)
        upper = (hz[i + 2] - freqs) / max(hz[i + 2] - hz[i + 1], 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(lower, upper)) * 2.0 / (hz[i + 2] - hz[i])
    return cos, sin, fb


def geometry(audio: dict) -> dict:
    sr = int(audio["SAMPLE_RATE"])
    return dict(sample_rate=sr, win=int(round(sr * float(audio["WIN_MS"]) / 1000.0)),
                hop=int(round(sr * float(audio["HOP_MS"]) / 1000.0)), n_fft=int(audio["N_FFT"]),
                n_mels=int(audio["N_MELS"]), fmin=float(audio["FMIN"]), fmax=float(audio["FMAX"]),
                offset=float(audio["LOG_OFFSET"]), max_frames=int(audio["MAX_FRAMES"]))


def check_supported(audio: dict) -> None:
    """The reference covers the frontend the configurations state."""
    want = {"HTK_MEL": False, "MEL_NORM": "slaney", "NORMALIZE": "utterance", "FEATURE": "logmel",
            "PREEMPHASIS": 0.0, "CENTER": False}
    for k, v in want.items():
        if audio[k] != v:
            raise ValueError(f"the reference frontend takes AUDIO.{k}={v!r}, not {audio[k]!r}")


def logmel(wav: torch.Tensor, g: dict, n_frames: int) -> torch.Tensor:
    """log(mel power + offset) of the first ``n_frames`` frames: [B, n_frames, n_mels]."""
    cos, sin, fb = (torch.as_tensor(t, dtype=torch.float32, device=wav.device)
                    for t in tables(g["sample_rate"], g["win"], g["n_fft"], g["n_mels"], g["fmin"], g["fmax"]))
    frames = precision.f32(wav.unfold(-1, g["win"], g["hop"])[:, :n_frames])
    re, im = frames @ precision.f32(cos), frames @ precision.f32(sin)
    mel = precision.f32(re * re + im * im) @ precision.f32(fb.T)
    return torch.log(mel + g["offset"])


def features(wav: torch.Tensor, wav_len: torch.Tensor, g: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(normalized features [B, max_frames, n_mels], valid-frame mask [B, max_frames])."""
    b, n = wav.shape
    avail = max(0, 1 + (n - g["win"]) // g["hop"])
    if avail <= 0:
        raise ValueError("signal shorter than one window")
    f = logmel(wav.float(), g, min(avail, g["max_frames"]))
    t = g["max_frames"]
    f = torch.nn.functional.pad(f, (0, 0, 0, t - f.shape[1]))
    idx = torch.arange(t, device=wav.device)
    mask = (idx[None, :] < avail) & (idx[None, :] * g["hop"] + g["win"] <= wav_len.to(wav.device)[:, None])
    m = mask[..., None].float()
    denom = m.sum(dim=(1, 2), keepdim=True).clamp(min=1.0) * f.shape[-1]
    mean = (f * m).sum(dim=(1, 2), keepdim=True) / denom
    var = ((f - mean).square() * m).sum(dim=(1, 2), keepdim=True) / denom
    return (f - mean) * torch.rsqrt(var + 1e-8) * m, mask
