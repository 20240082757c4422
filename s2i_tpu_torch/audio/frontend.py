"""Audio frontend: wav → log-mel / MFCC, the counterpart of
``s2i_tpu/audio/frontend.py``.

  wav [B, n_samples]
  → (optional pre-emphasis) → (optional center reflect-pad)
  → log-mel of every frame    (ops.mel_kernel: the CUDA kernel on the card)
  → (optional DCT-II → MFCC)
  → crop/pad to MAX_FRAMES, valid-frame mask
  → per-utterance mean/var normalization over the valid frames

There is no probe and no fallback to a second formulation, unlike the TPU
path. The log-mel kernel's FFT branch (n_fft a power of two, 128..2048)
stages each tile's span of samples, twice (double buffered), in one block's
shared memory beside its constant table, FFT buffers and output rows; the
span grows with the hop (a tile of n_fft 2048 is 4 frames: 3 hops and a
window). A geometry whose need passes the card's per-block shared-memory
opt-in (227 KB on an H100; n_fft 2048 from a hop of about 4 600 samples)
raises, and the error names the geometry, the bytes it needed and the
card's limit. No cfg comes near it.

    feats, mask = extract_features(wav, p, wav_len)          # [B, F, D], [B, F]
    batch = featurize({"wav", "wav_len", ...}, p)             # the same in a batch dict
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from s2i_tpu_torch.audio import filters
from s2i_tpu_torch.device import resolve_device
from s2i_tpu_torch.ops import mel_kernel
from s2i_tpu_torch.utils.logging import span


@dataclasses.dataclass(frozen=True)
class FrontendParams:
    """Static frontend config + precomputed constant matrices (host numpy,
    float32). Hash and equality cover the scalar config only."""

    sample_rate: int = 16000
    win_length: int = 400  # 25 ms @ 16 kHz
    hop_length: int = 160  # 10 ms @ 16 kHz
    n_fft: int = 512
    n_mels: int = 40
    fmin: float = 0.0
    fmax: float = 8000.0
    htk_mel: bool = False
    mel_norm: str = "slaney"
    log_offset: float = 1e-6
    max_frames: int = 1024
    normalize: str = "utterance"
    feature: str = "logmel"
    n_mfcc: int = 40
    preemphasis: float = 0.0
    center: bool = False

    dft_cos: np.ndarray = dataclasses.field(default=None, repr=False, compare=False)
    dft_sin: np.ndarray = dataclasses.field(default=None, repr=False, compare=False)
    mel_fb: np.ndarray = dataclasses.field(default=None, repr=False, compare=False)
    dct: np.ndarray = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.win_length > self.n_fft:
            # truncating the frame would time-alias the DFT
            raise ValueError(
                f"win_length={self.win_length} > n_fft={self.n_fft}: raise "
                "AUDIO.N_FFT to the next power of two >= the window"
            )
        c, s = filters.windowed_dft_matrices(self.win_length, self.n_fft)
        fb = filters.mel_filterbank(
            self.sample_rate,
            self.n_fft,
            self.n_mels,
            self.fmin,
            self.fmax,
            htk=self.htk_mel,
            norm=self.mel_norm,
        )
        d = filters.dct_matrix(self.n_mfcc, self.n_mels)
        object.__setattr__(self, "dft_cos", c.astype(np.float32))
        object.__setattr__(self, "dft_sin", s.astype(np.float32))
        object.__setattr__(self, "mel_fb", fb.astype(np.float32))
        object.__setattr__(self, "dct", d.astype(np.float32))

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def max_samples(self) -> int:
        """Samples that fill exactly ``max_frames`` frames (no center pad)."""
        return (self.max_frames - 1) * self.hop_length + self.win_length


def frontend_params_from_cfg(audio_cfg: Any) -> FrontendParams:
    """Build FrontendParams from a cfg.AUDIO block (reference-style keys)."""
    sr = int(audio_cfg.SAMPLE_RATE)
    return FrontendParams(
        sample_rate=sr,
        win_length=int(round(sr * float(audio_cfg.WIN_MS) / 1000.0)),
        hop_length=int(round(sr * float(audio_cfg.HOP_MS) / 1000.0)),
        n_fft=int(audio_cfg.N_FFT),
        n_mels=int(audio_cfg.N_MELS),
        fmin=float(audio_cfg.FMIN),
        fmax=float(audio_cfg.FMAX),
        htk_mel=bool(audio_cfg.HTK_MEL),
        mel_norm=str(audio_cfg.MEL_NORM),
        log_offset=float(audio_cfg.LOG_OFFSET),
        max_frames=int(audio_cfg.MAX_FRAMES),
        normalize=str(audio_cfg.NORMALIZE),
        feature=str(audio_cfg.FEATURE),
        n_mfcc=int(audio_cfg.N_MFCC),
        preemphasis=float(audio_cfg.PREEMPHASIS),
        center=bool(audio_cfg.CENTER),
    )


def preemphasize(wav: torch.Tensor, coeff: float) -> torch.Tensor:
    if coeff == 0.0:
        return wav
    return torch.cat([wav[..., :1], wav[..., 1:] - coeff * wav[..., :-1]], dim=-1)


def center_pad(wav: torch.Tensor, p: FrontendParams) -> torch.Tensor:
    """Reflect-pad ``win_length // 2`` samples on both sides (center mode)."""
    if not p.center:
        return wav
    pad = p.win_length // 2
    return F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]


def crop_or_pad_frames(
    feats: torch.Tensor, max_frames: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-length crop/pad along the frame axis (-2): (features
    [B, max_frames, D], mask [B, max_frames] of real frames)."""
    b, n, _ = feats.shape
    mask = torch.arange(max_frames, device=feats.device) < n
    if n >= max_frames:
        feats = feats[:, :max_frames]
    else:
        feats = F.pad(feats, (0, 0, 0, max_frames - n))
    return feats, mask.expand(b, max_frames)


def frames_valid_mask(
    wav_len: torch.Tensor, p: FrontendParams, max_frames: int
) -> torch.Tensor:
    """[B, max_frames]: frame i is real iff its window fits inside the signal
    as framed, including the reflect padding in center mode."""
    idx = torch.arange(max_frames, device=wav_len.device)
    eff_len = wav_len + (2 * (p.win_length // 2) if p.center else 0)
    return idx[None, :] * p.hop_length + p.win_length <= eff_len[:, None]


def normalize_features(
    feats: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """Per-utterance mean/variance normalization over the valid frames'
    (frames, features); padding frames come out as 0."""
    m = mask[..., None].to(feats.dtype)
    denom = torch.clamp(m.sum(dim=(-2, -1), keepdim=True), min=1.0) * feats.shape[-1]
    mean = (feats * m).sum(dim=(-2, -1), keepdim=True) / denom
    var = ((feats - mean).square() * m).sum(dim=(-2, -1), keepdim=True) / denom
    return (feats - mean) * torch.rsqrt(var + eps) * m


def extract_features(
    wav,
    p: FrontendParams,
    wav_len=None,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """wav [B, n_samples] (numpy or tensor) → (feats [B, max_frames, D],
    mask [B, max_frames]) on ``device``. ``wav_len`` (samples per utterance
    of a zero-padded batch) tightens the mask so padding frames are left
    out of the normalization and of the encoder's pooling."""
    dev = resolve_device(device)
    wav = torch.as_tensor(wav, dtype=torch.float32, device=dev)
    if wav.ndim != 2:
        raise ValueError(f"expect [batch, n_samples], got {tuple(wav.shape)}")
    wav = center_pad(preemphasize(wav, p.preemphasis), p)
    available = mel_kernel.num_frames(wav.shape[1], p)
    if available <= 0:
        raise ValueError("signal shorter than one window")
    # frames past max_frames would be cropped: the kernel never computes them
    feats = mel_kernel.logmel(wav, p, min(available, p.max_frames))
    if p.feature == "mfcc":
        feats = feats @ torch.as_tensor(p.dct, device=dev).T
    feats, mask = crop_or_pad_frames(feats, p.max_frames)
    if wav_len is not None:
        wav_len = torch.as_tensor(wav_len, device=dev)
        mask = mask & frames_valid_mask(wav_len, p, p.max_frames)
    if p.normalize == "utterance":
        feats = normalize_features(feats, mask)
    return feats, mask


def featurize(raw: dict, p: FrontendParams, device: str | torch.device = "cuda") -> dict:
    """A wav batch ``{"wav" [B, n], "wav_len" [B], ...}`` → the same batch
    with ``feats`` / ``feat_mask`` computed on ``device`` in place of the
    wav (for the encoder: ``{"feats", "feat_mask", "teacher", "class_id"}``).
    Host span ``audio.featurize``."""
    with span("audio.featurize"):
        feats, mask = extract_features(raw["wav"], p, wav_len=raw["wav_len"], device=device)
    rest = {k: v for k, v in raw.items() if k not in ("wav", "wav_len")}
    return {"feats": feats, "feat_mask": mask, **rest}
