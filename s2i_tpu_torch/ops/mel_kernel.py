"""Log-mel spectrogram: the hand-written CUDA kernels and their plain
versions.

``logmel(wav, p, n_frames)`` takes a preemphasized, center-padded wav
[B, n_samples] (float32) and returns ``log(mel + offset)`` for its first
``n_frames`` frames, [B, n_frames, n_mels]. A CUDA tensor goes through
``csrc/mel_fused.cu`` (K1); a CPU tensor through :func:`logmel_plain`, the
same function in plain PyTorch. Nothing falls back from one to the other.

``logmel_framed(wav, p)`` is the counterpart of the JAX package's
``logmel_pallas``: the same function computed from frame rows that a gather
cut out first (:func:`frame_rows`, a PyTorch op, as the JAX package leaves
it to XLA), then ``logmel_frames`` on them: ``csrc/mel_framed.cu`` (K4) for a
CUDA tensor, :func:`logmel_framed_plain` for a CPU tensor. The frontend
does not select it; it serves the frontend A/B.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from s2i_tpu_torch.ops import build


def num_frames(n_samples: int, p) -> int:
    """Frames of a signal of ``n_samples`` (already center-padded)."""
    return max(0, 1 + (n_samples - p.win_length) // p.hop_length)


def logmel_plain(wav: torch.Tensor, p, n_frames: int) -> torch.Tensor:
    """Plain PyTorch log-mel: frame, windowed-DFT power, mel, log."""
    frames = wav.unfold(-1, p.win_length, p.hop_length)[:, :n_frames]
    cos = torch.as_tensor(p.dft_cos, device=wav.device)
    sin = torch.as_tensor(p.dft_sin, device=wav.device)
    re = frames @ cos
    im = frames @ sin
    power = re * re + im * im
    mel = power @ torch.as_tensor(p.mel_fb, device=wav.device).T
    return torch.log(mel + p.log_offset)


@functools.lru_cache(maxsize=8)
def _tables(p, device: torch.device) -> tuple[torch.Tensor, ...]:
    """cos/sin tables with their rows zero-padded to a multiple of 4 (the
    kernel's 16-byte path), and the transposed filterbank, on ``device``."""
    rows = -(-p.win_length // 4) * 4
    cos = np.zeros((rows, p.n_bins), np.float32)
    sin = np.zeros((rows, p.n_bins), np.float32)
    cos[: p.win_length] = p.dft_cos
    sin[: p.win_length] = p.dft_sin
    mel_t = np.ascontiguousarray(p.mel_fb.T)
    return tuple(torch.from_numpy(a).to(device) for a in (cos, sin, mel_t))


def _lib() -> ctypes.CDLL:
    lib = build.load("mel_fused")
    if lib.s2i_mel_fused.argtypes is None:
        lib.s2i_mel_fused.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p,
        ]
        lib.s2i_mel_fused.restype = ctypes.c_int
        lib.s2i_mel_fused_error_string.argtypes = [ctypes.c_int]
        lib.s2i_mel_fused_error_string.restype = ctypes.c_char_p
    return lib


def logmel(wav: torch.Tensor, p, n_frames: int) -> torch.Tensor:
    """[B, n_samples] float32 → [B, n_frames, n_mels]: the kernel for a CUDA
    tensor, :func:`logmel_plain` for a CPU tensor."""
    if wav.ndim != 2 or wav.dtype != torch.float32:
        raise ValueError(f"expect float32 [batch, n_samples], got {wav.dtype} {tuple(wav.shape)}")
    if not 0 < n_frames <= num_frames(wav.shape[1], p):
        raise ValueError(
            f"n_frames={n_frames} not in 1..{num_frames(wav.shape[1], p)} "
            f"for {wav.shape[1]} samples"
        )
    if wav.device.type == "cpu":
        return logmel_plain(wav, p, n_frames)
    if wav.device.type != "cuda":
        raise ValueError(f"unsupported device {wav.device}")
    wav = wav.contiguous()
    cos, sin, mel_t = _tables(p, wav.device)
    out = torch.empty((wav.shape[0], n_frames, p.n_mels), device=wav.device)
    lib = _lib()
    err = lib.s2i_mel_fused(
        wav.data_ptr(), wav.shape[0], wav.shape[1],
        cos.data_ptr(), sin.data_ptr(), mel_t.data_ptr(), out.data_ptr(),
        n_frames, p.hop_length, cos.shape[0], p.n_bins, p.n_mels,
        p.log_offset, torch.cuda.current_stream(wav.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"mel_fused kernel: {lib.s2i_mel_fused_error_string(err).decode()}"
        )
    logmel.launches += 1
    return out


logmel.launches = 0  # kernel launches since the last reset


def frame_rows(wav: torch.Tensor, p, n_frames: int) -> torch.Tensor:
    """[B, n_samples] → [B·n_frames, n_fft] contiguous: frame f of utterance
    b is the ``n_fft`` samples from ``f·hop``, the tail padded with
    ``n_fft − win_length`` zeros so that the last frame's span exists (the
    DFT tables are zero past the window, so those samples never count)."""
    b = wav.shape[0]
    wav = F.pad(wav, (0, max(0, p.n_fft - p.win_length)))
    frames = wav.unfold(-1, p.n_fft, p.hop_length)[:, :n_frames]
    return frames.reshape(b * n_frames, p.n_fft).contiguous()


def logmel_framed_plain(frames: torch.Tensor, p) -> torch.Tensor:
    """Plain PyTorch log-mel of frame rows [R, n_fft] → [R, n_mels]."""
    x = frames[:, : p.win_length]
    cos = torch.as_tensor(p.dft_cos, device=frames.device)
    sin = torch.as_tensor(p.dft_sin, device=frames.device)
    re = x @ cos
    im = x @ sin
    mel = (re * re + im * im) @ torch.as_tensor(p.mel_fb, device=frames.device).T
    return torch.log(mel + p.log_offset)


def _framed_lib() -> ctypes.CDLL:
    lib = build.load("mel_framed")
    if lib.s2i_mel_framed.argtypes is None:
        lib.s2i_mel_framed.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.s2i_mel_framed.restype = ctypes.c_int
        lib.s2i_mel_framed_error_string.argtypes = [ctypes.c_int]
        lib.s2i_mel_framed_error_string.restype = ctypes.c_char_p
    return lib


def logmel_frames(frames: torch.Tensor, p) -> torch.Tensor:
    """Frame rows [R, n_fft] float32 → [R, n_mels]: the kernel K4 for a CUDA
    tensor, :func:`logmel_framed_plain` for a CPU tensor."""
    if frames.ndim != 2 or frames.dtype != torch.float32 or frames.shape[1] != p.n_fft:
        raise ValueError(
            f"expect float32 [rows, n_fft={p.n_fft}], got {frames.dtype} {tuple(frames.shape)}"
        )
    if frames.shape[0] == 0:
        raise ValueError("no frame rows")
    if frames.device.type == "cpu":
        return logmel_framed_plain(frames, p)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    frames = frames.contiguous()
    cos, sin, mel_t = _tables(p, frames.device)
    out = torch.empty((frames.shape[0], p.n_mels), device=frames.device)
    lib = _framed_lib()
    err = lib.s2i_mel_framed(
        frames.data_ptr(), frames.shape[0], frames.shape[1],
        cos.data_ptr(), sin.data_ptr(), mel_t.data_ptr(), out.data_ptr(),
        cos.shape[0], p.n_bins, p.n_mels, p.log_offset,
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"mel_framed kernel: {lib.s2i_mel_framed_error_string(err).decode()}"
        )
    logmel_frames.launches += 1
    return out


logmel_frames.launches = 0  # kernel launches since the last reset


def logmel_framed(wav: torch.Tensor, p) -> torch.Tensor:
    """wav [B, n_samples] float32 → log-mel [B, n_frames, n_mels] of every
    frame, as the JAX package's ``logmel_pallas``: preemphasis, the center
    reflect-pad, :func:`frame_rows`, then :func:`logmel_frames`."""
    from s2i_tpu_torch.audio.frontend import center_pad, preemphasize  # imports this module

    if wav.ndim != 2 or wav.dtype != torch.float32:
        raise ValueError(f"expect float32 [batch, n_samples], got {wav.dtype} {tuple(wav.shape)}")
    wav = center_pad(preemphasize(wav, p.preemphasis), p)
    n_frames = num_frames(wav.shape[1], p)
    if n_frames <= 0:
        raise ValueError("signal shorter than one window")
    out = logmel_frames(frame_rows(wav, p, n_frames), p)
    return out.reshape(wav.shape[0], n_frames, p.n_mels)
