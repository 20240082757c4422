"""Log-mel spectrogram: the hand-written CUDA kernel and its plain version.

``logmel(wav, p, n_frames)`` takes a preemphasized, center-padded wav
[B, n_samples] (float32) and returns ``log(mel + offset)`` for its first
``n_frames`` frames, [B, n_frames, n_mels]. A CUDA tensor goes through
``csrc/mel_fused.cu``; a CPU tensor through :func:`logmel_plain`, the same
function in plain PyTorch. Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

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
