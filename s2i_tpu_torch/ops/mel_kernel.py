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

Both kernels have two branches, chosen by shape only (:func:`kernel_branch`):
``"fft"`` for n_fft a power of two from 128 to 2048 (a shared-memory real
FFT and a sparse mel projection, ``csrc/mel_common.cuh``, fed by the packed
constants of :func:`fft_table`), ``"dft"`` for any other n_fft (the dense
windowed DFT, fed by :func:`_tables`). Each wrapper's ``branch`` attribute
names the branch of its last launch; ``launches`` counts its kernel launches.

Both wrappers call ``torch.library`` custom ops, ``s2i::logmel`` and
``s2i::logmel_frames``, so that ``torch.export`` carries the kernels into a
saved program (``s2i_tpu_torch/export.py``). An op takes the frame
geometry as scalars (:func:`geometry`), since a schema cannot take
``FrontendParams``; its CUDA registration checks the arguments and
launches the kernel, its CPU registration checks them and runs the plain
version, and its fake registration gives the output's shape for tracing.
The dispatcher picks the registration by the tensor's device.

The ops (these and the GRU's) are defined on a ``torch.library.Library``
with one kernel per dispatch key, not with ``torch.library.custom_op``,
whose per-call wrappers (an output aliasing check, a dynamo guard) added
tens of microseconds of host time to each call on an H100 machine, where
the serve batch waits on the host (``tools_torch/serve_ab.py``, PERF.md).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from s2i_tpu_torch.audio import filters
from s2i_tpu_torch.ops import build
from s2i_tpu_torch.ops.counted import counted


def num_frames(n_samples: int, p) -> int:
    """Frames of a signal of ``n_samples`` (already center-padded)."""
    return max(0, 1 + (n_samples - p.win_length) // p.hop_length)


def geometry(p) -> tuple:
    """The fields of ``p`` (``FrontendParams``) that the log-mel kernels
    read, in the order the custom ops take them."""
    return (int(p.sample_rate), int(p.win_length), int(p.hop_length), int(p.n_fft), int(p.n_mels),
            float(p.fmin), float(p.fmax), bool(p.htk_mel), str(p.mel_norm), float(p.log_offset))


@functools.lru_cache(maxsize=8)
def _params(sample_rate, win_length, hop_length, n_fft, n_mels, fmin, fmax, htk_mel, mel_norm, log_offset):
    """The ``FrontendParams`` of a geometry (:func:`geometry`): its tables
    depend on these fields alone."""
    from s2i_tpu_torch.audio.frontend import FrontendParams  # imports this module

    return FrontendParams(sample_rate=sample_rate, win_length=win_length, hop_length=hop_length, n_fft=n_fft,
                          n_mels=n_mels, fmin=fmin, fmax=fmax, htk_mel=htk_mel, mel_norm=mel_norm,
                          log_offset=log_offset)


# The ops' definitions; their registrations last as long as this object.
_LIB = torch.library.Library("s2i", "FRAGMENT")
_GEOMETRY = ("int sample_rate, int win_length, int hop_length, int n_fft, int n_mels, float fmin, float fmax, "
             "bool htk_mel, str mel_norm, float log_offset")  # the order of geometry()
_LIB.define(f"logmel(Tensor wav, int n_frames, {_GEOMETRY}) -> Tensor")
_LIB.define(f"logmel_frames(Tensor frames, {_GEOMETRY}) -> Tensor")


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


FFT_SIZES = tuple(2**k for k in range(7, 12))  # n_fft of the FFT branch: 128 .. 2048
_HEADER_BYTES = 32  # the packed table's int32 words ahead of its regions


def kernel_branch(p) -> str:
    """The kernels' branch for ``p``'s geometry: "fft" or "dft"."""
    return "fft" if p.n_fft in FFT_SIZES else "dft"


def mel_runs(mel_fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) per filter: the run [lo, hi) from its first to its last
    non-zero weight; lo == hi for an empty filter."""
    lo = np.zeros(len(mel_fb), np.int32)
    hi = np.zeros(len(mel_fb), np.int32)
    for m, row in enumerate(mel_fb):
        nz = np.flatnonzero(row)
        if nz.size:
            lo[m], hi[m] = nz[0], nz[-1] + 1
    return lo, hi


def fft_radices(m: int) -> list[int]:
    """The radices of the kernels' M-point Stockham FFT, in stage order:
    8 while three bits remain, then 4 or 2 (256 = 8·8·4)."""
    bits = m.bit_length() - 1
    return [8] * (bits // 3) + {0: [], 1: [2], 2: [4]}[bits % 3]


@functools.lru_cache(maxsize=8)
def fft_constants(p) -> dict[str, np.ndarray]:
    """The FFT branch's constants, float64 or complex128 (M = n_fft/2):

    - ``window`` [win];
    - ``tw``: each stage's twiddles after the first, end to end: a stage of
      radix R after stages whose radices multiply to ns has
      ``W^(r·k)``, W = exp(-2πi/(ns·R)), at [(r-1)·ns + k], r = 1..R-1,
      k = 0..ns-1;
    - ``split`` [M/2+1]: A_k = (1 - i W^k)/2, W = exp(-2πi/n_fft). Bin k of
      the real frame x is ``A_k Z[k] + B_k conj(Z[M-k])`` with
      B_k = 1 - A_k, where Z is the M-point FFT of z[n] = x[2n] + i x[2n+1]
      (Z[M] = Z[0]); for k > M/2, A_k = conj(A_{M-k});
    - the mel runs (``mel_runs``) and their weights, ``p.mel_fb``'s float32
      values laid end to end (``mel_w``)."""
    m = p.n_fft // 2
    tw, ns = [], 1
    for radix in fft_radices(m)[1:]:
        ns *= 8  # every stage but the last is radix 8
        r, k = np.meshgrid(np.arange(1, radix), np.arange(ns), indexing="ij")
        tw.append(np.exp(-2j * np.pi * r * k / (ns * radix)).ravel())
    lo, hi = mel_runs(p.mel_fb)
    return {
        "window": filters.hann_window(p.win_length),
        "tw": np.concatenate(tw),
        "split": (1 - 1j * np.exp(-2j * np.pi * np.arange(m // 2 + 1) / p.n_fft)) / 2,
        "mel_lo": lo,
        "mel_hi": hi,
        "mel_w": np.concatenate([p.mel_fb[i, lo[i]:hi[i]] for i in range(p.n_mels)]).astype(np.float32),
    }


def fft_table(p) -> np.ndarray:
    """:func:`fft_constants` packed in one byte buffer that a block copies
    into shared memory whole: a header of 8 int32 words (total bytes, then
    the byte offsets of the regions, as csrc/mel_common.cuh's ``Header``
    names them), then the split factors (complex128), the twiddles
    (complex128), the window as float64 pairs (w[2n], w[2n+1]) (zero past an
    odd window), the mel weights (float32) and the runs as int32 triples
    (lo, hi, offset of the filter's first weight), each region starting at a
    multiple of 16 bytes."""
    c = fft_constants(p)
    window = np.zeros(-(-p.win_length // 2) * 2)
    window[: p.win_length] = c["window"]
    starts = np.concatenate([[0], np.cumsum(c["mel_hi"] - c["mel_lo"])[:-1]])
    regions = [
        c["split"].astype(np.complex128),
        c["tw"].astype(np.complex128),
        window,
        c["mel_w"],
        np.stack([c["mel_lo"], c["mel_hi"], starts], axis=1).astype(np.int32).ravel(),
    ]
    offsets, end = [], _HEADER_BYTES
    for r in regions:
        offsets.append(end)
        end += -(-r.nbytes // 16) * 16
    table = np.zeros(end, np.uint8)
    for off, r in zip(offsets, regions):
        table[off:off + r.nbytes] = r.view(np.uint8)
    table[:24] = np.array([end, *offsets], np.int32).view(np.uint8)
    return table


@functools.lru_cache(maxsize=8)
def _fft_table(p, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(fft_table(p)).to(device)


def _lib() -> ctypes.CDLL:
    lib = build.load("mel_fused")
    if lib.s2i_mel_fused_fft.argtypes is None:
        lib.s2i_mel_fused_fft.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.s2i_mel_fused_fft.restype = ctypes.c_int
        lib.s2i_mel_fused_dft.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p,
        ]
        lib.s2i_mel_fused_dft.restype = ctypes.c_int
        lib.s2i_mel_fused_smem.argtypes = [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
        lib.s2i_mel_fused_smem.restype = ctypes.c_int
        lib.s2i_mel_fused_error_string.argtypes = [ctypes.c_int]
        lib.s2i_mel_fused_error_string.restype = ctypes.c_char_p
    return lib


def _check_smem(lib: ctypes.CDLL, p, branch: str, table_bytes: int, win: int) -> None:
    """Raise, naming the geometry, when a block of K1 at ``p`` needs more
    shared memory than the card lets a block opt in to (the kernel's span
    slots grow with the hop). ``win``: the window, or the DFT tables' padded
    rows."""
    need, limit = ctypes.c_longlong(), ctypes.c_int()
    err = lib.s2i_mel_fused_smem(table_bytes, p.hop_length, win, p.n_fft, p.n_bins, p.n_mels,
                                 ctypes.byref(need), ctypes.byref(limit))
    if err:
        raise RuntimeError(f"mel_fused kernel ({branch}): {lib.s2i_mel_fused_error_string(err).decode()}")
    if need.value > limit.value:
        raise RuntimeError(
            f"mel_fused kernel ({branch}): n_fft {p.n_fft}, win_length {p.win_length}, hop_length "
            f"{p.hop_length}, n_mels {p.n_mels} needs {need.value} bytes of shared memory per block; "
            f"this card lets a block have {limit.value}"
        )


def _check_wav(wav: torch.Tensor, p, n_frames: int) -> None:
    if wav.ndim != 2 or wav.dtype != torch.float32:
        raise ValueError(f"expect float32 [batch, n_samples], got {wav.dtype} {tuple(wav.shape)}")
    if not 0 < n_frames <= num_frames(wav.shape[1], p):
        raise ValueError(
            f"n_frames={n_frames} not in 1..{num_frames(wav.shape[1], p)} "
            f"for {wav.shape[1]} samples"
        )


def logmel(wav: torch.Tensor, p, n_frames: int) -> torch.Tensor:
    """[B, n_samples] float32 → [B, n_frames, n_mels] through
    ``s2i::logmel``: the kernel for a CUDA tensor, :func:`logmel_plain` for
    a CPU tensor. The op's registrations check the arguments."""
    return torch.ops.s2i.logmel(wav, n_frames, *geometry(p))


def _logmel_cpu(wav, n_frames, *geom):
    p = _params(*geom)
    _check_wav(wav, p, n_frames)
    return logmel_plain(wav, p, n_frames)


def _logmel_cuda(wav, n_frames, *geom):
    """K1: one launch for the batch."""
    p = _params(*geom)
    _check_wav(wav, p, n_frames)
    wav = wav.contiguous()
    out = torch.empty((wav.shape[0], n_frames, p.n_mels), device=wav.device)
    stream = torch.cuda.current_stream(wav.device).cuda_stream
    lib = _lib()
    branch = kernel_branch(p)
    if branch == "fft":
        table = _fft_table(p, wav.device)
        _check_smem(lib, p, branch, table.numel(), p.win_length)
        err = lib.s2i_mel_fused_fft(
            wav.data_ptr(), wav.shape[0], wav.shape[1], table.data_ptr(), table.numel(),
            out.data_ptr(), n_frames, p.hop_length, p.win_length, p.n_fft, p.n_mels,
            p.log_offset, stream,
        )
    else:
        cos, sin, mel_t = _tables(p, wav.device)
        _check_smem(lib, p, branch, 0, cos.shape[0])
        err = lib.s2i_mel_fused_dft(
            wav.data_ptr(), wav.shape[0], wav.shape[1],
            cos.data_ptr(), sin.data_ptr(), mel_t.data_ptr(), out.data_ptr(),
            n_frames, p.hop_length, cos.shape[0], p.n_bins, p.n_mels,
            p.log_offset, stream,
        )
    if err:
        raise RuntimeError(
            f"mel_fused kernel ({branch}): {lib.s2i_mel_fused_error_string(err).decode()}"
        )
    logmel.launches += 1
    logmel.branch = branch
    return out


_LIB.impl("logmel", _logmel_cpu, "CPU")
_LIB.impl("logmel", _logmel_cuda, "CUDA")


@torch.library.register_fake("s2i::logmel", lib=_LIB)
def _logmel_fake(wav, n_frames, sample_rate, win_length, hop_length, n_fft, n_mels, *rest):
    return wav.new_empty((wav.shape[0], n_frames, n_mels))


counted(logmel)  # K1 launches
logmel.branch = None  # "fft" or "dft": the branch of the last launch


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
    if lib.s2i_mel_framed_fft.argtypes is None:
        lib.s2i_mel_framed_fft.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.s2i_mel_framed_fft.restype = ctypes.c_int
        lib.s2i_mel_framed_dft.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.s2i_mel_framed_dft.restype = ctypes.c_int
        lib.s2i_mel_framed_error_string.argtypes = [ctypes.c_int]
        lib.s2i_mel_framed_error_string.restype = ctypes.c_char_p
    return lib


def _check_frames(frames: torch.Tensor, p) -> None:
    if frames.ndim != 2 or frames.dtype != torch.float32 or frames.shape[1] != p.n_fft:
        raise ValueError(
            f"expect float32 [rows, n_fft={p.n_fft}], got {frames.dtype} {tuple(frames.shape)}"
        )
    if frames.shape[0] == 0:
        raise ValueError("no frame rows")


def logmel_frames(frames: torch.Tensor, p) -> torch.Tensor:
    """Frame rows [R, n_fft] float32 → [R, n_mels] through
    ``s2i::logmel_frames``: the kernel K4 for a CUDA tensor,
    :func:`logmel_framed_plain` for a CPU tensor. The op's registrations
    check the arguments."""
    return torch.ops.s2i.logmel_frames(frames, *geometry(p))


def _logmel_frames_cpu(frames, *geom):
    p = _params(*geom)
    _check_frames(frames, p)
    return logmel_framed_plain(frames, p)


def _logmel_frames_cuda(frames, *geom):
    """K4: one launch for all rows."""
    p = _params(*geom)
    _check_frames(frames, p)
    frames = frames.contiguous()
    out = torch.empty((frames.shape[0], p.n_mels), device=frames.device)
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    lib = _framed_lib()
    branch = kernel_branch(p)
    if branch == "fft":
        table = _fft_table(p, frames.device)
        err = lib.s2i_mel_framed_fft(
            frames.data_ptr(), frames.shape[0], frames.shape[1], table.data_ptr(), table.numel(),
            out.data_ptr(), p.win_length, p.n_mels, p.log_offset, stream,
        )
    else:
        cos, sin, mel_t = _tables(p, frames.device)
        err = lib.s2i_mel_framed_dft(
            frames.data_ptr(), frames.shape[0], frames.shape[1],
            cos.data_ptr(), sin.data_ptr(), mel_t.data_ptr(), out.data_ptr(),
            cos.shape[0], p.n_bins, p.n_mels, p.log_offset, stream,
        )
    if err:
        raise RuntimeError(
            f"mel_framed kernel ({branch}): {lib.s2i_mel_framed_error_string(err).decode()}"
        )
    logmel_frames.launches += 1
    logmel_frames.branch = branch
    return out


_LIB.impl("logmel_frames", _logmel_frames_cpu, "CPU")
_LIB.impl("logmel_frames", _logmel_frames_cuda, "CUDA")


@torch.library.register_fake("s2i::logmel_frames", lib=_LIB)
def _logmel_frames_fake(frames, sample_rate, win_length, hop_length, n_fft, n_mels, *rest):
    return frames.new_empty((frames.shape[0], n_mels))


counted(logmel_frames)  # K4 launches
logmel_frames.branch = None  # "fft" or "dft": the branch of the last launch


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
