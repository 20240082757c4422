"""Host-side (numpy) constant builders for the audio frontend.

The port's own copy of ``s2i_tpu/audio/filters.py`` (the port imports
nothing of the JAX package). These run once at pipeline-construction time
and produce the constant matrices the log-mel kernel consumes: Hann window,
windowed real-DFT matrices (so the STFT becomes two products against
constant tables), mel filterbank (Slaney or HTK variants, implemented from
the standard formulas since librosa is not a dependency), and the DCT-II
matrix for MFCC.

Reference behavior being matched: librosa defaults (hann window, Slaney mel
with area normalization) as used by the reference's librosa-based frontend
(SURVEY.md §2 row 1; exact reference params are [?]-grade, so everything is
parameterized).
"""

from __future__ import annotations

import numpy as np


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window. ``periodic=True`` matches librosa/scipy ``sym=False``."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1)))
    return w[:win_length].astype(np.float64)


def windowed_dft_matrices(
    win_length: int, n_fft: int, window: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT as matmul: returns ``(C, S)`` with shape [win_length, n_bins].

    For a frame x[0:win] (implicitly zero-padded to n_fft):
      real_k = x @ C[:, k],  imag_k = -(x @ S[:, k])
      power_k = (x@C)^2 + (x@S)^2
    The window is folded into the matrices so the kernel does no separate
    elementwise multiply. n_bins = n_fft//2 + 1.
    """
    if window is None:
        window = hann_window(win_length)
    n_bins = n_fft // 2 + 1
    t = np.arange(win_length)[:, None]  # [win, 1]
    k = np.arange(n_bins)[None, :]  # [1, bins]
    ang = 2.0 * np.pi * t * k / n_fft
    c = (np.cos(ang) * window[:, None]).astype(np.float64)
    s = (np.sin(ang) * window[:, None]).astype(np.float64)
    return c, s


def _hz_to_mel(f: np.ndarray | float, htk: bool) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3.0
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels
    )


def _mel_to_hz(m: np.ndarray, htk: bool) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel,
        min_log_hz * np.exp(logstep * (m - min_log_mel)),
        f_min + f_sp * m,
    )


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank, shape [n_mels, n_fft//2 + 1].

    ``htk=False, norm='slaney'`` reproduces librosa's default filterbank
    (the likely reference configuration, SURVEY.md §2 row 1 [?]).
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(
        _hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2
    )
    hz_pts = _mel_to_hz(mel_pts, htk)

    fb = np.zeros((n_mels, n_bins), dtype=np.float64)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # [n_mels+2, bins]
    for i in range(n_mels):
        lower = -ramps[i] / max(fdiff[i], 1e-10)
        upper = ramps[i + 2] / max(fdiff[i + 1], 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    elif norm not in ("none", None):
        raise ValueError(f"unknown mel norm {norm!r}")
    return fb


def dct_matrix(n_mfcc: int, n_mels: int, norm: str = "ortho") -> np.ndarray:
    """DCT-II matrix [n_mfcc, n_mels] (librosa/scipy 'ortho' convention)."""
    n = np.arange(n_mels)[None, :]
    k = np.arange(n_mfcc)[:, None]
    m = np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_mels)) * 2.0
    if norm == "ortho":
        m[0] *= np.sqrt(1.0 / (4.0 * n_mels))
        m[1:] *= np.sqrt(1.0 / (2.0 * n_mels))
    return m.astype(np.float64)
