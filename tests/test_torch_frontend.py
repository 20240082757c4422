"""The port's audio frontend (s2i_tpu_torch/audio/, ops/mel_kernel.py)
against the JAX package's, on the CPU where the port runs its plain PyTorch
log-mel (the fused path K1 and the framed path K4).

Signals are tones plus a broadband noise floor, so every mel bin carries
energy: the log amplifies float32 rounding in near-empty bins. Tolerance
1e-4 absolute on log-mel (the JAX package's own kernel-vs-jnp tolerance:
float32 DFT sums in another order) and 2e-4 on normalized features (the
same error divided by the utterance's standard deviation)."""

import dataclasses
import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s2i_tpu import config as jax_config
from s2i_tpu.audio import frontend as jf
from s2i_tpu.audio import wavio as jwavio
from s2i_tpu.ops.mel_kernel import logmel_pallas, logmel_pallas_fused
from s2i_tpu_torch import config as port_config
from s2i_tpu_torch.audio import frontend as tf
from s2i_tpu_torch.audio import wavio as twavio
from s2i_tpu_torch.ops import mel_kernel

SR = 16000


def _signals(n: int, b: int = 3, seed: int = 0) -> np.ndarray:
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    rows = [
        0.5 * np.sin(2 * np.pi * (150.0 * (i + 1)) * t * (1 + t))
        + 0.05 * rng.standard_normal(n)
        for i in range(b)
    ]
    return np.stack(rows).astype(np.float32)


def _params(**kw):
    return jf.FrontendParams(**kw), tf.FrontendParams(**kw)


@pytest.mark.parametrize(
    "kw",
    [
        dict(max_frames=64),
        dict(max_frames=32, feature="mfcc", n_mfcc=13, center=True, preemphasis=0.97),
        dict(max_frames=64, center=True, htk_mel=True, mel_norm="none"),
        # n_fft/hop = 12.8 > 9: the JAX package computes this one with logmel_jnp
        dict(max_frames=128, hop_length=40, preemphasis=0.97, normalize="none"),
    ],
    ids=["logmel-pad", "mfcc-center-crop", "htk-center", "hop40-unnormalized"],
)
def test_extract_features_matches_jax(kw):
    jp, tp = _params(**kw)
    wav = _signals(8000)
    lens = np.array([8000, 5123, 300], np.int32)  # full, ragged, < one window
    want_f, want_m = jf.extract_features(
        jnp.asarray(wav), jp, use_pallas=False, wav_len=jnp.asarray(lens)
    )
    got_f, got_m = tf.extract_features(wav, tp, wav_len=lens, device="cpu")
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert int(got_m[2].sum()) == jp.num_frames(300)  # 0, or 2 with center pad
    tol = 2e-4 if tp.normalize == "utterance" else 1e-4
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=tol, rtol=0)


def test_plain_logmel_matches_pallas_kernel_interpret():
    """The port's plain log-mel against the TPU kernel itself (interpret
    mode), on a ragged length with center padding and preemphasis."""
    jp, tp = _params(max_frames=64, center=True, preemphasis=0.97)
    wav = _signals(8777, b=2)
    want = np.asarray(logmel_pallas_fused(jnp.asarray(wav), jp, block_frames=16))
    x = tf.center_pad(tf.preemphasize(torch.from_numpy(wav), tp.preemphasis), tp)
    n = mel_kernel.num_frames(x.shape[1], tp)
    assert n == want.shape[1] == jp.num_frames(8777)
    got = mel_kernel.logmel(x, tp, n).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "kw,n",
    [
        (dict(win_length=250, hop_length=33, n_fft=256), 7001),  # n_fft > win_length
        (dict(center=True, preemphasis=0.97), 8777),
    ],
    ids=["nfft-gt-win", "center-preemph"],
)
def test_logmel_framed_matches_pallas_kernel_interpret(kw, n):
    """K4's path: the port's frame gather against the JAX package's, and
    logmel_framed (plain on the CPU) against logmel_pallas itself (interpret
    mode), frame count included."""
    jp, tp = _params(**kw)
    wav = _signals(n, b=2)
    want = np.asarray(logmel_pallas(jnp.asarray(wav), jp, block_frames=16))
    got = mel_kernel.logmel_framed(torch.from_numpy(wav), tp)
    assert got.shape == want.shape == (2, jp.num_frames(n), tp.n_mels)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)

    x = tf.center_pad(tf.preemphasize(torch.from_numpy(wav), tp.preemphasis), tp)
    f = mel_kernel.num_frames(x.shape[1], tp)
    rows = mel_kernel.frame_rows(x, tp, f)
    xj = np.pad(x.numpy(), ((0, 0), (0, tp.n_fft - tp.win_length)))
    idx = np.arange(f)[:, None] * tp.hop_length + np.arange(tp.n_fft)[None, :]
    assert rows.shape == (2 * f, tp.n_fft) and rows.is_contiguous()
    np.testing.assert_array_equal(rows.numpy(), xj[:, idx].reshape(2 * f, tp.n_fft))
    np.testing.assert_allclose(mel_kernel.logmel_frames(rows, tp).numpy(),
                               mel_kernel.logmel_framed_plain(rows, tp).numpy(), rtol=0, atol=0)


def test_constant_tables_and_cfg_match_jax():
    for kw in ({}, dict(win_length=250, hop_length=33, n_fft=256, htk_mel=True)):
        jp, tp = _params(**kw)
        for name in ("dft_cos", "dft_sin", "mel_fb", "dct"):
            np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    cfg = port_config.cfg_from_file("cfg/birds_3stages.yml")
    assert cfg == jax_config.cfg_from_file("cfg/birds_3stages.yml")
    got = tf.frontend_params_from_cfg(cfg.AUDIO)
    want = jf.frontend_params_from_cfg(cfg.AUDIO)
    for f in dataclasses.fields(want):
        if f.compare:  # every scalar of the geometry
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.max_samples == 164080


def test_wav_io_matches_jax():
    x = _signals(4000, b=1)[0]
    buf = io.BytesIO()
    jwavio.write_wav(buf, x, 22050)
    got, sr = twavio.read_wav(io.BytesIO(buf.getvalue()))
    want, sr_j = jwavio.read_wav(io.BytesIO(buf.getvalue()))
    assert sr == sr_j == 22050
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        twavio.resample_linear(got, sr, SR), jwavio.resample_linear(want, sr, SR)
    )


def test_frontend_rejects_what_it_cannot_frame():
    with pytest.raises(ValueError, match="n_fft"):
        tf.FrontendParams(win_length=600, n_fft=512)
    _, tp = _params(max_frames=8)
    with pytest.raises(ValueError, match="shorter than one window"):
        tf.extract_features(np.zeros((1, 100), np.float32), tp, device="cpu")
    with pytest.raises(ValueError, match="n_frames"):
        mel_kernel.logmel(torch.zeros(1, 1000), tp, 99)
    with pytest.raises(ValueError, match="shorter than one window"):
        mel_kernel.logmel_framed(torch.zeros(1, 100), tp)
    with pytest.raises(ValueError, match="n_fft"):
        mel_kernel.logmel_frames(torch.zeros(4, 400), tp)
