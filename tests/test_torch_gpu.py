"""The port's CUDA kernels on the card, against their plain PyTorch versions
(which the other test_torch_*.py files hold against the JAX package on the
CPU). Every test here is marked ``gpu`` and skips without a card. The file
imports nothing of JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are absolute, for float32 sums taken in another order than the
plain version's: 1e-4 on log-mel (400-term DFT sums, then a log), 2e-4 on
normalized features (that error over the utterance's standard deviation),
1e-5 on GRU states (H-term dot products over T dependent steps), 1e-4 on
images (the encoder and generator behind them)."""

import numpy as np
import pytest
import torch

from s2i_tpu_torch import config
from s2i_tpu_torch.audio import frontend as tf
from s2i_tpu_torch.ops import gru_kernel, mel_kernel
from s2i_tpu_torch.pipeline import SpeechToImage, build_encoder, build_generator

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _signals(n: int, b: int = 3, seed: int = 0) -> np.ndarray:
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(seed)
    rows = [0.5 * np.sin(2 * np.pi * 150.0 * (i + 1) * t * (1 + t)) + 0.05 * rng.standard_normal(n)
            for i in range(b)]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize(
    "kw,n",
    [
        (dict(), 16000),  # the birds geometry: win 400, hop 160, n_fft 512
        (dict(hop_length=40, center=True, preemphasis=0.97), 9000),  # n_fft/hop 12.8
        (dict(win_length=250, hop_length=33, n_fft=256), 7000),  # hop not a multiple of 4
    ],
    ids=["birds", "hop40-center", "hop33"],
)
def test_logmel_kernel_matches_plain(card, kw, n):
    p = tf.FrontendParams(**kw)
    wav = tf.center_pad(tf.preemphasize(torch.from_numpy(_signals(n)).to(card), p.preemphasis), p)
    frames = mel_kernel.num_frames(wav.shape[1], p)
    before = mel_kernel.logmel.launches
    got = mel_kernel.logmel(wav, p, frames)
    torch.cuda.synchronize()
    assert mel_kernel.logmel.launches == before + 1
    want = mel_kernel.logmel_plain(wav, p, frames)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4, rtol=0)


def test_extract_features_on_the_card_matches_cpu(card):
    p = tf.FrontendParams(max_frames=128, hop_length=40, center=True, preemphasis=0.97)
    wav = _signals(8000)
    lens = np.array([8000, 5123, 300], np.int32)
    got_f, got_m = tf.extract_features(wav, p, wav_len=lens, device="cuda")
    want_f, want_m = tf.extract_features(wav, p, wav_len=lens, device="cpu")
    np.testing.assert_array_equal(got_m.cpu().numpy(), want_m.numpy())
    np.testing.assert_allclose(got_f.cpu().numpy(), want_f.numpy(), atol=2e-4, rtol=0)


@pytest.mark.parametrize(
    "t,b,h",
    [(64, 5, 96), (12, 3, 16), (8, 100, 512)],  # the last needs two row chunks
    ids=["h96", "h16", "b100-h512"],
)
def test_gru_kernel_matches_plain(card, t, b, h):
    rng = np.random.default_rng(t + b + h)
    lens = rng.integers(1, t + 1, b)
    lens[0], lens[-1] = t, 0  # full, ragged, all-masked
    args = dict(
        xw=rng.standard_normal((t, b, 3 * h)),
        w_h=rng.standard_normal((h, 3 * h)) / np.sqrt(h),
        b_h=0.1 * rng.standard_normal(3 * h),
        mask=np.arange(t)[:, None] < lens[None, :],
        h0=0.5 * rng.standard_normal((b, h)),
    )
    dev = {k: torch.from_numpy(np.asarray(v, np.float32)).to(card) for k, v in args.items()}
    before = gru_kernel.gru_scan.launches
    got = gru_kernel.gru_scan(**dev)
    torch.cuda.synchronize()
    assert gru_kernel.gru_scan.launches > before
    want = gru_kernel.gru_scan_plain(**dev)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5, rtol=0)
    # the all-masked row carries h0 through every step
    np.testing.assert_array_equal(got[:, -1].cpu().numpy(), np.broadcast_to(args["h0"][-1], (t, h)).astype(np.float32))


def test_gru_wrapper_rejects_mixed_devices(card):
    t, b, h = 4, 2, 8
    with pytest.raises(ValueError, match="w_h"):
        gru_kernel.gru_scan(
            torch.zeros(t, b, 3 * h, device=card), torch.zeros(h, 3 * h),
            torch.zeros(3 * h, device=card), torch.ones(t, b, device=card),
            torch.zeros(b, h, device=card),
        )


def test_pipeline_on_the_card_matches_cpu(card):
    cfg = config.default_cfg()
    cfg.TREE.BRANCH_NUM = 2
    cfg.GAN.GF_DIM = 4
    cfg.GAN.Z_DIM = 6
    cfg.GAN.EMBEDDING_DIM = 6
    cfg.TEXT.DIMENSION = 12
    cfg.AUDIO.MAX_FRAMES = 64
    cfg.ENCODER.CONV_CHANNELS = [6, 8]
    cfg.ENCODER.RNN_HIDDEN = 8
    torch.manual_seed(0)
    enc, g = build_encoder(cfg).state_dict(), build_generator(cfg).state_dict()
    gpu, cpu = (SpeechToImage(cfg, enc, g, device=d) for d in ("cuda", "cpu"))
    n = gpu.p.max_samples
    wavs = _signals(n, b=2)
    lens = np.array([n, n // 3], np.int32)
    z = np.random.default_rng(1).standard_normal((2, 6)).astype(np.float32)
    before = mel_kernel.logmel.launches, gru_kernel.gru_scan.launches
    got = gpu.generate(wavs, lens, z=z)
    assert mel_kernel.logmel.launches > before[0] and gru_kernel.gru_scan.launches > before[1]
    want = cpu.generate(wavs, lens, z=z)
    assert got.shape == want.shape == (2, 128, 128, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
