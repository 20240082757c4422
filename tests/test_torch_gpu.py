"""The port's CUDA kernels on the card, against their plain PyTorch versions
(which the other test_torch_*.py files hold against the JAX package on the
CPU). Every test here is marked ``gpu`` and skips without a card. The file
imports nothing of JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are absolute, for float32 sums taken in another order than the
plain version's: 1e-4 on log-mel (FFT or 400-term DFT sums, then a log), 2e-4 on
normalized features (that error over the utterance's standard deviation),
1e-5 on GRU states (H-term dot products over T dependent steps), 1e-4 on
images (the encoder and generator behind them). GRU gradients: 5e-6 of the
largest magnitude of each output (dW_h and db_h sum T·B products, dxw and
dh0 carry the sum over T reverse steps). One GAN step, card vs CPU: losses
1e-4 relative, gradients 1e-3 of each tensor's largest magnitude (BN batch
statistics over 4 examples), BN running statistics 1e-4 absolute."""

import os
import re

import numpy as np
import pytest
import torch

from s2i_tpu_torch import cli, config
from s2i_tpu_torch.audio import filters
from s2i_tpu_torch.audio import frontend as tf
from s2i_tpu_torch.ops import gru_kernel, mel_kernel
from s2i_tpu_torch.pipeline import SpeechToImage, build_encoder, build_generator
from s2i_tpu_torch.train import gan, loop
from s2i_tpu_torch.utils import checkpoint

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


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` whose data starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


# (kw, n, branch): the log-mel geometries the card tests run
LOGMEL_CASES = {
    "birds": (dict(), 16000, "fft"),  # win 400, hop 160, n_fft 512
    "hop40-center": (dict(hop_length=40, center=True, preemphasis=0.97), 9000, "fft"),  # n_fft/hop 12.8
    "hop33": (dict(win_length=250, hop_length=33, n_fft=256), 7000, "fft"),  # hop not a multiple of 4
    "nfft-gt-win": (dict(win_length=250, hop_length=33, n_fft=256, center=True, preemphasis=0.97), 7000, "fft"),
    "htk-256": (dict(win_length=250, hop_length=100, n_fft=256, htk_mel=True), 7000, "fft"),  # narrow filters
    "nfft128": (dict(win_length=100, hop_length=50, n_fft=128), 5000, "fft"),
    "nfft2048": (dict(win_length=1600, hop_length=400, n_fft=2048), 20000, "fft"),
    "nfft400-dft": (dict(win_length=400, hop_length=160, n_fft=400), 16000, "dft"),  # not a power of two
}


def _case(name: str) -> tuple[str, str]:
    """"birds" → ("birds", ""); "birds+zero-row" → ("birds", "zero-row")."""
    case, _, variant = name.partition("+")
    return case, variant


@pytest.mark.parametrize(
    "name",
    ["birds", "hop40-center", "hop33", "birds+zero-row", "birds+fewer-frames", "hop33+unaligned", "htk-256",
     "nfft128", "nfft2048", "nfft400-dft", "nfft400-dft+zero-row", "birds+batch40", "nfft2048+batch40"],
)
def test_logmel_kernel_matches_plain(card, name):
    case, variant = _case(name)
    kw, n, branch = LOGMEL_CASES[case]
    p = tf.FrontendParams(**kw)
    b, n = (40, max(n, 48000)) if variant == "batch40" else (3, n)  # more tiles than the persistent grid's blocks
    sig = _signals(n, b)
    if variant == "zero-row":
        sig[1] = 0.0  # every filter gives log(offset)
    wav = tf.center_pad(tf.preemphasize(torch.from_numpy(sig).to(card), p.preemphasis), p)
    if variant == "unaligned":
        wav = _unaligned(wav)
    frames = mel_kernel.num_frames(wav.shape[1], p)
    if variant == "fewer-frames":
        frames -= 7
    before = mel_kernel.logmel.launches
    got = mel_kernel.logmel(wav, p, frames)
    torch.cuda.synchronize()
    assert mel_kernel.logmel.launches == before + 1
    assert mel_kernel.logmel.branch == mel_kernel.kernel_branch(p) == branch
    want = mel_kernel.logmel_plain(wav, p, frames)
    assert got.shape == want.shape == (b, frames, p.n_mels)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "name",
    ["birds", "nfft-gt-win", "birds+zero-row", "birds+fewer-frames", "birds+unaligned", "htk-256",
     "nfft128", "nfft2048", "nfft400-dft", "birds+batch40", "nfft2048+batch40"],
)
def test_logmel_framed_kernel_matches_plain(card, name):
    """K4 on a ragged batch (zero tails) against its plain version."""
    case, variant = _case(name)
    kw, n, branch = LOGMEL_CASES[case]
    p = tf.FrontendParams(**kw)
    b, n = (40, max(n, 48000)) if variant == "batch40" else (3, n)  # more tiles than the persistent grid's blocks
    wav = _signals(n, b)
    wav[1, n // 3:] = 0.0
    wav[2, 500:] = 0.0
    if variant == "zero-row":
        wav[0] = 0.0
    w = torch.from_numpy(wav).to(card)
    x = tf.center_pad(tf.preemphasize(w, p.preemphasis), p)
    frames = mel_kernel.num_frames(x.shape[1], p) - (7 if variant == "fewer-frames" else 0)
    rows = mel_kernel.frame_rows(x, p, frames)
    if variant == "unaligned":
        rows = _unaligned(rows)
    before = mel_kernel.logmel_frames.launches
    got = mel_kernel.logmel_frames(rows, p)
    torch.cuda.synchronize()
    assert mel_kernel.logmel_frames.launches == before + 1
    assert mel_kernel.logmel_frames.branch == mel_kernel.kernel_branch(p) == branch
    want = mel_kernel.logmel_framed_plain(rows, p)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(mel_kernel.logmel_framed(w, p).cpu().numpy(),
                               mel_kernel.logmel_framed(torch.from_numpy(wav), p).numpy(), atol=1e-4, rtol=0)


def _logmel_f64(frames: torch.Tensor, p: tf.FrontendParams) -> np.ndarray:
    """The plain arithmetic in float64, from the float64 tables: frames
    [..., win] → log-mel [..., n_mels]."""
    cos, sin = filters.windowed_dft_matrices(p.win_length, p.n_fft)
    fb = filters.mel_filterbank(p.sample_rate, p.n_fft, p.n_mels, p.fmin, p.fmax, htk=p.htk_mel, norm=p.mel_norm)
    x = frames.double().cpu().numpy()
    return np.log(((x @ cos) ** 2 + (x @ sin) ** 2) @ fb.T + p.log_offset)


def test_logmel_kernels_with_empty_filters_match_float64(card):
    """HTK filters at n_fft 256 with 80 mels: the narrowest cover one bin
    and two cover none, which give log(offset). The float32 plain version
    strays from the float64 arithmetic by more than 1e-4 in these narrow
    filters on the ragged batch (1.3e-4, on an H100), so both kernels are
    held to the float64 arithmetic itself, at the same 1e-4."""
    p = tf.FrontendParams(win_length=250, hop_length=100, n_fft=256, n_mels=80, htk_mel=True)
    empty = np.flatnonzero(~p.mel_fb.any(axis=1))
    assert empty.size == 2
    wav = _signals(7000)
    wav[1, 7000 // 3:] = 0.0
    wav[2, 500:] = 0.0
    x = torch.from_numpy(wav).to(card)
    n = mel_kernel.num_frames(x.shape[1], p)
    frames = x.unfold(-1, p.win_length, p.hop_length)[:, :n]
    fused = mel_kernel.logmel(x, p, n)
    framed = mel_kernel.logmel_frames(mel_kernel.frame_rows(x, p, n), p).view(3, n, p.n_mels)
    torch.cuda.synchronize()
    assert mel_kernel.logmel.branch == mel_kernel.logmel_frames.branch == "fft"
    want = _logmel_f64(frames, p)
    for got in (fused, framed):
        got = got.cpu().numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        np.testing.assert_allclose(got[..., empty], np.log(p.log_offset), atol=2e-6, rtol=0)  # a float32 ulp


def test_logmel_kernels_raise_past_shared_memory(card):
    """n_fft 2048 at hop 8000: two staged spans of a 4-frame tile (~208 kB)
    beside the constants and buffers are more than a block may hold, so the
    launch is refused and the wrapper raises, launching nothing."""
    p = tf.FrontendParams(win_length=2048, hop_length=8000, n_fft=2048)
    wav = torch.zeros(1, 80000, device=card)
    before = mel_kernel.logmel.launches
    with pytest.raises(RuntimeError, match="mel_fused kernel"):
        mel_kernel.logmel(wav, p, mel_kernel.num_frames(wav.shape[1], p))
    assert mel_kernel.logmel.launches == before


def test_extract_features_names_a_geometry_past_shared_memory(card):
    """n_fft 2048 at hop 4800: a tile's two staged spans (3 hops and a
    window each) beside the 48 kB table pass a block's 227 KB, and the
    frontend raises with the geometry and the bytes it needed, launching
    nothing (no fallback to another formulation)."""
    p = tf.FrontendParams(win_length=2048, hop_length=4800, n_fft=2048, max_frames=8)
    before = mel_kernel.logmel.launches
    with pytest.raises(RuntimeError) as err:
        tf.extract_features(np.zeros((1, 40000), np.float32), p, device="cuda")
    msg = str(err.value)
    m = re.search(r"n_fft 2048, win_length 2048, hop_length 4800, n_mels 40 needs (\d+) bytes of shared "
                  r"memory per block; this card lets a block have (\d+)", msg)
    assert m and int(m.group(1)) > int(m.group(2)), msg
    assert mel_kernel.logmel.launches == before


def test_logmel_rejects_frames_past_the_signal(card):
    """More frames than the wav holds: the wrapper raises before launching,
    and the library's FFT entry refuses them too (it would stage spans that
    start past the signal) and leaves the output as it was."""
    p = tf.FrontendParams()
    wav = torch.from_numpy(_signals(16000)).to(card)
    n = mel_kernel.num_frames(wav.shape[1], p)
    before = mel_kernel.logmel.launches
    with pytest.raises(ValueError, match="n_frames"):
        mel_kernel.logmel(wav, p, n + 1)
    assert mel_kernel.logmel.launches == before
    table = mel_kernel.fft_table(p)
    table = torch.from_numpy(table).to(card)
    for frames in (n + 1, n + 64):
        out = torch.full((wav.shape[0], frames, p.n_mels), 7.0, device=card)
        err = mel_kernel._lib().s2i_mel_fused_fft(
            wav.data_ptr(), wav.shape[0], wav.shape[1], table.data_ptr(), table.numel(), out.data_ptr(),
            frames, p.hop_length, p.win_length, p.n_fft, p.n_mels, p.log_offset,
            torch.cuda.current_stream().cuda_stream,
        )
        torch.cuda.synchronize()
        assert err != 0
        assert (out == 7.0).all()


def test_gan_step_on_the_card_matches_cpu(card):
    cfg = config.apply_overrides(config.default_cfg(), [
        "TREE.BRANCH_NUM=2", "GAN.GF_DIM=4", "GAN.DF_DIM=4", "GAN.Z_DIM=8", "GAN.EMBEDDING_DIM=16",
        "GAN.R_NUM=1", "TEXT.DIMENSION=32", "TRAIN.COEFF.COLOR_LOSS=50.0", "DTYPE.COMPUTE=float32"])
    rng = np.random.default_rng(0)
    batch = {"images": (rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8),),
             "embedding": rng.standard_normal((4, 32)).astype(np.float32), "class_id": np.arange(4)}
    z, eps = rng.standard_normal((4, 8)).astype(np.float32), rng.standard_normal((4, 16)).astype(np.float32)
    states = {dev: gan.init_state(cfg, device=dev) for dev in ("cuda", "cpu")}
    mets = {dev: gan.train_step(st, batch, z, eps) for dev, st in states.items()}
    for k, v in mets["cpu"].items():
        if "_acc" not in k:
            assert abs(mets["cuda"][k].item() - v.item()) <= 1e-4 * abs(v.item()), k
    mods = {dev: [st.models.g, *st.models.ds] for dev, st in states.items()}
    for mc, mp in zip(mods["cuda"], mods["cpu"]):
        for (name, pc), pp in zip(mc.named_parameters(), mp.parameters()):
            assert pc.grad.abs().max() > 0, name
            err = (pc.grad.cpu() - pp.grad).abs().max().item()
            assert err <= 1e-3 * pp.grad.abs().max().item(), name
        sd = mp.state_dict()
        for k, v in mc.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.cpu().numpy(), sd[k].numpy(), atol=1e-4, rtol=0, err_msg=k)


def test_extract_features_on_the_card_matches_cpu(card):
    p = tf.FrontendParams(max_frames=128, hop_length=40, center=True, preemphasis=0.97)
    wav = _signals(8000)
    lens = np.array([8000, 5123, 300], np.int32)
    got_f, got_m = tf.extract_features(wav, p, wav_len=lens, device="cuda")
    want_f, want_m = tf.extract_features(wav, p, wav_len=lens, device="cpu")
    np.testing.assert_array_equal(got_m.cpu().numpy(), want_m.numpy())
    np.testing.assert_allclose(got_f.cpu().numpy(), want_f.numpy(), atol=2e-4, rtol=0)


def _gru_args(t, b, h, card, d=1):
    """Seeded stacked inputs [D, ...] on the card: ragged lengths with a full
    row first and an all-masked row last (when b > 1), non-zero h0; and dys."""
    rng = np.random.default_rng(t + b + h + d)
    lens = rng.integers(1, t + 1, b)
    lens[0] = t
    if b > 1:
        lens[-1] = 0
    args = dict(
        xw=rng.standard_normal((d, t, b, 3 * h)),
        w_h=rng.standard_normal((d, h, 3 * h)) / np.sqrt(h),
        b_h=0.1 * rng.standard_normal((d, 3 * h)),
        mask=np.arange(t)[:, None] < lens[None, :],
        h0=0.5 * rng.standard_normal((d, b, h)),
    )
    dev = {k: torch.from_numpy(np.asarray(v, np.float32)).to(card) for k, v in args.items()}
    dys = torch.from_numpy(rng.standard_normal((d, t, b, h)).astype(np.float32)).to(card)
    return dev, dys


def _check_fwd(dev):
    before = gru_kernel.gru_scan.launches
    got = gru_kernel.gru_scan(**dev)
    torch.cuda.synchronize()
    assert gru_kernel.gru_scan.launches == before + 1
    want = gru_kernel.gru_scan_plain(**dev)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5, rtol=0)
    return got


def _assert_grads_close(got, want, sum_scale=1.0):
    """5e-6 of each output's largest magnitude; dW_h and db_h, which sum T·B
    products, ``sum_scale`` times that (for sums longer than T=128's)."""
    for name, g, w in zip(("dxw", "dw_h", "db_h", "dh0"), got, want):
        err = (g - w).abs().max().item()
        tol = 5e-6 * (sum_scale if name in ("dw_h", "db_h") else 1.0)
        assert err <= tol * max(1.0, w.abs().max().item()), (name, err)


def _check_bwd(dev, dys, sum_scale=1.0):
    ys = gru_kernel.gru_scan_plain(**dev)
    before = gru_kernel.gru_scan_bwd.launches
    got = gru_kernel.gru_scan_bwd(**dev, ys=ys, dys=dys)
    torch.cuda.synchronize()
    assert gru_kernel.gru_scan_bwd.launches == before + 1
    _assert_grads_close(got, gru_kernel.gru_scan_bwd_plain(**dev, ys=ys, dys=dys), sum_scale)
    return got


@pytest.mark.parametrize(
    "t,b,h",
    [(64, 5, 96), (12, 3, 16), (8, 100, 512), (128, 24, 512)],  # b100: two row groups; b24: the joint's batch
    ids=["h96", "h16", "b100-h512", "joint-b24"],
)
def test_gru_kernel_matches_plain(card, t, b, h):
    dev, _ = _gru_args(t, b, h, card)
    got = _check_fwd(dev)
    # the all-masked row carries h0 through every step
    np.testing.assert_array_equal(got[0, :, -1].cpu().numpy(), np.broadcast_to(dev["h0"][0, -1].cpu().numpy(), (t, h)))


@pytest.mark.parametrize(
    "t,b,h",
    # b=100: more rows than one launch takes; b=24 (the joint finetune's batch): a partial row group
    [(12, 3, 16), (64, 5, 96), (8, 100, 512), (128, 64, 512), (128, 24, 512)],
    ids=["h16", "h96", "b100-h512", "encoder-b64", "joint-b24"],
)
def test_gru_bwd_kernel_matches_plain(card, t, b, h):
    dev, dys = _gru_args(t, b, h, card)
    got = _check_bwd(dev, dys)
    # the all-masked row: nothing reaches its gates
    assert not got[0][:, :, -1].any()


# Both kernels over the launch plans: one and two directions; B from 1 to 65
# (65 crosses a row group at D=2); H=200, whose unit blocks do not fill a
# cluster; one step and the encoder's 128.
GRID = [(d, t, b, h) for d in (1, 2) for t in (1, 128) for b in (1, 7, 24, 64, 65) for h in (64, 200, 512)]


@pytest.mark.parametrize("d,t,b,h", GRID, ids=[f"D{d}-T{t}-B{b}-H{h}" for d, t, b, h in GRID])
def test_gru_kernels_match_plain_over_plans(card, d, t, b, h):
    dev, dys = _gru_args(t, b, h, card, d)
    _check_fwd(dev)
    _check_bwd(dev, dys)


def test_gru_kernels_match_plain_past_one_launch(card):
    """B=200 at D=2 is more rows than one launch of either kernel takes:
    the wrappers split the batch into row chunks, and K3 adds the chunks'
    weight gradients in order."""
    dev, dys = _gru_args(24, 200, 512, card, d=2)
    before = gru_kernel.gru_scan.launches, gru_kernel.gru_scan_bwd.launches
    got = gru_kernel.gru_scan(**dev)
    ys = gru_kernel.gru_scan_plain(**dev)
    grads = gru_kernel.gru_scan_bwd(**dev, ys=ys, dys=dys)
    torch.cuda.synchronize()
    assert gru_kernel.gru_scan.launches > before[0] + 1 and gru_kernel.gru_scan_bwd.launches > before[1] + 1
    np.testing.assert_allclose(got.cpu().numpy(), ys.cpu().numpy(), atol=1e-5, rtol=0)
    _assert_grads_close(grads, gru_kernel.gru_scan_bwd_plain(**dev, ys=ys, dys=dys))


def test_gru_two_directions_match_two_calls_on_flipped_inputs(card):
    dev, dys = _gru_args(128, 24, 512, card, d=2)
    ys = gru_kernel.gru_scan(**dev)
    grads = gru_kernel.gru_scan_bwd(**dev, ys=ys, dys=dys)
    for d, flip in ((0, False), (1, True)):
        f = (lambda x: x.flip(0)) if flip else (lambda x: x)  # noqa: E731
        one = dict(xw=f(dev["xw"][d])[None], w_h=dev["w_h"][d:d + 1], b_h=dev["b_h"][d:d + 1],
                   mask=f(dev["mask"]), h0=dev["h0"][d:d + 1])
        ys1 = gru_kernel.gru_scan(**one)
        g1 = gru_kernel.gru_scan_bwd(**one, ys=ys1, dys=f(dys[d])[None])
        torch.testing.assert_close(ys[d], f(ys1[0]), atol=1e-5, rtol=0)
        want = (f(g1[0][0]), g1[1][0], g1[2][0], g1[3][0])
        _assert_grads_close([g[d] for g in grads], want)


def test_gru_long_sequence_has_no_stale_state(card):
    """1024 steps of both directions at the encoder's width: a step that read
    h_{t-1} or dhg[t] before every block had written it would show here, in
    ys, dxw and dh0 at the usual tolerances. dW_h and db_h sum 8 times as
    many products as at T=128, and are held to 8 times its tolerance."""
    dev, dys = _gru_args(1024, 64, 512, card, d=2)
    _check_fwd(dev)
    _check_bwd(dev, dys, sum_scale=1024 / 128)


def test_gru_bwd_is_bitwise_repeatable(card):
    dev, dys = _gru_args(128, 64, 512, card, d=2)
    ys = gru_kernel.gru_scan(**dev)
    first = gru_kernel.gru_scan_bwd(**dev, ys=ys, dys=dys)
    second = gru_kernel.gru_scan_bwd(**dev, ys=ys, dys=dys)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_gru_scan_backward_on_the_card_matches_autograd(card):
    dev, dys = _gru_args(20, 6, 64, card, d=2)
    leaves = [dev[k].requires_grad_() for k in ("xw", "w_h", "b_h", "h0")]
    want = torch.autograd.grad(gru_kernel.gru_scan_plain(**dev), leaves, dys)
    before = gru_kernel.gru_scan.launches, gru_kernel.gru_scan_bwd.launches
    ys = gru_kernel.gru_scan(**dev)
    # a permuted gradient, as the encoder's [B, T, D*H] output gives it
    got = torch.autograd.grad(ys, leaves, dys.permute(2, 1, 0, 3).contiguous().permute(2, 1, 0, 3))
    torch.cuda.synchronize()
    assert gru_kernel.gru_scan.launches == before[0] + 1
    assert gru_kernel.gru_scan_bwd.launches == before[1] + 1
    _assert_grads_close(got, want)


def test_gru_bwd_rejects_what_the_kernel_does_not_take(card):
    dev, dys = _gru_args(4, 2, 6, card)  # H=6: rows are not whole 16-byte pieces
    ys = gru_kernel.gru_scan_plain(**dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        gru_kernel.gru_scan_bwd(**dev, ys=ys, dys=dys)


def test_gru_wrapper_rejects_mixed_devices(card):
    t, b, h = 4, 2, 8
    with pytest.raises(ValueError, match="w_h"):
        gru_kernel.gru_scan(
            torch.zeros(1, t, b, 3 * h, device=card), torch.zeros(1, h, 3 * h),
            torch.zeros(1, 3 * h, device=card), torch.ones(t, b, device=card),
            torch.zeros(1, b, h, device=card),
        )


def test_pipeline_on_the_card_matches_cpu(card):
    cfg = config.default_cfg()
    cfg.DTYPE.COMPUTE = "float32"
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


def _tiny_gan_cfg():
    return config.apply_overrides(config.default_cfg(), [
        "DATASET_NAME=synthetic", "TREE.BRANCH_NUM=1", "GAN.GF_DIM=4", "GAN.DF_DIM=4", "GAN.Z_DIM=8",
        "GAN.EMBEDDING_DIM=16", "GAN.R_NUM=1", "TEXT.DIMENSION=32", "TRAIN.BATCH_SIZE=8"])


def _host_state(st) -> dict:
    return checkpoint.to_host(st.state_dict())


def _assert_equal_states(got: dict, want: dict, path: str = "") -> None:
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_equal_states(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_states(g, w, f"{path}/{i}")
    elif torch.is_tensor(want):
        assert got.device.type == "cpu" and torch.equal(got, want), path
    else:
        assert got == want, path


def test_checkpoints_move_between_card_and_cpu(card, tmp_path):
    """A state trained a step on the card restores bitwise into a fresh CPU
    state, and one trained on the CPU into a fresh card state."""
    cfg = _tiny_gan_cfg()
    batch = next(iter(cli.synthetic_gan_batches(cfg)(0)))
    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        st = gan.init_state(cfg, device=src)
        gan.train_step(st, batch)
        mgr = checkpoint.CheckpointManager(str(tmp_path / src))
        mgr.save(st.step, st)
        fresh = gan.init_state(cfg, device=dst)
        mgr.restore_latest(fresh)
        assert fresh.device.type == dst and fresh.step == 1
        _assert_equal_states(_host_state(fresh), _host_state(st))
        gan.train_step(fresh, batch)  # the restored optimizer state works where it landed


def test_trainer_resumes_on_the_card(card, tmp_path):
    """3 steps, stop, resume to 6: bitwise the uninterrupted 6 steps, with
    cuDNN's deterministic algorithms (restored afterwards)."""
    cfg = _tiny_gan_cfg()
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        def run(out, **kw):
            t = loop.GanTrainer(cfg, str(out), cli.gan_batch_factory(cfg), device="cuda", image_every=0)
            t.train(max_epoch=2, **kw)
            t.close()
            return t
        want = _host_state(run(tmp_path / "straight", max_steps=6).state)
        assert run(tmp_path / "stopped", max_steps=3).state.step == 3
        got = run(tmp_path / "stopped", max_steps=6)
        assert os.path.exists(tmp_path / "stopped" / "ckpt" / "6.pt")
        _assert_equal_states(_host_state(got.state), want)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _host_batches(n: int, seed: int = 0):
    """``n`` batches shaped like the loaders': a tuple of uint8 images, float
    wavs, int lengths; every batch's values differ."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield {"images": (rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),),
               "wav": rng.standard_normal((4, 50_000)).astype(np.float32),
               "wav_len": rng.integers(1, 50_000, 4).astype(np.int32), "step": 3}


def test_pinned_prefetch_equals_pageable_copies(card):
    """The side-stream copies from the pinned ring equal plain copies, also
    when the consumer's stream is busy while the producer runs ahead and
    refills the ring (depth 2: a ring of 4 buffers per key, 12 batches), and
    when the consumer reads each batch on its own stream at once."""
    from s2i_tpu_torch.data.pipeline import prefetch

    want = [{k: torch.as_tensor(v[0] if k == "images" else v) for k, v in b.items() if k != "step"}
            for b in _host_batches(12)]
    got = []
    for b in prefetch(_host_batches(12), depth=2, device=card):
        torch.cuda._sleep(2_000_000)  # the consumer's stream is busy; the copies run ahead
        got.append({"images": b["images"][0].clone(), "wav": b["wav"] * 1.0, "wav_len": b["wav_len"].clone(),
                    "step": b["step"]})
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["step"] == 3 and g["wav"].is_cuda and g["images"].dtype == torch.uint8
        for k in ("images", "wav", "wav_len"):
            assert torch.equal(g[k].cpu(), w[k]), k


def test_pinned_prefetch_raises_producer_errors_and_reaps_its_thread(card):
    from s2i_tpu_torch.data.pipeline import Prefetcher

    def failing():
        yield from _host_batches(1)
        raise OSError("disk gone")

    pf = Prefetcher(failing(), depth=2, device=card)
    it = iter(pf)
    assert next(it)["wav"].is_cuda
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()


def _spread_gate(card_out, cpu16, cpu32) -> tuple[float, float]:
    """(max|card bf16 - CPU float32|, max|CPU bf16 - CPU float32|) over the
    outputs, the first no larger than twice the second: bfloat16 rounding
    taken in another order lands no further from float32 than the CPU's own
    bfloat16 does, give or take."""
    d = lambda a, b: max((x.float().cpu() - y.float()).abs().max().item() for x, y in zip(a, b))  # noqa: E731
    err, spread = d(card_out, cpu32), d(cpu16, cpu32)
    assert 0 < spread and err <= 2 * spread, (err, spread)
    return err, spread


def test_bf16_generator_and_discriminators_on_the_card_match_cpu(card):
    """A bfloat16 G forward (images, float32) and each D's trunk code and
    logits (float32), card against the CPU, from the same weights."""
    from s2i_tpu_torch.models.discriminator import build_discriminators
    from s2i_tpu_torch.models.generator import GNet

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    z, c = (torch.from_numpy(rng.standard_normal((8, n)).astype(np.float32)) for n in (8, 16))
    nets = {dt: (GNet(8, 8, 16, 32, 3, 1, dt, "transpose"), build_discriminators(3, 8, 16, dtype=dt))
            for dt in (torch.bfloat16, torch.float32)}
    sd_g, sd_d = nets[torch.float32][0].state_dict(), [d.state_dict() for d in nets[torch.float32][1]]
    for g, ds in nets.values():
        g.load_state_dict(sd_g)
        for d, sd in zip(ds, sd_d):
            d.load_state_dict(sd)
    g16c, ds16c = GNet(8, 8, 16, 32, 3, 1, torch.bfloat16, "transpose"), build_discriminators(3, 8, 16,
                                                                                            dtype=torch.bfloat16)
    g16c.load_state_dict(sd_g)
    for d, sd in zip(ds16c, sd_d):
        d.load_state_dict(sd)
    g16c.to(card).eval()
    with torch.no_grad():
        outs = {dt: g.eval()(z, c) for dt, (g, _) in nets.items()}
        got = g16c(z.to(card), c.to(card))
        assert all(x.dtype == torch.float32 for x in got)
        _spread_gate(got, outs[torch.bfloat16], outs[torch.float32])
        imgs = outs[torch.float32]
        for i, dc in enumerate(ds16c):
            dc.to(card).eval()
            ref = {dt: (ds[i].eval().trunk(imgs[i]), *ds[i](imgs[i], c)) for dt, (_, ds) in nets.items()}
            out = (dc.trunk(imgs[i].to(card)), *dc(imgs[i].to(card), c.to(card)))
            assert out[1].dtype == out[2].dtype == torch.float32
            _spread_gate(out, ref[torch.bfloat16], ref[torch.float32])


def test_bf16_moment_adam_on_the_card_matches_cpu(card):
    """TRAIN.MOMENT_DTYPE=bfloat16: 3 steps of the same gradients on the
    card and on the CPU give bitwise equal bfloat16 moments on the large
    leaves (elementwise float32 arithmetic, one operation per kernel), and
    parameters within float32 rounding (the card divides by a scalar as a
    product with its reciprocal)."""
    cfg = config.apply_overrides(config.default_cfg(), ["TRAIN.MOMENT_DTYPE=bfloat16",
                                                        "TRAIN.MOMENT_DTYPE_MIN_SIZE=300"])
    rng = np.random.default_rng(0)
    shapes = [(8, 3, 4, 4), (64, 32), (8,), (16,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    params, opts = {}, {}
    for dev in ("cpu", "cuda"):
        params[dev] = [torch.nn.Parameter(torch.from_numpy(x.copy()).to(dev)) for x in init]
        opts[dev] = gan.make_optimizer(cfg, params[dev], 2e-4)
        for step in grads:
            for p, g in zip(params[dev], step):
                p.grad = torch.from_numpy(g.copy()).to(dev)
            opts[dev].step()
    for pc, pg in zip(params["cpu"], params["cuda"]):
        sc, sg = opts["cpu"].state[pc], opts["cuda"].state[pg]
        if pc.numel() >= 300:
            assert sg["exp_avg"].dtype == sg["exp_avg_sq"].dtype == torch.bfloat16
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(sg[k].cpu(), sc[k]), k
        else:
            assert sg["exp_avg"].dtype == torch.float32
        np.testing.assert_allclose(pg.detach().cpu().numpy(), pc.detach().numpy(), rtol=1e-6, atol=1e-7)
