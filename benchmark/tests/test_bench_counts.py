"""The yardstick's arithmetic: FLOP counts against ``torch.utils.flop_counter``
on the reference at tiny shapes, byte counts against the tensors' sizes,
the whole-window rate and the trace's reduction."""

from __future__ import annotations

from bench_tiny import tiny_cell  # noqa: F401  (the fixture)

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode


def counted(fn) -> int:
    with FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


def meta_free(cell, part, joint=False):
    from harness import weights
    from reference import models

    m = models.build(cell.cfg, part, joint)
    state = weights.seeded_state(weights.shapes_of("", m), 1, "cpu")
    m.load_state_dict(state)
    return m


def test_generator_flops(tiny_cell):
    from roofline import stackgan

    cell = tiny_cell("birds3-gan-b24")
    g = meta_free(cell, "g")
    b, cfg = 3, cell.cfg
    z, emb = torch.randn(b, cfg["GAN"]["Z_DIM"]), torch.randn(b, cfg["TEXT"]["DIMENSION"])
    want = counted(lambda: g(z, g.ca_net(emb)[0]))
    assert stackgan.g_forward(cfg, b, taps=9) == want
    assert stackgan.g_forward(cfg, b) < want  # the 2×2-tap up-convolution needs less


@pytest.mark.parametrize("scale", [64, 128, 256])
def test_discriminator_flops(tiny_cell, scale):
    from roofline import stackgan

    cell = tiny_cell("birds3-gan-b24")
    d = meta_free(cell, f"d{scale}")
    b, cfg = 2, cell.cfg
    img, c = torch.randn(b, 3, scale, scale), torch.randn(b, cfg["GAN"]["EMBEDDING_DIM"])
    code = d.trunk(img)
    assert counted(lambda: d.trunk(img)) == stackgan.d_trunk(cfg, b, scale)
    assert counted(lambda: d.logits(code, c)) == stackgan.d_cond_head(cfg, b)
    assert counted(lambda: d.uncond_logits(code)) == stackgan.d_uncond_head(cfg, b)


@pytest.mark.parametrize("cls_head", [True, False])
def test_encoder_and_gru_flops(tiny_cell, cls_head):
    from roofline import k2_gru_fwd, shapes, stackgan

    cell = tiny_cell("birds3-encoder-b64")
    cfg = cell.cfg
    enc = meta_free(cell, "encoder", joint=not cls_head)
    b, t = 3, cfg["AUDIO"]["MAX_FRAMES"]
    full = [10**6] * b  # every frame and step valid: the reference computes them all
    feats, mask = torch.randn(b, t, cfg["AUDIO"]["N_MELS"]), torch.ones(b, t, dtype=torch.bool)
    assert counted(lambda: enc(feats, mask)) == stackgan.encoder_forward(cfg, full, cls_head)
    x = torch.randn(b, shapes.encoder_steps(cfg), cfg["ENCODER"]["CONV_CHANNELS"][-1])
    m = torch.ones(b, x.shape[1], dtype=torch.bool)
    h = cfg["ENCODER"]["RNN_HIDDEN"]
    projection = 2 * 2 * b * x.shape[1] * x.shape[2] * 3 * h
    flops, _ = k2_gru_fwd.cost(cfg, {"gru": full})
    gates = 2 * 12 * b * x.shape[1] * h
    assert counted(lambda: enc.rnn(x, m)) - projection == flops - gates


def test_kernel_bytes_are_the_tensors_read_and_written(tiny_cell):
    from roofline import k1_logmel, k2_gru_fwd, k3_gru_bwd, shapes

    cfg = tiny_cell("birds3-encoder-b64").cfg
    g = shapes.frame_geometry(cfg)
    b, n = 3, (g["max_frames"] - 1) * g["hop"] + g["win"]
    _, nbytes = k1_logmel.cost(cfg, {"logmel": [b, n]})
    assert nbytes == 4 * (b * n + b * g["max_frames"] * g["n_mels"] + k1_logmel.filterbank_nonzeros(g))
    d, t, h = 2, shapes.encoder_steps(cfg), cfg["ENCODER"]["RNN_HIDDEN"]
    xw, w_h, b_h, mask, h0, ys = d * t * b * 3 * h, d * h * 3 * h, d * 3 * h, t * b, d * b * h, d * t * b * h
    rec = {"gru": [n] * b, "gru_bwd": True}
    assert k2_gru_fwd.cost(cfg, rec)[1] == 4 * (xw + w_h + b_h + mask + h0 + ys)
    assert k3_gru_bwd.cost(cfg, rec)[1] == 4 * ((xw + w_h + b_h + mask + h0 + 2 * ys) + (xw + w_h + b_h + h0))
    assert k3_gru_bwd.cost(cfg, {"gru": [n] * b, "gru_bwd": False}) is None


def test_valid_steps_follow_the_frontend_and_strides(tiny_cell):
    from roofline import shapes

    cfg = tiny_cell("birds3-encoder-b64").cfg
    g = shapes.frame_geometry(cfg)
    assert shapes.valid_steps(g["win"] - 1, cfg) == 0
    assert shapes.valid_steps(g["win"], cfg) == 1
    assert shapes.valid_steps(10**7, cfg) == shapes.encoder_steps(cfg) == 4  # 32 frames, three strides of 2


def test_rate_is_over_the_whole_window(tiny_cell):
    from harness import spec

    cell = tiny_cell("birds3-gan-b24")
    task = spec.task("train_gan").Task(cell, torch.device("cpu"))
    task.b, task._events = 4, []
    task.work = [{"model": "gan", "batch": 4}] * 7
    assert task.end_to_end(2.0)["gan_images_per_s"] == 7 * 4 / 2.0


def test_trace_reduction():
    from harness.trace import Trace

    dev = [("k_a", 100, 50), ("k_b", 120, 100), ("mel_fused_fft_kernel<8>", 400, 100), ("k_a", 900, 50)]
    host = [("cudaMemcpyAsync", 200, 150), ("cudaLaunchKernel", 260, 5)]
    tr = Trace(dev, host, (0, 1000), [(0, "step"), (300, "featurize")])
    assert tr.busy_s == pytest.approx((120 + 100 + 50) / 1e9)  # [100, 220], [400, 500], [900, 950]
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.device_s(("mel_fused",)) == pytest.approx(100 / 1e9)
    b = tr.breakdown()
    assert sorted(b["device_ops"]) == [["k_a", 1e-7], ["k_b", 1e-7], ["mel_fused_fft_kernel<8>", 1e-7]]
    gaps = b["idle_gaps"]
    assert gaps[0] == ["featurize: no CUDA call", pytest.approx(400 / 1e9)]  # 500 → 900
    assert ["step: cudaMemcpyAsync", pytest.approx(180 / 1e9)] in gaps  # 220 → 400, the copy under way
    assert ["step: no CUDA call", pytest.approx(100 / 1e9)] in gaps  # 0 → 100


def test_roofline_share_and_mfu_from_readings(tiny_cell):
    from harness.runner import Readings
    from harness.trace import Trace
    from roofline import k1_logmel, stackgan

    cell = tiny_cell("birds3-encoder-b64")
    rec = {"model": "encoder", "batch": 4, "logmel": [4, 6000], "gru": [6000, 3000, 1000, 500], "gru_bwd": True}
    tr = Trace([("void (anonymous namespace)::mel_fused_fft_kernel<8>(float const*)", 0, 2000)], [], (0, 10**6), [])
    r = Readings(cell, tr, {}, {}, [rec, rec], 1e-3)
    flops, nbytes = k1_logmel.cost(cell.cfg, rec)
    least = max(flops / r.peaks["fp32_flops"], nbytes / r.peaks["hbm_bytes_per_s"])
    assert r.roofline_share("k1_logmel") == pytest.approx(100 * 2 * least / 2e-6)
    assert r.roofline_share("k2_gru_fwd") is None  # no launch in the trace: nothing to read
    assert r.mfu("stackgan") == pytest.approx(100 * 2 * stackgan.step_flops(cell.cfg, rec) / (1e-3 * r.peaks["bf16_flops"]))
