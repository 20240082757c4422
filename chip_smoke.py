"""Smoke run of the PyTorch/CUDA port on one NVIDIA card:

    python3 chip_smoke.py

Phases, each of which passes or raises (nothing is caught):
  1. device  - the card's name and power limit; no card, no run;
  2. build   - nvcc builds every kernel of the serving path from
               s2i_tpu_torch/csrc/ (one process per source, all at once);
  3. kernels - each kernel against its plain PyTorch version on the card, at
               the shapes the serving path gives it (plus a second log-mel
               geometry), with times from CUDA events;
  4. serve   - the birds config (cfg/birds_3stages.yml) at full width with
               seeded random weights behind the HTTP server: POSTed WAVs come
               back as 256 px PNGs, the kernels' launch counters show that
               the requests went through them, and the same batch through the
               plain versions on the CPU (same weights, same z) agrees.
The last lines are a JSON record of the kernels, the card as nvidia-smi
names it, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import subprocess
import threading
import time
import urllib.request

import numpy as np
import torch

from s2i_tpu_torch import config
from s2i_tpu_torch.audio.frontend import (
    FrontendParams,
    center_pad,
    extract_features,
    frontend_params_from_cfg,
    preemphasize,
)
from s2i_tpu_torch.audio.wavio import write_wav
from s2i_tpu_torch.device import resolve_device
from s2i_tpu_torch.models.layers import BatchNorm
from s2i_tpu_torch.ops import build, gru_kernel, mel_kernel
from s2i_tpu_torch.pipeline import SpeechToImage, build_encoder, build_generator
from s2i_tpu_torch.serving import make_server

# NVIDIA H100 SXM data sheet (700 W): fp32 without tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SEED = 0
BATCH = 8  # the server's batch, and the kernels' batch at the serving shapes
LATENCY_RUNS = 20

# Tolerances, all absolute, float32 sums taken in another order than the
# plain version's: the log-mel (DFT sums of 400 products, then a log),
# the GRU state (512-long dot products over 128 dependent steps), and the
# whole pipeline (card vs CPU, through ~25 conv/BN layers and tanh).
TOL_MEL = 1e-4
TOL_GRU = 1e-5
TOL_FEATS = 5e-4
TOL_IMAGE = 5e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: (ms, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tone_batch(n_samples: int, lens, seed: int) -> np.ndarray:
    """Tones plus a noise floor, zero past each utterance's length."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    wavs = np.zeros((len(lens), n_samples), np.float32)
    for i, n in enumerate(lens):
        x = 0.3 * np.sin(2 * np.pi * 180.0 * (i + 1) * t * (1 + 0.5 * t)) + 0.02 * rng.standard_normal(n_samples)
        wavs[i, :n] = x[:n]
    return wavs


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    resolve_device("cuda")  # float32 throughout: TF32 off for matmuls and cuDNN
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def phase_build() -> None:
    t0 = time.time()
    build.build_all(["mel_fused", "gru_fwd"])
    log(f"[build] mel_fused + gru_fwd in {time.time() - t0:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def check_logmel(p: FrontendParams, wavs: np.ndarray) -> tuple[float, float, float, int]:
    """Kernel vs plain on the card: (max_abs_err, kernel_ms, plain_ms, frames)."""
    x = center_pad(preemphasize(torch.from_numpy(wavs).cuda(), p.preemphasis), p)
    n = min(mel_kernel.num_frames(x.shape[1], p), p.max_frames)
    got = mel_kernel.logmel(x, p, n)
    torch.cuda.synchronize()
    want = mel_kernel.logmel_plain(x, p, n)
    err = (got - want).abs().max().item()
    if not err <= TOL_MEL:
        raise AssertionError(f"log-mel kernel disagrees with its plain version: {err} > {TOL_MEL}")
    k_ms = time_ms(lambda: mel_kernel.logmel(x, p, n))
    p_ms = time_ms(lambda: mel_kernel.logmel_plain(x, p, n))
    return err, k_ms, p_ms, n


def phase_kernels() -> dict:
    cfg = config.cfg_from_file("cfg/birds_3stages.yml")
    p = frontend_params_from_cfg(cfg.AUDIO)
    wavs = tone_batch(p.max_samples, [p.max_samples, 120000, 80000, 164000, 40000, 9000, 150000, 400], 1)
    err, k_ms, p_ms, n = check_logmel(p, wavs)
    flops = 2.0 * 2 * BATCH * n * p.win_length * p.n_bins + 2.0 * BATCH * n * p.n_bins * p.n_mels
    nbytes = 4.0 * (wavs.size + 2 * p.win_length * p.n_bins + p.n_bins * p.n_mels + BATCH * n * p.n_mels)
    b_ms, b_by = bound(flops, nbytes)
    log(f"[kernels] mel_fused birds B={BATCH} wav={p.max_samples} frames={n}: max_abs_err={err:.3g} "
        f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) library_ms=none")
    mel = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # a second geometry: n_fft/hop = 12.8, center padding, preemphasis, ragged
    p2 = FrontendParams(hop_length=40, center=True, preemphasis=0.97, max_frames=4096)
    err2, k2, pl2, n2 = check_logmel(p2, tone_batch(64000, [64000, 30011, 5000, 401, 64000, 12345, 777, 50000], 2))
    log(f"[kernels] mel_fused hop=40 center preemph B={BATCH} frames={n2}: max_abs_err={err2:.3g} "
        f"kernel_ms={k2:.4f} plain_ms={pl2:.4f}")
    mel["max_abs_err"] = max(err, err2)

    # GRU at the encoder's shapes: T=1024/8=128 steps, B=8, H=512, input 256
    t, b, h, c_in = 128, BATCH, int(cfg.ENCODER.RNN_HIDDEN), int(cfg.ENCODER.CONV_CHANNELS[-1])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rnd = lambda *s, scale=1.0: scale * torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    x = rnd(t, b, c_in)
    w_ih, w_hh = rnd(3 * h, c_in, scale=c_in ** -0.5), rnd(3 * h, h, scale=h ** -0.5)
    b_ih, b_hh = rnd(3 * h, scale=0.1), rnd(3 * h, scale=0.1)
    xw = torch.nn.functional.linear(x, w_ih, b_ih).contiguous()
    w_h, h0 = w_hh.t().contiguous(), torch.zeros(b, h, device="cuda")
    lens = torch.tensor([t, 100, 64, 1, t, 77, 120, 0], device="cuda")  # ragged, one all-masked
    mask = (torch.arange(t, device="cuda")[:, None] < lens[None, :]).float()
    got = gru_kernel.gru_scan(xw, w_h, b_hh, mask, h0)
    torch.cuda.synchronize()
    want = gru_kernel.gru_scan_plain(xw, w_h, b_hh, mask, h0)
    err = (got - want).abs().max().item()
    if not err <= TOL_GRU:
        raise AssertionError(f"GRU kernel disagrees with its plain version: {err} > {TOL_GRU}")
    k_ms = time_ms(lambda: gru_kernel.gru_scan(xw, w_h, b_hh, mask, h0))
    p_ms = time_ms(lambda: gru_kernel.gru_scan_plain(xw, w_h, b_hh, mask, h0), reps=5)
    # yardstick: cuDNN's GRU with the same weights at full-length masks (it
    # also does the input projection, which the port leaves to F.linear)
    ref = torch.nn.GRU(c_in, h).cuda()
    with torch.no_grad():
        for name, v in (("weight_ih_l0", w_ih), ("weight_hh_l0", w_hh), ("bias_ih_l0", b_ih), ("bias_hh_l0", b_hh)):
            getattr(ref, name).copy_(v)
        full = torch.ones_like(mask)
        lib_err = (ref(x)[0] - gru_kernel.gru_scan(xw, w_h, b_hh, full, h0)).abs().max().item()
        l_ms = time_ms(lambda: ref(x))
    flops = 2.0 * t * b * h * 3 * h + 12.0 * t * b * h  # h @ W_h + the gates
    nbytes = 4.0 * (xw.numel() + w_h.numel() + b_hh.numel() + mask.numel() + h0.numel() + got.numel())
    b_ms, b_by = bound(flops, nbytes)
    log(f"[kernels] gru_fwd T={t} B={b} H={h}: max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
        f"({1e3 * k_ms / t:.2f} us/step) plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
        f"(cuDNN, max_abs_err vs kernel at full masks {lib_err:.3g}) bound_ms={b_ms:.4f} ({b_by})")
    gru = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
    return {"mel_fused": mel, "gru_fwd": gru}


def embedding(out) -> torch.Tensor:
    """The encoder's embedding, with or without its class logits beside it."""
    return out[0] if isinstance(out, tuple) else out


def seeded_pipeline(cfg, wavs: np.ndarray, lens: np.ndarray, z: np.ndarray):
    """The pipeline on the card with random weights from ``SEED``: the JAX
    package's init scheme (orthogonal convs and linears, BN scales
    ~N(1, 0.02)), then every BatchNorm's running statistics set to those of
    its input on this batch, in the order the forward pass reaches them. A
    random network keeps unit-scale activations through every layer that
    way, so its images span [-1, 1] and the card-vs-CPU comparison below
    tests real values, not a near-constant image.
    Returns (pipe, encoder state_dict, generator state_dict), both on the CPU."""
    torch.manual_seed(SEED)
    enc, g = build_encoder(cfg), build_generator(cfg)
    with torch.no_grad():
        for mod in (enc, g):
            for m in mod.modules():
                if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Linear)):
                    torch.nn.init.orthogonal_(m.weight)
                elif isinstance(m, BatchNorm):
                    m.weight.normal_(1.0, 0.02)
    pipe = SpeechToImage(cfg, enc.state_dict(), g.state_dict(), device="cuda")

    def set_stats(bn, args):
        x = args[0]
        dims = [0, *range(2, x.ndim)]
        bn.running_mean.copy_(x.mean(dims))
        bn.running_var.copy_(x.var(dims, correction=0))

    bns = [m for mod in (pipe.encoder, pipe.g) for m in mod.modules() if isinstance(m, BatchNorm)]
    hooks = [bn.register_forward_pre_hook(set_stats) for bn in bns]
    try:
        with torch.no_grad():
            feats, mask = extract_features(wavs, pipe.p, wav_len=lens, device="cuda")
            mu = pipe.g.ca_net(embedding(pipe.encoder(feats, mask)))[0]
            pipe.g(torch.from_numpy(z).cuda(), mu)
    finally:
        for h in hooks:
            h.remove()
    cpu_sd = lambda mod: {k: v.cpu() for k, v in mod.state_dict().items()}  # noqa: E731
    return pipe, cpu_sd(pipe.encoder), cpu_sd(pipe.g)


def post_wavs(url: str, bodies: list[bytes]) -> list[tuple[int, bytes]]:
    out: list = [None] * len(bodies)

    def post(i: int) -> None:
        req = urllib.request.Request(f"{url}/generate", data=bodies[i], method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            out[i] = (r.status, r.read())

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if any(r is None for r in out):
        raise AssertionError("a request got no answer")
    return out


def phase_serve(card: str) -> dict[str, int]:
    cfg = config.cfg_from_file("cfg/birds_3stages.yml")
    cfg.DTYPE.COMPUTE = "float32"
    p = frontend_params_from_cfg(cfg.AUDIO)
    lens = [p.max_samples, 150000, 120000, 96000, 64000, 48000, 30000, 16000]
    wavs = tone_batch(p.max_samples, lens, 3)
    lens_np = np.asarray(lens, np.int32)
    z = np.random.default_rng(SEED).standard_normal((BATCH, int(cfg.GAN.Z_DIM))).astype(np.float32)
    pipe, enc_sd, g_sd = seeded_pipeline(cfg, wavs, lens_np, z)
    bodies = []
    for w, n in zip(wavs, lens):
        buf = io.BytesIO()
        write_wav(buf, w[:n], p.sample_rate)
        bodies.append(buf.getvalue())

    # the serving path, counted from zero: warmup batch + the POSTed requests
    mel_kernel.logmel.launches = 0
    gru_kernel.gru_scan.launches = 0
    t0 = time.time()
    srv = make_server(pipe, "127.0.0.1", 0, batch_size=BATCH, device="cuda")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            if r.status != 200:
                raise AssertionError(f"/healthz answered {r.status}")
        answers = post_wavs(url, bodies)
    finally:
        srv.shutdown()
        srv.server_close()
    launches = {"mel_fused": mel_kernel.logmel.launches, "gru_fwd": gru_kernel.gru_scan.launches}
    for status, png in answers:
        size = (int.from_bytes(png[16:20], "big"), int.from_bytes(png[20:24], "big"))
        if status != 200 or png[:8] != b"\x89PNG\r\n\x1a\n" or size != (256, 256):
            raise AssertionError(f"bad answer: status {status}, PNG {png[:8]!r} {size}")
    log(f"[serve] {len(answers)} POSTs -> 200 + 256x256 PNG in {time.time() - t0:.1f} s "
        f"(server start and warmup included); launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")

    # the same batch through the plain versions (CPU), same weights, same z
    cpu = SpeechToImage(cfg, enc_sd, g_sd, device="cpu")
    errs = {}
    with torch.inference_mode():
        fc, mc = extract_features(wavs, p, wav_len=lens_np, device="cuda")
        fp, mp = extract_features(wavs, p, wav_len=lens_np, device="cpu")
        if not torch.equal(mc.cpu(), mp):
            raise AssertionError("frame masks differ between card and CPU")
        errs["feats"] = (fc.cpu() - fp).abs().max().item()
        ec, ep = embedding(pipe.encoder(fc, mc)), embedding(cpu.encoder(fp, mp))
        errs["embedding"] = (ec.cpu() - ep).abs().max().item()
    img_c = pipe.generate(wavs, lens_np, z=z)
    img_p = cpu.generate(wavs, lens_np, z=z)
    errs["image"] = float(np.abs(img_c - img_p).max())
    if not (np.isfinite(img_c).all() and img_c.shape == (BATCH, 256, 256, 3)):
        raise AssertionError(f"bad images: {img_c.shape}, finite={np.isfinite(img_c).all()}")
    log(f"[serve] card vs plain (CPU) max_abs_err: feats {errs['feats']:.3g} (tol {TOL_FEATS}) "
        f"embedding {errs['embedding']:.3g} image {errs['image']:.3g} (tol {TOL_IMAGE}); "
        f"image std {img_c.std():.3f}")
    if not (errs["feats"] <= TOL_FEATS and errs["image"] <= TOL_IMAGE):
        raise AssertionError(f"kernel path disagrees with the plain path: {errs}")
    if not img_c.std() > 0.05:
        raise AssertionError(f"near-constant images (std {img_c.std()}): the comparison tests nothing")

    # per-batch latency and peak memory at batch 8
    torch.cuda.reset_peak_memory_stats()
    times = []
    before = mel_kernel.logmel.launches, gru_kernel.gru_scan.launches
    for _ in range(LATENCY_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.generate(wavs, lens_np, seed=1, output_dtype="uint8")
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2**20
    per_batch = ((mel_kernel.logmel.launches - before[0]) / LATENCY_RUNS,
                 (gru_kernel.gru_scan.launches - before[1]) / LATENCY_RUNS)
    parts = {}
    with torch.inference_mode():
        wav_dev = torch.from_numpy(wavs).cuda()
        parts["frontend"] = time_ms(lambda: extract_features(wav_dev, p, wav_len=lens_np), reps=10)
        parts["encoder"] = time_ms(lambda: pipe.encoder(fc, mc), reps=10)
        mu = pipe.g.ca_net(ec)[0]
        zt = torch.from_numpy(z).cuda()
        parts["generator"] = time_ms(lambda: pipe.g(zt, mu), reps=10)
    log(f"[serve] {card}: batch {BATCH} wav->uint8 image latency ms "
        f"median {np.median(times):.2f} min {min(times):.2f} max {max(times):.2f} (n={len(times)}); "
        f"device ms frontend {parts['frontend']:.3f} encoder {parts['encoder']:.3f} "
        f"generator {parts['generator']:.3f}; max_memory_allocated {peak:.0f} MiB; "
        f"launches per batch mel_fused {per_batch[0]:g} gru_fwd {per_batch[1]:g}")
    return launches


def main() -> None:
    name, smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    launches = phase_serve(f"{name} ({smi})")
    rows = []
    for kname, route, src, replaces in (
        ("mel_fused", "cuda", "s2i_tpu_torch/csrc/mel_fused.cu", "s2i_tpu/ops/mel_kernel.py:151"),
        ("gru_fwd", "cuda", "s2i_tpu_torch/csrc/gru_fwd.cu", "s2i_tpu/ops/gru_kernel.py:48"),
    ):
        rows.append({"name": kname, "route": route, "source": src, "replaces": replaces,
                     "launches": launches[kname], **kernels[kname]})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
