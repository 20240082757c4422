"""Same-call A/B of the live serve path on one card: this checkout's
``SpeechToImage`` against another checkout's (an earlier commit, from
``git archive``), at the full width of ``cfg/birds_3stages.yml``, batch 8,
in float32 and in the cfg's own bfloat16. Run from the repo root on a card:

    python3 tools_torch/serve_ab.py --old DIR [--runs 20]

The two packages share a name, so each version runs in a process of its
own, in turns: earlier, current, current, earlier. A process builds its
kernels, makes the pipeline from seeded weights (the package's init
schemes) and the 8 tone WAVs of chip_smoke.py's serve phase, then reads:

- ``latency``: host ms of ``generate(..., output_dtype="uint8")``, each
  call synchronized (median, min, max of ``--runs``, after 3 of warm-up);
- ``device_ms``: CUDA-event ms per call of the frontend, the encoder and G,
  back to back (chip_smoke.py's "device ms"; where the host is slower than
  the device, this is the host's pace);
- ``host_us``: host microseconds per call of the same parts and of each
  kernel's public wrapper (``mel_kernel.logmel``, ``gru_kernel.gru_scan``)
  at the shapes the pipeline gives them, 200 calls queued without a sync;
- ``kernel_us``: CUDA-event microseconds per wrapper call with the host
  ahead of the device (a ~25 ms device sleep first).

Prints one line per version run and a JSON line of every number.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
BATCH = 8
SEED = 0


def time_ms(torch, fn, reps: int = 20, warmup: int = 3, queued: bool = False) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(torch, fn, reps: int = 200) -> float:
    """Host microseconds per call, the calls queued without a sync."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def worker(root: str, runs: int) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from s2i_tpu_torch import config
    from s2i_tpu_torch.audio.frontend import extract_features
    from s2i_tpu_torch.models import encoder as encoder_model
    from s2i_tpu_torch.ops import build, gru_kernel, mel_kernel
    from s2i_tpu_torch.pipeline import SpeechToImage, build_encoder, build_generator
    from s2i_tpu_torch.train import encoder as encoder_train
    from s2i_tpu_torch.train import gan

    if not Path(gru_kernel.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise SystemExit(f"imported {gru_kernel.__file__}, not the package under {root}")
    build.build_all(["mel_fused", "gru_fwd", "gru_bwd", "mel_framed"])
    out = {}
    for compute in ("float32", "bfloat16"):
        cfg = config.cfg_from_file(str(Path(root) / "cfg" / "birds_3stages.yml"))
        cfg.DTYPE.COMPUTE = compute
        gen = torch.Generator().manual_seed(SEED)
        enc, g = build_encoder(cfg), build_generator(cfg)
        encoder_train.init_weights(enc, gen)
        gan.init_weights(g, [], gen)
        pipe = SpeechToImage(cfg, enc.state_dict(), g.state_dict(), device="cuda")
        p = pipe.p
        lens = np.asarray([p.max_samples, 150000, 120000, 96000, 64000, 48000, 30000, 16000], np.int32)
        rng = np.random.default_rng(3)
        t = np.arange(p.max_samples) / 16000.0
        wavs = np.zeros((BATCH, p.max_samples), np.float32)
        for i, n in enumerate(lens):
            x = 0.3 * np.sin(2 * np.pi * 180.0 * (i + 1) * t * (1 + 0.5 * t)) + 0.02 * rng.standard_normal(t.size)
            wavs[i, :n] = x[:n]

        for _ in range(3):
            pipe.generate(wavs, lens, seed=1, output_dtype="uint8")
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.generate(wavs, lens, seed=1, output_dtype="uint8")
            times.append(1e3 * (time.perf_counter() - t0))

        with torch.inference_mode():
            wav_dev = torch.from_numpy(wavs).cuda()
            feats, mask = extract_features(wav_dev, p, wav_len=lens)
            seen = []
            scan = encoder_model.gru_scan

            def record(*args):
                seen.append(args)
                return scan(*args)

            encoder_model.gru_scan = record
            try:
                emb = pipe.encoder(feats, mask)
            finally:
                encoder_model.gru_scan = scan
            emb = emb[0] if isinstance(emb, tuple) else emb
            mu = pipe.g.ca_net(emb)[0]
            z = torch.randn((BATCH, int(cfg.GAN.Z_DIM)), device="cuda", generator=torch.Generator("cuda").manual_seed(1))
            n_frames = min(mel_kernel.num_frames(wav_dev.shape[1], p), p.max_frames)
            parts = {
                "frontend": lambda: extract_features(wav_dev, p, wav_len=lens),
                "encoder": lambda: pipe.encoder(feats, mask),
                "generator": lambda: pipe.g(z, mu),
            }
            kernels = {
                "logmel": lambda: mel_kernel.logmel(wav_dev, p, n_frames),
                "gru_scan": lambda: gru_kernel.gru_scan(*seen[0]),
            }
            out[compute] = {
                "latency_ms": {"median": float(np.median(times)), "min": min(times), "max": max(times)},
                "device_ms": {k: time_ms(torch, f, reps=10) for k, f in parts.items()},
                "host_us": {**{k: host_us(torch, f, reps=20) for k, f in parts.items()},
                            **{k: host_us(torch, f) for k, f in kernels.items()}},
                "kernel_us": {k: 1e3 * time_ms(torch, f, reps=50, queued=True) for k, f in kernels.items()},
                "gru_calls_per_encoder": len(seen),
            }
        del pipe
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="root of the earlier checkout")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.runs)), flush=True)
        return
    if not args.old:
        ap.error("--old DIR is required")
    name_limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {name_limit}", flush=True)
    results = []
    for tag, root in (("old", args.old), ("new", str(HERE)), ("new", str(HERE)), ("old", args.old)):
        t0 = time.time()
        proc = subprocess.run([sys.executable, __file__, "--worker", root, "--runs", str(args.runs)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{tag} worker failed:\n{proc.stdout}\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append({"version": tag, **res})
        for compute, r in res.items():
            lat = r["latency_ms"]
            print(f"{tag} {compute}: latency ms median {lat['median']:.3f} min {lat['min']:.3f} max {lat['max']:.3f}; "
                  "device ms " + " ".join(f"{k} {v:.3f}" for k, v in r["device_ms"].items())
                  + "; host us " + " ".join(f"{k} {v:.1f}" for k, v in r["host_us"].items())
                  + "; kernel us " + " ".join(f"{k} {v:.1f}" for k, v in r["kernel_us"].items())
                  + f" ({time.time() - t0:.0f} s)", flush=True)
    print(json.dumps({"card": name_limit, "runs": results}))


if __name__ == "__main__":
    main()
