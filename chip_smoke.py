"""Smoke run of the PyTorch/CUDA port on one NVIDIA card:

    python3 chip_smoke.py

Phases, each of which passes or raises (nothing is caught):
  1. device  - the card's name and power limit; no card, no run;
  2. build   - nvcc builds every kernel from s2i_tpu_torch/csrc/ (one
               process per source, all at once);
  3. kernels - each kernel against its plain PyTorch version on the card, at
               the shapes the serving path gives it (plus a second log-mel
               geometry), at the encoder training shapes (batch 64), at the
               joint finetune's (batch 24) and, for the framed log-mel K4, at
               the frontend A/B shape, with times from CUDA events. The
               log-mel kernels print the branch they took (FFT or dense
               DFT), their and the plain version's distance from the float64
               arithmetic (the FFT branch may be no further from it), their
               time warm and with L2 flushed, their bounds (the branch's
               operations at their types' peaks or bytes; the float32
               bound and the dense DFT's beside it), and the cuFFT route
               as a yardstick. The GRU
               kernels run as the paths call them, both directions of the
               layer in one launch (plus one direction alone at batch 64),
               beside cuDNN's GRU on the same weights; the backward runs
               twice and must be bitwise repeatable, and its parts (gate
               SGEMM, chain, dW_h SGEMM + db_h) are timed;
  4. serve   - the birds config (cfg/birds_3stages.yml), in float32, at full width with
               seeded random weights behind the HTTP server: POSTed WAVs come
               back as 256 px PNGs, the kernels' launch counters show that
               the requests went through them, and the same batch through the
               plain versions on the CPU (same weights, same z) agrees;
  5. train   - encoder distillation pretraining of
               cfg/pretrain_encoder_birds.yml in float32 at full width (batch 64, 1024
               frames, bi-GRU H=512, 200 classes) through run_encoder_pretrain
               on 64 ragged synthetic WAVs: featurize (K1) → encoder (K2) →
               loss → backward (K3) → Adam; the launch counters show each
               step went through the three kernels, once each, the first
               step matches the same step on the CPU through the plain
               versions, and the step time is measured;
  6. mel_ab  - K4's path, the frontend A/B of the JAX package's
               scripts/perf_cert.py::cert_mel: log-mel of a seeded 8 × 64000
               standard-normal wav (then the birds serve batch) through the
               frame gather + K4, through K1 and through the plain version,
               each route's error against the plain one and its device time;
  7. gan     - GAN training of cfg/birds_3stages.yml in float32 at full width (3 stages
               to 256 px, batch 24) through run_gan_training on synthetic
               uint8 top-scale images: 3 counted steps, the first step card
               vs CPU at batch 4 (every loss term, gradient and BN statistic),
               then the step time, its parts and peak memory;
  8. joint   - the same for cfg/birds_joint_ft.yml: the speech encoder in
               G's optimizer group on ragged synthetic WAVs, featurized per
               step (K1), its recurrence through K2 forward and K3 backward;
  8b. ddp    - data parallelism (s2i_tpu_torch/parallel/) on
               cfg/birds_3stages.yml at full width in float32, global batch
               24, ranks spawned as torchrun would (this script with
               --ddp-rank SPEC): (a) NCCL over every visible card (at most
               4; one on a one-card machine), the first step bitwise the
               one-process step on the same global batch when that repeats
               bitwise (cuDNN deterministic), then the step time beside the
               gan phase's one-process median, a pmean's host µs, and a
               GanTrainer that saves a step and resumes from it on every
               rank (Adam's host-side step counts replicated over the gloo
               group); (b) 2 gloo ranks sharing the
               card, 12 rows each: the first GAN and joint steps against the
               one-process steps with the GAN step's gates, parameters and
               buffers bitwise equal across the ranks, K1, K2 and K3 once
               per rank in the joint step, gloo step times as a check;
  9. bf16    - the cfgs' own compute type, bfloat16 (phases 4, 5, 7, 8 set
               DTYPE.COMPUTE float32 against it, as their gates are
               float32's): a dtype audit of a joint step (G's and the Ds'
               conv and BN outputs bfloat16; images, logits, the GRU's
               input and the embedding float32), the serve batch's images
               and the first GAN step (batch 4) on the card and the CPU in
               bfloat16 against the CPU's float32, the card no further
               from it than twice the CPU's bfloat16; then serve, encoder,
               GAN, joint and GAN with bfloat16 Adam moments, each timed
               with its device parts and peak memory beside those phases'
               float32 numbers, K1/K2/K3 launches, the checkpoint's bytes
               with bfloat16 moments;
  9b. export - the deployment path (s2i_tpu_torch/export.py): the bf16
               phase's serve pipeline (cfg/birds_3stages.yml, full width,
               the serve phase's seeded weights) saved with torch.export at
               batch sizes 1 and 8; a fresh process with the model modules
               blocked loads it and serves the 8 tone WAVs (K1 and K2
               launches per program call, printed), and in this process the
               artifact holds against the live pipeline with the same seed
               (B=8, one program call; B=3, padded; B=12, two chunks, the
               second at the derived seed): uint8 images no more than one
               level apart on at most 0.1% of the pixels; POSTs through
               make_server(loaded); export and load seconds, artifact
               bytes, first-call ms, batch latency at B=8 and device memory
               after load and at peak, artifact beside the live pipeline;
               its launches are those of the loaded program's calls alone;
  9c. ckpt   - checkpoint interchange with the reference project
               (s2i_tpu_torch/port/): a seeded GAN state of
               cfg/birds_3stages.yml at full width in float32 (G the serve
               phase's, the EMA equal to it) through export-torch-gan to
               reference netG.pth / netD{64,128,256}.pth, netG re-saved under
               module. with num_batches_tracked and the serve phase's
               encoder saved as a reference .pth the same way; then
               port-torch-gan and port_encoder read them back and the ported
               pair (ENCODER.CONV_PADDING torch) serves the serve phase's 8
               WAVs at 256 px through SpeechToImage.from_checkpoints: uint8
               images bitwise those of the pipeline of the source
               state_dicts, float images within TOL_IMAGE of the plain
               versions on the CPU, K1 once and K2 RNN_LAYERS times a batch;
               export-torch-gan of the ported checkpoint gives the files'
               tensors back bitwise; command seconds, file bytes and batch
               latency;
 10. loop    - the trainer loop (train.loop.GanTrainer) on the joint cfg,
               in bfloat16 with bfloat16 Adam moments, at
               full width, batch 24, with cuDNN's deterministic algorithms:
               4 steps straight, and 2 steps, a stop, and a resume by a new
               trainer to step 4; the two final states (every parameter,
               buffer, Adam state, EMA, the step) must be bitwise equal (else
               the resume must lie within the spread of two straight runs and
               the checkpoint round trip must be bitwise: the phase prints
               which held); checkpoint bytes, save and restore ms, BN recalc
               under the EMA (EVAL.EMA_BN_RECALC batches) ms with the
               trainer's G untouched, sample_to_dir images/s, and the serve
               phase's WAVs through SpeechToImage.from_checkpoints of the
               run, bitwise equal to a pipeline of the trainer's in-memory
               EMA state; K1, K2 and K3 once per step, K1 and K2 per serve;
               with TRAIN.TENSORBOARD on, the straight run's event file
               read back by utils/logging.read_events (every checksum, the
               tags, steps and float32 values of its scalars.jsonl, its
               sample grid at step 4 equal to the grid PNG) and the event
               writer's host cost on a step's scalars and on the grid;
 11. data    - the real-data path through the port's CLI at full birds
               width, in the cfgs' bfloat16: a StackGAN tree made from SEED
               (tools_torch/make_fixture_dataset.py: 8 classes x 7 images
               at 500 px, 10 captions each, WAVs of 3 000-164 080 samples),
               then entrypoints.main pretrain-encoder (1 epoch), --extract
               (speech-embeddings.pickle of both splits, shapes and
               finiteness, one row against the float32 pipeline's embedding
               of its WAV alone, no further than twice the bfloat16
               pipeline's), train birds_3stages (2 epochs) and
               birds_joint_ft (1 epoch, NET_E), and sample eval_birds (a
               PNG per test file name and sample); K1, K2 (and K3) once per
               step and extraction batch; which image loader ran, the
               loaders' host rates, the wav batch's copy pageable against
               pinned, and windows of encoder and GAN steps on made-ahead
               and loader batches through the pinned prefetch, with the
               device's idle share between steps; DATA.PIPELINE grain
               (data/grain_pipeline.py): two epochs at GRAIN_WORKERS 0 and
               2 bitwise equal and their images/s, then train
               birds_3stages through entrypoints.main on grain batches (2
               forked decode workers, 20 steps, TRAIN.TENSORBOARD: the
               event file read back against scalars.jsonl), and the tools
               tools_torch/validate_data.py (exit 0), inspect_ckpt.py (the
               grain run's element total) and synthesize_speech.py --tone
               (WAVs read back), each a process of its own;
 12. eval    - the evaluation layer (s2i_tpu_torch/eval/, no kernel of
               its own): InceptionV3 at 299 px in float32 with seeded
               weights, BN scale and bias randomized and BN statistics
               from a train-mode pass over G's images, card vs CPU on 8
               of G's 256 px images (and the quantized resize); 2 x 1024
               images of
               cfg/birds_3stages.yml's seeded G in its bfloat16 through
               InceptionFeatures(quantize_input=True) at EVAL.FID_BATCH:
               IS over 10 splits >= 1, FID(X, X) ~ 0, FID(X, Y) > 0,
               pipelined extraction bitwise equal to the serial loop;
               images/s pipelined and serial, the forward's device ms per
               batch beside its bound, peak memory, FID's host ms beside
               scipy's sqrtm; then on the data phase's tree (deleted
               after this phase) the eval, eval --retrieval,
               finetune-inception (1 epoch, 299 px, batch 32) and eval
               --finetuned_ckpt commands, and the finetune step's ms;
 13. cert    - the quality-certification harness (s2i_tpu_torch/scripts/)
               at full birds width in the cfgs' bfloat16 on a seeded
               fixture of 4 classes x 4 images x 2 captions: quality_cert
               (cfg/birds_3stages.yml, BN recalc), encoder_quality_cert,
               joint_quality_cert (a 1-epoch pretrain, then the joint cfg
               with NET_E), posthoc_quality_eval of the quality run, each
               with 2 training steps, an eval after each and a 1-epoch
               Inception finetune at 299 px, then eval_smoke (the port's
               commands in subprocesses); every record finite, K3 once per
               training step and none in the quality cert, each cert's
               seconds and K1/K2/K3 launches.
The last lines are a JSON record of the kernels, the card as nvidia-smi
names it, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import hashlib
import io
import itertools
import json
import math
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import scipy.linalg
import torch
from PIL import Image

from s2i_tpu_torch import cli, config, entrypoints, native, parallel
from s2i_tpu_torch import export as s2i_export
from s2i_tpu_torch.audio import filters
from s2i_tpu_torch.audio.frontend import (
    FrontendParams,
    center_pad,
    extract_features,
    frontend_params_from_cfg,
    preemphasize,
)
from s2i_tpu_torch.audio.wavio import read_wav, write_wav
from s2i_tpu_torch.data import SyntheticGanDataset, synthetic_wavs
from s2i_tpu_torch.data.grain_pipeline import grain_batches
from s2i_tpu_torch.data.pipeline import Prefetcher
from s2i_tpu_torch.data.stackgan import GanEpochIterator, SpeechEpochIterator, StackGanSplit
from s2i_tpu_torch.device import compute_dtype, resolve_device
from s2i_tpu_torch.eval import InceptionFeatures, fid_from_stats, gaussian_stats, inception_score_from_probs
from s2i_tpu_torch.eval.features import preprocess
from s2i_tpu_torch.eval.finetune import init_inception_state, make_inception_train_step
from s2i_tpu_torch.eval.inception_score import softmax
from s2i_tpu_torch.models import encoder as encoder_model
from s2i_tpu_torch.models.discriminator import DLogits
from s2i_tpu_torch.models.generator import ToRGB
from s2i_tpu_torch.models.inception import InceptionV3
from s2i_tpu_torch.models.inception import init_weights as init_inception
from s2i_tpu_torch.models.layers import BatchNorm, Conv2d
from s2i_tpu_torch.ops import build, gru_kernel, mel_kernel
from s2i_tpu_torch.pipeline import SpeechToImage, build_encoder, build_generator
from s2i_tpu_torch.port import port_encoder
from s2i_tpu_torch.scripts import (encoder_quality_cert, eval_smoke, joint_quality_cert, posthoc_quality_eval,
                                   quality_cert)
from s2i_tpu_torch.serving import make_server
from s2i_tpu_torch.train import encoder as encoder_train
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.train.loop import PREFETCH_DEPTH, GanTrainer
from s2i_tpu_torch.train.encoder import encoder_train_step, init_encoder_state
from s2i_tpu_torch.train.losses import distillation_loss
from s2i_tpu_torch.utils import CheckpointManager
from s2i_tpu_torch.utils.checkpoint import to_host
from s2i_tpu_torch.utils.logging import EventWriter, read_events
from tools_torch.make_fixture_dataset import make_fixture, tone_synthesize

# NVIDIA H100 SXM data sheet (700 W): fp32 and fp64 without tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
PEAK_BYTES_PER_S = 3.35e12
SEED = 0
BATCH = 8  # the server's batch, and the kernels' batch at the serving shapes
TRAIN_BATCH = 64  # ENCODER.BATCH_SIZE of cfg/pretrain_encoder_birds.yml
LATENCY_RUNS = 20
TRAIN_STEPS = 3  # steps of the counted training run
STEP_RUNS = 12  # timed training steps, after 2 of warm-up
GAN_BATCH = 24  # TRAIN.BATCH_SIZE of cfg/birds_3stages.yml and cfg/birds_joint_ft.yml
GAN_STEPS = 3  # steps of each counted GAN run
GAN_STEP_RUNS = 10  # timed GAN steps, after 2 of warm-up
CHECK_BATCH = 4  # batch of the first GAN step held card vs CPU
LOOP_STEPS = 4  # steps of the loop phase's runs; the stopped run stops at half of them
LOOP_SAMPLES = 48  # embeddings sampled to PNGs by the loop phase, GAN_BATCH at a time
DATA_CLASSES, DATA_PER_CLASS, DATA_CAPTIONS = 8, 7, 10  # the data phase's tree: CUB's 10 captions an image
DATA_TRAIN = DATA_CLASSES * (DATA_PER_CLASS - 1)  # one image of each class is the test split's
DATA_IMAGE_PX = 500  # CUB's photos are about 500 px on the long side
DATA_WAV_SAMPLES = (3000, 164080)  # up to the longest utterance the birds frontend takes
DATA_STEPS = 14  # timed encoder steps of each data-phase window
DATA_GAN_STEPS = 10  # timed GAN steps of each data-phase window
GRAIN_WORKERS = 2  # DATA.GRAIN_WORKERS of the data phase's grain loader and run
GRAIN_EPOCHS = 10  # epochs of the grain run: 20 steps, the trainer's log_every, so that it logs once
EVAL_IMAGES = 1024  # G images of each set the eval phase scores
EVAL_GEN_BATCH = 24  # TRAIN.BATCH_SIZE of cfg/birds_3stages.yml
EVAL_SPLITS = 10  # the StackGAN IS protocol's splits
EVAL_CHECK = 8  # G images held card vs CPU through InceptionV3
FINETUNE_BATCH = 32  # finetune-inception's --batch default
FINETUNE_STEPS = 6  # timed finetune steps, after 2 of warm-up
AB_SHAPE = (8, 64000)  # scripts/perf_cert.py::cert_mel's wav batch
FLUSH_BYTES = 256 << 20  # written between launches of a cold timing: five times the H100's 50 MB L2
EXPORT_BATCHES = (1, BATCH)  # the artifact's batch sizes, scripts/export.py's default
CERT_FIXTURE = ("--classes", "4", "--per_class", "4", "--captions", "2")  # the cert phase's fixture
CERT_STEPS = 2  # training steps of each cert, an eval after each
CERT_BATCH = 8  # GAN and encoder batch of the cert phase: its train splits hold 8 (test_per_class 2) to 12 images

# kernel name → (wrapper whose .launches counts it, source, the TPU kernel it replaces)
KERNELS = {
    "mel_fused": (mel_kernel.logmel, "s2i_tpu_torch/csrc/mel_fused.cu", "s2i_tpu/ops/mel_kernel.py:151"),
    "gru_fwd": (gru_kernel.gru_scan, "s2i_tpu_torch/csrc/gru_fwd.cu", "s2i_tpu/ops/gru_kernel.py:48"),
    "gru_bwd": (gru_kernel.gru_scan_bwd, "s2i_tpu_torch/csrc/gru_bwd.cu", "s2i_tpu/ops/gru_kernel.py:67"),
    "mel_framed": (mel_kernel.logmel_frames, "s2i_tpu_torch/csrc/mel_framed.cu", "s2i_tpu/ops/mel_kernel.py:37"),
}

# Tolerances, all absolute, float32 sums taken in another order than the
# plain version's: the log-mel (DFT sums of 400 products, then a log),
# the GRU state (512-long dot products over 128 dependent steps), and the
# whole pipeline (card vs CPU, through ~25 conv/BN layers and tanh).
TOL_MEL = 1e-4
TOL_GRU = 1e-5
TOL_FEATS = 5e-4
TOL_IMAGE = 5e-4
# The GRU backward, relative to the largest magnitude of each output: dW_h
# and db_h sum T·B = 8192 products, dxw and dh0 carry a sum over 128
# reverse steps.
TOL_GRU_BWD = 5e-6
# The first training step, card vs CPU, through BN batch statistics (whose
# gradients subtract means), 128-step recurrences both ways and 3 convs:
# loss relative to itself, each gradient relative to its tensor's largest
# magnitude, the updated BN running statistics relative to max(1, |stat|).
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = 1e-3
TOL_TRAIN_STATS = 1e-4
# The first GAN step, card vs CPU, at full width and batch 4: every loss
# term relative to itself; the BN running statistics of G, the Ds (and the
# encoder) relative to max(1, |stat|). The gradients are held as a whole per
# network (G with CA, each D, the encoder: the norm of the difference over
# the norm), by their median tensor and by their worst tensor (max-abs error
# over the tensor's largest magnitude). Two float32 steps on the same CPU
# that differ only in their convolution code are as far apart as the card
# is from the CPU (tools/cudnn_probe.py): a few LeakyReLU inputs lie within
# rounding of 0, so their slope is 1 in one step and 0.2 in the other, and
# at 4×4 maps over 4 examples one such flip moves a D256 weight's gradient
# by 15% of its largest element; and the G phase runs against Ds that
# Adam's first step moved by ±lr per weight, by the sign of its gradient,
# also where that gradient is at rounding level. The tolerances sit just
# above what the card reads (per network 1.12e-2, median 4.4e-3, worst
# tensor 0.151), which is that CPU-vs-CPU spread.
TOL_GAN_LOSS = 1e-4
TOL_GAN_GRAD_NET = 1.5e-2
TOL_GAN_GRAD_MEDIAN = 6e-3
TOL_GAN_GRAD_TENSOR = 0.2
TOL_GAN_STATS = 1e-4
# InceptionV3 at 299 px in float32 (TF32 off), card vs CPU: pool3 and the
# logits relative to their largest magnitude (sums over ~95 layers in
# cuDNN's order); the quantized resize absolute (one rounding per tap sum).
TOL_INCEPTION = 1e-3
TOL_PREPROCESS = 1e-5
# The artifact against the live pipeline, same kernels and cuDNN calls on
# one card: uint8 images at most one level apart (a value within rounding
# of a .5 edge), on at most this share of the pixels.
TOL_ARTIFACT_PIXELS = 1e-3


# step medians (ms) of the train, gan and joint phases on batches made ahead
# in host memory, for the data phase to print beside its loader-fed steps
MADE_AHEAD_MS: dict[str, float] = {}
ADDED_S: dict[str, float] = {}  # seconds of the grain, TensorBoard and tools checks, by phase
REPO = os.path.dirname(os.path.abspath(__file__))
# the float32 phases' results, for the bf16 phase: each path's times, parts
# and peak memory ("serve", "train", "gan", "joint"), the serve phase's
# weights, batch and CPU images ("serve_ref"), the gan phase's CPU float32
# first-step record ("gan_cpu_step")
F32: dict[str, dict] = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


def time_ms(fn, reps: int = 20, warmup: int = 3, queued: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls. queued: a
    ~25 ms device sleep first, so that the host has queued every call before
    the first starts (for a call shorter than its own host overhead)."""
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


def timed_steps(step, n: int, warmup: int = 2) -> tuple[list[float], float, object]:
    """Host ms of ``n`` synchronized calls of ``step`` after ``warmup`` of
    warm-up, the peak device memory (MiB) over them and the last call's
    result."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times, torch.cuda.max_memory_allocated() / 2**20, out


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """The least time the card could take: (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
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
    build.build_all(list(KERNELS))
    log(f"[build] {' + '.join(KERNELS)} in {time.time() - t0:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def time_cold_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` with the L2 cache flushed before each call
    (a FLUSH_BYTES write outside the timed events)."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


# Operations of one R-point DFT in registers (mel_common.cuh's dft_regs<R>):
# radix 2 one complex add and sub; radix 4 eight; radix 8 two radix-4 DFTs,
# the W_8 and W_8^3 products (2 adds + 2 products each) and eight complex
# adds or subs.
BUTTERFLY_OPS = {2: 4, 4: 16, 8: 56}
CMUL_OPS = 6  # a complex product: 4 products + 2 adds


def mel_fft_ops(p: FrontendParams, frames: int) -> tuple[float, float]:
    """(float64, float32) operations of the FFT branch on ``frames`` frames,
    as mel_common.cuh does them. float64: the window (win products), the
    M = n_fft/2-point Stockham FFT (per stage of radix R, M/R butterflies,
    each BUTTERFLY_OPS[R] plus R-1 twiddle products after the first stage),
    the split step (9 per bin: per pair (k, M-k) two differences and eight
    FMAs) and the power (3 per bin), over M + 1 bins. float32: the sparse
    mel projection (one FMA per non-zero weight) and per mel two adds and
    the log."""
    m = p.n_fft // 2
    fft, ns = 0.0, 1
    for radix in mel_kernel.fft_radices(m):
        fft += m // radix * (BUTTERFLY_OPS[radix] + (radix - 1) * CMUL_OPS * (ns > 1))
        ns *= radix
    f64 = p.win_length + fft + 12.0 * (m + 1)
    f32 = 2.0 * np.count_nonzero(p.mel_fb) + 3.0 * p.n_mels
    return frames * f64, frames * f32


def mel_dft_flops(p: FrontendParams, frames: int) -> float:
    """Operations of the dense windowed DFT + dense mel projection."""
    return frames * (2.0 * 2 * p.win_length * p.n_bins + 2.0 * p.n_bins * p.n_mels)


def mel_bounds(p: FrontendParams, frames: int, in_bytes: float, out_bytes: float) -> dict:
    """bound_ms / bound_by of the branch the kernels take for ``p``, with the
    float32 bound (``f32_bound_ms``: the same work at the float32 peak, as a
    float32 kernel could do it) and the dense DFT's bound (``dft_bound_ms``)
    beside it, each with its own constant tables read once. The FFT branch
    does its window, FFT, split and power in float64 and its mel and log in
    float32: its bound is the largest of the bytes' time and each type's
    operations over that type's peak (the H100 has separate float64 and
    float32 units). The DFT branch computes in float32."""
    nbytes = in_bytes + out_bytes + mel_kernel.fft_table(p).nbytes
    f64, f32 = mel_fft_ops(p, frames)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, max(f64 / PEAK_FP64_FLOPS, f32 / PEAK_FP32_FLOPS)
    f32_ms, f32_by = bound(f64 + f32, nbytes)
    dft_tables = 4.0 * (2 * p.win_length * p.n_bins + p.n_bins * p.n_mels)
    dft_ms, dft_by = bound(mel_dft_flops(p, frames), in_bytes + out_bytes + dft_tables)
    if mel_kernel.kernel_branch(p) == "fft":
        return dict(bound_ms=1e3 * max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                    f32_bound_ms=f32_ms, f32_bound_by=f32_by, dft_bound_ms=dft_ms)
    return dict(bound_ms=dft_ms, bound_by=dft_by, f32_bound_ms=dft_ms, f32_bound_by=dft_by, dft_bound_ms=dft_ms)


def logmel_f64(frames: torch.Tensor, p: FrontendParams) -> torch.Tensor:
    """The plain arithmetic in float64 on the card, from the float64 tables
    (window-folded DFT, filterbank) that the float32 ones are cast from:
    frames [..., win] → log-mel [..., n_mels]."""
    cos, sin = (torch.from_numpy(t).cuda() for t in filters.windowed_dft_matrices(p.win_length, p.n_fft))
    fb = torch.from_numpy(filters.mel_filterbank(p.sample_rate, p.n_fft, p.n_mels, p.fmin, p.fmax,
                                                 htk=p.htk_mel, norm=p.mel_norm)).cuda()
    x = frames.double()
    return torch.log(((x @ cos) ** 2 + (x @ sin) ** 2) @ fb.T + p.log_offset)


def cufft_route(frames: torch.Tensor, p: FrontendParams):
    """A yardstick the port never calls: torch.fft.rfft (cuFFT) of the
    windowed frames [..., win] zero-padded to n_fft, power, mel matmul, log."""
    window = torch.from_numpy(filters.hann_window(p.win_length).astype(np.float32)).cuda()
    fb_t = torch.as_tensor(p.mel_fb, device="cuda").T.contiguous()

    def run() -> torch.Tensor:
        spec = torch.fft.rfft(frames * window, n=p.n_fft)
        return torch.log((spec.real ** 2 + spec.imag ** 2) @ fb_t + p.log_offset)
    return run


def mel_errors(got, plain, cufft, frames: torch.Tensor, p: FrontendParams, what: str) -> dict:
    """Kernel vs plain (raises past TOL_MEL), and kernel, plain and the cuFFT
    route against the float64 arithmetic (the first two held by
    check_mel_precision once every row is printed)."""
    err = (got - plain).abs().max().item()
    if not err <= TOL_MEL:
        raise AssertionError(f"{what} disagrees with its plain version: {err} > {TOL_MEL}")
    want = logmel_f64(frames, p).view(got.shape)
    f64 = lambda y: (y.double().view(got.shape) - want).abs().max().item()  # noqa: E731
    return dict(max_abs_err=err, f64_err=f64(got), plain_f64_err=f64(plain), cufft_f64_err=f64(cufft))


def check_mel_precision(rows: dict[str, dict]) -> None:
    """The FFT branch, which rounds another way than the plain version's
    float32 DFT, must be no further than it from the float64 arithmetic."""
    worse = {label: (r["f64_err"], r["plain_f64_err"]) for label, r in rows.items()
             if r["branch"] == "fft" and not r["f64_err"] <= r["plain_f64_err"]}
    if worse:
        raise AssertionError(f"log-mel kernels further from float64 than the plain version (kernel, plain): {worse}")


def mel_times(kernel, plain, cufft) -> dict:
    """Device ms of a log-mel kernel warm and with L2 flushed, its plain
    version and the cuFFT route. No single PyTorch call computes the
    function, so library_ms is None."""
    return dict(ms=time_ms(kernel, queued=True), ms_l2_flushed=time_cold_ms(kernel),
                plain_ms=time_ms(plain, queued=True), cufft_route_ms=time_ms(cufft, queued=True),
                library_ms=None)


def log_mel_row(name: str, label: str, shape: str, row: dict) -> None:
    log(f"[kernels] {name} yardstick {label}: cuFFT route (torch.fft.rfft of the windowed frames, power, "
        f"mel matmul, log; the port never calls it) {row['cufft_route_ms']:.4f} ms, vs float64 "
        f"{row['cufft_f64_err']:.3g}")
    log(f"[kernels] {name} {label} {shape}: branch {row['branch']} max_abs_err={row['max_abs_err']:.3g} "
        f"(vs float64: kernel {row['f64_err']:.3g}, plain {row['plain_f64_err']:.3g}) kernel_ms={row['ms']:.4f} "
        f"(L2 flushed {row['ms_l2_flushed']:.4f}) plain_ms={row['plain_ms']:.4f} "
        f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}; float32 {row['f32_bound_ms']:.5f} "
        f"({row['f32_bound_by']}); dense DFT {row['dft_bound_ms']:.4f}) library_ms=none")


def kernel_logmel(p: FrontendParams, wavs: np.ndarray, label: str) -> dict:
    """K1 on ``wavs`` against its plain version, float64 and the cuFFT
    route."""
    x = center_pad(preemphasize(torch.from_numpy(wavs).cuda(), p.preemphasis), p)
    n = min(mel_kernel.num_frames(x.shape[1], p), p.max_frames)
    got = mel_kernel.logmel(x, p, n)
    torch.cuda.synchronize()
    frames = x.unfold(-1, p.win_length, p.hop_length)[:, :n]
    route = cufft_route(frames, p)
    row = dict(branch=mel_kernel.logmel.branch,
               **mel_errors(got, mel_kernel.logmel_plain(x, p, n), route(), frames, p, f"K1 {label}"))
    row.update(mel_times(lambda: mel_kernel.logmel(x, p, n), lambda: mel_kernel.logmel_plain(x, p, n), route))
    b = wavs.shape[0]
    covered = (n - 1) * p.hop_length + p.win_length  # the samples the frames read, per utterance
    row.update(mel_bounds(p, b * n, 4.0 * b * covered, 4.0 * b * n * p.n_mels))
    log_mel_row("mel_fused", label, f"B={b} wav={x.shape[1]} frames={n}", row)
    return row


def kernel_mel_framed(p: FrontendParams, wavs: np.ndarray, label: str) -> dict:
    """K4 on the frame rows of ``wavs`` against its plain version, float64
    and the cuFFT route. The bound reads the win samples of each row that
    count (the window is zero past them)."""
    x = center_pad(preemphasize(torch.from_numpy(wavs).cuda(), p.preemphasis), p)
    rows = mel_kernel.frame_rows(x, p, mel_kernel.num_frames(x.shape[1], p))
    got = mel_kernel.logmel_frames(rows, p)
    torch.cuda.synchronize()
    frames = rows[:, : p.win_length]
    route = cufft_route(frames, p)
    row = dict(branch=mel_kernel.logmel_frames.branch,
               **mel_errors(got, mel_kernel.logmel_framed_plain(rows, p), route(), frames, p, f"K4 {label}"))
    row.update(mel_times(lambda: mel_kernel.logmel_frames(rows, p), lambda: mel_kernel.logmel_framed_plain(rows, p),
                         route))
    r = rows.shape[0]
    row.update(mel_bounds(p, r, 4.0 * r * p.win_length, 4.0 * r * p.n_mels))
    log_mel_row("mel_framed", label, f"B={wavs.shape[0]} wav={wavs.shape[1]} rows={r}x{p.n_fft}", row)
    return row


def ab_wavs() -> np.ndarray:
    """perf_cert.py::cert_mel's input: seeded standard-normal 8 × 64000."""
    return np.random.default_rng(SEED).standard_normal(AB_SHAPE).astype(np.float32)


def gru_setup(t: int, b: int, h: int, c_in: int, lens, h0_scale: float = 0.0, d: int = 2) -> dict:
    """Seeded inputs of one GRU layer of ``d`` directions on the card: x,
    nn.GRU-layout weights [D, ...], the port's stacked xw [D, T, B, 3H] /
    w_h [D, H, 3H], a mask from ``lens`` and h0 [D, B, H] (zeros, or
    ``h0_scale`` * N(0, 1))."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rnd = lambda *s, scale=1.0: scale * torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    g = dict(x=rnd(t, b, c_in))
    g["w_ih"], g["w_hh"] = rnd(d, 3 * h, c_in, scale=c_in ** -0.5), rnd(d, 3 * h, h, scale=h ** -0.5)
    g["b_ih"], g["b_hh"] = rnd(d, 3 * h, scale=0.1), rnd(d, 3 * h, scale=0.1)
    g["xw"] = torch.stack([torch.nn.functional.linear(g["x"], g["w_ih"][i], g["b_ih"][i]) for i in range(d)])
    g["w_h"] = g["w_hh"].transpose(1, 2).contiguous()
    g["h0"] = rnd(d, b, h, scale=h0_scale) if h0_scale else torch.zeros(d, b, h, device="cuda")
    lens = torch.as_tensor(lens, device="cuda")
    g["mask"] = (torch.arange(t, device="cuda")[:, None] < lens[None, :]).float()
    return g


def cudnn_gru(g: dict) -> torch.nn.GRU:
    """The yardstick: cuDNN's GRU (bidirectional for D=2) holding the same weights."""
    d = g["w_h"].shape[0]
    ref = torch.nn.GRU(g["x"].shape[-1], g["w_h"].shape[1], bidirectional=d == 2).cuda()
    with torch.no_grad():
        for i, sfx in enumerate(("", "_reverse")[:d]):
            for name, v in (("weight_ih", g["w_ih"]), ("weight_hh", g["w_hh"]),
                            ("bias_ih", g["b_ih"]), ("bias_hh", g["b_hh"])):
                getattr(ref, f"{name}_l0{sfx}").copy_(v[i])
    return ref


def gru_label(xw) -> str:
    d, t, b, h3 = xw.shape
    return f"D={d} T={t} B={b} H={h3 // 3}"


def kernel_gru_fwd(g: dict) -> dict:
    xw, w_h, b_hh, mask, h0 = (g[k] for k in ("xw", "w_h", "b_hh", "mask", "h0"))
    d, t, b, h = xw.shape[0], xw.shape[1], xw.shape[2], w_h.shape[1]
    got = gru_kernel.gru_scan(xw, w_h, b_hh, mask, h0)
    torch.cuda.synchronize()
    want = gru_kernel.gru_scan_plain(xw, w_h, b_hh, mask, h0)
    err = (got - want).abs().max().item()
    if not err <= TOL_GRU:
        raise AssertionError(f"GRU kernel disagrees with its plain version: {err} > {TOL_GRU}")
    k_ms = time_ms(lambda: gru_kernel.gru_scan(xw, w_h, b_hh, mask, h0))
    p_ms = time_ms(lambda: gru_kernel.gru_scan_plain(xw, w_h, b_hh, mask, h0), reps=5)
    # yardstick: cuDNN's GRU, both directions, with the same weights at
    # full-length masks (it also does the input projection, which the port
    # leaves to F.linear)
    ref = cudnn_gru(g)
    with torch.no_grad():
        full = torch.ones_like(mask)
        x, h0_ref = g["x"], h0
        ours = gru_kernel.gru_scan(xw, w_h, b_hh, full, h0).permute(1, 2, 0, 3).reshape(t, b, d * h)
        lib_err = (ref(x, h0_ref)[0] - ours).abs().max().item()
        l_ms = time_ms(lambda: ref(x, h0_ref))
    flops = d * (2.0 * t * b * h * 3 * h + 12.0 * t * b * h)  # h @ W_h + the gates, every direction
    nbytes = 4.0 * (xw.numel() + w_h.numel() + b_hh.numel() + mask.numel() + h0.numel() + got.numel())
    b_ms, b_by = bound(flops, nbytes)
    log(f"[kernels] gru_fwd {gru_label(xw)}: max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
        f"({1e3 * k_ms / t:.2f} us/step) plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
        f"(cuDNN {'bidirectional ' if d == 2 else ''}GRU, max_abs_err vs kernel at full masks {lib_err:.3g}) "
        f"bound_ms={b_ms:.4f} ({b_by})")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)


def gru_bwd_parts_ms(args) -> dict[str, float]:
    """Device ms of K3's parts (median of 5 calls, by the chain's time), from
    the CUDA events the kernel records between its launches."""
    runs = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        gru_kernel.gru_scan_bwd(*args, events=ev)
        torch.cuda.synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    gates, chain, dw = sorted(runs, key=lambda r: r[1])[2]
    return {"gate_sgemm": gates, "chain": chain, "dw_sgemm_db": dw}


def kernel_gru_bwd(g: dict) -> dict:
    xw, w_h, b_hh, mask, h0 = (g[k] for k in ("xw", "w_h", "b_hh", "mask", "h0"))
    d, t, b, h = xw.shape[0], xw.shape[1], xw.shape[2], w_h.shape[1]
    ys = gru_kernel.gru_scan_plain(xw, w_h, b_hh, mask, h0)
    dys = torch.randn(ys.shape, generator=torch.Generator(device="cuda").manual_seed(SEED + 1), device="cuda")
    args = (xw, w_h, b_hh, mask, h0, ys, dys)
    got = gru_kernel.gru_scan_bwd(*args)
    again = gru_kernel.gru_scan_bwd(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
        raise AssertionError("two calls of the GRU backward kernel on the same inputs differ")
    want = gru_kernel.gru_scan_bwd_plain(*args)
    errs = {name: ((a - w).abs().max().item(), w.abs().max().item())
            for name, a, w in zip(("dxw", "dw_h", "db_h", "dh0"), got, want)}
    for name, (err, scale) in errs.items():
        if not err <= TOL_GRU_BWD * max(1.0, scale):
            raise AssertionError(f"GRU backward kernel disagrees with its plain version on {name}: "
                                 f"{err} > {TOL_GRU_BWD} * {scale}")
    k_ms = time_ms(lambda: gru_kernel.gru_scan_bwd(*args))
    parts = gru_bwd_parts_ms(args)
    p_ms = time_ms(lambda: gru_kernel.gru_scan_bwd_plain(*args), reps=3)
    # yardstick: cuDNN's GRU (both directions) forward+backward minus its
    # forward, full masks, same weights and h0 (its backward also gives dx
    # and dW_ih)
    ref = cudnn_gru(g)
    x = g["x"].clone().requires_grad_()
    leaves = [x, *ref.parameters()]
    dys_ref = dys.permute(1, 2, 0, 3).reshape(t, b, d * h)
    f_ms = time_ms(lambda: ref(x, h0))
    fb_ms = time_ms(lambda: torch.autograd.grad(ref(x, h0)[0], leaves, dys_ref))
    l_ms = fb_ms - f_ms
    # three products of 2·T·B·H·3H per direction (gate recompute, dhg @ W_h^T, h^T dhg) + the gates
    flops = d * (3 * 2.0 * t * b * h * 3 * h + 40.0 * t * b * h)
    nbytes = 4.0 * (sum(a.numel() for a in args) + sum(a.numel() for a in got))
    b_ms, b_by = bound(flops, nbytes)
    rel = " ".join(f"{k}={e:.3g}/{s_:.3g}" for k, (e, s_) in errs.items())
    log(f"[kernels] gru_bwd {gru_label(xw)}: max_abs_err/max_abs {rel} (tol {TOL_GRU_BWD} relative; two calls "
        f"bitwise equal) kernel_ms={k_ms:.4f} ({1e3 * k_ms / t:.2f} us/step; parts ms "
        + " ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f") plain_ms={p_ms:.4f} library_ms={l_ms:.4f} (cuDNN {'bidirectional ' if d == 2 else ''}GRU "
        f"fwd+bwd {fb_ms:.4f} - fwd {f_ms:.4f}, full masks) bound_ms={b_ms:.4f} ({b_by})")
    return dict(max_abs_err=max(e for e, _ in errs.values()), ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=l_ms, parts_ms=parts)


def train_lengths(n_samples: int) -> np.ndarray:
    """64 utterance lengths from the full 164,080 samples down to 3,000."""
    lens = np.linspace(n_samples, 3000, TRAIN_BATCH).round().astype(np.int32)
    return np.random.default_rng(SEED).permutation(lens)


def phase_kernels() -> dict:
    cfg = config.cfg_from_file("cfg/birds_3stages.yml")
    p = frontend_params_from_cfg(cfg.AUDIO)
    wavs = tone_batch(p.max_samples, [p.max_samples, 120000, 80000, 164000, 40000, 9000, 150000, 400], 1)
    mel = kernel_logmel(p, wavs, "birds")

    # a second geometry: n_fft/hop = 12.8, center padding, preemphasis, ragged
    p2 = FrontendParams(hop_length=40, center=True, preemphasis=0.97, max_frames=4096)
    mel["hop40"] = kernel_logmel(p2, tone_batch(64000, [64000, 30011, 5000, 401, 64000, 12345, 777, 50000], 2),
                                 "hop=40 center preemph")
    mel["max_abs_err"] = max(mel["max_abs_err"], mel["hop40"]["max_abs_err"])

    # GRU at the encoder's shapes, both directions of the layer in one call:
    # T=1024/8=128 steps, B=8, H=512, input 256
    t, h, c_in = 128, int(cfg.ENCODER.RNN_HIDDEN), int(cfg.ENCODER.CONV_CHANNELS[-1])
    gru = kernel_gru_fwd(gru_setup(t, BATCH, h, c_in, [t, 100, 64, 1, t, 77, 120, 0]))  # ragged, one all-masked

    # the training shapes: batch 64, ragged lengths with one all-masked row, non-zero h0
    mel["train"] = kernel_logmel(p, tone_batch(p.max_samples, train_lengths(p.max_samples), 4), "birds train")
    lens = np.random.default_rng(SEED).integers(1, t + 1, TRAIN_BATCH)
    lens[0], lens[-1] = t, 0
    g64 = gru_setup(t, TRAIN_BATCH, h, c_in, lens, h0_scale=0.5)
    gru["train"] = kernel_gru_fwd(g64)
    gru_bwd = kernel_gru_bwd(g64)
    # one direction alone (a cfg with RNN_BIDIRECTIONAL: False), same batch
    g64_1 = gru_setup(t, TRAIN_BATCH, h, c_in, lens, h0_scale=0.5, d=1)
    gru["train_one_direction"] = kernel_gru_fwd(g64_1)
    gru_bwd["train_one_direction"] = kernel_gru_bwd(g64_1)
    for row in (mel, gru, gru_bwd):
        row["max_abs_err"] = max(row["max_abs_err"], row.get("train", row)["max_abs_err"],
                                 row.get("train_one_direction", row)["max_abs_err"])

    # the joint finetune's shapes: batch 24 of the path's own ragged WAVs,
    # and the GRU at B=24, one row all-masked, non-zero h0
    jwavs, _ = synthetic_wavs(np.arange(GAN_BATCH) % 8, p.max_samples, seed=SEED)
    mel["joint"] = kernel_logmel(p, jwavs, "birds joint")
    lens = np.random.default_rng(SEED + 1).integers(1, t + 1, GAN_BATCH)
    lens[0], lens[-1] = t, 0
    g24 = gru_setup(t, GAN_BATCH, h, c_in, lens, h0_scale=0.5)
    gru["joint"] = kernel_gru_fwd(g24)
    gru_bwd["joint"] = kernel_gru_bwd(g24)
    for row in (mel, gru, gru_bwd):
        row["max_abs_err"] = max(row["max_abs_err"], row["joint"]["max_abs_err"])

    # K4 at its A/B shape, and at the birds serve shape (the function of K1)
    framed = kernel_mel_framed(FrontendParams(), ab_wavs(), "A/B")
    framed["serve"] = kernel_mel_framed(p, wavs, "birds serve")
    framed["max_abs_err"] = max(framed["max_abs_err"], framed["serve"]["max_abs_err"])
    check_mel_precision({"K1 serve": mel, **{f"K1 {k}": mel[k] for k in ("hop40", "train", "joint")},
                         "K4 A/B": framed, "K4 serve": framed["serve"]})
    return {"mel_fused": mel, "gru_fwd": gru, "gru_bwd": gru_bwd, "mel_framed": framed}


def embedding(out) -> torch.Tensor:
    """The encoder's embedding, with or without its class logits beside it."""
    return out[0] if isinstance(out, tuple) else out


def seeded_pipeline(cfg, wavs: np.ndarray, lens: np.ndarray, z: np.ndarray):
    """The pipeline on the card with random weights from ``SEED``: the
    package's init schemes (``train.encoder.init_weights``,
    ``train.gan.init_weights``), then every BatchNorm's running statistics
    set to those of its input on this batch, in the order the forward pass
    reaches them. A random network keeps unit-scale activations through
    every layer that way, so its images span [-1, 1] and the card-vs-CPU
    comparison below tests real values, not a near-constant image.
    Returns (pipe, encoder state_dict, generator state_dict), both on the CPU."""
    gen = torch.Generator().manual_seed(SEED)
    enc, g = build_encoder(cfg), build_generator(cfg)
    encoder_train.init_weights(enc, gen)
    gan.init_weights(g, [], gen)
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


def serve_wavs(p: FrontendParams) -> tuple[np.ndarray, np.ndarray]:
    """The serve phase's BATCH tone WAVs, up to the longest the frontend takes, and their lengths."""
    lens = np.asarray([p.max_samples, 150000, 120000, 96000, 64000, 48000, 30000, 16000], np.int32)
    return tone_batch(p.max_samples, lens, 3), lens


def phase_serve(card: str) -> dict[str, int]:
    """The birds serve path in float32 (``DTYPE.COMPUTE`` set against the
    cfg's bfloat16; the bf16 phase runs the cfg's own type)."""
    cfg = config.cfg_from_file("cfg/birds_3stages.yml")
    cfg.DTYPE.COMPUTE = "float32"
    p = frontend_params_from_cfg(cfg.AUDIO)
    wavs, lens_np = serve_wavs(p)
    lens = lens_np.tolist()
    z = np.random.default_rng(SEED).standard_normal((BATCH, int(cfg.GAN.Z_DIM))).astype(np.float32)
    pipe, enc_sd, g_sd = seeded_pipeline(cfg, wavs, lens_np, z)
    bodies = []
    for w, n in zip(wavs, lens):
        buf = io.BytesIO()
        write_wav(buf, w[:n], p.sample_rate)
        bodies.append(buf.getvalue())

    # the serving path, counted from zero: warmup batch + the POSTed requests
    reset_counts()
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
    launches = read_counts()
    for status, png in answers:
        size = (int.from_bytes(png[16:20], "big"), int.from_bytes(png[20:24], "big"))
        if status != 200 or png[:8] != b"\x89PNG\r\n\x1a\n" or size != (256, 256):
            raise AssertionError(f"bad answer: status {status}, PNG {png[:8]!r} {size}")
    log(f"[serve] DTYPE.COMPUTE float32: {len(answers)} POSTs -> 200 + 256x256 PNG in {time.time() - t0:.1f} s "
        f"(server start and warmup included); launches {launches}")
    if not (launches["mel_fused"] and launches["gru_fwd"]):
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
    if per_batch != (1, 1):
        raise AssertionError(f"launches per batch {per_batch}, expected K1 and K2 once each")
    F32["serve"] = {"times": times, "parts": parts, "peak": peak}
    F32["serve_ref"] = {"enc_sd": enc_sd, "g_sd": g_sd, "wavs": wavs, "lens": lens_np, "z": z, "img_cpu": img_p}
    return launches


def train_batch(p: FrontendParams, n_classes: int, emb_dim: int) -> dict:
    """64 ragged synthetic WAVs with a teacher embedding and a class id each."""
    rng = np.random.default_rng(SEED + 5)
    lens = train_lengths(p.max_samples)
    return {"wav": tone_batch(p.max_samples, lens, 5), "wav_len": lens,
            "teacher": rng.standard_normal((TRAIN_BATCH, emb_dim)).astype(np.float32),
            "class_id": rng.integers(0, n_classes, TRAIN_BATCH)}


def step_parts_ms(state, raw: dict, p: FrontendParams) -> dict[str, float]:
    """Device ms of one training step's parts (CUDA events): featurize
    (host wav → log-mel, K1), forward + loss (K2), backward (K3), Adam. The
    parts are those of encoder_train_step, spelled out to put events between
    them."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    model = state.model
    ev[0].record()
    batch = cli.featurize(raw, p, "cuda")
    ev[1].record()
    emb, logits = model(batch["feats"], batch["feat_mask"])
    teacher = torch.as_tensor(batch["teacher"], device="cuda")
    labels = torch.as_tensor(batch["class_id"], device="cuda").long()
    loss, _ = distillation_loss(emb, teacher, logits, labels, state.ce_coeff)
    ev[2].record()
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    ev[3].record()
    state.opt.step()
    ev[4].record()
    torch.cuda.synchronize()
    names = ("featurize", "forward", "backward", "adam")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def phase_train(card: str) -> dict[str, int]:
    cfg = config.cfg_from_file("cfg/pretrain_encoder_birds.yml")
    cfg.DTYPE.COMPUTE = "float32"  # against the cfg's bfloat16: the bf16 phase runs that
    cfg.ENCODER.LOG_EVERY = 1
    e = cfg.ENCODER
    p = frontend_params_from_cfg(cfg.AUDIO)
    raw = train_batch(p, int(e.N_CLASSES), int(cfg.TEXT.DIMENSION))
    log(f"[train] {cfg.CONFIG_NAME}, DTYPE.COMPUTE float32: batch {e.BATCH_SIZE}, {p.max_samples} samples -> {p.max_frames} frames "
        f"x {p.n_mels} mels, convs {list(e.CONV_CHANNELS)} k{e.CONV_KERNEL} s{e.CONV_STRIDE}, "
        f"bi-GRU H={e.RNN_HIDDEN}, {e.N_CLASSES} classes, CE_COEFF {e.CE_COEFF}, Adam lr {e.LR}; "
        f"wav lengths {raw['wav_len'].min()}..{raw['wav_len'].max()}")
    if int(e.BATCH_SIZE) != TRAIN_BATCH:
        raise AssertionError(f"{cfg.CONFIG_NAME}: batch {e.BATCH_SIZE}, expected {TRAIN_BATCH}")

    # the training path, counted from zero: TRAIN_STEPS steps of run_encoder_pretrain
    reset_counts()
    run_dir = os.path.join(cfg.OUTPUT_DIR, f"chip_smoke_encoder_{os.getpid()}")
    t0 = time.time()
    mets = cli.run_encoder_pretrain(cfg, steps=TRAIN_STEPS, device="cuda", run_dir=run_dir,
                                    wav_batches=lambda epoch: [raw] * TRAIN_STEPS)
    launches = read_counts()
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    losses = [rec["loss"] for rec in lines]
    log(f"[train] run_encoder_pretrain {TRAIN_STEPS} steps in {time.time() - t0:.1f} s (first-call "
        f"set-up included): losses {losses}, last {mets}; launches {launches}")
    if len(losses) != TRAIN_STEPS or not all(isinstance(v, float) and np.isfinite(v) for v in losses):
        raise AssertionError(f"training losses not finite, or not one per step: {losses}")
    shutil.rmtree(run_dir)  # its checkpoint: the loop phase tests checkpoints
    want = {"mel_fused": TRAIN_STEPS, "gru_fwd": TRAIN_STEPS, "gru_bwd": TRAIN_STEPS, "mel_framed": 0}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want} (K1, K2 and K3 once per step)")

    # the same first step on the card and on the CPU through the plain
    # versions: same seeded weights, same batch
    states = {dev: init_encoder_state(cfg, device=dev) for dev in ("cuda", "cpu")}
    step_mets = {dev: encoder_train_step(st, cli.featurize(raw, p, dev)) for dev, st in states.items()}
    loss_c, loss_p = float(step_mets["cuda"]["loss"]), float(step_mets["cpu"]["loss"])
    if not np.isfinite(loss_c):
        raise AssertionError(f"loss on the card is not finite: {loss_c}")
    grad_err, zero = {}, []
    params_p = dict(states["cpu"].model.named_parameters())
    for name, pc in states["cuda"].model.named_parameters():
        gc, gp = pc.grad, params_p[name].grad
        if gc is None or not gc.abs().max().item() > 0:
            zero.append(name)
            continue
        grad_err[name] = (gc.cpu() - gp).abs().max().item() / gp.abs().max().item()
    if zero:
        raise AssertionError(f"encoder parameters with no gradient on the card: {zero}")
    sd_p = states["cpu"].model.state_dict()
    stat_err = max((v.cpu() - sd_p[k]).abs().max().item() / max(1.0, sd_p[k].abs().max().item())
                   for k, v in states["cuda"].model.state_dict().items() if "running" in k)
    worst = max(grad_err, key=grad_err.get)
    loss_err = abs(loss_c - loss_p) / abs(loss_p)
    log(f"[train] first step card vs plain (CPU): loss {loss_c:.6f} vs {loss_p:.6f} (rel err {loss_err:.3g}, "
        f"tol {TOL_TRAIN_LOSS}); grads of {len(grad_err)} tensors, all non-zero, worst max_abs_err/max_abs "
        f"{grad_err[worst]:.3g} ({worst}; tol {TOL_TRAIN_GRAD}); BN running stats {stat_err:.3g} "
        f"(tol {TOL_TRAIN_STATS})")
    if not (loss_err <= TOL_TRAIN_LOSS and grad_err[worst] <= TOL_TRAIN_GRAD and stat_err <= TOL_TRAIN_STATS):
        raise AssertionError("the card's training step disagrees with the plain path")

    # step time: featurize + encoder_train_step, host clock, synchronized
    state = states["cuda"]
    times, peak, m = timed_steps(lambda: encoder_train_step(state, cli.featurize(raw, p, "cuda")), STEP_RUNS)
    if not np.isfinite(float(m["loss"])):
        raise AssertionError(f"loss not finite after {state.step} steps: {m}")
    parts = [step_parts_ms(state, raw, p) for _ in range(3)]
    med = {k: float(np.median([pt[k] for pt in parts])) for k in parts[0]}
    MADE_AHEAD_MS["encoder"] = float(np.median(times))
    F32["train"] = {"times": times, "parts": med, "peak": peak}
    log(f"[train] {card}: batch {TRAIN_BATCH} step (featurize + encoder_train_step) ms "
        f"median {np.median(times):.2f} min {min(times):.2f} max {max(times):.2f} (n={len(times)}); "
        f"device ms (median of 3) " + " ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f" sum {sum(med.values()):.3f}; max_memory_allocated {peak:.0f} MiB; loss after "
        f"{state.step} steps {float(m['loss']):.4f}")
    return launches


def phase_mel_ab(card: str) -> dict[str, int]:
    """K4's path: the frontend A/B of the three log-mel routes, at the A/B
    shape and at the birds serve shape. The counted run is one call of each
    route per shape; the timing loops after it are not counted."""
    birds = frontend_params_from_cfg(config.cfg_from_file("cfg/birds_3stages.yml").AUDIO)
    cases = [("A/B", FrontendParams(), ab_wavs()),
             ("birds serve", birds, tone_batch(birds.max_samples, [birds.max_samples] * BATCH, 6))]
    inputs, outs = [], []
    reset_counts()
    for _, p, wavs in cases:
        w = torch.from_numpy(wavs).cuda()
        x = center_pad(preemphasize(w, p.preemphasis), p)
        n = mel_kernel.num_frames(x.shape[1], p)
        routes = {
            "framed (gather + K4)": lambda w=w, p=p: mel_kernel.logmel_framed(w, p),
            "fused (K1)": lambda x=x, p=p, n=n: mel_kernel.logmel(x, p, n),
            "plain": lambda x=x, p=p, n=n: mel_kernel.logmel_framed_plain(
                mel_kernel.frame_rows(x, p, n), p).view(x.shape[0], n, p.n_mels),
        }
        inputs.append((routes, w.shape[0] * n))
        outs.append({name: fn() for name, fn in routes.items()})
    torch.cuda.synchronize()
    launches = read_counts()
    if launches["mel_framed"] != len(cases):
        raise AssertionError(f"K4 launches {launches}, expected {len(cases)}")
    for (label, p, wavs), (routes, frames), out in zip(cases, inputs, outs):
        errs = {name: (y - out["plain"]).abs().max().item() for name, y in out.items() if name != "plain"}
        if not all(e <= TOL_MEL for e in errs.values()):
            raise AssertionError(f"[mel_ab] {label}: a route disagrees with the plain version: {errs}")
        ms = {name: time_ms(fn) for name, fn in routes.items()}
        log(f"[mel_ab] {card}: {label} B={wavs.shape[0]} wav={wavs.shape[1]} frames={frames}: " + "; ".join(
            f"{name} {t:.4f} ms ({frames / t * 1e3:.4g} frames/s"
            + (f", max_abs_err vs plain {errs[name]:.3g})" if name in errs else ")")
            for name, t in ms.items()))
    return launches


DDP_CASES = {"gan": "cfg/birds_3stages.yml", "joint": "cfg/birds_joint_ft.yml"}
DDP_MAX_CARDS = 4  # the NCCL part's ranks: every visible card, at most this many
DDP_STEP_RUNS = 10  # timed steps of the NCCL part, after 2 of warm-up (as GAN_STEP_RUNS)
DDP_GLOO_RUNS = 2  # timed steps of each gloo case after its first (no more warm-up): a check, not a rate
DDP_TIMEOUT_S = 400  # a rank's collectives, and the wait for its process


def gan_cfg(path: str, batch: int, compute: str | None = None):
    """``path`` on synthetic data at ``batch``; ``compute`` replaces the
    cfg's DTYPE.COMPUTE when given."""
    cfg = config.cfg_from_file(path)
    cfg.DATASET_NAME = "synthetic"
    cfg.TRAIN.BATCH_SIZE = batch
    if compute:
        cfg.DTYPE.COMPUTE = compute
    return cfg


def step_modules(st: gan.GanTrainState) -> dict:
    mods = {"g": st.models.g, **{f"d{i}": d for i, d in enumerate(st.models.ds)}}
    if st.models.encoder is not None:
        mods["enc"] = st.models.encoder
    return mods


def first_step_inputs(path: str, compute: str | None = None, batch: int = CHECK_BATCH) -> tuple:
    """(cfg at ``batch`` in ``compute``, host batch, z, eps) of the first-step check."""
    cfg = gan_cfg(path, batch, compute)
    raw = next(iter(cli.synthetic_gan_batches(cfg)(0)))
    rng = np.random.default_rng(SEED + 7)
    z = rng.standard_normal((batch, int(cfg.GAN.Z_DIM))).astype(np.float32)
    eps = rng.standard_normal((batch, int(cfg.GAN.EMBEDDING_DIM))).astype(np.float32)
    return cfg, raw, z, eps


def first_step(cfg, raw: dict, z: np.ndarray, eps: np.ndarray, dev: str) -> tuple[gan.GanTrainState, dict]:
    """One step from the seeded init on ``dev``: (state, record), the record
    holding the metrics, every gradient and every BN running statistic on
    the CPU, keyed by network."""
    st = gan.init_state(cfg, device=dev)
    batch = cli.featurize(raw, frontend_params_from_cfg(cfg.AUDIO), dev) if cfg.TRAIN.JOINT_FT else raw
    return st, step_record(st, gan.train_step(st, batch, z, eps))


def step_record(st: gan.GanTrainState, mets: dict) -> dict:
    """The step's metrics, every gradient and every BN running statistic of
    ``st`` on the CPU, keyed by network."""
    rec = {"mets": {k: float(v) for k, v in mets.items()}, "grads": {}, "stats": {}}
    for part, mod in step_modules(st).items():
        for name, prm in mod.named_parameters():
            rec["grads"][f"{part}.{name}"] = None if prm.grad is None else prm.grad.detach().cpu()
        for k, v in mod.state_dict().items():
            if "running" in k:
                rec["stats"][f"{part}.{k}"] = v.detach().cpu()
    return rec


def step_errors(got: dict, want: dict) -> dict:
    """``got``'s first-step record against ``want``'s: each metric's relative
    error, each gradient's max-abs error over the tensor's largest magnitude,
    each network's |diff|/|grad|, each BN statistic's error over
    max(1, |stat|), and the gradients that are missing or all zero."""
    loss = {k: abs(v - want["mets"][k]) / max(abs(want["mets"][k]), 1e-6)
            for k, v in got["mets"].items() if "_acc" not in k}
    tensor, zero, sums = {}, [], {}
    for name, gw in want["grads"].items():
        gg = got["grads"][name]
        if gg is None or not gg.abs().max().item() > 0:
            zero.append(name)
            continue
        d = gg - gw
        tensor[name] = d.abs().max().item() / gw.abs().max().item()
        s = sums.setdefault(name.split(".")[0], [0.0, 0.0])
        s[0] += d.square().sum().item()
        s[1] += gw.square().sum().item()
    stats = {k: (got["stats"][k] - v).abs().max().item() / max(1.0, v.abs().max().item())
             for k, v in want["stats"].items()}
    return {"loss": loss, "tensor": tensor, "zero": zero, "stats": stats,
            "net": {part: (d2 / n2) ** 0.5 for part, (d2, n2) in sums.items()}}


def gan_first_step_vs_cpu(path: str) -> tuple[gan.GanTrainState, dict]:
    """The first step of the cfg at full width and batch CHECK_BATCH in
    float32, on the card and on the CPU, from the same seeded weights, batch
    and noise; raises unless they agree. Returns the card's state, one step
    in, and the CPU's record."""
    cfg, raw, z, eps = first_step_inputs(path, "float32")
    st, rec = first_step(cfg, raw, z, eps, "cuda")
    _, rec_cpu = first_step(cfg, raw, z, eps, "cpu")
    e = step_errors(rec, rec_cpu)
    if e["zero"]:
        raise AssertionError(f"parameters with no gradient on the card: {e['zero']}")
    worst = {name: max(e[name], key=e[name].get) for name in ("loss", "net", "tensor", "stats")}
    median = float(np.median(list(e["tensor"].values())))
    log(f"[{'joint' if cfg.TRAIN.JOINT_FT else 'gan'}] first step card vs plain (CPU), batch {CHECK_BATCH}: "
        f"losses {rec['mets']}; worst loss rel err {e['loss'][worst['loss']]:.3g} ({worst['loss']}; tol "
        f"{TOL_GAN_LOSS}); grads of {len(e['tensor'])} tensors, all non-zero: per network |diff|/|grad| "
        + " ".join(f"{k} {v:.3g}" for k, v in e["net"].items())
        + f" (tol {TOL_GAN_GRAD_NET}), per tensor max_abs_err/max_abs median {median:.3g} (tol "
        f"{TOL_GAN_GRAD_MEDIAN}) worst {e['tensor'][worst['tensor']]:.3g} ({worst['tensor']}; tol "
        f"{TOL_GAN_GRAD_TENSOR}); BN running stats of {len(e['stats'])} tensors, worst "
        f"{e['stats'][worst['stats']]:.3g} ({worst['stats']}; tol {TOL_GAN_STATS})")
    if not (e["loss"][worst["loss"]] <= TOL_GAN_LOSS and e["net"][worst["net"]] <= TOL_GAN_GRAD_NET
            and median <= TOL_GAN_GRAD_MEDIAN and e["tensor"][worst["tensor"]] <= TOL_GAN_GRAD_TENSOR
            and e["stats"][worst["stats"]] <= TOL_GAN_STATS):
        raise AssertionError("the card's GAN step disagrees with the plain path")
    return st, rec_cpu


def gan_step_parts_ms(st: gan.GanTrainState, raw: dict, p: FrontendParams, joint: bool) -> dict[str, float]:
    """Device ms of one GAN step's parts, from CUDA events that
    ``gan.train_step`` records as each part ends: featurize (joint: host wav
    → log-mel, K1), G forward (batch to the device, the encoder in joint
    mode, CA, G), D phase (forward, backward, Adam), G phase (the Ds'
    forward, backward through D and G, Adam, EMA)."""
    events = {}

    def mark(part: str) -> None:
        events[part] = torch.cuda.Event(enable_timing=True)
        events[part].record()

    mark("start")
    b = cli.featurize(raw, p, "cuda") if joint else raw
    mark("featurize")
    gan.train_step(st, b, mark=mark)
    torch.cuda.synchronize()
    names = list(events)
    parts = {n: events[prev].elapsed_time(events[n]) for prev, n in zip(names, names[1:])}
    if not joint:
        del parts["featurize"]
    return parts


def phase_gan(card: str, path: str) -> dict[str, int]:
    """GAN training of ``path`` at full width: the counted run through
    run_gan_training, the first step card vs CPU, then step time, parts and
    peak memory at batch GAN_BATCH."""
    cfg = gan_cfg(path, GAN_BATCH, "float32")  # against the cfg's bfloat16: the bf16 phase runs that
    joint = bool(cfg.TRAIN.JOINT_FT)
    tag = "joint" if joint else "gan"
    g, c = cfg.GAN, cfg.TRAIN.COEFF
    p = frontend_params_from_cfg(cfg.AUDIO)
    log(f"[{tag}] {path}, DTYPE.COMPUTE float32: batch {cfg.TRAIN.BATCH_SIZE}, {cfg.TREE.BRANCH_NUM} stages to "
        f"{64 * 2 ** (int(cfg.TREE.BRANCH_NUM) - 1)} px, GF {g.GF_DIM} DF {g.DF_DIM} R_NUM {g.R_NUM} Z {g.Z_DIM} "
        f"CA {g.EMBEDDING_DIM} TEXT {cfg.TEXT.DIMENSION}, KL {c.KL} COLOR {c.COLOR_LOSS} DISTILL {c.DISTILL}, "
        f"EMA {cfg.TRAIN.EMA_G} warmup {cfg.TRAIN.EMA_WARMUP}, Adam lr {cfg.TRAIN.GENERATOR_LR} betas "
        f"({cfg.TRAIN.ADAM_BETA1}, {cfg.TRAIN.ADAM_BETA2}), images {cfg.DATA.IMAGE_DTYPE} {cfg.DATA.SHIP_SCALES}"
        + (f"; encoder convs {list(cfg.ENCODER.CONV_CHANNELS)} bi-GRU H={cfg.ENCODER.RNN_HIDDEN}, "
           f"wavs up to {p.max_samples} samples" if joint else ""))
    if (int(cfg.TREE.BRANCH_NUM), int(g.GF_DIM), int(g.DF_DIM), int(g.R_NUM), int(g.Z_DIM),
            int(g.EMBEDDING_DIM)) != (3, 64, 64, 2, 100, 128):
        raise AssertionError(f"{path} is not the full birds width")

    # the path, counted from zero: GAN_STEPS steps of run_gan_training
    reset_counts()
    run_dir = os.path.join(cfg.OUTPUT_DIR, f"chip_smoke_{tag}_{os.getpid()}")
    t0 = time.time()
    mets = cli.run_gan_training(cfg, steps=GAN_STEPS, device="cuda", run_dir=run_dir, log_every=1)
    launches = read_counts()
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    log(f"[{tag}] run_gan_training {GAN_STEPS} steps in {time.time() - t0:.1f} s (set-up included): "
        f"g_loss {[r['g_loss'] for r in lines]}, d_loss {[r['d_loss'] for r in lines]}, last {mets}; "
        f"launches {launches}")
    if [r["step"] for r in lines] != list(range(1, GAN_STEPS + 1)) or not all(
            isinstance(v, float) and np.isfinite(v) for r in lines for k, v in r.items() if k != "step"):
        raise AssertionError(f"GAN metrics not finite, or not one line per step: {lines}")
    n = GAN_STEPS if joint else 0
    want = {"mel_fused": n, "gru_fwd": n, "gru_bwd": n, "mel_framed": 0}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    shutil.rmtree(run_dir)  # its ~1.5 GB checkpoint: the loop phase tests checkpoints

    st, rec_cpu = gan_first_step_vs_cpu(path)
    if not joint:
        F32["gan_cpu_step"] = rec_cpu

    # step time at batch GAN_BATCH on host batches made ahead (featurize,
    # the wav → log-mel on the card, is part of a joint step)
    raws = list(cli.synthetic_gan_batches(cfg)(1))
    stream = itertools.cycle(raws)
    step = (lambda: gan.train_step(st, cli.featurize(next(stream), p, "cuda"))) if joint else \
        (lambda: gan.train_step(st, next(stream)))
    times, peak, m = timed_steps(step, GAN_STEP_RUNS)
    if not all(np.isfinite(float(v)) for v in m.values()):
        raise AssertionError(f"GAN metrics not finite after {st.step} steps: {m}")
    parts = [gan_step_parts_ms(st, next(stream), p, joint) for _ in range(3)]
    med = {k: float(np.median([pt[k] for pt in parts])) for k in parts[0]}
    t_med = float(np.median(times))
    MADE_AHEAD_MS[tag] = t_med
    F32[tag] = {"times": times, "parts": med, "peak": peak}
    log(f"[{tag}] {card}: batch {GAN_BATCH} step ({'featurize + ' if joint else ''}train_step) ms "
        f"median {t_med:.2f} min {min(times):.2f} max {max(times):.2f} (n={len(times)}), "
        f"{GAN_BATCH / t_med * 1e3:.1f} images/s; device ms (median of 3) "
        + " ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f" sum {sum(med.values()):.3f}; max_memory_allocated {peak:.0f} MiB; g_loss after {st.step} steps "
        f"{float(m['g_loss']):.4f}")
    return launches


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms, without autotuning, for the block."""
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def ddp_first_step(cfg, st: gan.GanTrainState, raw: dict, dev: torch.device) -> tuple[dict, dict[str, int]]:
    """A step of ``st`` on this rank's rows of the global batch ``raw`` over
    ``st.axis`` (None: the whole batch in one process), with the step's own
    noise: (record, kernel launches)."""
    rows = parallel.shard_batch(raw, st.axis)
    reset_counts()
    batch = cli.featurize(rows, frontend_params_from_cfg(cfg.AUDIO), dev) if cfg.TRAIN.JOINT_FT else rows
    rec = step_record(st, gan.train_step(st, batch))
    torch.cuda.synchronize()
    return rec, read_counts()


def state_digest(st: gan.GanTrainState) -> str:
    """SHA-256 of every parameter and buffer of the state's networks."""
    h = hashlib.sha256()
    for mod in step_modules(st).values():
        for t in itertools.chain(mod.parameters(), mod.buffers()):
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def records_equal(a: dict, b: dict) -> bool:
    """Bitwise equality of two step records."""
    return a["mets"] == b["mets"] and all(
        (x is None and b[k][n] is None) or (x is not None and b[k][n] is not None and torch.equal(x, b[k][n]))
        for k in ("grads", "stats") for n, x in a[k].items())


def ddp_trainer_resume(axis: parallel.DataAxis, dev: torch.device, out: str) -> dict:
    """``GanTrainer`` over the axis on the gan case's batch (the cfg's Adam,
    whose step counts live on the host): one step and a checkpoint, then a
    new trainer in the same directory restores it on every rank, replicates
    it (a card's tensors over the joined group, the host's over the gloo
    one) and takes a second step. Returns the digests saved and restored,
    the steps, where the Adam step counts live and whether the metrics are
    finite."""
    cfg = gan_cfg(DDP_CASES["gan"], GAN_BATCH, "float32")
    with open(os.path.join(out, "gan.batch.pkl"), "rb") as f:
        raw = pickle.load(f)
    factory = cli.gan_batch_factory(cfg, lambda epoch: iter([raw, raw]), axis)
    run_dir = os.path.join(out, "trainer")

    def trainer() -> GanTrainer:
        return GanTrainer(cfg, run_dir, factory, log_every=0, image_every=0, device=dev, mesh=axis)

    t = trainer()
    try:
        t.train(max_steps=1)
        res = {"saved": state_digest(t.state)}
    finally:
        t.close()
    del t
    gc.collect()
    t = trainer()  # restores step 1 on every rank and replicates it
    try:
        res.update(restored=state_digest(t.state), restored_step=t.state.step,
                   adam_step_devices=sorted({str(s["step"].device) for s in t.state.g_opt.state.values()}))
        mets = t.train(max_steps=2)
        res.update(step=t.state.step, finite=all(np.isfinite(v) for v in mets.values()))
    finally:
        t.close()
    del t
    gc.collect()
    return res


def pmean_host_us(axis: parallel.DataAxis, dev: torch.device, n: int = 200) -> float:
    """Host µs a ``DataAxis.pmean`` of a BatchNorm's [2, 512] statistics
    takes to queue, after 10 of warm-up."""
    x = torch.zeros(2, 512, device=dev)
    for _ in range(10):
        axis.pmean(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        axis.pmean(x)
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return us


def ddp_rank(spec_path: str) -> None:
    """One rank of the ddp phase (``chip_smoke.py --ddp-rank SPEC``, with
    torchrun's variables set by :func:`run_ranks`): joins the process group
    of the spec's backend (NCCL, one card per rank; gloo, every rank on
    cuda:0), runs the first step of each case on its rows of the global batch
    the parent saved, with cuDNN deterministic, and writes rank 0's record,
    then times the spec's runs of steps (cuDNN as the gan phase has it) and
    writes a JSON of its launches, state digest and times. NCCL ranks then
    time a pmean on the host and save and resume a ``GanTrainer``
    (:func:`ddp_trainer_resume`)."""
    with open(spec_path) as f:
        spec = json.load(f)
    backend, out = spec["backend"], spec["out"]
    dev = "cuda" if backend == "nccl" else "cuda:0"
    parallel.maybe_initialize_distributed(dev, backend=backend, timeout_s=DDP_TIMEOUT_S)
    try:
        dev = resolve_device(parallel.local_device(dev))
        axis = parallel.make_mesh()
        res = {"rank": axis.rank, "size": axis.size, "device": str(dev), "cases": {}}
        for case in spec["cases"]:
            cfg = gan_cfg(DDP_CASES[case], GAN_BATCH, "float32")
            with open(os.path.join(out, f"{case}.batch.pkl"), "rb") as f:
                raw = pickle.load(f)
            st = gan.init_state(cfg, dev, axis=axis)
            with cudnn_deterministic():
                rec, counts = ddp_first_step(cfg, st, raw, dev)
            if axis.rank == 0:
                torch.save(rec, os.path.join(out, f"{case}.{backend}.pt"))
            p = frontend_params_from_cfg(cfg.AUDIO)
            rows = parallel.shard_batch(raw, axis)
            step = (lambda: gan.train_step(st, cli.featurize(rows, p, dev))) if cfg.TRAIN.JOINT_FT else \
                (lambda: gan.train_step(st, rows))
            times, peak, _ = timed_steps(step, spec["runs"], warmup=2 if backend == "nccl" else 0)
            res["cases"][case] = {"launches": counts, "digest": state_digest(st), "times": times, "peak": peak}
            del st
            gc.collect()
        if backend == "nccl":
            res["pmean_us"] = pmean_host_us(axis, dev)
            res["resume"] = ddp_trainer_resume(axis, dev, out)
        with open(os.path.join(out, f"rank{axis.rank}.{backend}.json"), "w") as f:
            json.dump(res, f)
    finally:
        parallel.destroy()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(out: str, backend: str, world: int, cases: list[str], runs: int) -> list[dict]:
    """Start ``world`` ranks of :func:`ddp_rank`, wait for them all within
    DDP_TIMEOUT_S (killing every one that is left past it, or when one
    fails) and return their JSON results, by rank."""
    spec = os.path.join(out, f"spec.{backend}.json")
    with open(spec, "w") as f:
        json.dump({"backend": backend, "cases": cases, "runs": runs, "out": out}, f)
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    procs, logs = [], [os.path.join(out, f"log{r}.{backend}.txt") for r in range(world)]
    for r in range(world):
        with open(logs[r], "w") as log_f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ddp-rank", spec],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r if backend == "nccl" else 0)),
                stdout=log_f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DDP_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n" + open(logs[r]).read()[-4000:]
                          for r, p in enumerate(procs))
        raise AssertionError(f"{backend} ranks failed:\n{tails}")
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.{backend}.json")) as f:
            results.append(json.load(f))
    return results


def check_step(got: dict, want: dict, what: str) -> str:
    """``got``'s first-step record against ``want``'s with the GAN step's
    gates (TOL_GAN_*); raises past them, returns what it read."""
    e = step_errors(got, want)
    if e["zero"]:
        raise AssertionError(f"{what}: parameters with no gradient: {e['zero']}")
    worst = {name: max(e[name], key=e[name].get) for name in ("loss", "net", "tensor", "stats")}
    median = float(np.median(list(e["tensor"].values())))
    msg = (f"worst loss rel err {e['loss'][worst['loss']]:.3g} ({worst['loss']}; tol {TOL_GAN_LOSS}); "
           f"per network |diff|/|grad| " + " ".join(f"{k} {v:.3g}" for k, v in e["net"].items())
           + f" (tol {TOL_GAN_GRAD_NET}), per tensor median {median:.3g} (tol {TOL_GAN_GRAD_MEDIAN}) worst "
           f"{e['tensor'][worst['tensor']]:.3g} ({worst['tensor']}; tol {TOL_GAN_GRAD_TENSOR}); BN running stats "
           f"worst {e['stats'][worst['stats']]:.3g} ({worst['stats']}; tol {TOL_GAN_STATS})")
    if not (e["loss"][worst["loss"]] <= TOL_GAN_LOSS and e["net"][worst["net"]] <= TOL_GAN_GRAD_NET
            and median <= TOL_GAN_GRAD_MEDIAN and e["tensor"][worst["tensor"]] <= TOL_GAN_GRAD_TENSOR
            and e["stats"][worst["stats"]] <= TOL_GAN_STATS):
        raise AssertionError(f"{what} disagrees: {msg}")
    return msg


def phase_ddp(card: str) -> dict[str, int]:
    """Data-parallel GAN training (s2i_tpu_torch/parallel/) of
    cfg/birds_3stages.yml at full width in float32, global batch GAN_BATCH,
    ranks spawned as torchrun would (this script with --ddp-rank):
    (a) NCCL over every visible card (at most DDP_MAX_CARDS): the first step
        held against this process's one-process step on the same global
        batch, bitwise when the one-process step repeats bitwise (cuDNN
        deterministic), else within its repeat distance; then the step time
        beside the gan phase's one-process median, a pmean's host µs, and a
        GanTrainer saved after one step and resumed on every rank, bitwise;
    (b) 2 gloo ranks sharing cuda:0, half the batch each: the first GAN and
        joint (cfg/birds_joint_ft.yml) steps held against the one-process
        steps with the GAN step's gates, parameters and buffers bitwise equal
        across the ranks, K1, K2 and K3 once per rank in the joint step, and
        gloo step times (through the host: a check that steps go on, not a
        rate)."""
    t0 = time.time()
    os.makedirs("output", exist_ok=True)
    out = tempfile.mkdtemp(prefix="chip_smoke_ddp_", dir="output")
    dev = torch.device("cuda")
    try:
        refs = {}
        with cudnn_deterministic():
            for case, path in DDP_CASES.items():
                cfg = gan_cfg(path, GAN_BATCH, "float32")
                raw = next(iter(cli.synthetic_gan_batches(cfg)(0)))
                with open(os.path.join(out, f"{case}.batch.pkl"), "wb") as f:
                    pickle.dump(raw, f)
                st = gan.init_state(cfg, dev)
                init = to_host(st.state_dict())
                refs[case] = ddp_first_step(cfg, st, raw, dev)[0]
                if case == "gan":  # the same step again, from the same init
                    st.load_state_dict(init)
                    repeat = ddp_first_step(cfg, st, raw, dev)[0]
                del st, init
        gc.collect()
        torch.cuda.empty_cache()
        t_refs = time.time() - t0
        deterministic = records_equal(repeat, refs["gan"])
        rep_net = step_errors(repeat, refs["gan"])["net"]
        log(f"[ddp] one-process first GAN step at batch {GAN_BATCH} repeats "
            f"{'bitwise' if deterministic else 'within per network ' + str(rep_net)} (cuDNN deterministic)")

        world = min(torch.cuda.device_count(), DDP_MAX_CARDS)
        t1 = time.time()
        nccl = run_ranks(out, "nccl", world, ["gan"], DDP_STEP_RUNS)
        t_nccl = time.time() - t1
        got = torch.load(os.path.join(out, "gan.nccl.pt"), weights_only=False)
        bitwise = records_equal(got, refs["gan"])
        e = step_errors(got, refs["gan"])
        log(f"[ddp] (a) NCCL, {world} rank(s) on {[r['device'] for r in nccl]}: first GAN step "
            f"{'bitwise equal to' if bitwise else 'differs from'} the one-process step on the global batch "
            f"(per network |diff|/|grad| " + " ".join(f"{k} {v:.3g}" for k, v in e["net"].items()) + ")")
        if deterministic and not bitwise:
            raise AssertionError("NCCL ranks: the first step is not bitwise the one-process step, which repeats bitwise")
        if not deterministic and any(v > 2 * rep_net[k] for k, v in e["net"].items()):
            raise AssertionError(f"NCCL ranks: the first step is further from the one-process step than its repeat: "
                                 f"{e['net']} against {rep_net}")
        if len({r["cases"]["gan"]["digest"] for r in nccl}) != 1:
            raise AssertionError("NCCL ranks hold different parameters or buffers after the first step")
        times = nccl[0]["cases"]["gan"]["times"]
        med, one = float(np.median(times)), MADE_AHEAD_MS["gan"]
        log(f"[ddp] (a) {card}: NCCL over {world} rank(s), global batch {GAN_BATCH}: step ms median {med:.2f} "
            f"min {min(times):.2f} max {max(times):.2f} (n={len(times)}) beside the gan phase's one-process "
            f"median {one:.2f} ({100 * (med / one - 1):+.1f}%), {GAN_BATCH / med * 1e3:.1f} images/s, "
            f"max_memory_allocated {nccl[0]['cases']['gan']['peak']:.0f} MiB on rank 0; a pmean of [2, 512] "
            f"{nccl[0]['pmean_us']:.1f} host us to queue")
        for r in nccl:
            res = r["resume"]
            if not (res["restored"] == res["saved"] and res["restored_step"] == 1 and res["step"] == 2
                    and res["finite"]):
                raise AssertionError(f"NCCL rank {r['rank']}: GanTrainer save and resume failed: {res}")
        log(f"[ddp] (a) GanTrainer over NCCL: 1 step, checkpoint, a new trainer restores it on every rank "
            f"bitwise (Adam step counts on {nccl[0]['resume']['adam_step_devices']}, replicated over the host "
            f"group) and takes step 2 with finite metrics")

        t1 = time.time()
        gloo = run_ranks(out, "gloo", 2, list(DDP_CASES), DDP_GLOO_RUNS)
        t_gloo = time.time() - t1
        launches = dict.fromkeys(KERNELS, 0)
        for case in DDP_CASES:
            msg = check_step(torch.load(os.path.join(out, f"{case}.gloo.pt"), weights_only=False), refs[case],
                             f"2 gloo ranks, {case}")
            if len({r["cases"][case]["digest"] for r in gloo}) != 1:
                raise AssertionError(f"gloo ranks hold different parameters or buffers after the first {case} step")
            per_rank = [r["cases"][case]["launches"] for r in gloo]
            n = 1 if case == "joint" else 0
            want = {"mel_fused": n, "gru_fwd": n, "gru_bwd": n, "mel_framed": 0}
            if any(c != want for c in per_rank):
                raise AssertionError(f"gloo {case} launches per rank {per_rank}, expected {want}")
            for c in per_rank:
                for k, v in c.items():
                    launches[k] += v
            gt = [t for r in gloo for t in r["cases"][case]["times"]]
            log(f"[ddp] (b) 2 gloo ranks on cuda:0, {GAN_BATCH // 2} rows each, {case} first step vs one process: "
                f"{msg}; parameters and buffers bitwise equal across the ranks; launches per rank {per_rank[0]}; "
                f"{card}: gloo step ms {[round(t, 1) for t in gt]} (through the host: a check, not a rate)")
        log(f"[ddp] the phase {time.time() - t0:.1f} s (one-process references {t_refs:.1f}, NCCL ranks "
            f"{t_nccl:.1f}, gloo ranks {t_gloo:.1f}, process start and imports included); launches {launches}")
        return launches
    finally:
        shutil.rmtree(out, ignore_errors=True)


def state_distance(a: dict, b: dict) -> float:
    """The largest max-abs difference of two host state dicts' tensors, each
    over max(1, the tensor's largest magnitude); inf where their keys,
    shapes or scalars differ."""
    fa, fb = flat_state(a), flat_state(b)
    if fa.keys() != fb.keys():
        return float("inf")
    worst = 0.0
    for k, x in fa.items():
        y = fb[k]
        if not torch.is_tensor(x):
            if x != y:
                return float("inf")
        elif x.shape != y.shape:
            return float("inf")
        elif x.numel() and x.is_floating_point():
            worst = max(worst, (x - y).abs().max().item() / max(1.0, x.abs().max().item()))
        elif not torch.equal(x, y):
            return float("inf")
    return worst


def flat_state(sd, prefix: str = "") -> dict:
    if isinstance(sd, dict):
        return {k: v for key, val in sd.items() for k, v in flat_state(val, f"{prefix}/{key}").items()}
    if isinstance(sd, (list, tuple)):
        return {k: v for i, val in enumerate(sd) for k, v in flat_state(val, f"{prefix}/{i}").items()}
    return {prefix: sd}


def states_equal(a: dict, b: dict) -> bool:
    """Bitwise equality of two host state dicts."""
    fa, fb = flat_state(a), flat_state(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(x, fb[k]) if torch.is_tensor(x) else x == fb[k] for k, x in fa.items())


# Run by phase_export in a fresh process: load the artifact with the model
# code blocked, serve the serve phase's WAVs twice (seed 1), and print one
# JSON line of what happened.
LOADED_SERVE = r"""
import json, sys, time
for m in ("models", "pipeline", "train", "data"):
    sys.modules["s2i_tpu_torch." + m] = None
import numpy as np
import torch
from s2i_tpu_torch import export
from s2i_tpu_torch.ops import gru_kernel, mel_kernel

art, inputs, out = sys.argv[1:4]
t0 = time.perf_counter()
loaded = export.load(art)
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
resident = torch.cuda.memory_allocated()
d = np.load(inputs)
torch.cuda.reset_peak_memory_stats()
launches = []
for _ in range(2):
    k = mel_kernel.logmel.launches, gru_kernel.gru_scan.launches
    t0 = time.perf_counter()
    img = loaded.generate(d["wavs"], d["lens"], seed=1)
    launches.append([mel_kernel.logmel.launches - k[0], gru_kernel.gru_scan.launches - k[1],
                     1e3 * (time.perf_counter() - t0)])
np.save(out, img)
print(json.dumps({"load_s": load_s, "resident": resident, "peak": torch.cuda.max_memory_allocated(),
                  "calls": launches, "model_modules": sorted(m for m in sys.modules if sys.modules[m] is not None
                                                             and m.split(".")[1:2] in (["models"], ["pipeline"],
                                                                                        ["train"], ["data"]))}))
"""


def pixels_apart(got: np.ndarray, want: np.ndarray, what: str) -> str:
    """uint8 images against each other under TOL_ARTIFACT_PIXELS: raises
    past it, else returns how far apart they are."""
    if got.shape != want.shape or got.dtype != np.uint8 or want.dtype != np.uint8:
        raise AssertionError(f"[export] {what}: {got.dtype} {got.shape} against {want.dtype} {want.shape}")
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    n = int((diff > 0).sum())
    if diff.max() > 1 or n > TOL_ARTIFACT_PIXELS * diff.size:
        raise AssertionError(f"[export] {what}: {n} of {diff.size} values differ, by up to {diff.max()} "
                             f"(gate: 1 level on {TOL_ARTIFACT_PIXELS:.1%})")
    return f"{what} {n} of {diff.size} values differ (max {diff.max()})"


def phase_export(card: str) -> dict[str, int]:
    """The deployment path: the bf16 phase's serve pipeline (cfg/birds_3stages.yml
    at full width in its bfloat16, the serve phase's weights) exported at
    EXPORT_BATCHES, loaded in a fresh process with the model code blocked
    and in this one, held against the live pipeline, served over HTTP and
    timed beside it. The artifact goes to a temporary directory under
    output/, deleted at the end. The launches it returns are the loaded
    program's alone (each of its calls counted from zero, the fresh
    process's included), not the live pipeline's reference calls."""
    ref = F32["serve_ref"]
    cfg = config.cfg_from_file("cfg/birds_3stages.yml")
    layers = int(cfg.ENCODER.RNN_LAYERS)
    wavs, lens = ref["wavs"], ref["lens"]
    reset_counts()
    counted = dict.fromkeys(KERNELS, 0)  # the loaded program's launches

    def on_artifact(fn):
        """fn() (calls of the loaded program only), the counts set to 0 just
        before it and added to ``counted`` just after."""
        reset_counts()
        try:
            return fn()
        finally:
            for k, v in read_counts().items():
                counted[k] += v

    def allocated() -> int:
        """Device bytes held, after the earlier phases' garbage is freed."""
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    base = allocated()
    pipe = SpeechToImage(cfg, ref["enc_sd"], ref["g_sd"], device="cuda")
    live_resident = allocated() - base
    os.makedirs("output", exist_ok=True)
    out = tempfile.mkdtemp(prefix="chip_smoke_export_", dir="output")
    try:
        art = os.path.join(out, "artifact")
        t0 = time.perf_counter()
        meta = s2i_export.export_pipeline(pipe, art, batch_sizes=EXPORT_BATCHES)
        export_s = time.perf_counter() - t0
        nbytes = {f: os.path.getsize(os.path.join(art, f)) for f in sorted(os.listdir(art))}
        if read_counts() != dict.fromkeys(KERNELS, 0):
            raise AssertionError(f"[export] tracing launched a kernel: {read_counts()}")
        log(f"[export] {card}: {meta['output_dtype']} program of stage {meta['stage']} ({meta['image_size']} px), "
            f"batch sizes {meta['batch_sizes']}, DTYPE.COMPUTE {cfg.DTYPE.COMPUTE}: exported in {export_s:.2f} s; "
            f"artifact {sum(nbytes.values())} bytes {nbytes}")

        # a fresh process with models, pipeline, train and data blocked
        np.savez(os.path.join(out, "inputs.npz"), wavs=wavs, lens=lens)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", LOADED_SERVE, art, os.path.join(out, "inputs.npz"),
                               os.path.join(out, "images.npy")], capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            raise AssertionError(f"[export] the loading process failed:\n{proc.stderr[-4000:]}")
        sub = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"[export] fresh process ({time.perf_counter() - t0:.1f} s with its start), model modules "
            f"imported {sub['model_modules']}: load {sub['load_s']:.2f} s, device memory after load "
            f"{sub['resident'] / 2**20:.0f} MiB, peak {sub['peak'] / 2**20:.0f} MiB; per program call of "
            f"{BATCH} WAVs K1/K2 launches and host ms {sub['calls']}")
        if sub["model_modules"] or any(c[:2] != [1, layers] for c in sub["calls"]):
            raise AssertionError(f"[export] expected no model module and 1 K1 + {layers} K2 launches a call: {sub}")
        counted["mel_fused"] += sum(c[0] for c in sub["calls"])
        counted["gru_fwd"] += sum(c[1] for c in sub["calls"])

        # this process: the artifact against the live pipeline, seed for seed
        base = allocated()
        t0 = time.perf_counter()
        loaded = s2i_export.load(art)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        art_resident = allocated() - base
        t0 = time.perf_counter()
        got = on_artifact(lambda: loaded.generate(wavs, lens, seed=1))
        first_ms = 1e3 * (time.perf_counter() - t0)
        one = read_counts()
        if (one["mel_fused"], one["gru_fwd"]) != (1, layers):
            raise AssertionError(f"[export] one program call launched {one}")
        want = pipe.generate(wavs, lens, seed=1, output_dtype="uint8")
        lines = [pixels_apart(got, want, f"B={BATCH} (one call)"),
                 pixels_apart(np.load(os.path.join(out, "images.npy")), want, f"B={BATCH} fresh process")]
        n = loaded.max_samples

        def pad(x: np.ndarray, rows: int, fill) -> np.ndarray:
            return np.concatenate([x, np.full((rows - len(x), *x.shape[1:]), fill, x.dtype)])

        lines.append(pixels_apart(
            on_artifact(lambda: loaded.generate(wavs[:3], lens[:3], seed=2)),
            pipe.generate(pad(wavs[:3], BATCH, 0), pad(lens[:3], BATCH, n), seed=2, output_dtype="uint8")[:3],
            "B=3 (padded to 8)"))
        w12, l12 = np.concatenate([wavs, wavs[:4]]), np.concatenate([lens, lens[:4]])
        got12 = on_artifact(lambda: loaded.generate(w12, l12, seed=5))
        want12 = np.concatenate([
            pipe.generate(w12[:BATCH], l12[:BATCH], seed=5, output_dtype="uint8"),
            pipe.generate(pad(w12[BATCH:], BATCH, 0), pad(l12[BATCH:], BATCH, n), seed=s2i_export.chunk_seed(5, 1),
                          output_dtype="uint8")[:4]])
        lines.append(pixels_apart(got12, want12, "B=12 (chunks of 8 and 4)"))
        log("[export] artifact vs live, same seed: " + "; ".join(lines))

        # HTTP through make_server(loaded): warmup batch + the POSTed WAVs
        bodies = []
        for w, m in zip(wavs, lens):
            buf = io.BytesIO()
            write_wav(buf, w[:m], loaded.p.sample_rate)
            bodies.append(buf.getvalue())

        def serve() -> list[tuple[int, bytes]]:
            srv = make_server(loaded, "127.0.0.1", 0, batch_size=BATCH, device="cuda")
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            try:
                return post_wavs(f"http://127.0.0.1:{srv.server_address[1]}", bodies)
            finally:
                srv.shutdown()
                srv.server_close()

        answers = on_artifact(serve)
        for status, png in answers:
            size = (int.from_bytes(png[16:20], "big"), int.from_bytes(png[20:24], "big"))
            if status != 200 or png[:8] != b"\x89PNG\r\n\x1a\n" or size != (256, 256):
                raise AssertionError(f"[export] bad answer: status {status}, PNG {png[:8]!r} {size}")

        # batch latency at B=8 and peak memory, live and artifact in turns (live, artifact, artifact, live)
        runs = {"live": lambda: pipe.generate(wavs, lens, seed=1, output_dtype="uint8"),
                "artifact": lambda: loaded.generate(wavs, lens, seed=1)}
        times, peaks = {k: [] for k in runs}, {k: 0.0 for k in runs}
        for k in ("live", "artifact", "artifact", "live"):
            held = allocated() / 2**20
            run = lambda: timed_steps(runs[k], LATENCY_RUNS // 2)  # noqa: E731
            ts, peak, _ = on_artifact(run) if k == "artifact" else run()
            times[k] += ts
            peaks[k] = max(peaks[k], peak - held)
        f = lambda ts: f"median {np.median(ts):.2f} min {min(ts):.2f} max {max(ts):.2f} (n={len(ts)})"  # noqa: E731
        log(f"[export] {card}: {len(answers)} POSTs through make_server(loaded) -> 200 + 256x256 PNG; load "
            f"{load_s:.2f} s, first call {first_ms:.1f} ms; batch {BATCH} wav->uint8 latency ms artifact "
            f"{f(times['artifact'])} | live {f(times['live'])}; device memory after load artifact "
            f"{art_resident / 2**20:.0f} | live {live_resident / 2**20:.0f} MiB, peak above the weights artifact "
            f"{peaks['artifact']:.0f} | live {peaks['live']:.0f} MiB")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log(f"[export] launches of the loaded program's calls (this process and the fresh one): {counted}")
    if not counted["mel_fused"] or counted["gru_fwd"] != layers * counted["mel_fused"]:
        raise AssertionError(f"[export] expected 1 K1 and {layers} K2 launches a program call: {counted}")
    return counted


def with_dataparallel_names(sd: dict) -> dict:
    """``sd`` as ``nn.DataParallel`` saves it: every key under ``module.``,
    and each BN's ``num_batches_tracked`` (the reference's BatchNorm keeps one)."""
    out = {f"module.{k}": v for k, v in sd.items()}
    for k in sd:
        if k.endswith(".running_mean"):
            out[f"module.{k[: -len('running_mean')]}num_batches_tracked"] = torch.tensor(1000)
    return out


def phase_ckpt(card: str) -> dict[str, int]:
    """Checkpoint interchange with the reference project
    (s2i_tpu_torch/port/, the export-torch-gan and port-torch-gan commands):
    a seeded GAN state of cfg/birds_3stages.yml at full width (G the serve
    phase's) exported to reference netG.pth / netD*.pth, netG re-saved as
    DataParallel saves it and the serve phase's encoder as a reference .pth,
    then both ported back and the pair served at 256 px on the card: uint8
    images bitwise those of the source state_dicts' pipeline, float images
    within TOL_IMAGE of the plain versions on the CPU, K1 and K2 once a
    batch; the ported checkpoint exported again gives the files' tensors
    bitwise. Files under output/, deleted at the end."""
    ref = F32["serve_ref"]
    # the serve phase's type, and a torch encoder's padding
    over = ["DTYPE.COMPUTE=float32", "ENCODER.CONV_PADDING=torch"]
    cfg = config.apply_overrides(config.cfg_from_file("cfg/birds_3stages.yml"), over)
    wavs, lens, z = ref["wavs"], ref["lens"], ref["z"]
    os.makedirs("output", exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir="output")
    sub = lambda *names: os.path.join(root, *names)  # noqa: E731
    secs: dict[str, float] = {}

    def timed(what: str, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[what] = time.perf_counter() - t0
        return out

    try:
        # the files: a seeded port checkpoint (G the serve phase's, EMA = G), exported; netG and the
        # encoder as the reference's DataParallel runs save them
        state = gan.init_state(cfg, device="cuda")
        state.models.g.load_state_dict(ref["g_sd"])
        with torch.no_grad():
            for name, p in state.models.g.named_parameters():
                state.ema[name].copy_(p)
        CheckpointManager(sub("run")).save(0, state)
        del state
        files = timed("export-torch-gan", lambda: entrypoints.main(["export-torch-gan", "--ckpt", sub("run"),
                                                                   "--out", sub("ref")]))
        netg = torch.load(files["netG.pth"], weights_only=True)
        torch.save(with_dataparallel_names(netg), sub("ref", "netG_dp.pth"))
        torch.save(with_dataparallel_names(ref["enc_sd"]), sub("ref", "audio_encoder.pth"))
        sizes = {f: os.path.getsize(sub("ref", f)) for f in sorted(os.listdir(sub("ref")))}

        # read them: port-torch-gan, port_encoder
        netds = [files[f"netD{s}.pth"] for s in (256, 64, 128)]  # any order
        timed("port-torch-gan", lambda: entrypoints.main([
            "port-torch-gan", "--cfg", "cfg/birds_3stages.yml", "--netg", sub("ref", "netG_dp.pth"),
            "--netd", *netds, "--out", sub("ported"), "--set", *over]))
        enc_sd, meta = timed("port_encoder", lambda: port_encoder(sub("ref", "audio_encoder.pth"),
                                                                  emb_dim=int(cfg.TEXT.DIMENSION)))
        want_meta = {"n_mels": int(cfg.AUDIO.N_MELS), "emb_dim": int(cfg.TEXT.DIMENSION),
                     "conv_channels": tuple(cfg.ENCODER.CONV_CHANNELS), "conv_kernel": int(cfg.ENCODER.CONV_KERNEL),
                     "conv_stride": int(cfg.ENCODER.CONV_STRIDE), "conv_padding": "torch",
                     "rnn_hidden": int(cfg.ENCODER.RNN_HIDDEN), "rnn_layers": int(cfg.ENCODER.RNN_LAYERS),
                     "bidirectional": bool(cfg.ENCODER.BIDIRECTIONAL), "pool": str(cfg.ENCODER.POOL),
                     "n_classes": int(cfg.ENCODER.N_CLASSES)}
        if meta != want_meta:
            raise AssertionError(f"[ckpt] port_encoder's meta {meta}, the cfg's encoder {want_meta}")
        CheckpointManager(sub("encoder")).save(0, {"step": 0, "model": enc_sd})
        ported_cfg = config.cfg_from_file(sub("ported", "ported_config.yml"))

        # serve the ported pair on the card, counted from zero: one uint8 and one float32 batch
        pipe = SpeechToImage.from_checkpoints(ported_cfg, sub("encoder"), sub("ported"), device="cuda")
        source = SpeechToImage(cfg, ref["enc_sd"], ref["g_sd"], device="cuda")
        reset_counts()
        img = pipe.generate(wavs, lens, z=z, output_dtype="uint8")
        img_f = pipe.generate(wavs, lens, z=z)
        launches = read_counts()
        same = np.array_equal(img, source.generate(wavs, lens, z=z, output_dtype="uint8"))
        cpu = SpeechToImage(cfg, ref["enc_sd"], ref["g_sd"], device="cpu").generate(wavs, lens, z=z)
        err = float(np.abs(img_f - cpu).max())
        times, _, _ = timed("latency", lambda: timed_steps(
            lambda: pipe.generate(wavs, lens, seed=1, output_dtype="uint8"), LATENCY_RUNS))
        del pipe, source

        # the round trip: the ported checkpoint exported again
        back = timed("export-torch-gan again", lambda: entrypoints.main([
            "export-torch-gan", "--ckpt", sub("ported"), "--out", sub("back")]))
        diff = []
        for name, path in back.items():
            a, b = torch.load(path, weights_only=True), torch.load(files[name], weights_only=True)
            if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
                diff.append(name)
        log(f"[ckpt] {card}: {cfg.CONFIG_NAME} at full width, DTYPE.COMPUTE float32, ENCODER.CONV_PADDING "
            f"torch; seconds {({k: round(v, 3) for k, v in secs.items() if k != 'latency'})}; file bytes {sizes}")
        log(f"[ckpt] {card}: ported pair served, {img.shape} uint8 bitwise equal to the source pipeline's "
            f"{same}; float images vs plain (CPU) max_abs_err {err:.3g} (tol {TOL_IMAGE}); launches {launches} "
            f"for 2 batches; batch {BATCH} wav->uint8 latency ms median {np.median(times):.2f} min "
            f"{min(times):.2f} max {max(times):.2f} (n={len(times)}); round trip bitwise, files differing {diff}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    layers = int(cfg.ENCODER.RNN_LAYERS)
    if not (same and err <= TOL_IMAGE and not diff and img.shape == (BATCH, 256, 256, 3)):
        raise AssertionError(f"[ckpt] ported pair: bitwise {same}, CPU error {err}, round trip differs {diff}")
    if launches != {"mel_fused": 2, "gru_fwd": 2 * layers, "gru_bwd": 0, "mel_framed": 0}:
        raise AssertionError(f"[ckpt] launches {launches}, expected K1 once and K2 {layers} times a batch")
    return launches


def check_events(run_dir: str) -> tuple[list[dict], list[dict]]:
    """The event file of ``run_dir/tb`` read back with the port's own reader
    (every checksum checked): its scalars must be those of
    ``scalars.jsonl`` (tags, steps, float32 values) and each image summary
    the grid PNG of its step. Returns (scalar records, image records)."""
    (name,) = os.listdir(os.path.join(run_dir, "tb"))
    recs = read_events(os.path.join(run_dir, "tb", name))
    if recs[0].get("file_version") != "brain.Event:2":
        raise AssertionError(f"{name}: first record {recs[0]}")
    got = [(r["step"], v["tag"], v["simple_value"]) for r in recs[1:] for v in r["values"] if "image" not in v]
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        jsonl = [json.loads(line) for line in f]
    want = [(r["step"], k, float(np.float32(float(v)))) for r in jsonl for k, v in r.items()
            if k not in ("step", "time")]
    same = len(got) == len(want) and all(g[:2] == w[:2] and np.array_equal(g[2], w[2], equal_nan=True)
                                         for g, w in zip(got, want))
    if not (same and got):
        raise AssertionError(f"{name}: {len(got)} scalars against {len(want)} in scalars.jsonl, or they differ")
    images = [(r["step"], v) for r in recs for v in r.get("values", []) if "image" in v]
    for step, v in images:
        with Image.open(io.BytesIO(v["image"]["png"])) as im, \
                Image.open(os.path.join(run_dir, "images", f"fake_{step:07d}.png")) as grid:
            if not np.array_equal(np.asarray(im), np.asarray(grid)):
                raise AssertionError(f"{name}: the image of step {step} is not its grid PNG")
    return got, images


def loop_events(card: str, run_dir: str, steps: int) -> None:
    """The loop phase's event file checked (:func:`check_events`: one grid,
    at ``steps``), and the event writer's host cost on the same records."""
    t_check = time.time()
    got, images = check_events(run_dir)
    if [(s, v["tag"]) for s, v in images] != [(steps, "samples")]:
        raise AssertionError(f"event images {[(s, v['tag']) for s, v in images]}: not one grid at step {steps}")
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        last = {k: v for k, v in json.loads(f.readlines()[-1]).items() if k not in ("step", "time")}
    with Image.open(os.path.join(run_dir, "images", f"fake_{steps:07d}.png")) as im:
        grid = np.asarray(im)
    with tempfile.TemporaryDirectory(dir=run_dir) as d:
        w = EventWriter(d)
        t0 = time.perf_counter()
        for i in range(100):
            w.scalars(i, last)
        scalar_us = 1e6 * (time.perf_counter() - t0) / 100
        t0 = time.perf_counter()
        w.image(steps, "samples", grid)
        image_ms = 1e3 * (time.perf_counter() - t0)
        w.close()
    log(f"[loop] {card}: TRAIN.TENSORBOARD event file read back: {len(got)} scalars of {steps} steps equal "
        f"to scalars.jsonl (float32), every checksum valid, the grid of step {steps} "
        f"({len(images[0][1]['image']['png'])} PNG bytes, {grid.shape}) equal to its PNG; host cost of the "
        f"writer: {scalar_us:.1f} us a logged step ({len(last)} scalars), {image_ms:.1f} ms a grid (PIL PNG "
        f"encode and a pure-Python CRC-32C)")
    ADDED_S["loop"] = time.time() - t_check


def phase_loop(card: str) -> dict[str, int]:
    """The trainer loop of cfg/birds_joint_ft.yml at full width and batch
    GAN_BATCH, in a temporary run directory deleted at the end: resume,
    checkpoints, BN recalc, sampling, and serving the run's checkpoint."""
    cfg = gan_cfg("cfg/birds_joint_ft.yml", GAN_BATCH)  # the cfg's own DTYPE.COMPUTE, bfloat16
    cfg.TRAIN.MOMENT_DTYPE = "bfloat16"  # the resume covers Adam's bfloat16 moments too
    cfg.TRAIN.TENSORBOARD = True  # event files beside scalars.jsonl
    p = frontend_params_from_cfg(cfg.AUDIO)
    recalc = int(cfg.EVAL.EMA_BN_RECALC)
    factory = cli.gan_batch_factory(cfg)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_loop_", dir=cfg.OUTPUT_DIR)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

        def run(name: str, max_steps: int, image_every: int = 0) -> GanTrainer:
            t = GanTrainer(cfg, os.path.join(root, name), factory, log_every=1, image_every=image_every,
                           device="cuda", max_to_keep=1)
            t.train(max_steps=max_steps)
            t.close()
            return t

        # the path, counted from zero: 4 steps straight (a sample grid at the
        # last, mirrored into the event file); 2, a stop and 2 more
        reset_counts()
        t0 = time.time()
        straight = run("straight", LOOP_STEPS, image_every=LOOP_STEPS)
        want = to_host(straight.state.state_dict())
        t1 = time.time()
        half = run("stopped", LOOP_STEPS // 2).state.step
        resumed = run("stopped", LOOP_STEPS)
        got = to_host(resumed.state.state_dict())
        t2 = time.time()
        train_launches = read_counts()
        log(f"[loop] {card}, {cfg.CONFIG_NAME}, DTYPE.COMPUTE {cfg.DTYPE.COMPUTE}, TRAIN.MOMENT_DTYPE "
            f"{cfg.TRAIN.MOMENT_DTYPE}: {LOOP_STEPS} steps straight in {t1 - t0:.1f} s, {half} + "
            f"{resumed.state.step - half} steps stopped and resumed in {t2 - t1:.1f} s (set-up and saves "
            f"included); launches {train_launches}")
        if half != LOOP_STEPS // 2 or resumed.state.step != LOOP_STEPS or straight.state.step != LOOP_STEPS:
            raise AssertionError(f"steps: straight {straight.state.step}, stopped {half}, resumed "
                                 f"{resumed.state.step}")
        want_launches = {"mel_fused": 2 * LOOP_STEPS, "gru_fwd": 2 * LOOP_STEPS, "gru_bwd": 2 * LOOP_STEPS,
                         "mel_framed": 0}
        if train_launches != want_launches:
            raise AssertionError(f"launches {train_launches}, expected {want_launches}: one of each per step")

        # resumed vs straight; the checkpoint's bytes, save, restore and round trip
        ckpt = resumed.ckpt
        nbytes = os.path.getsize(ckpt.path(LOOP_STEPS))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(LOOP_STEPS, resumed.state, force=True)
        save_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        ckpt.restore_latest(resumed.state)
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        round_trip = states_equal(to_host(resumed.state.state_dict()), got)
        tensor_bytes = sum(v.numel() * v.element_size() for v in flat_state(got).values() if torch.is_tensor(v))
        if states_equal(got, want):
            held = "bitwise: resumed == straight"
        else:
            again = to_host(run("straight_again", LOOP_STEPS).state.state_dict())
            spread, dist = state_distance(again, want), state_distance(got, want)
            log(f"[loop] resumed != straight bitwise: distance {dist:.3g}, two straight runs {spread:.3g}")
            if not (round_trip and dist <= spread):
                raise AssertionError(f"resume off by {dist} against a spread of {spread}; round trip "
                                     f"bitwise {round_trip}")
            held = f"within the spread of two straight runs ({dist:.3g} <= {spread:.3g}) and round trip bitwise"
        if not round_trip:
            raise AssertionError("a checkpoint restored into its own state changed it")
        log(f"[loop] {card}: resume check held: {held}; checkpoint {nbytes} bytes ({tensor_bytes} of "
            f"tensors) save {save_ms:.1f} ms restore {restore_ms:.1f} ms (host clock, synchronized); round "
            f"trip bitwise {round_trip}")
        shutil.rmtree(os.path.join(root, "stopped"))
        del resumed
        loop_events(card, os.path.join(root, "straight"), LOOP_STEPS)

        # BN recalc under the EMA, then sampling, from the straight run
        emb = SyntheticGanDataset(branch_num=int(cfg.TREE.BRANCH_NUM), base_size=int(cfg.TREE.BASE_SIZE),
                                  emb_dim=int(cfg.TEXT.DIMENSION), seed=SEED + 999).embeddings
        g_before = {k: v.clone() for k, v in straight.state.models.g.state_dict().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g_eval = straight.eval_state(emb, seed=0)
        torch.cuda.synchronize()
        recalc_ms = 1e3 * (time.perf_counter() - t0)
        moved = [k for k, v in g_eval.state_dict().items() if "running" in k and not torch.equal(v, g_before[k])]
        t0 = time.perf_counter()
        straight.sample_to_dir(emb[:LOOP_SAMPLES], os.path.join(root, "samples"), batch_size=GAN_BATCH)
        sample_s = time.perf_counter() - t0
        pngs = sorted(os.listdir(os.path.join(root, "samples")))
        untouched = all(torch.equal(v, g_before[k]) for k, v in straight.state.models.g.state_dict().items())
        # its part on the card: the same batches through gan.sample alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, LOOP_SAMPLES, GAN_BATCH):
            gan.sample(g_eval, emb[i: i + GAN_BATCH], seed=0, offset=i)[-1].cpu()
        gen_ms = 1e3 * (time.perf_counter() - t0)
        log(f"[loop] {card}: eval_state (BN recalc, {recalc} batches of {GAN_BATCH}) {recalc_ms:.1f} ms, "
            f"{len(moved)} running statistics moved; sample_to_dir {len(pngs)} PNGs at batch {GAN_BATCH} in "
            f"{1e3 * sample_s:.1f} ms ({LOOP_SAMPLES / sample_s:.1f} images/s, its own BN recalc and PNG "
            f"writes included; gan.sample of the same batches {gen_ms:.1f} ms, "
            f"{LOOP_SAMPLES / gen_ms * 1e3:.1f} images/s); trainer's G untouched {untouched}")
        if not (untouched and moved and len(pngs) == LOOP_SAMPLES):
            raise AssertionError("BN recalc or sampling failed its checks")

        # the run's checkpoint served: SpeechToImage.from_checkpoints vs the in-memory EMA state
        wavs, lens = serve_wavs(p)
        m = straight.state.models
        mem = SpeechToImage(cfg, to_host(m.encoder.state_dict()),
                            to_host({**m.g.state_dict(), **straight.state.ema}), joint=True, device="cuda")
        reset_counts()
        pipe = SpeechToImage.from_checkpoints(cfg, None, os.path.join(root, "straight", "ckpt"), device="cuda")
        img = pipe.generate(wavs, lens, seed=SEED)
        img_mem = mem.generate(wavs, lens, seed=SEED)
        serve_launches = read_counts()
        log(f"[loop] {card}: from_checkpoints: {img.shape} images bitwise equal to the in-memory pipeline's "
            f"{np.array_equal(img, img_mem)} (std {img.std():.3f}); launches {serve_launches}")
        if not (np.array_equal(img, img_mem) and np.isfinite(img).all() and img.shape == (BATCH, 256, 256, 3)):
            raise AssertionError("the checkpoint's pipeline serves other images than the trainer's state")
        if not (serve_launches["mel_fused"] and serve_launches["gru_fwd"]):
            raise AssertionError(f"serving the checkpoint skipped a kernel: {serve_launches}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        shutil.rmtree(root, ignore_errors=True)
    return {k: train_launches[k] + serve_launches[k] for k in train_launches}


def fixture_tree(root: str) -> tuple[str, float]:
    """The data phase's StackGAN tree under ``root``; returns (path, seconds)."""
    t0 = time.time()
    path = os.path.join(root, "fixture")
    counts = make_fixture(path, classes=DATA_CLASSES, per_class=DATA_PER_CLASS, captions=DATA_CAPTIONS,
                          emb_dim=1024, image_size=DATA_IMAGE_PX, wav_samples=DATA_WAV_SAMPLES, seed=SEED)
    if counts != {"train": DATA_TRAIN, "test": DATA_CLASSES}:
        raise AssertionError(f"fixture splits {counts}")
    return path, time.time() - t0


def copy_ms(host: np.ndarray) -> tuple[float, float]:
    """Median ms (CUDA events, 5 runs) of one host→card copy of ``host``:
    from pageable memory, and from a pinned buffer filled beforehand."""
    pinned = torch.empty(host.shape, dtype=torch.float32, pin_memory=True)
    pinned.copy_(torch.from_numpy(host))
    out = {}
    for name, fn in (("pageable", lambda: torch.from_numpy(host).to("cuda")),
                     ("pinned", lambda: pinned.to("cuda", non_blocking=True))):
        fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = float(np.median(times))
    return out["pageable"], out["pinned"]


def loader_window(batches, step, n: int) -> dict[str, float]:
    """``n`` steps on the batches of ``batches`` as the loops take them, with
    no synchronization between steps, after one step of warm-up: host ms
    per step, host ms spent waiting for the next batch, and the device's idle
    share between steps (the gaps between one step's last event and the
    next step's first, over the window; CUDA events on the step's stream)."""
    it = iter(batches)
    step(next(it))
    torch.cuda.synchronize()
    marks, waits = [], []
    t0 = time.perf_counter()
    for _ in range(n):
        tw = time.perf_counter()
        batch = next(it)
        waits.append(time.perf_counter() - tw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(batch)
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if hasattr(it, "close"):
        it.close()  # a prefetcher's: stops and reaps its thread
    gaps = sum(marks[i][1].elapsed_time(marks[i + 1][0]) for i in range(n - 1))
    span = marks[0][0].elapsed_time(marks[-1][1])
    return {"ms_per_step": 1e3 * wall / n, "wait_ms": 1e3 * float(np.mean(waits)), "idle_share": gaps / span,
            "device_ms_per_step": span / n}


def window_line(w: dict[str, float]) -> str:
    return (f"{w['ms_per_step']:.2f} ms/step (host clock over the window), waiting for the next batch "
            f"{w['wait_ms']:.2f} ms/step, device span {w['device_ms_per_step']:.2f} ms/step, idle between "
            f"steps {100 * w['idle_share']:.1f}%")


def finite_checkpoint(ckpt_dir: str) -> int:
    """The latest checkpoint's step; raises if any float tensor in it is not finite."""
    raw, step = CheckpointManager(ckpt_dir).restore_latest_raw()
    bad = [k for k, v in flat_state(raw).items() if torch.is_tensor(v) and v.is_floating_point()
           and not torch.isfinite(v).all()]
    if bad:
        raise AssertionError(f"{ckpt_dir}: non-finite tensors {bad[:5]}")
    return step


def only_run(out: str, prefix: str) -> str:
    (name,) = [n for n in os.listdir(out) if n.startswith(prefix)]
    return os.path.join(out, name)


def grain_loader(card: str, split: StackGanSplit, cfg) -> None:
    """DATA.PIPELINE grain's loader alone on the data tree: two epochs at
    GRAIN_WORKERS 0 and 2 must be bitwise equal; prints each one's host
    images/s beside the GanEpochIterator rates above."""
    epochs, rates, first_ms = {}, {}, {}
    for workers in (0, GRAIN_WORKERS):
        epochs[workers], firsts = [], []
        t0 = time.perf_counter()
        for e in range(2):
            t1 = time.perf_counter()
            for b in grain_batches(split, GAN_BATCH, int(cfg.TREE.BRANCH_NUM), int(cfg.TREE.BASE_SIZE),
                                   seed=SEED + e, num_workers=workers, image_dtype=str(cfg.DATA.IMAGE_DTYPE),
                                   ship_scales=str(cfg.DATA.SHIP_SCALES)):
                if len(epochs[workers]) == e * (DATA_TRAIN // GAN_BATCH):
                    firsts.append(1e3 * (time.perf_counter() - t1))
                epochs[workers].append(b)
        rates[workers] = sum(len(b["embedding"]) for b in epochs[workers]) / (time.perf_counter() - t0)
        first_ms[workers] = float(np.mean(firsts))
    same = len(epochs[0]) == len(epochs[GRAIN_WORKERS]) == 2 * (DATA_TRAIN // GAN_BATCH) and all(
        np.array_equal(a, b) for x, y in zip(epochs[0], epochs[GRAIN_WORKERS])
        for a, b in [*zip(x["images"], y["images"]), (x["embedding"], y["embedding"]), (x["class_id"], y["class_id"])])
    log(f"[data] {card}: grain loader alone (data/grain_pipeline.py, Grain's order, PIL decode, batch {GAN_BATCH}, "
        f"{cfg.DATA.IMAGE_DTYPE} {cfg.DATA.SHIP_SCALES} scale, two epochs rebuilt per epoch): GRAIN_WORKERS 0 "
        f"{rates[0]:.1f} images/s, {GRAIN_WORKERS} forked workers {rates[GRAIN_WORKERS]:.1f} images/s; an "
        f"epoch's first batch after {first_ms[0]:.1f} and {first_ms[GRAIN_WORKERS]:.1f} ms (the workers' fork "
        f"from this process, which holds the card, included); the two bitwise equal {same}")
    if not same:
        raise AssertionError("grain batches differ between 0 and 2 workers")


def grain_train_and_tools(card: str, tree: str, root: str, counted) -> float:
    """``train`` of cfg/birds_3stages.yml through entrypoints.main (``counted``)
    on DATA.PIPELINE grain with GRAIN_WORKERS decode processes forked after
    CUDA is up and TRAIN.TENSORBOARD on, for GRAIN_EPOCHS epochs (the
    trainer logs every 20th step): its checkpoint finite and its event file
    read back against its scalars.jsonl; then the three tools_torch
    commands in processes of their own. Returns the seconds taken."""
    t0 = time.time()
    out = os.path.join(root, "grain_runs")
    _, train_s = counted("grain", ["train", "--cfg", "cfg/birds_3stages.yml", "--set", "DATA.PIPELINE=grain",
                                   f"DATA.GRAIN_WORKERS={GRAIN_WORKERS}", "TRAIN.TENSORBOARD=True",
                                   f"TRAIN.MAX_EPOCH={GRAIN_EPOCHS}"], out=out)
    run = only_run(out, "birds_3stages_train_")
    ckpt = os.path.join(run, "ckpt")
    steps = GRAIN_EPOCHS * (DATA_TRAIN // GAN_BATCH)
    if finite_checkpoint(ckpt) != steps:
        raise AssertionError(f"{run}: not {steps} steps")
    scalars, _ = check_events(run)
    total = sum(v.numel() for v in flat_state(CheckpointManager(ckpt).restore_latest_raw()[0]).values()
                if torch.is_tensor(v))
    log(f"[data] {card}: train birds_3stages on DATA.PIPELINE grain ({GRAIN_WORKERS} forked workers, "
        f"TRAIN.TENSORBOARD) through entrypoints.main: {steps} steps in {train_s:.1f} s (init and checkpoint "
        f"included), event file read back: {len(scalars)} scalars equal to scalars.jsonl, every checksum valid")

    def tool(*argv: str) -> tuple[str, float]:
        t1 = time.time()
        res = subprocess.run([sys.executable, os.path.join(REPO, argv[0]), *argv[1:]], capture_output=True,
                             text=True, timeout=300)
        if res.returncode:
            raise AssertionError(f"{argv[0]} exited {res.returncode}: {res.stderr[-2000:]}")
        return res.stdout, time.time() - t1

    report, validate_s = tool("tools_torch/validate_data.py", "--data_dir", tree)
    if not all(r["ok"] and not r["problems"] for r in json.loads(report)):
        raise AssertionError(f"validate_data: {report}")
    listing, inspect_s = tool("tools_torch/inspect_ckpt.py", "--ckpt", ckpt)
    if not listing.rstrip().endswith(f"({total} elements)") or f"steps: [{steps}]" not in listing:
        raise AssertionError(f"inspect_ckpt printed {listing!r}, the state holds {total} elements")
    synth = os.path.join(root, "synth")
    names = {"train": ["a/x", "a/y"], "test": ["b/z"]}
    captions = {"a/x": ["a small bird with a red crown", "white belly"], "a/y": ["yellow wings"], "b/z": ["tiny"]}
    for split_name, files in names.items():
        os.makedirs(os.path.join(synth, split_name))
        with open(os.path.join(synth, split_name, "filenames.pickle"), "wb") as f:
            pickle.dump(files, f)
    with open(os.path.join(synth, "captions.json"), "w") as f:
        json.dump(captions, f)
    _, synth_s = tool("tools_torch/synthesize_speech.py", "--data_dir", synth, "--tone", "--captions",
                      os.path.join(synth, "captions.json"))
    for name, caps in captions.items():
        for k, text in enumerate(caps):
            x, sr = read_wav(os.path.join(synth, "audio", name, f"{k}.wav"))
            pcm16 = (np.clip(tone_synthesize(text, 16000, 48000), -1, 1) * 32767.0).astype(np.int16) / 32768.0
            if sr != 16000 or not np.array_equal(x, pcm16.astype(np.float32)):
                raise AssertionError(f"synthesize_speech: {name}/{k}.wav is not the tone of {text!r}")
    log(f"[data] {card}: tools_torch: validate_data exit 0 ({validate_s:.1f} s), inspect_ckpt of the grain run "
        f"{total} elements ({inspect_s:.1f} s), synthesize_speech --tone 4 WAVs read back equal to the tone "
        f"({synth_s:.1f} s); each a process of its own")
    return time.time() - t0


def phase_data(card: str, root: str) -> tuple[dict[str, int], dict[str, str]]:
    """The real-data path through the port's CLI at full birds width, on a
    StackGAN tree made from SEED (tools_torch/make_fixture_dataset.py)
    under ``root``: pretrain → extract → train (frozen, joint) → sample,
    each through entrypoints.main; the loaders' host rates, the wav copy
    pageable vs pinned, and the encoder and GAN steps fed by the loaders
    through the pinned prefetch against steps on batches made ahead.
    Returns the launches and the paths the eval phase reads (``tree``,
    ``samples``, ``runs``)."""
    t_phase = time.time()
    tree, fixture_s = fixture_tree(root)
    runs = os.path.join(root, "runs")
    lib = native.get_lib()
    loader = "native (C++ JPEG decode, s2i_tpu_torch/native)" if lib is not None else \
        f"PIL (the native loader did not build: {native.unavailable_reason()})"
    log(f"[data] fixture {DATA_CLASSES} classes x {DATA_PER_CLASS} images ({DATA_TRAIN} train, "
        f"{DATA_CLASSES} test), {DATA_CAPTIONS} captions each, {DATA_IMAGE_PX} px JPEGs, 1024-d teacher "
        f"embeddings, 16 kHz WAVs of {DATA_WAV_SAMPLES[0]}..{DATA_WAV_SAMPLES[1]} samples, made in "
        f"{fixture_s:.1f} s; image loader: {loader}")

    enc_cfg = config.cfg_from_file("cfg/pretrain_encoder_birds.yml")
    birds_cfg = config.apply_overrides(config.cfg_from_file("cfg/birds_3stages.yml"), [f"DATA_DIR={tree}"])
    p = frontend_params_from_cfg(enc_cfg.AUDIO)
    split = StackGanSplit(tree, "train")

    # the host loaders alone
    it = GanEpochIterator(split, GAN_BATCH, 3, seed=SEED, num_threads=int(birds_cfg.WORKERS),
                          image_dtype=str(birds_cfg.DATA.IMAGE_DTYPE), ship_scales=str(birds_cfg.DATA.SHIP_SCALES))
    rates = {}
    for name, use_native in (("native", True), ("PIL", False)):
        if use_native and lib is None:
            continue
        it.use_native = use_native
        t0 = time.perf_counter()
        n_img = sum(len(b["images"][0]) for _ in range(2) for b in it)
        rates[name] = n_img / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    n_utt = sum(len(b["wav"]) for b in SpeechEpochIterator(split, TRAIN_BATCH, p.sample_rate, p.max_samples))
    utt_rate = n_utt / (time.perf_counter() - t0)
    pageable_ms, pinned_ms = copy_ms(np.zeros((TRAIN_BATCH, p.max_samples), np.float32))
    mb = TRAIN_BATCH * p.max_samples * 4 / 1e6
    log(f"[data] {card}: host loaders alone: " + ", ".join(f"{k} {v:.1f} images/s" for k, v in rates.items())
        + f" at 256 px (GanEpochIterator, batch {GAN_BATCH}, uint8 top scale, {birds_cfg.WORKERS} threads); "
        f"{utt_rate:.1f} utterances/s (SpeechEpochIterator, batch {TRAIN_BATCH}, serial WAV reads); one "
        f"encoder wav batch ({mb:.1f} MB) host->card: pageable {pageable_ms:.3f} ms, pinned {pinned_ms:.3f} ms "
        f"({mb / pinned_ms:.1f} GB/s; CUDA events, median of 5)")
    t_grain = time.time()
    grain_loader(card, split, birds_cfg)
    t_grain = time.time() - t_grain

    base = ["--data_dir", tree, "--output_dir", runs]
    counts = {}

    def counted(name: str, argv: list[str], out: str = runs):
        reset_counts()
        t0 = time.time()
        result = entrypoints.main(argv + ["--data_dir", tree, "--output_dir", out])
        counts[name] = read_counts()
        return result, time.time() - t0

    _, pre_s = counted("pretrain", ["pretrain-encoder", "--cfg", "cfg/pretrain_encoder_birds.yml", "--set",
                                    "ENCODER.EPOCHS=1", "ENCODER.LOG_EVERY=1"])
    enc_run = only_run(runs, "birds_encoder_encoder_")
    with open(os.path.join(enc_run, "scalars.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    steps = DATA_TRAIN * DATA_CAPTIONS // TRAIN_BATCH
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"pretraining losses {losses}: not {steps} finite ones")
    finite_checkpoint(os.path.join(enc_run, "ckpt"))

    written, ext_s = counted("extract", ["pretrain-encoder", "--cfg", "cfg/pretrain_encoder_birds.yml",
                                         "--extract", os.path.join(enc_run, "ckpt")])
    n_ext = (DATA_TRAIN + DATA_CLASSES) * DATA_CAPTIONS
    embs = {}
    for name, n in (("train", DATA_TRAIN), ("test", DATA_CLASSES)):
        embs[name] = StackGanSplit(tree, name, embedding_file="speech-embeddings.pickle").embeddings
        if embs[name].shape != (n, DATA_CAPTIONS, 1024) or not np.isfinite(embs[name]).all():
            raise AssertionError(f"{written[name]}: shape {embs[name].shape} or not finite")
    # one utterance's row against the pipeline's encoder embedding of its WAV alone
    enc_sd = CheckpointManager(os.path.join(enc_run, "ckpt")).restore_latest_raw()[0]["model"]
    pipe = SpeechToImage(enc_cfg, enc_sd, build_generator(enc_cfg).state_dict(), device="cuda")
    test = StackGanSplit(tree, "test")
    row = (DATA_CLASSES - 1, DATA_CAPTIONS - 1)  # the last test image's last caption
    wav = test.load_wav(*row, p.sample_rate)[: p.max_samples]
    # in bfloat16 (the cfg's) extraction at batch 64 and the pipeline at
    # batch 1 may take other cuDNN algorithms, and each rounds to
    # bfloat16 where the other need not: the row may sit no further from
    # the float32 pipeline's embedding than twice the bfloat16
    # pipeline's does on the same WAV (the rule of the bf16 phase)
    f32_cfg = config.apply_overrides(copy.deepcopy(enc_cfg), ["DTYPE.COMPUTE=float32"])
    pipe32 = SpeechToImage(f32_cfg, enc_sd, build_generator(f32_cfg).state_dict(), device="cuda")
    with torch.no_grad():
        one, one32 = (embedding(q.encoder(*extract_features(wav[None], q.p, [len(wav)], device="cuda")))[0]
                      .cpu().numpy() for q in (pipe, pipe32))
    ext_err = float(np.abs(one - embs["test"][row]).max())
    ext_err32 = float(np.abs(one32 - embs["test"][row]).max())
    ext_bound = 2 * float(np.abs(one - one32).max())
    del pipe, pipe32
    if not ext_err32 <= ext_bound:
        raise AssertionError(f"extracted row vs the float32 pipeline's embedding: {ext_err32} > {ext_bound}")

    counted("train", ["train", "--cfg", "cfg/birds_3stages.yml", "--set", "TRAIN.MAX_EPOCH=2"])
    gan_run = only_run(runs, "birds_3stages_train_")
    counted("joint", ["train", "--cfg", "cfg/birds_joint_ft.yml", "--set", "TRAIN.MAX_EPOCH=1",
                      f"TRAIN.NET_E={os.path.join(enc_run, 'ckpt')}"])
    joint_run = only_run(runs, "birds_joint_train_")
    gan_steps = DATA_TRAIN // GAN_BATCH
    for run, want in ((gan_run, 2 * gan_steps), (joint_run, gan_steps)):
        with open(os.path.join(run, "run_meta.json")) as f:
            meta = json.load(f)
        if finite_checkpoint(os.path.join(run, "ckpt")) != want or meta["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"{run}: not {want} steps on the card ({meta['device']})")
    t_grain += grain_train_and_tools(card, tree, root, counted)
    samples, sample_s = counted("sample", ["sample", "--cfg", "cfg/eval_birds.yml", "--set",
                                           f"TRAIN.NET_G={os.path.join(gan_run, 'ckpt')}"])
    names = sorted(f.replace("/", "_") + ".png" for f in test.filenames)
    n_samples = int(config.cfg_from_file("cfg/eval_birds.yml").EVAL.NUM_SAMPLES_PER_EMB)
    got = {s: sorted(os.listdir(os.path.join(samples, str(s)))) for s in range(n_samples)}
    if any(v != names for v in got.values()):
        raise AssertionError(f"samples {got} are not one PNG per test image {names}")
    with Image.open(os.path.join(samples, "0", names[0])) as im:
        px = np.asarray(im)
    if px.shape != (256, 256, 3) or not px.std() > 0:
        raise AssertionError(f"sample {names[0]}: shape {px.shape}, std {px.std()}")

    extract_batches = sum(math.ceil(n * DATA_CAPTIONS / TRAIN_BATCH) for n in (DATA_TRAIN, DATA_CLASSES))
    per_step = {"pretrain": steps, "extract": extract_batches, "train": 0, "joint": gan_steps, "grain": 0,
                "sample": 0}
    want = {name: {"mel_fused": n, "gru_fwd": n, "gru_bwd": n if name in ("pretrain", "joint") else 0,
                   "mel_framed": 0} for name, n in per_step.items()}
    log(f"[data] {card}: through entrypoints.main: pretrain {steps} steps {pre_s:.1f} s, extract "
        f"{n_ext} utterances in {ext_s:.1f} s ({n_ext / ext_s:.1f} utterances/s, model load and pickle "
        f"writes included), extracted row vs the pipeline's embedding max_abs_err {ext_err:.3g} (float32's "
        f"fixed tol {TOL_FEATS}), vs the float32 pipeline's {ext_err32:.3g} (bound {ext_bound:.3g}: twice "
        f"the bfloat16 pipeline's), train {2 * gan_steps} + joint {gan_steps} steps on the card, sample {n_samples} x "
        f"{len(names)} PNGs in {sample_s:.1f} s; launches " + "; ".join(f"{k} {v}" for k, v in counts.items()))
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}: K1, K2 (+ K3) once per step or batch")

    # the steps on loader batches through the pinned prefetch, against
    # batches made ahead in host memory (the train and gan phases')
    cli_cfg = config.apply_overrides(config.cfg_from_file("cfg/pretrain_encoder_birds.yml"),
                                     [f"DATA_DIR={tree}"])
    state = init_encoder_state(cli_cfg, device="cuda")
    host = cli.speech_host_batches(cli_cfg)
    made = list(itertools.islice(host(0), 2))
    enc_step = lambda b: encoder_train_step(state, cli.featurize(b, p, "cuda"))  # noqa: E731
    runs_enc = {
        "made ahead, pageable copy in the step": loader_window(itertools.cycle(made), enc_step, DATA_STEPS),
        "made ahead, pinned prefetch": loader_window(
            Prefetcher(itertools.cycle(made), depth=cli.SPEECH_PREFETCH, device="cuda"), enc_step, DATA_STEPS),
        "loader, pinned prefetch": loader_window(
            Prefetcher(itertools.chain.from_iterable(host(e) for e in range(4)), depth=cli.SPEECH_PREFETCH,
                       device="cuda"), enc_step, DATA_STEPS),
    }
    del state
    st = gan.init_state(birds_cfg, device="cuda")
    factory = cli.gan_batch_factory(birds_cfg)
    made = list(factory(0))
    gan_step = lambda b: gan.train_step(st, b)  # noqa: E731
    runs_gan = {
        "made ahead, copy in the step": loader_window(itertools.cycle(made), gan_step, DATA_GAN_STEPS),
        "loader, pinned prefetch": loader_window(
            Prefetcher(itertools.chain.from_iterable(factory(e) for e in range(DATA_GAN_STEPS)),
                       depth=PREFETCH_DEPTH, device="cuda"), gan_step, DATA_GAN_STEPS),
    }
    del st
    for what, results, ref in (("encoder", runs_enc, "encoder"), ("GAN", runs_gan, "gan")):
        log(f"[data] {card}: {what} step, {DATA_STEPS if what == 'encoder' else DATA_GAN_STEPS} steps "
            f"each, no sync between steps; the {ref} phase's median on made-ahead batches (synchronized "
            f"per step) {MADE_AHEAD_MS.get(ref, float('nan')):.2f} ms: "
            + "; ".join(f"{k}: {window_line(w)}" for k, w in results.items()))
    for w in (*runs_enc.values(), *runs_gan.values()):
        if not np.isfinite(w["ms_per_step"]):
            raise AssertionError(f"a timed window failed: {w}")
    ADDED_S["data"] = t_grain
    log(f"[data] phase took {time.time() - t_phase:.1f} s, of which the grain loader, the grain run and the "
        f"tools {t_grain:.1f} s")
    return {k: sum(c[k] for c in counts.values()) for k in KERNELS}, {"tree": tree, "samples": samples, "runs": runs}


def inception_with_random_bn(num_classes: int, images: np.ndarray) -> dict[str, torch.Tensor]:
    """A seeded InceptionV3 state_dict on the card with every BN scale and
    bias randomized and its running statistics those of one train-mode pass
    over ``images`` (quantized and resized as the extractor does). At
    statistics of 0 and 1 eval-mode BN is nearly an identity, which would
    hide a wrong eps or a swapped mean and variance; at random statistics
    the BN offsets swamp the signal within a few layers and every image
    gets the same features (IS and FID(X, Y) at their trivial 1 and 0).
    Statistics of the images themselves keep both away."""
    model = InceptionV3(num_classes)
    init_inception(model, torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for m in bns:
            m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=gen))
            m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))
            m.momentum = 0.0  # the pass below sets the running statistics to its batch's
        model.to("cuda").train()(preprocess(torch.from_numpy(images).cuda(), 299, True))
    for m in bns:
        del m.momentum  # back to the class's 0.9
    return model.eval().state_dict()


def inception_work(model: torch.nn.Module, batch: int, size: int) -> tuple[float, float]:
    """(operations, bytes) of one InceptionV3 forward on ``batch`` images at
    ``size`` px: 2 per multiply-add of every conv and of fc (BN, ReLU and the
    pools are a few per element, left out), counted from the layer shapes of
    a one-image forward; bytes: the input read once, every parameter and BN
    statistic once, pool3 and the logits written once."""
    macs = []

    def hook(m, inp, out):
        w = m.weight
        macs.append(out.numel() * (w[0].numel() if isinstance(m, torch.nn.Conv2d) else w.shape[1]))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    dev = next(model.parameters()).device
    with torch.no_grad():
        out = model(torch.zeros(1, size, size, 3, device=dev))
    for h in handles:
        h.remove()
    state_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    out_bytes = batch * 4 * sum(v.shape[1] for v in out.values())
    return 2.0 * batch * sum(macs), batch * size * size * 3 * 4 + state_bytes + out_bytes


def generated_images(g, n: int, seed: int) -> np.ndarray:
    """``n`` top-scale images [n, 256, 256, 3] in [-1, 1] (host float32) of
    eval-mode ``g`` for seeded random embeddings, EVAL_GEN_BATCH at a time."""
    emb = np.random.default_rng(seed).standard_normal((n, g.ca_net.fc.in_features)).astype(np.float32)
    out = np.empty((n, 256, 256, 3), np.float32)
    with torch.no_grad():
        for i in range(0, n, EVAL_GEN_BATCH):
            img = gan.sample(g, emb[i:i + EVAL_GEN_BATCH], seed=seed, offset=i)[-1]
            out[i:i + EVAL_GEN_BATCH] = img.permute(0, 2, 3, 1).cpu().numpy()
    return out


def phase_eval(card: str, data: dict[str, str]) -> dict[str, int]:
    """The evaluation layer at full width: InceptionV3 at 299 px, float32,
    card against the CPU on 8 of G's 256 px images (BN scale and bias
    random, statistics from G's images); 2 x EVAL_IMAGES images
    of cfg/birds_3stages.yml's seeded G (its bfloat16) through
    InceptionFeatures(quantize_input=True) at EVAL.FID_BATCH, IS and FID,
    pipelined extraction bitwise equal to the serial loop, times, the bound
    and peak memory; then the eval, eval --retrieval, finetune-inception
    and eval --finetuned_ckpt commands on the data phase's tree (``data``:
    its ``tree``, ``samples`` and ``runs``)."""
    t_phase = time.time()
    cfg = config.cfg_from_file("cfg/birds_3stages.yml")
    batch = int(cfg.EVAL.FID_BATCH)
    n_classes = int(cfg.ENCODER.N_CLASSES)
    reset_counts()

    g = build_generator(cfg)
    gan.init_weights(g, [], torch.Generator().manual_seed(SEED))
    g.to("cuda").eval()
    t0 = time.perf_counter()
    x, y = (generated_images(g, EVAL_IMAGES, SEED + k) for k in (1, 2))
    gen_s = time.perf_counter() - t0
    del g
    if not (np.isfinite(x).all() and np.isfinite(y).all()):
        raise AssertionError("[eval] G's images are not finite")

    # card vs CPU, 8 images at 299 px, float32
    sd = inception_with_random_bn(n_classes, x[-batch:])
    ex = InceptionFeatures(sd, num_classes=n_classes, quantize_input=True, device="cuda")
    ex_cpu = InceptionFeatures(sd, num_classes=n_classes, quantize_input=True, device="cpu")
    x8 = torch.from_numpy(x[:EVAL_CHECK])
    pre_err = (preprocess(x8.cuda(), 299, True).cpu() - preprocess(x8, 299, True)).abs().max().item()
    got, want = ex.forward(x8.cuda()), ex_cpu.forward(x8)
    errs = {k: ((a.cpu() - b).abs().max().item(), b.abs().max().item()) for k, a, b in
            zip(("pool3", "logits"), got, want)}
    log(f"[eval] {card}: InceptionV3 299 px float32 on {EVAL_CHECK} of G's 256 px images, card vs CPU: "
        + ", ".join(f"{k} max_abs_err {e:.3g} (largest {m:.3g}, bound {TOL_INCEPTION:g} of it)"
                    for k, (e, m) in errs.items())
        + f"; quantized preprocess max_abs_err {pre_err:.3g} (tol {TOL_PREPROCESS:g})")
    if not all(e <= TOL_INCEPTION * m for e, m in errs.values()) or not pre_err <= TOL_PREPROCESS:
        raise AssertionError(f"[eval] card vs CPU: {errs}, preprocess {pre_err}")
    del ex_cpu

    # full width: extraction pipelined and serial, IS, FID
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    px, lx = ex.extract(x, batch)
    pipe_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    t0 = time.perf_counter()
    serial = []
    for i in range(0, EVAL_IMAGES, batch):  # one batch at a time, a blocking copy back; the tail padded alike
        b = x[i:i + batch]
        m = len(b)
        if m < batch:
            b = np.concatenate([b, np.zeros((batch - m, *b.shape[1:]), np.float32)])
        p3, lg = ex.forward(torch.from_numpy(b).cuda())
        serial.append((p3.cpu().numpy()[:m], lg.cpu().numpy()[:m]))
    serial_s = time.perf_counter() - t0
    if not (np.array_equal(px, np.concatenate([p for p, _ in serial]))
            and np.array_equal(lx, np.concatenate([lg for _, lg in serial]))):
        raise AssertionError("[eval] pipelined extraction is not bitwise the serial loop's")
    py, _ = ex.extract(y, batch)
    is_mean, is_std = inception_score_from_probs(softmax(lx), EVAL_SPLITS)
    t0 = time.perf_counter()
    sx, sy = gaussian_stats(px), gaussian_stats(py)
    fid_xx = fid_from_stats(*sx, *sx)
    fid_xy = fid_from_stats(*sx, *sy)
    fid_ms = 1e3 * (time.perf_counter() - t0) / 2
    t0 = time.perf_counter()
    covmean = scipy.linalg.sqrtm(sx[1] @ sy[1])
    sqrtm_ms = 1e3 * (time.perf_counter() - t0)
    diff = sx[0] - sy[0]
    fid_scipy = float(diff @ diff + np.trace(sx[1]) + np.trace(sy[1]) - 2.0 * np.trace(covmean.real))
    log(f"[eval] {card}: {EVAL_IMAGES} + {EVAL_IMAGES} G images (cfg/birds_3stages.yml, "
        f"{compute_dtype(cfg)}, batch {EVAL_GEN_BATCH}) in {gen_s:.1f} s; IS over {EVAL_SPLITS} splits "
        f"{is_mean:.4f} +- {is_std:.4f}; FID(X, X) {fid_xx:.3g}; FID(X, Y) {fid_xy:.4f} (scipy.linalg.sqrtm "
        f"route, the JAX package's: {fid_scipy:.4f}); pipelined extraction bitwise equal to the serial loop")
    if not (np.isfinite(is_mean) and is_mean >= 1.0 and abs(fid_xx) <= 1e-3 and np.isfinite(fid_xy)
            and fid_xy > 0):
        raise AssertionError(f"[eval] IS {is_mean}, FID(X, X) {fid_xx}, FID(X, Y) {fid_xy}")

    xb = torch.from_numpy(x[:batch]).cuda()
    pre = preprocess(xb, 299, True)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: ex.model(pre), reps=10)
    pre_ms = time_ms(lambda: preprocess(xb, 299, True), reps=10)
    flops, nbytes = inception_work(ex.model, batch, 299)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"[eval] {card}: extraction of {EVAL_IMAGES} images at batch {batch} (host clock, copies included): "
        f"pipelined {EVAL_IMAGES / pipe_s:.1f} images/s, serial {EVAL_IMAGES / serial_s:.1f} images/s; "
        f"device ms per batch of {batch}: InceptionV3 forward {fwd_ms:.3f} (bound {bound_ms:.3f} by {bound_by}: "
        f"{flops / 1e9:.1f} GFLOP at the fp32 peak, TF32 off; {nbytes / 1e6:.1f} MB), quantize + resize "
        f"256 -> 299 {pre_ms:.3f}; peak memory {peak:.0f} MiB; FID host ms (two eigendecompositions and an SVD) "
        f"{fid_ms:.1f}, scipy.linalg.sqrtm of the 2048^2 product {sqrtm_ms:.1f}")
    del ex, xb, pre

    # the commands, on the data phase's tree: each passes or raises
    images_dir = os.path.join(data["tree"], "images")
    rec = entrypoints.main(["eval", "--gen_dir", data["samples"], "--real_dir", images_dir, "--json"])
    if rec["inception"] != "random-weight" or not (rec["is_mean"] >= 1.0 and np.isfinite(rec["fid"])):
        raise AssertionError(f"[eval] eval: {rec}")
    ret = entrypoints.main(["eval", "--retrieval", os.path.join(data["tree"], "test", "speech-embeddings.pickle"),
                            os.path.join(data["tree"], "test", "char-CNN-RNN-embeddings.pickle")])
    if not all(0.0 <= ret[d][k] <= 1.0 for d in ret for k in ("r@1", "r@5", "r@10", "mrr", "map")):
        raise AssertionError(f"[eval] retrieval: {ret}")
    t0 = time.time()
    run = entrypoints.main(["finetune-inception", "--cfg", "cfg/birds_3stages.yml", "--data_dir", data["tree"],
                            "--output_dir", data["runs"], "--epochs", "1", "--batch", str(FINETUNE_BATCH)])
    ft_s = time.time() - t0
    rec_ft = entrypoints.main(["eval", "--gen_dir", data["samples"], "--finetuned_ckpt", os.path.join(run, "ckpt"),
                               "--json"])
    if rec_ft["inception"] != "finetuned" or not rec_ft["is_mean"] >= 1.0:
        raise AssertionError(f"[eval] eval --finetuned_ckpt: {rec_ft}")

    # the finetune step at full width: 299 px, batch FINETUNE_BATCH, from the 256 px G images
    state = init_inception_state(n_classes, SEED, device="cuda")
    step = make_inception_train_step(299)
    labels = np.arange(FINETUNE_BATCH) % n_classes
    times, ft_peak, mets = timed_steps(lambda: step(state, x[:FINETUNE_BATCH], labels), FINETUNE_STEPS)
    del state
    torch.cuda.empty_cache()
    counts = read_counts()
    log(f"[eval] {card}: eval of {rec['n_gen']} sample PNGs vs the tree's images {json.dumps(rec)}; retrieval "
        f"(speech vs teacher, test split) q2t r@1 {ret['q2t']['r@1']:.3f} map {ret['q2t']['map']:.3f}; "
        f"finetune-inception 1 epoch at 299 px, batch {FINETUNE_BATCH}: {ft_s:.1f} s; eval --finetuned_ckpt "
        f"{json.dumps(rec_ft)}; finetune step at 299 px, batch {FINETUNE_BATCH} (host clock, synchronized): "
        f"median {np.median(times):.2f} ms (min {min(times):.2f}, max {max(times):.2f}, n={len(times)}), "
        f"peak {ft_peak:.0f} MiB, ce {float(mets['ce']):.4f}; launches {counts}")
    if any(counts.values()):
        raise AssertionError(f"[eval] launches {counts}: the eval path runs none of the kernels")
    log(f"[eval] phase took {time.time() - t_phase:.1f} s")
    return counts


def finite_records(path: str) -> list[dict]:
    """The JSON lines of ``path``; raises on a number that is not finite."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    bad = [(r.get("step"), k) for r in recs for k, v in r.items() if isinstance(v, float) and not math.isfinite(v)]
    if not recs or bad:
        raise AssertionError(f"{path}: {len(recs)} records, non-finite {bad[:5]}")
    return recs


def phase_cert(card: str) -> dict[str, int]:
    """The quality-certification harness (s2i_tpu_torch/eval/cert.py,
    s2i_tpu_torch/scripts/) at full birds width in the cfgs' bfloat16 on a
    fixture of 4 classes x 4 images x 2 captions: each cert's main with
    CERT_STEPS training steps and an eval after each, a 1-epoch Inception
    finetune at 299 px: quality (cfg/birds_3stages.yml, BN recalc), encoder
    (cfg/pretrain_encoder_birds.yml), joint (1 pretrain epoch, then
    cfg/birds_joint_ft.yml with NET_E), posthoc on the quality run, then
    eval_smoke (the port's commands in subprocesses, cfg/debug_tiny.yml).
    Every record finite; K1/K2/K3 launches per cert, K3 one per training
    step (the joint cert's pretrain steps included), none in the quality
    cert; each cert's seconds."""
    t_phase = time.time()
    os.makedirs("output", exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_cert_", dir="output")
    q, e, j = (os.path.join(root, name) for name in ("quality", "encoder", "joint"))
    batch = [f"TRAIN.BATCH_SIZE={CERT_BATCH}", f"ENCODER.BATCH_SIZE={CERT_BATCH}"]
    steps = ("--steps", str(CERT_STEPS), "--eval_every", "1")
    certs = {
        "quality": (quality_cert.main, ["--out", q, *CERT_FIXTURE, *steps, "--inc_epochs", "1", "--eval_batch",
                                        str(CERT_BATCH), "--ema_bn_recalc", "2", "--set", *batch]),
        "encoder": (encoder_quality_cert.main, ["--out", e, *CERT_FIXTURE, *steps, "--set", *batch]),
        "joint": (joint_quality_cert.main, ["--out", j, *CERT_FIXTURE, *steps, "--pretrain_epochs", "1",
                                            "--inc_epochs", "1", "--eval_batch", str(CERT_BATCH), "--set", *batch]),
        "posthoc": (posthoc_quality_eval.main, ["--run", q, "--classes", "4", "--eval_batch", str(CERT_BATCH),
                                                "--ema_bn_recalc", "2", "--set", *batch]),
        "eval_smoke": (eval_smoke.main, ["--out", os.path.join(root, "eval_smoke")]),
    }
    counts, secs = {}, {}
    try:
        for name, (main, argv) in certs.items():
            reset_counts()
            t0 = time.time()
            out = main(argv)
            torch.cuda.synchronize()
            secs[name], counts[name] = time.time() - t0, read_counts()
            if name in ("quality", "encoder", "joint"):
                recs = finite_records(os.path.join(root, name, "results.jsonl"))
                if [r["step"] for r in recs if "step" in r] != list(range(CERT_STEPS + 1)):
                    raise AssertionError(f"[cert] {name}: points at steps {[r.get('step') for r in recs]}")
            elif not all(math.isfinite(v) for v in out.values() if isinstance(v, float)):
                raise AssertionError(f"[cert] {name}: {out}")
            log(f"[cert] {card}: {name} {secs[name]:.1f} s, launches {counts[name]}; "
                + json.dumps({k: v for k, v in out.items() if k != "curve"}))
        with open(os.path.join(j, "encoder", "train_progress.json")) as f:
            pretrain_steps = json.load(f)["step"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want_k3 = {"quality": 0, "encoder": CERT_STEPS, "joint": pretrain_steps + CERT_STEPS, "posthoc": 0,
               "eval_smoke": 0}
    by_cert = {k: {name: c[k] for name, c in counts.items()} for k in KERNELS}
    log(f"[cert] {card}: K3 launches {by_cert['gru_bwd']} (one per training step: {want_k3}); K1 "
        f"{by_cert['mel_fused']}, K2 {by_cert['gru_fwd']}; seconds {({n: round(t, 1) for n, t in secs.items()})}")
    if by_cert["gru_bwd"] != want_k3 or any(by_cert["mel_framed"].values()):
        raise AssertionError(f"[cert] launches {counts}, K3 expected {want_k3}")
    if not (counts["encoder"]["mel_fused"] and counts["encoder"]["gru_fwd"] and counts["joint"]["mel_fused"]
            and counts["joint"]["gru_fwd"]):
        raise AssertionError(f"[cert] the encoder and joint certs launched no K1 or K2: {counts}")
    log(f"[cert] phase took {time.time() - t_phase:.1f} s")
    return {k: sum(c[k] for c in counts.values()) for k in KERNELS}


def dtype_audit(models: gan.GanModels, run) -> dict[str, set]:
    """The output types of ``models`` during ``run()``, by point: G's and
    the Ds' conv and BN outputs, the images (to-RGB), the logits, the
    embedding and what the recurrence is given ("xw")."""
    seen: dict[str, set] = {}

    def hook(point):
        return lambda m, args, out: seen.setdefault(point, set()).add(str(out.dtype).replace("torch.", ""))

    points = []
    for tag, net in (("g", models.g), *(("d", d) for d in models.ds)):
        for m in net.modules():
            kind = ("conv" if isinstance(m, Conv2d) else "bn" if isinstance(m, BatchNorm) else None)
            if kind:
                points.append((m, f"{tag} {kind}"))
            elif isinstance(m, ToRGB):
                points.append((m, "images"))
            elif isinstance(m, DLogits):
                points.append((m, "logits"))
    if models.encoder is not None:
        points.append((models.encoder, "embedding"))
    handles = [m.register_forward_hook(hook(name)) for m, name in points]
    scan = encoder_model.gru_scan

    def scan_audit(xw, *args):
        seen.setdefault("xw", set()).add(str(xw.dtype).replace("torch.", ""))
        return scan(xw, *args)

    encoder_model.gru_scan = scan_audit
    try:
        run()
    finally:
        encoder_model.gru_scan = scan
        for h in handles:
            h.remove()
    return seen


def beside(tag: str, times: list[float], parts: dict[str, float], peak: float, ref: dict) -> str:
    """One path's bfloat16 numbers with the float32 phase's of the same run beside them."""
    f = lambda ts: f"{np.median(ts):.2f} ({min(ts):.2f}-{max(ts):.2f})"  # noqa: E731
    return (f"[bf16] {tag}: host ms median (min-max) bf16 {f(times)} | float32 {f(ref['times'])}; device ms "
            + " ".join(f"{k} {v:.3f} | {ref['parts'].get(k, float('nan')):.3f}" for k, v in parts.items())
            + f"; peak {peak:.0f} | {ref['peak']:.0f} MiB")


def bf16_step_gate(what: str, got: dict, cpu: dict, ref: dict) -> None:
    """The card's bfloat16 first step (``got``) against the CPU's float32
    (``ref``), no further than twice the CPU's bfloat16 (``cpu``): each
    network's gradient (|diff| / |grad|) and the worst BN running
    statistic, each of which pools the rounding of many numbers. The loss
    terms are printed, not gated: each is one number, one draw of the
    rounding noise, and twice one draw bounds another only about 70% of the
    time (the ratio of two half-normal draws exceeds 2 with probability
    0.30); their gradients are gated."""
    e_card, e_cpu = step_errors(got, ref), step_errors(cpu, ref)
    if e_card["zero"]:
        raise AssertionError(f"[bf16] {what}: parameters with no gradient on the card: {e_card['zero']}")
    rows = {"stats": (max(e_card["stats"].values()), max(e_cpu["stats"].values())),
            **{f"grad {k}": (v, e_cpu["net"][k]) for k, v in e_card["net"].items()}}
    e16 = step_errors(got, cpu)
    log(f"[bf16] {what}, first step at batch {CHECK_BATCH}, vs the CPU's float32 step: card bf16 | CPU bf16 (bound "
        "2x) " + "; ".join(f"{k} {a:.3g} | {b:.3g}" for k, (a, b) in rows.items())
        + "; loss terms (rel err, not gated) " + " ".join(f"{k} {v:.3g} | {e_cpu['loss'][k]:.3g}"
                                                         for k, v in e_card["loss"].items())
        + f"; card vs CPU bf16: worst loss {max(e16['loss'].values()):.3g} (float32's fixed tol {TOL_GAN_LOSS}), "
        "per network " + " ".join(f"{k} {v:.3g}" for k, v in e16["net"].items())
        + f" (float32's {TOL_GAN_GRAD_NET}), BN stats {max(e16['stats'].values()):.3g} ({TOL_GAN_STATS})")
    if not all(np.isfinite(v) for v in got["mets"].values()):
        raise AssertionError(f"[bf16] {what}: the card's losses are not finite: {got['mets']}")
    bad = [k for k, (a, b) in rows.items() if not a <= 2 * b]
    if bad:
        raise AssertionError(f"[bf16] {what}: the card's bf16 step is further from float32 than twice the "
                             f"CPU's bf16 in {bad}")


def phase_bf16(card: str) -> dict[str, int]:
    """The shipped cfgs' own compute type, bfloat16 (DTYPE.COMPUTE), on each
    training and serving path at full birds width, beside the float32
    phases of the same run: a dtype audit of a joint step, serve images and
    the first GAN step held against the CPU's bfloat16 and float32 (the
    card's bfloat16 no further from the CPU's float32 than twice the CPU's
    bfloat16), then serve (batch 8), encoder (64), GAN (24), joint (24) and
    GAN with bfloat16 Adam moments (24): host times, device parts, peak
    memory, K1/K2/K3 launches and the checkpoint's bytes. The launches it
    returns are those of the counted runs (the audit step, one serve batch,
    3 steps of each training path), not of the timing loops."""
    counts = {}

    def counted(name: str, fn):
        before = read_counts()
        out = fn()
        counts[name] = {k: v - before[k] for k, v in read_counts().items()}
        return out

    reset_counts()
    # the dtype audit: one joint step at CHECK_BATCH on the card
    cfg, raw, z, eps = first_step_inputs("cfg/birds_joint_ft.yml")
    if compute_dtype(cfg) != torch.bfloat16:
        raise AssertionError(f"cfg/birds_joint_ft.yml computes in {cfg.DTYPE.COMPUTE}, not bfloat16")
    st = gan.init_state(cfg, device="cuda")

    def audited_step():
        batch = cli.featurize(raw, frontend_params_from_cfg(cfg.AUDIO), "cuda")
        return dtype_audit(st.models, lambda: gan.train_step(st, batch, z, eps))

    seen = counted("audit", audited_step)
    want = {"g conv": {"bfloat16"}, "g bn": {"bfloat16"}, "d conv": {"bfloat16"}, "d bn": {"bfloat16"},
            "images": {"float32"}, "logits": {"float32"}, "embedding": {"float32"}, "xw": {"float32"}}
    log(f"[bf16] dtype audit of a joint step (forward hooks): {dict(sorted(seen.items()))}")
    if seen != want:
        raise AssertionError(f"[bf16] output types {seen}, expected {want}")
    del st

    # serve: the serve phase's weights and batch in bfloat16, card and CPU
    ref = F32["serve_ref"]
    cfg = config.cfg_from_file("cfg/birds_3stages.yml")
    pipe = SpeechToImage(cfg, ref["enc_sd"], ref["g_sd"], device="cuda")
    img_c = counted("serve", lambda: pipe.generate(ref["wavs"], ref["lens"], z=ref["z"]))
    img_p = SpeechToImage(cfg, ref["enc_sd"], ref["g_sd"], device="cpu").generate(ref["wavs"], ref["lens"],
                                                                                  z=ref["z"])
    err32, spread = (float(np.abs(x - ref["img_cpu"]).max()) for x in (img_c, img_p))
    err16 = float(np.abs(img_c - img_p).max())
    log(f"[bf16] serve images, max_abs_err vs the CPU's float32: card bf16 {err32:.3g}, CPU bf16 {spread:.3g} (bound "
        f"{2 * spread:.3g}); card vs CPU bf16 {err16:.3g} (float32's fixed tol {TOL_IMAGE}); image std "
        f"{img_c.std():.3f}")
    if not (np.isfinite(img_c).all() and img_c.shape == (BATCH, 256, 256, 3) and img_c.dtype == np.float32):
        raise AssertionError(f"bad bf16 images: {img_c.shape} {img_c.dtype}")
    if not err32 <= 2 * spread:
        raise AssertionError(f"[bf16] serve: card bf16 {err32} from float32, over twice the CPU's {spread}")
    wavs_dev = torch.from_numpy(ref["wavs"]).cuda()
    with torch.inference_mode():
        fc, mc = extract_features(wavs_dev, pipe.p, wav_len=ref["lens"])
        mu = pipe.g.ca_net(embedding(pipe.encoder(fc, mc)))[0]
        zt = torch.from_numpy(ref["z"]).cuda()
        parts = {"frontend": time_ms(lambda: extract_features(wavs_dev, pipe.p, wav_len=ref["lens"]), reps=10),
                 "encoder": time_ms(lambda: pipe.encoder(fc, mc), reps=10),
                 "generator": time_ms(lambda: pipe.g(zt, mu), reps=10)}
    times, peak, _ = timed_steps(lambda: pipe.generate(ref["wavs"], ref["lens"], seed=1, output_dtype="uint8"),
                                 LATENCY_RUNS)
    log(beside(f"serve, batch {BATCH}", times, parts, peak, F32["serve"]))
    del pipe

    # the first GAN step: card and CPU in bfloat16 against the gan phase's CPU float32 step
    cfg, raw, z, eps = first_step_inputs("cfg/birds_3stages.yml")
    st, rec = first_step(cfg, raw, z, eps, "cuda")
    _, rec_cpu = first_step(cfg, raw, z, eps, "cpu")
    bf16_step_gate("GAN birds_3stages", rec, rec_cpu, F32["gan_cpu_step"])
    del st

    # encoder pretraining at batch 64
    cfg = config.cfg_from_file("cfg/pretrain_encoder_birds.yml")
    p = frontend_params_from_cfg(cfg.AUDIO)
    raw = train_batch(p, int(cfg.ENCODER.N_CLASSES), int(cfg.TEXT.DIMENSION))
    state = init_encoder_state(cfg, device="cuda")
    counted("train", lambda: [encoder_train_step(state, cli.featurize(raw, p, "cuda")) for _ in range(TRAIN_STEPS)])
    times, peak, mets = timed_steps(lambda: encoder_train_step(state, cli.featurize(raw, p, "cuda")), STEP_RUNS)
    parts = [step_parts_ms(state, raw, p) for _ in range(3)]
    parts = {k: float(np.median([pt[k] for pt in parts])) for k in parts[0]}
    log(beside(f"encoder pretrain, batch {TRAIN_BATCH}", times, parts, peak, F32["train"])
        + f"; loss after {state.step} steps {float(mets['loss']):.4f}")
    if not np.isfinite(float(mets["loss"])):
        raise AssertionError(f"[bf16] encoder loss not finite: {mets}")
    del state

    # GAN, joint and GAN with bfloat16 moments at batch 24
    for tag, path, moments in (("gan", "cfg/birds_3stages.yml", "float32"),
                               ("joint", "cfg/birds_joint_ft.yml", "float32"),
                               ("gan_bf16_moments", "cfg/birds_3stages.yml", "bfloat16")):
        cfg = gan_cfg(path, GAN_BATCH)
        cfg.TRAIN.MOMENT_DTYPE = moments
        joint = bool(cfg.TRAIN.JOINT_FT)
        p = frontend_params_from_cfg(cfg.AUDIO)
        st = gan.init_state(cfg, device="cuda")
        stream = itertools.cycle(list(cli.synthetic_gan_batches(cfg)(1)))
        step = (lambda: gan.train_step(st, cli.featurize(next(stream), p, "cuda"))) if joint else \
            (lambda: gan.train_step(st, next(stream)))
        counted(tag, lambda: [step() for _ in range(GAN_STEPS)])
        times, peak, mets = timed_steps(step, GAN_STEP_RUNS)
        parts = [gan_step_parts_ms(st, next(stream), p, joint) for _ in range(3)]
        parts = {k: float(np.median([pt[k] for pt in parts])) for k in parts[0]}
        line = beside(f"{tag}, batch {GAN_BATCH}, Adam moments {moments}", times, parts, peak,
                      F32["joint" if joint else "gan"])
        if not all(np.isfinite(float(v)) for v in mets.values()):
            raise AssertionError(f"[bf16] {tag}: metrics not finite: {mets}")
        if moments == "bfloat16":
            moments_now = [v for o in (st.g_opt, *st.d_opts) for s_ in o.state.values()
                           for k_, v in s_.items() if k_ != "step"]
            n_bf16 = sum(v.dtype == torch.bfloat16 for v in moments_now)
            in_f32 = sum(2 * p_.numel() * 4 for o in (st.g_opt, *st.d_opts) for g in o.param_groups
                         for p_ in g["params"])
            os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
            d = tempfile.mkdtemp(prefix="chip_smoke_bf16_", dir=cfg.OUTPUT_DIR)
            try:
                CheckpointManager(d).save(st.step, st)
                nbytes = os.path.getsize(os.path.join(d, f"{st.step}.pt"))
            finally:
                shutil.rmtree(d, ignore_errors=True)
            line += (f"; checkpoint {nbytes} bytes, Adam moments {sum(v.numel() * v.element_size() for v in moments_now)}"
                     f" bytes ({n_bf16} of {len(moments_now)} tensors bfloat16) against {in_f32} in float32")
            if not n_bf16:
                raise AssertionError("[bf16] TRAIN.MOMENT_DTYPE=bfloat16 kept no moment in bfloat16")
        log(line + f"; g_loss after {st.step} steps {float(mets['g_loss']):.4f}")
        del st, stream, step
        torch.cuda.empty_cache()

    log(f"[bf16] {card}: launches (K1/K2/K3/K4) " + "; ".join(
        f"{k} {'/'.join(str(v[n]) for n in KERNELS)}" for k, v in counts.items()))
    want = {"audit": (1, 1, 1), "serve": (1, 1, 0), "train": (TRAIN_STEPS,) * 3, "gan": (0, 0, 0),
            "joint": (GAN_STEPS,) * 3, "gan_bf16_moments": (0, 0, 0)}
    for k, (n1, n2, n3) in want.items():
        if counts[k] != {"mel_fused": n1, "gru_fwd": n2, "gru_bwd": n3, "mel_framed": 0}:
            raise AssertionError(f"[bf16] {k}: launches {counts[k]}, expected K1/K2/K3 {n1}/{n2}/{n3}")
    return {k: sum(c[k] for c in counts.values()) for k in KERNELS}


def main() -> None:
    name, smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    card = f"{name} ({smi})"
    paths = {"serve": phase_serve(card), "train": phase_train(card), "mel_ab": phase_mel_ab(card),
             "gan": phase_gan(card, "cfg/birds_3stages.yml"), "joint": phase_gan(card, "cfg/birds_joint_ft.yml"),
             "ddp": phase_ddp(card),
             "bf16": phase_bf16(card), "export": phase_export(card), "ckpt": phase_ckpt(card),
             "loop": phase_loop(card)}
    os.makedirs("output", exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_data_", dir="output")
    try:
        paths["data"], made = phase_data(card, root)
        paths["eval"] = phase_eval(card, made)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    paths["cert"] = phase_cert(card)
    log(f"[smoke] {card}: the grain loader and run, the tools and the event-file checks took "
        f"{sum(ADDED_S.values()):.1f} s (" + ", ".join(f"{k} phase {v:.1f} s" for k, v in ADDED_S.items())
        + "; the loop phase's grid and event writes run inside its timed training)")
    rows = []
    for kname, (_, src, replaces) in KERNELS.items():
        by_path = {path: counts[kname] for path, counts in paths.items()}
        rows.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": sum(by_path.values()), "launches_by_path": by_path, **kernels[kname]})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        ddp_rank(sys.argv[2])
    else:
        main()
