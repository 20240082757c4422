"""The port's command-line plumbing and its drivers, the counterpart of
``s2i_tpu/cli.py``: config resolution, run directories, the batch factories
(synthetic corpora or the StackGAN tree) and the train / sample / pretrain /
extract drivers that ``entrypoints.py`` and ``python -m s2i_tpu_torch`` run.

    from s2i_tpu_torch import config, cli
    cfg = config.cfg_from_file("cfg/pretrain_encoder_birds.yml")
    cli.run_encoder_pretrain(cfg, steps=100)             # on the card
    cli.run_embedding_extraction(cfg, "<run>/ckpt", "speech-embeddings.pickle")
    cfg = config.cfg_from_file("cfg/birds_3stages.yml")   # or birds_joint_ft.yml
    cli.run_gan_training(cfg, steps=100, run_dir=run)     # train.loop.GanTrainer
    cli.run_gan_training(cfg, steps=200, run_dir=run)     # resumes at step 100
    cli.run_sampling(cfg)                                 # TRAIN.NET_G's run → PNG tree

Both training loops checkpoint the full state (``<run_dir>/ckpt``, with the
batch stream's place in ``train_progress.json``) and resume when given an
existing ``run_dir``; epochs count in total. Batches come from the synthetic
corpora (``DATASET_NAME: synthetic``), the StackGAN tree under ``DATA_DIR``
(``data/stackgan.py``; ``DATA.PIPELINE`` native or pil), or the caller:
encoder batches as wavs ``{"wav", "wav_len", "teacher", "class_id"}``, GAN
batches ``{"images", "embedding", "class_id"}`` (plus ``"wav"``,
``"wav_len"`` and ``"teacher"`` in joint mode). A prefetch thread
(``data/pipeline.py``) loads host batches ahead and copies them to the
device from pinned buffers on a side stream; ``featurize`` turns wavs into
log-mel features on the device (K1 on the card). The TensorBoard mirror is
not ported (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import pickle
import time
from typing import Callable, Iterable

import numpy as np
import torch

from s2i_tpu_torch import config
from s2i_tpu_torch.audio.frontend import featurize, frontend_params_from_cfg
from s2i_tpu_torch.data import SyntheticGanDataset, SyntheticSpeechDataset, synthetic_wavs
from s2i_tpu_torch.data.pipeline import Prefetcher
from s2i_tpu_torch.data.stackgan import GanEpochIterator, SpeechEpochIterator, StackGanSplit, wav_batch
from s2i_tpu_torch.device import compute_dtype, moment_dtype, resolve_device
from s2i_tpu_torch.pipeline import build_encoder
from s2i_tpu_torch.train.encoder import encoder_train_step, init_encoder_state
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils import CheckpointManager, ScalarLogger

SPEECH_PREFETCH = 2  # wav batches ahead (42 MB each at the birds width), as the JAX loop


def base_parser(description: str) -> argparse.ArgumentParser:
    """The flags every entry point takes: the JAX package's (``--cfg
    --data_dir --output_dir --manualSeed --gpu --set``) and ``--device``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", dest="cfg_file", default=None, help="YAML config")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--manualSeed", type=int, default=None)
    p.add_argument("--gpu", dest="gpu_id", type=int, default=None, help="run on cuda:GPU (default: the current card)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default) or cpu: the plain PyTorch versions of the kernels, for tests")
    p.add_argument("--set", dest="overrides", nargs="*", default=[], metavar="KEY=VAL",
                   help="config overrides, e.g. TRAIN.BATCH_SIZE=32")
    return p


def resolve_cfg(args) -> config.AttrDict:
    cfg = config.cfg_from_file(args.cfg_file) if args.cfg_file else config.default_cfg()
    if args.data_dir:
        cfg.DATA_DIR = args.data_dir
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.manualSeed is not None:
        cfg.SEED = args.manualSeed
    if args.overrides:
        config.apply_overrides(cfg, args.overrides)
    # a type the port does not take raises here, not after a run's set-up
    compute_dtype(cfg)
    moment_dtype(cfg)
    return cfg


def resolve_args_device(args) -> torch.device:
    """``--device cpu`` → the CPU; otherwise ``cuda:<--gpu>`` (or the
    current card), which raises without a card."""
    if args.device == "cpu":
        if args.gpu_id is not None:
            raise ValueError("--gpu names a card; it cannot go with --device cpu")
        return resolve_device("cpu")
    return resolve_device("cuda" if args.gpu_id is None else f"cuda:{args.gpu_id}")


def make_run_dir(cfg, tag: str) -> str:
    """``<OUTPUT_DIR>/<dataset>_<config>_<tag>_<timestamp>``, created, with
    the resolved config in ``config.yml``."""
    stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    run_dir = os.path.join(cfg.OUTPUT_DIR, f"{cfg.DATASET_NAME}_{cfg.CONFIG_NAME}_{tag}_{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    config.dump_cfg(cfg, os.path.join(run_dir, "config.yml"))
    return run_dir


def speech_host_batches(
    cfg, wav_batches: Callable[[int], Iterable[dict]] | None = None
) -> Callable[[int], Iterable[dict]]:
    """epoch → host encoder-pretrain batches: the synthetic corpus's
    features, ``wav_batches(epoch)`` when given, or the StackGAN tree's
    captions (``SpeechEpochIterator`` over ``DATA_DIR``'s train split,
    shuffled from SEED + epoch)."""
    batch_size = int(cfg.ENCODER.BATCH_SIZE)
    if cfg.DATASET_NAME == "synthetic":
        ds = SyntheticSpeechDataset(
            num_classes=int(cfg.ENCODER.N_CLASSES),
            max_frames=int(cfg.AUDIO.MAX_FRAMES),
            n_mels=int(cfg.AUDIO.N_MELS),
            emb_dim=int(cfg.TEXT.DIMENSION),
            seed=int(cfg.SEED),
        )
        steps = max(1, ds.n // batch_size)
        return lambda epoch: ds.batches(batch_size, steps, seed=int(cfg.SEED) + epoch)
    if wav_batches is not None:
        return wav_batches
    p = frontend_params_from_cfg(cfg.AUDIO)
    split = StackGanSplit(cfg.DATA_DIR, "train")
    return lambda epoch: SpeechEpochIterator(split, batch_size, p.sample_rate, p.max_samples,
                                             seed=int(cfg.SEED) + epoch)


def speech_batch_factory(
    cfg,
    device: str | torch.device = "cuda",
    wav_batches: Callable[[int], Iterable[dict]] | None = None,
) -> Callable[[int], Iterable[dict]]:
    """epoch → encoder-pretrain batches on ``device``: those of
    :func:`speech_host_batches`, loaded and copied ahead by a prefetch
    thread (``SPEECH_PREFETCH`` deep), wavs through :func:`featurize`."""
    dev = resolve_device(device)
    host = speech_host_batches(cfg, wav_batches)
    p = frontend_params_from_cfg(cfg.AUDIO)

    def factory(epoch: int):
        batches = Prefetcher(host(epoch), depth=SPEECH_PREFETCH, device=dev)
        try:
            for b in batches:
                yield featurize(b, p, dev) if "wav" in b else b
        finally:
            batches.close()

    return factory


def run_encoder_pretrain(
    cfg,
    steps: int | None = None,
    epochs: int | None = None,
    device: str | torch.device = "cuda",
    run_dir: str | None = None,
    wav_batches: Callable[[int], Iterable[dict]] | None = None,
) -> dict:
    """Distillation pretraining of the speech encoder until ``epochs`` TOTAL
    epochs (default ``ENCODER.EPOCHS``) are done or the global step reaches
    ``steps``, from weights seeded with ``cfg.SEED``. An existing ``run_dir``
    resumes: the latest checkpoint of ``<run_dir>/ckpt`` is restored and the
    loop continues at the epoch its progress file records (a mid-epoch
    snapshot replays its epoch from the start, as the JAX loop does). Every
    ``ENCODER.LOG_EVERY`` steps it appends the step's metrics and
    ``examples_per_sec`` to ``<run_dir>/scalars.jsonl``; it checkpoints every
    ``ENCODER.SNAPSHOT_INTERVAL`` steps and at each epoch's end. Returns the
    last step's metrics."""
    dev = resolve_device(device)
    run_dir = run_dir or make_run_dir(cfg, "encoder")
    prog_path = os.path.join(run_dir, "train_progress.json")
    state = init_encoder_state(cfg, device=dev)
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    start_epoch = 0
    if ckpt.restore_latest(state) is not None:
        try:
            with open(prog_path) as f:
                start_epoch = int(json.load(f).get("epoch", 0))
        except (OSError, ValueError):
            start_epoch = 0  # no progress file: replay from the first epoch
        print(f"resumed from step {state.step} (epoch {start_epoch})")
    factory = speech_batch_factory(cfg, dev, wav_batches)
    logger = ScalarLogger(run_dir)
    log_every = int(cfg.ENCODER.LOG_EVERY)
    snapshot = int(cfg.ENCODER.SNAPSHOT_INTERVAL)
    done = lambda: steps is not None and state.step >= steps  # noqa: E731

    def save(epoch: int) -> None:
        # the epoch to resume at: the current one for a mid-epoch snapshot,
        # the next one at an epoch's end (tmp + rename: never torn)
        if ckpt.save(state.step, state):
            tmp = prog_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"epoch": epoch, "step": state.step}, f)
            os.replace(tmp, prog_path)

    mets: dict = {}
    t0, seen = time.time(), 0
    try:
        for epoch in range(start_epoch, epochs or int(cfg.ENCODER.EPOCHS)):
            if done():
                break
            with contextlib.closing(factory(epoch)) as batches:  # a stop reaps the prefetch thread
                for batch in batches:
                    if done():
                        break
                    seen += batch["feats"].shape[0]
                    mets = encoder_train_step(state, batch)
                    if log_every and state.step % log_every == 0:
                        dt = time.time() - t0
                        scalars = {k: float(v) for k, v in mets.items()}
                        scalars["examples_per_sec"] = seen / max(dt, 1e-9)
                        logger.log(state.step, scalars)
                        t0, seen = time.time(), 0
                    if snapshot and state.step % snapshot == 0:
                        save(epoch)
                else:
                    save(epoch + 1)
                    continue
            save(epoch)  # stopped at `steps` inside the epoch: a resume replays it
            break
    finally:
        logger.close()
    print(f"run dir: {run_dir}")
    return {k: float(v) for k, v in mets.items()}


@torch.no_grad()
def run_embedding_extraction(
    cfg, encoder_ckpt: str, out_path: str = "speech-embeddings.pickle", device: str | torch.device = "cuda"
) -> dict[str, str]:
    """The encoder of ``encoder_ckpt``'s latest checkpoint (an encoder
    pretraining run's ``<run>/ckpt``), in eval mode, over every caption of
    both splits of ``DATA_DIR``, ``ENCODER.BATCH_SIZE`` utterances at a time
    (the last batch padded with empty rows): writes
    ``<DATA_DIR>/<split>/<out_path>``, a float32 [images, captions,
    TEXT.DIMENSION] pickle that ``StackGanSplit`` (the port's and the JAX
    package's) reads as ``TEXT.EMBEDDING_FILE``. WAV reads and copies run in
    a prefetch thread. Returns the paths written, by split."""
    dev = resolve_device(device)
    restored = CheckpointManager(encoder_ckpt).restore_latest_raw()
    if restored is None:
        raise FileNotFoundError(f"no encoder checkpoint under {encoder_ckpt}")
    model = build_encoder(cfg)
    model.load_state_dict(restored[0]["model"])
    model.to(dev).eval()
    p = frontend_params_from_cfg(cfg.AUDIO)
    bs = int(cfg.ENCODER.BATCH_SIZE)
    written = {}
    for split_name in ("train", "test"):
        split = StackGanSplit(cfg.DATA_DIR, split_name)
        caps = split.captions_per_image
        flat = [(i, c) for i in range(len(split)) for c in range(caps)]
        chunks = [flat[s: s + bs] for s in range(0, len(flat), bs)]
        out = np.zeros((len(split), caps, int(cfg.TEXT.DIMENSION)), np.float32)
        host = (wav_batch(split, chunk, bs, p.sample_rate, p.max_samples) for chunk in chunks)
        batches = Prefetcher(host, depth=SPEECH_PREFETCH, device=dev)
        try:
            for chunk, raw in zip(chunks, batches):
                b = featurize(raw, p, dev)
                emb = model(b["feats"], b["feat_mask"])
                emb = (emb[0] if isinstance(emb, tuple) else emb).cpu().numpy()
                for j, (i, c) in enumerate(chunk):
                    out[i, c] = emb[j]
        finally:
            batches.close()
        dst = os.path.join(cfg.DATA_DIR, split_name, out_path)
        with open(dst, "wb") as f:
            pickle.dump(out, f)
        print(f"wrote {dst}: {out.shape}")
        written[split_name] = dst
    return written


def _synthetic_gan(cfg) -> SyntheticGanDataset:
    return SyntheticGanDataset(
        branch_num=int(cfg.TREE.BRANCH_NUM),
        base_size=int(cfg.TREE.BASE_SIZE),
        emb_dim=int(cfg.TEXT.DIMENSION),
        seed=int(cfg.SEED),
        image_dtype=str(cfg.DATA.IMAGE_DTYPE),
        ship_scales=str(cfg.DATA.SHIP_SCALES),
    )


def synthetic_gan_batches(cfg) -> Callable[[int], Iterable[dict]]:
    """epoch → host batches of the synthetic GAN corpus, ``TRAIN.BATCH_SIZE``
    each; in joint mode (``TRAIN.JOINT_FT``) each example carries a wav of
    :func:`synthetic_wavs` and distills toward its own embedding."""
    joint = bool(cfg.TRAIN.JOINT_FT)
    ds = _synthetic_gan(cfg)
    bs = int(cfg.TRAIN.BATCH_SIZE)
    steps = max(1, ds.n // bs)
    if joint:
        p = frontend_params_from_cfg(cfg.AUDIO)
        wavs, lens = synthetic_wavs(ds.class_id, p.max_samples, seed=int(cfg.SEED))

    def factory(epoch: int):
        rng = np.random.default_rng(int(cfg.SEED) + epoch)
        for _ in range(steps):
            idx = rng.integers(0, ds.n, size=bs)
            b = ds.batch(idx)
            if joint:
                b.update(wav=wavs[idx], wav_len=lens[idx], teacher=b["embedding"])
            yield b

    return factory


def stackgan_gan_batches(cfg) -> Callable[[int], Iterable[dict]]:
    """epoch → host GAN batches of ``DATA_DIR``'s train split
    (``GanEpochIterator``, shuffled from SEED + epoch, one caption drawn per
    image, ``TEXT.EMBEDDING_FILE``'s embedding of it). ``DATA.PIPELINE``:
    ``native`` takes the C++ JPEG loader where it builds (``g++`` and
    libjpeg) and PIL otherwise, ``pil`` always PIL. In joint mode
    (``TRAIN.JOINT_FT``) each example also carries the wav of the same
    caption, and its embedding is the distillation teacher (the JAX
    package's ``joint_batch_factory``)."""
    pipeline = str(cfg.DATA.PIPELINE).lower()
    if pipeline == "grain":
        raise NotImplementedError(
            "DATA.PIPELINE=grain is not ported (ROADMAP.md Queue 1); use native or pil")
    if pipeline not in ("native", "pil"):
        raise ValueError(f"unknown DATA.PIPELINE {pipeline!r}")
    split = StackGanSplit(cfg.DATA_DIR, "train", embedding_file=str(cfg.TEXT.EMBEDDING_FILE))
    p = frontend_params_from_cfg(cfg.AUDIO)
    return lambda epoch: GanEpochIterator(
        split,
        int(cfg.TRAIN.BATCH_SIZE),
        int(cfg.TREE.BRANCH_NUM),
        int(cfg.TREE.BASE_SIZE),
        seed=int(cfg.SEED) + epoch,
        num_threads=int(cfg.WORKERS),
        use_native=None if pipeline == "native" else False,
        with_audio=bool(cfg.TRAIN.JOINT_FT),
        sample_rate=p.sample_rate,
        max_samples=p.max_samples,
        image_dtype=str(cfg.DATA.IMAGE_DTYPE),
        ship_scales=str(cfg.DATA.SHIP_SCALES),
        fast_decode=bool(cfg.DATA.FAST_DECODE),
    )


def gan_batch_factory(
    cfg, batches: Callable[[int], Iterable[dict]] | None = None
) -> Callable[[int], Iterable[dict]]:
    """epoch → host GAN batches: ``batches(epoch)`` when given, else the
    synthetic corpus (``DATASET_NAME: synthetic``) or the StackGAN tree
    (:func:`stackgan_gan_batches`). Joint-mode batches carry their captions'
    wavs, which the trainer featurizes on the device (K1 on the card) as it
    takes each batch."""
    if batches is not None:
        return batches
    if cfg.DATASET_NAME == "synthetic":
        return synthetic_gan_batches(cfg)
    return stackgan_gan_batches(cfg)


def run_gan_training(
    cfg,
    steps: int | None = None,
    epochs: int | None = None,
    device: str | torch.device = "cuda",
    run_dir: str | None = None,
    batches: Callable[[int], Iterable[dict]] | None = None,
    log_every: int = 20,
) -> dict:
    """GAN training (frozen embeddings, or the joint encoder + GAN finetune
    when ``TRAIN.JOINT_FT``) through :class:`train.loop.GanTrainer` until
    ``epochs`` TOTAL epochs (default ``TRAIN.MAX_EPOCH``) are done or the
    global step reaches ``steps``, from weights seeded with ``cfg.SEED``
    (or ``TRAIN.NET_G`` / ``TRAIN.NET_E``'s). An existing ``run_dir``
    resumes where its latest checkpoint stopped. Every ``log_every`` steps it
    appends the step's metrics and ``images_per_sec`` to
    ``<run_dir>/scalars.jsonl``. Returns the last step's metrics."""
    dev = resolve_device(device)
    run_dir = run_dir or make_run_dir(cfg, "train")
    trainer = GanTrainer(cfg, run_dir, gan_batch_factory(cfg, batches), log_every=log_every, device=dev)
    try:
        mets = trainer.train(epochs, steps)
    finally:
        trainer.close()
    print(f"run dir: {run_dir}")
    return mets


def run_sampling(cfg, device: str | torch.device = "cuda") -> str:
    """The evaluation path: ``EVAL.NUM_SAMPLES_PER_EMB`` PNGs per test
    embedding (``<run dir>/samples``; with several samples per embedding,
    ``samples/<s>/``), from the G of ``TRAIN.NET_G``'s run (its EMA with BN
    re-estimated when ``EVAL.EMA_BN_RECALC`` > 0; the seeded init without
    ``TRAIN.NET_G``). The embeddings are the test split's first caption's
    (``TEXT.EMBEDDING_FILE``), each PNG named after its image's file name
    with ``/`` turned into ``_``; the synthetic corpus's (seed ``SEED +
    999``) with ``DATASET_NAME: synthetic``. Returns the samples' directory."""
    dev = resolve_device(device)
    run_dir = make_run_dir(cfg, "sample")
    if cfg.DATASET_NAME == "synthetic":
        emb = SyntheticGanDataset(branch_num=int(cfg.TREE.BRANCH_NUM), base_size=int(cfg.TREE.BASE_SIZE),
                                  emb_dim=int(cfg.TEXT.DIMENSION), seed=int(cfg.SEED) + 999).embeddings
        names = None
    else:
        split = StackGanSplit(cfg.DATA_DIR, "test", embedding_file=str(cfg.TEXT.EMBEDDING_FILE))
        emb = split.embeddings[:, 0]
        names = [f.replace("/", "_") for f in split.filenames]
    # the trainer only samples here: its batches are never drawn
    trainer = GanTrainer(cfg, run_dir, lambda epoch: iter(()), device=dev)
    out_dir = os.path.join(run_dir, "samples")
    try:
        trainer.sample_to_dir(np.asarray(emb, np.float32), out_dir, names,
                              samples_per_emb=int(cfg.EVAL.NUM_SAMPLES_PER_EMB), seed=int(cfg.SEED))
    finally:
        trainer.close()
    print(f"samples: {out_dir}")
    return out_dir
