"""The port's command-line plumbing and its drivers, the counterpart of
``s2i_tpu/cli.py``: config resolution, run directories, the batch factories
(synthetic corpora or the StackGAN tree) and the train / sample / pretrain /
extract drivers that ``entrypoints.py`` and ``python -m s2i_tpu_torch`` run,
and the metric drivers of ``scripts/eval.py`` and
``scripts/finetune_inception.py`` (``run_eval``, ``run_retrieval``,
``run_inception_finetune``), and the checkpoint interchange with the
reference project of ``scripts/port_torch_gan.py`` and
``scripts/export_torch_gan.py`` (``run_port_gan``, ``run_export_gan``).

    from s2i_tpu_torch import config, cli
    cfg = config.cfg_from_file("cfg/pretrain_encoder_birds.yml")
    cli.run_encoder_pretrain(cfg, steps=100)             # on the card
    cli.run_embedding_extraction(cfg, "<run>/ckpt", "speech-embeddings.pickle")
    cfg = config.cfg_from_file("cfg/birds_3stages.yml")   # or birds_joint_ft.yml
    cli.run_gan_training(cfg, steps=100, run_dir=run)     # train.loop.GanTrainer
    cli.run_gan_training(cfg, steps=200, run_dir=run)     # resumes at step 100
    cli.run_sampling(cfg)                                 # TRAIN.NET_G's run → PNG tree
    cli.run_eval("<samples>", real_dir="<images>")        # {"is_mean", "is_std", "fid", ...}

Both training loops checkpoint the full state (``<run_dir>/ckpt``, with the
batch stream's place in ``train_progress.json``) and resume when given an
existing ``run_dir``; epochs count in total. Batches come from the synthetic
corpora (``DATASET_NAME: synthetic``), the StackGAN tree under ``DATA_DIR``
(``data/stackgan.py``; ``DATA.PIPELINE`` native or pil, or grain's order
from ``data/grain_pipeline.py``), or the caller:
encoder batches as wavs ``{"wav", "wav_len", "teacher", "class_id"}``, GAN
batches ``{"images", "embedding", "class_id"}`` (plus ``"wav"``,
``"wav_len"`` and ``"teacher"`` in joint mode). A prefetch thread
(``data/pipeline.py``) loads host batches ahead and copies them to the
device from pinned buffers on a side stream; ``featurize`` turns wavs into
log-mel features on the device (K1 on the card). With ``TRAIN.TENSORBOARD``
the training drivers also write TensorBoard event files under
``<run_dir>/tb`` (``utils/logging.py``, no TensorBoard needed).

Under ``torchrun`` (:func:`command_device` joins the process group) the
encoder pretraining, GAN training, sampling and eval drivers run over a
data axis (``parallel.make_mesh_if_configured``): every rank walks the same
(SEED, epoch) order and loads only its rows of each global batch, rank 0
makes the run directory and writes what a run writes.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import glob
import json
import os
import pickle
import time
from typing import Callable, Iterable

import numpy as np
import torch
from PIL import Image

from s2i_tpu_torch import config, parallel
from s2i_tpu_torch.audio.frontend import featurize, frontend_params_from_cfg
from s2i_tpu_torch.data import SyntheticGanDataset, SyntheticSpeechDataset, synthetic_wavs
from s2i_tpu_torch.data.grain_pipeline import grain_batch_factory
from s2i_tpu_torch.data.pipeline import Prefetcher
from s2i_tpu_torch.data.stackgan import GanEpochIterator, SpeechEpochIterator, StackGanSplit, wav_batch
from s2i_tpu_torch.device import compute_dtype, moment_dtype, resolve_device
from s2i_tpu_torch.eval import (InceptionFeatures, fid_from_stats, gaussian_stats, inception_score_from_probs,
                                retrieval_metrics)
from s2i_tpu_torch.eval.finetune import init_inception_state, make_inception_train_step
from s2i_tpu_torch.eval.inception_score import softmax
from s2i_tpu_torch.eval.weights import load_torch_inception
from s2i_tpu_torch.pipeline import build_encoder
from s2i_tpu_torch.port import export_dnet, export_gnet, load_torch_state_dict, port_dnet, port_gnet
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.train.encoder import encoder_train_step, init_encoder_state
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils import CheckpointManager, ScalarLogger

SPEECH_PREFETCH = 2  # wav batches ahead (42 MB each at the birds width), as the JAX loop


def add_device_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``--gpu N`` and ``--device cpu``, which :func:`resolve_args_device` reads."""
    p.add_argument("--gpu", dest="gpu_id", type=int, default=None, help="run on cuda:GPU (default: the current card)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default) or cpu: the plain PyTorch versions of the kernels, for tests")
    return p


def base_parser(description: str) -> argparse.ArgumentParser:
    """The flags every training or sampling entry point takes: the JAX
    package's (``--cfg --data_dir --output_dir --manualSeed --gpu --set``)
    and ``--device``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", dest="cfg_file", default=None, help="YAML config")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--manualSeed", type=int, default=None)
    add_device_flags(p)
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


def resolve_args_device(args, distributed: bool = False) -> torch.device:
    """``--device cpu`` → the CPU; otherwise ``cuda:<--gpu>`` (or the
    current card), which raises without a card. A torchrun launch of more
    than one rank raises unless the command is ``distributed`` (it then
    joins the process group in :func:`command_device`), and there ``--gpu``
    raises too: ``LOCAL_RANK`` picks each rank's card."""
    world = parallel.launched_world_size()
    if world > 1 and not distributed:
        raise ValueError(f"this command runs in one process, but WORLD_SIZE={world} ranks were launched")
    if world > 1 and args.gpu_id is not None:
        raise ValueError(f"--gpu names one card, but WORLD_SIZE={world} ranks were launched: under torchrun "
                         "LOCAL_RANK picks each rank's card")
    if args.device == "cpu":
        if args.gpu_id is not None:
            raise ValueError("--gpu names a card; it cannot go with --device cpu")
        return resolve_device("cpu")
    return resolve_device("cuda" if args.gpu_id is None else f"cuda:{args.gpu_id}")


@contextlib.contextmanager
def command_device(args, distributed: bool = False):
    """The device a command runs on (:func:`resolve_args_device`). Under
    torchrun's environment a ``distributed`` command joins the process group
    first (NCCL on the card, ``cuda:LOCAL_RANK``; gloo with ``--device
    cpu``) and leaves it as the command ends, also when it raises, so that a
    failing rank exits instead of hanging; any other command refuses a
    launch of more than one rank."""
    dev = resolve_args_device(args, distributed)
    try:
        if distributed and parallel.maybe_initialize_distributed(dev):
            dev = resolve_device(parallel.local_device(dev))
        yield dev
    finally:
        parallel.destroy()


def make_run_dir(cfg, tag: str, axis: parallel.DataAxis | None = None) -> str:
    """``<OUTPUT_DIR>/<dataset>_<config>_<tag>_<timestamp>``, created, with
    the resolved config in ``config.yml``; over ``axis`` rank 0 makes it and
    every rank gets its name."""
    run_dir = None
    if axis is None or axis.rank == 0:
        stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        run_dir = os.path.join(cfg.OUTPUT_DIR, f"{cfg.DATASET_NAME}_{cfg.CONFIG_NAME}_{tag}_{stamp}")
        os.makedirs(run_dir, exist_ok=True)
        config.dump_cfg(cfg, os.path.join(run_dir, "config.yml"))
    return run_dir if axis is None else axis.broadcast_object(run_dir)


def speech_host_batches(
    cfg, wav_batches: Callable[[int], Iterable[dict]] | None = None, axis: parallel.DataAxis | None = None
) -> Callable[[int], Iterable[dict]]:
    """epoch → host encoder-pretrain batches: the synthetic corpus's
    features, ``wav_batches(epoch)`` when given, or the StackGAN tree's
    captions (``SpeechEpochIterator`` over ``DATA_DIR``'s train split,
    shuffled from SEED + epoch). Over ``axis``, this rank's rows of each
    global batch of ``ENCODER.BATCH_SIZE``: the loaders load only those, the
    caller's batches are sliced."""
    batch_size = int(cfg.ENCODER.BATCH_SIZE)
    rows = None if axis is None else axis.rows(batch_size)
    if cfg.DATASET_NAME == "synthetic":
        ds = SyntheticSpeechDataset(
            num_classes=int(cfg.ENCODER.N_CLASSES),
            max_frames=int(cfg.AUDIO.MAX_FRAMES),
            n_mels=int(cfg.AUDIO.N_MELS),
            emb_dim=int(cfg.TEXT.DIMENSION),
            seed=int(cfg.SEED),
        )
        steps = max(1, ds.n // batch_size)
        return lambda epoch: ds.batches(batch_size, steps, seed=int(cfg.SEED) + epoch, rows=rows)
    if wav_batches is not None:
        return wav_batches if axis is None else lambda epoch: (parallel.shard_batch(b, axis)
                                                               for b in wav_batches(epoch))
    p = frontend_params_from_cfg(cfg.AUDIO)
    split = StackGanSplit(cfg.DATA_DIR, "train")
    return lambda epoch: SpeechEpochIterator(split, batch_size, p.sample_rate, p.max_samples,
                                             seed=int(cfg.SEED) + epoch, rows=rows)


def speech_batch_factory(
    cfg,
    device: str | torch.device = "cuda",
    wav_batches: Callable[[int], Iterable[dict]] | None = None,
    axis: parallel.DataAxis | None = None,
) -> Callable[[int], Iterable[dict]]:
    """epoch → encoder-pretrain batches on ``device``: those of
    :func:`speech_host_batches` (this rank's rows over ``axis``), loaded and
    copied ahead by a prefetch thread (``SPEECH_PREFETCH`` deep), wavs
    through :func:`featurize`."""
    dev = resolve_device(device)
    host = speech_host_batches(cfg, wav_batches, axis)
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
    ``ENCODER.SNAPSHOT_INTERVAL`` steps and at each epoch's end. Under
    torchrun every rank steps on its rows of each global batch
    (``ENCODER.BATCH_SIZE``) and rank 0 writes. Returns the last step's
    metrics."""
    dev = resolve_device(device)
    axis = parallel.make_mesh_if_configured(cfg, int(cfg.ENCODER.BATCH_SIZE))
    writer = axis is None or axis.rank == 0
    run_dir = run_dir or make_run_dir(cfg, "encoder", axis)
    prog_path = os.path.join(run_dir, "train_progress.json")
    state = init_encoder_state(cfg, device=dev, axis=axis)
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"), writer=writer)
    start_epoch = 0
    if ckpt.restore_latest(state) is not None:
        try:
            with open(prog_path) as f:
                start_epoch = int(json.load(f).get("epoch", 0))
        except (OSError, ValueError):
            start_epoch = 0  # no progress file: replay from the first epoch
        print(f"resumed from step {state.step} (epoch {start_epoch})")
    parallel.replicate_state(state, axis)
    factory = speech_batch_factory(cfg, dev, wav_batches, axis)
    logger = ScalarLogger(run_dir, writer=writer, use_tensorboard=bool(cfg.TRAIN.TENSORBOARD))
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
                    seen += batch["feats"].shape[0] * (1 if axis is None else axis.size)
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
    if axis is not None:
        axis.barrier()  # rank 0's checkpoint is on disk when any rank returns
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
    a prefetch thread. Returns the paths written, by split. It runs in one
    process: a torchrun launch of more than one rank raises."""
    if parallel.launched_world_size() > 1:
        raise ValueError("embedding extraction (--extract) runs in one process; launch it without torchrun")
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


def synthetic_gan_batches(cfg, axis: parallel.DataAxis | None = None) -> Callable[[int], Iterable[dict]]:
    """epoch → host batches of the synthetic GAN corpus, ``TRAIN.BATCH_SIZE``
    each (over ``axis``, this rank's rows of each); in joint mode
    (``TRAIN.JOINT_FT``) each example carries a wav of
    :func:`synthetic_wavs` and distills toward its own embedding."""
    joint = bool(cfg.TRAIN.JOINT_FT)
    ds = _synthetic_gan(cfg)
    bs = int(cfg.TRAIN.BATCH_SIZE)
    rows = slice(None) if axis is None else axis.rows(bs)
    steps = max(1, ds.n // bs)
    if joint:
        p = frontend_params_from_cfg(cfg.AUDIO)
        wavs, lens = synthetic_wavs(ds.class_id, p.max_samples, seed=int(cfg.SEED))

    def factory(epoch: int):
        rng = np.random.default_rng(int(cfg.SEED) + epoch)
        for _ in range(steps):
            idx = rng.integers(0, ds.n, size=bs)[rows]
            b = ds.batch(idx)
            if joint:
                b.update(wav=wavs[idx], wav_len=lens[idx], teacher=b["embedding"])
            yield b

    return factory


def stackgan_gan_batches(cfg, axis: parallel.DataAxis | None = None) -> Callable[[int], Iterable[dict]]:
    """epoch → host GAN batches of ``DATA_DIR``'s train split
    (``GanEpochIterator``, shuffled from SEED + epoch, one caption drawn per
    image, ``TEXT.EMBEDDING_FILE``'s embedding of it; over ``axis`` the
    rank's rows of each, the only images and wavs it loads). ``DATA.PIPELINE``:
    ``native`` takes the C++ JPEG loader where it builds (``g++`` and
    libjpeg) and PIL otherwise, ``pil`` always PIL. In joint mode
    (``TRAIN.JOINT_FT``) each example also carries the wav of the same
    caption, and its embedding is the distillation teacher (the JAX
    package's ``joint_batch_factory``). ``grain`` takes
    ``data/grain_pipeline.py``'s batches in Grain's order
    (``DATA.GRAIN_WORKERS`` decode processes) for the frozen GAN; joint mode
    has no grain path in the JAX package either, and takes the native loader
    there."""
    pipeline = str(cfg.DATA.PIPELINE).lower()
    if pipeline not in ("native", "pil", "grain"):
        raise ValueError(f"unknown DATA.PIPELINE {pipeline!r}")
    if pipeline == "grain" and not bool(cfg.TRAIN.JOINT_FT):
        return grain_batch_factory(cfg, axis)
    split = StackGanSplit(cfg.DATA_DIR, "train", embedding_file=str(cfg.TEXT.EMBEDDING_FILE))
    p = frontend_params_from_cfg(cfg.AUDIO)
    return lambda epoch: GanEpochIterator(
        split,
        int(cfg.TRAIN.BATCH_SIZE),
        int(cfg.TREE.BRANCH_NUM),
        int(cfg.TREE.BASE_SIZE),
        seed=int(cfg.SEED) + epoch,
        num_threads=int(cfg.WORKERS),
        use_native=False if pipeline == "pil" else None,
        with_audio=bool(cfg.TRAIN.JOINT_FT),
        sample_rate=p.sample_rate,
        max_samples=p.max_samples,
        image_dtype=str(cfg.DATA.IMAGE_DTYPE),
        ship_scales=str(cfg.DATA.SHIP_SCALES),
        fast_decode=bool(cfg.DATA.FAST_DECODE),
        rows=None if axis is None else axis.rows(int(cfg.TRAIN.BATCH_SIZE)),
    )


def gan_batch_factory(
    cfg, batches: Callable[[int], Iterable[dict]] | None = None, axis: parallel.DataAxis | None = None
) -> Callable[[int], Iterable[dict]]:
    """epoch → host GAN batches: ``batches(epoch)`` when given (global
    batches), else the synthetic corpus (``DATASET_NAME: synthetic``) or the
    StackGAN tree (:func:`stackgan_gan_batches`). Over ``axis``, this rank's
    rows of each global batch: the loaders load only those, the caller's
    batches are sliced. Joint-mode batches carry their captions' wavs,
    which the trainer featurizes on the device (K1 on the card) as it takes
    each batch."""
    if batches is not None:
        return batches if axis is None else lambda epoch: (parallel.shard_batch(b, axis)
                                                           for b in batches(epoch))
    if cfg.DATASET_NAME == "synthetic":
        return synthetic_gan_batches(cfg, axis)
    return stackgan_gan_batches(cfg, axis)


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
    ``<run_dir>/scalars.jsonl``. Under torchrun every rank trains on its rows
    of each global batch. Returns the last step's metrics."""
    dev = resolve_device(device)
    axis = parallel.make_mesh_if_configured(cfg, int(cfg.TRAIN.BATCH_SIZE))
    run_dir = run_dir or make_run_dir(cfg, "train", axis)
    trainer = GanTrainer(cfg, run_dir, gan_batch_factory(cfg, batches, axis), log_every=log_every, device=dev,
                         mesh=axis)
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
    999``) with ``DATASET_NAME: synthetic``. Under torchrun each rank samples
    its rows of each batch and rank 0 writes. Returns the samples' directory."""
    dev = resolve_device(device)
    axis = parallel.make_mesh_if_configured(cfg)
    run_dir = make_run_dir(cfg, "sample", axis)
    if cfg.DATASET_NAME == "synthetic":
        emb = SyntheticGanDataset(branch_num=int(cfg.TREE.BRANCH_NUM), base_size=int(cfg.TREE.BASE_SIZE),
                                  emb_dim=int(cfg.TEXT.DIMENSION), seed=int(cfg.SEED) + 999).embeddings
        names = None
    else:
        split = StackGanSplit(cfg.DATA_DIR, "test", embedding_file=str(cfg.TEXT.EMBEDDING_FILE))
        emb = split.embeddings[:, 0]
        names = [f.replace("/", "_") for f in split.filenames]
    # the trainer only samples here: its batches are never drawn
    trainer = GanTrainer(cfg, run_dir, lambda epoch: iter(()), device=dev, mesh=axis)
    out_dir = os.path.join(run_dir, "samples")
    try:
        trainer.sample_to_dir(np.asarray(emb, np.float32), out_dir, names,
                              samples_per_emb=int(cfg.EVAL.NUM_SAMPLES_PER_EMB), seed=int(cfg.SEED))
    finally:
        trainer.close()
    print(f"samples: {out_dir}")
    return out_dir


def list_images(d: str, limit: int | None = None) -> list[str]:
    """The PNGs and JPEGs under ``d`` (recursively), sorted, the first ``limit``."""
    paths = sorted(glob.glob(os.path.join(d, "**", "*.png"), recursive=True)
                   + glob.glob(os.path.join(d, "**", "*.jpg"), recursive=True))[:limit]
    if not paths:
        raise FileNotFoundError(f"no images under {d}")
    return paths


def extract_dir(ex, d: str, batch: int, limit: int | None = None,
                img_size: int | None = None) -> tuple[np.ndarray, np.ndarray, int]:
    """A directory of images through the extractor → (pool3, logits, n).

    Decodes ``batch`` images at a time (the 30k-image protocol at 256 px is
    ~24 GB as one float32 stack) and brings every image to one (H, W)
    canvas: ``img_size``, or the first image's size. Images of another size
    are PIL-bilinear resized to it on the host; a directory of one size
    passes through untouched, so the extractor's resize to 299 px is its
    only resample."""
    paths = list_images(d, limit)
    pools, logits, size = [], [], None
    for i in range(0, len(paths), batch):
        chunk = []
        for p in paths[i: i + batch]:
            with Image.open(p) as f:
                im = f.convert("RGB")
            if size is None:
                size = (img_size, img_size) if img_size else (im.height, im.width)
            if (im.height, im.width) != size:
                im = im.resize((size[1], size[0]), Image.BILINEAR)
            chunk.append(np.asarray(im, np.float32) / 127.5 - 1.0)
        p3, lg = ex.extract(np.stack(chunk), batch)
        pools.append(p3)
        logits.append(lg)
    return np.concatenate(pools), np.concatenate(logits), len(paths)


def _load_embeddings(path: str) -> tuple[np.ndarray, np.ndarray]:
    """An embedding pickle → ([rows, D] float32, group ids). An extraction
    pickle [N_img, captions, D] groups rows by image (an image's other
    captions are positives too); a flat [N, D] one is paired."""
    with open(path, "rb") as f:
        e = np.asarray(pickle.load(f, encoding="latin1"), np.float32)
    if e.ndim == 3:
        return e.reshape(-1, e.shape[-1]), np.repeat(np.arange(e.shape[0]), e.shape[1])
    return e.reshape(-1, e.shape[-1]), np.arange(e.shape[0])


def run_retrieval(query_pkl: str, target_pkl: str, device: str | torch.device = "cuda") -> dict:
    """Speech↔teacher retrieval over two embedding pickles (e.g. the
    extracted ``speech-embeddings.pickle`` against the split's
    ``char-CNN-RNN-embeddings.pickle``), aligned by group id: only the
    image ids both hold are kept, so that every query group keeps its
    targets in both directions (a row-count cut would strand groups)."""
    (q, qid), (t, tid) = _load_embeddings(query_pkl), _load_embeddings(target_pkl)
    n_groups = min(int(qid.max()), int(tid.max())) + 1
    qm, tm = qid < n_groups, tid < n_groups
    if not (qm.all() and tm.all()):
        print(f"# group counts differ: keeping the common first {n_groups} "
              f"({int(qm.sum())} query rows, {int(tm.sum())} target rows)")
    return retrieval_metrics(q[qm], t[tm], query_ids=qid[qm], target_ids=tid[tm], device=device)


def inception_weights(weights: str | None = None, finetuned_ckpt: str | None = None,
                      num_classes: int | None = None) -> tuple[dict | None, int]:
    """(InceptionV3 state_dict, classes) from a torchvision-layout ``.pth``
    or ``.pt`` state_dict, or from the latest checkpoint of a
    ``finetune-inception`` run's ``ckpt`` directory; (None, ``num_classes``
    or 1000) for seeded random weights. A ``num_classes`` other than the
    weights' raises."""
    if weights:
        if not weights.endswith((".pth", ".pt")):
            raise ValueError("--weights takes a torch .pth state_dict")
        sd = load_torch_inception(torch.load(weights, map_location="cpu", weights_only=True))
    elif finetuned_ckpt:
        restored = CheckpointManager(finetuned_ckpt).restore_latest_raw()
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {finetuned_ckpt}")
        sd = load_torch_inception(restored[0]["model"])
    else:
        return None, num_classes or 1000
    n = int(sd["fc.weight"].shape[0])
    if num_classes is not None and num_classes != n:
        raise ValueError(f"--num_classes {num_classes}, but the weights have {n} classes")
    return sd, n


def run_eval(
    gen_dir: str,
    real_dir: str | None = None,
    weights: str | None = None,
    finetuned_ckpt: str | None = None,
    num_classes: int | None = None,
    splits: int = 10,
    batch: int = 64,
    limit: int | None = None,
    img_size: int | None = None,
    protocol: str = "exact",
    device: str | torch.device = "cuda",
) -> dict:
    """Inception Score of the images under ``gen_dir`` and, with
    ``real_dir``, their FID against those: one extractor pass over each
    directory (pool3 feeds FID, the logits IS). ``protocol`` "pytorch-fid"
    quantizes inputs through uint8 before the 299 px resize, a no-op on
    decoded files (already uint8). Returns ``{"is_mean", "is_std",
    "n_gen", "inception"[, "fid"]}`` with ``inception`` "finetuned" when
    weights were given, else "random-weight". Under torchrun each rank
    extracts its rows of each batch (``InceptionFeatures(mesh=)``; every
    rank decodes the whole directory) and every rank returns the metrics."""
    if protocol not in ("exact", "pytorch-fid"):
        raise ValueError(f"unknown protocol {protocol!r}: exact or pytorch-fid")
    sd, n_classes = inception_weights(weights, finetuned_ckpt, num_classes)
    ex = InceptionFeatures(sd, num_classes=n_classes, quantize_input=protocol == "pytorch-fid", device=device,
                           mesh=parallel.make_mesh_if_configured(None))
    gen_pool, gen_logits, n_gen = extract_dir(ex, gen_dir, batch, limit, img_size)
    mean, std = inception_score_from_probs(softmax(gen_logits), splits)
    rec = {"is_mean": round(float(mean), 4), "is_std": round(float(std), 4), "n_gen": int(n_gen),
           "inception": "finetuned" if sd is not None else "random-weight"}
    if real_dir:
        real_pool, _, _ = extract_dir(ex, real_dir, batch, limit, img_size)
        rec["fid"] = round(fid_from_stats(*gaussian_stats(gen_pool), *gaussian_stats(real_pool)), 4)
    return rec


def run_inception_finetune(
    cfg,
    epochs: int = 20,
    batch: int = 32,
    lr: float = 1e-4,
    warm_start: str | None = None,
    image_size: int = 299,
    base_size: int = 256,
    device: str | torch.device = "cuda",
) -> str:
    """Fine-tune InceptionV3 on ``ENCODER.N_CLASSES`` classes of
    ``DATA_DIR``'s train split (labels ``class_id % N_CLASSES``) for
    ``epochs`` epochs of ``batch`` images loaded at ``base_size`` and
    resized to ``image_size`` on the device, from the seeded init or a
    torchvision ``.pth`` (``warm_start``, class head excluded). Each epoch
    appends its last step's ``ce``/``acc`` to ``scalars.jsonl`` and saves
    the state to ``<run dir>/ckpt``, which ``eval --finetuned_ckpt`` reads.
    Returns the run dir."""
    dev = resolve_device(device)
    warm = None
    if warm_start:
        warm = load_torch_inception(torch.load(warm_start, map_location="cpu", weights_only=True))
    run_dir = make_run_dir(cfg, "inception")
    n_classes = int(cfg.ENCODER.N_CLASSES)
    state = init_inception_state(n_classes, int(cfg.SEED), lr, warm, device=dev)
    step = make_inception_train_step(image_size)
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    logger = ScalarLogger(run_dir)
    split = StackGanSplit(cfg.DATA_DIR, "train")
    try:
        for epoch in range(epochs):
            it = GanEpochIterator(split, batch, 1, base_size=base_size, seed=int(cfg.SEED) + epoch)
            mets = {}
            for b in it:
                mets = step(state, b["images"][0], b["class_id"] % n_classes)
            logger.log(state.step, {k: float(v) for k, v in mets.items()})
            ckpt.save(state.step, state)
            print(f"epoch {epoch}: {({k: round(float(v), 3) for k, v in mets.items()})}")
    finally:
        logger.close()
    print(f"run dir: {run_dir}")
    return run_dir


def run_port_gan(cfg, netg: str, netds: Iterable[str] = (), out: str = "ported",
                 device: str | torch.device = "cuda") -> str:
    """Reference ``netG.pth`` (and per-scale ``netD*.pth``, in any order)
    → a step-0 GAN checkpoint ``<out>/0.pt`` beside ``<out>/ported_config.yml``
    (``scripts/port_torch_gan.py``'s counterpart). The dims inferred from the
    files override ``cfg`` (``GAN.GF_DIM``, ``GAN.Z_DIM``,
    ``GAN.EMBEDDING_DIM``, ``TEXT.DIMENSION``, ``TREE.BRANCH_NUM``,
    ``GAN.R_NUM``, and ``GAN.DF_DIM`` with netDs; ``TRAIN.JOINT_FT`` off):
    the ported weights define the model. A scale with no netD keeps its
    seeded D; the EMA, where ``TRAIN.EMA_G`` keeps one, starts at G's
    weights. The state is built on ``device``. Returns ``out``."""
    dev = resolve_device(device)
    g_sd, meta = port_gnet(load_torch_state_dict(netg))
    print(f"netG: {netg} -> {meta}")
    cfg.GAN.GF_DIM, cfg.GAN.Z_DIM = meta["gf_dim"], meta["z_dim"]
    cfg.GAN.EMBEDDING_DIM, cfg.TEXT.DIMENSION = meta["c_dim"], meta["t_dim"]
    cfg.TREE.BRANCH_NUM = meta["branch_num"]
    if meta["r_num"] is not None:
        cfg.GAN.R_NUM = meta["r_num"]
    cfg.TRAIN.JOINT_FT = False
    scales = [64 * 2**i for i in range(int(cfg.TREE.BRANCH_NUM))]
    ported_ds: dict[int, dict] = {}
    for path in netds:
        d_sd, dmeta = port_dnet(load_torch_state_dict(path))
        print(f"netD: {path} -> {dmeta}")
        if dmeta["ef_dim"] != meta["c_dim"]:
            raise ValueError(f"{path}: condition dim {dmeta['ef_dim']} != netG's {meta['c_dim']}")
        if dmeta["scale"] in ported_ds:
            raise ValueError(f"duplicate netD for scale {dmeta['scale']}")
        if dmeta["scale"] not in scales:
            raise ValueError(f"netD{dmeta['scale']} has no slot at BRANCH_NUM={cfg.TREE.BRANCH_NUM}")
        if ported_ds and dmeta["df_dim"] != int(cfg.GAN.DF_DIM):
            raise ValueError(f"netDs disagree on df_dim: {int(cfg.GAN.DF_DIM)} and {dmeta['df_dim']}")
        cfg.GAN.DF_DIM = dmeta["df_dim"]
        ported_ds[dmeta["scale"]] = d_sd

    state = gan.init_state(cfg, dev)
    m = state.models
    m.g.load_state_dict(g_sd)
    for scale, d in zip(scales, m.ds):
        if scale in ported_ds:
            d.load_state_dict(ported_ds[scale])
    with torch.no_grad():
        for name, p in m.g.named_parameters():
            if name in state.ema:
                state.ema[name].copy_(p)
    CheckpointManager(out).save(0, state, force=True)
    cfg_path = os.path.join(out, "ported_config.yml")
    config.dump_cfg(cfg, cfg_path)
    missing = [s for s in scales if s not in ported_ds]
    note = f" (seeded Ds at scales {missing}; fine for sampling)" if missing else ""
    print(f"ported checkpoint written to {out} at step 0{note}")
    print(f"sample: python -m s2i_tpu_torch sample --cfg {cfg_path} --set TRAIN.NET_G={out}")
    return out


def run_export_gan(ckpt: str, out: str, raw: bool = False) -> dict[str, str]:
    """The latest GAN checkpoint of ``ckpt`` (a port run's ``<run>/ckpt``,
    frozen or joint) → reference ``netG.pth`` and ``netD{64,128,256}.pth``
    in ``out`` (``scripts/export_torch_gan.py``'s counterpart): G with its
    EMA weights over it, as ``SpeechToImage.from_checkpoints`` serves it, or
    the raw G with ``raw`` or when the run kept no EMA; a joint checkpoint's
    encoder is not exported. Returns the paths written, by file name."""
    if not os.path.isdir(ckpt):
        raise FileNotFoundError(f"no checkpoint directory {ckpt}")
    restored = CheckpointManager(ckpt).restore_latest_raw()
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt}")
    sd, step = restored
    if not {"g", "ds", "ema"} <= set(sd):
        raise ValueError(f"{ckpt}: not a GAN checkpoint (fields {sorted(sd)})")
    g_sd = dict(sd["g"])
    which = "raw" if raw or not sd["ema"] else "ema"
    if which == "ema":
        g_sd.update(sd["ema"])
    os.makedirs(out, exist_ok=True)
    files = {"netG.pth": export_gnet(g_sd)}
    files.update({f"netD{64 * 2**i}.pth": export_dnet(d_sd) for i, d_sd in enumerate(sd["ds"])})
    written = {}
    for name, tensors in files.items():
        written[name] = os.path.join(out, name)
        torch.save(tensors, written[name])
        what = f"({which}, step {step}, " if name == "netG.pth" else "("
        print(f"{name[:-4]} {what}{len(tensors)} tensors) -> {written[name]}")
    return written
