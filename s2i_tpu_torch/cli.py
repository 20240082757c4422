"""Training loops of the port, the counterpart of the training half of
``s2i_tpu/cli.py``:

    from s2i_tpu_torch import config, cli
    cfg = config.cfg_from_file("cfg/pretrain_encoder_birds.yml")
    cli.run_encoder_pretrain(cfg, steps=100)            # on the card
    cfg = config.cfg_from_file("cfg/birds_3stages.yml")  # or birds_joint_ft.yml
    cli.run_gan_training(cfg, steps=100)

Batches come from the synthetic corpora (``DATASET_NAME: synthetic``) or,
for real data, from the caller: encoder batches as wavs ``{"wav",
"wav_len", "teacher", "class_id"}``, GAN batches ``{"images",
"embedding", "class_id"}`` (plus ``"wav"``, ``"wav_len"`` and ``"teacher"``
in joint mode). ``featurize`` turns wavs into log-mel features on the device
(K1 on the card). The StackGAN loaders, checkpoints, resume, TensorBoard
and sample grids are not ported yet (``ROADMAP.md`` items 11-12).
"""

from __future__ import annotations

import datetime
import json
import math
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from s2i_tpu_torch.audio.frontend import FrontendParams, extract_features, frontend_params_from_cfg
from s2i_tpu_torch.data import SyntheticGanDataset, SyntheticSpeechDataset, synthetic_wavs
from s2i_tpu_torch.device import resolve_device
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.train.encoder import encoder_train_step, init_encoder_state


class ScalarLogger:
    """JSONL scalars, one line per ``log`` call: ``{"step", "time", **scalars}``
    in ``<run_dir>/scalars.jsonl`` (the JSONL half of the JAX package's
    ``utils/logging.py::ScalarLogger``). Non-finite values are written as
    strings: bare NaN/Infinity tokens are not valid JSON."""

    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self._f = open(os.path.join(run_dir, "scalars.jsonl"), "a", buffering=1)

    def log(self, step: int, scalars: dict[str, Any]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (f if math.isfinite(f) else str(f))
                    for k, v in scalars.items() for f in (float(v),)})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


def make_run_dir(cfg, tag: str) -> str:
    """``<OUTPUT_DIR>/<dataset>_<config>_<tag>_<timestamp>``, created."""
    stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    run_dir = os.path.join(cfg.OUTPUT_DIR, f"{cfg.DATASET_NAME}_{cfg.CONFIG_NAME}_{tag}_{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def featurize(raw: dict, p: FrontendParams, device: str | torch.device = "cuda") -> dict:
    """A wav batch ``{"wav" [B, n], "wav_len" [B], ...}`` → the same batch
    with ``feats`` / ``feat_mask`` computed on ``device`` in place of the
    wav (for the encoder: ``{"feats", "feat_mask", "teacher", "class_id"}``)."""
    feats, mask = extract_features(raw["wav"], p, wav_len=raw["wav_len"], device=device)
    rest = {k: v for k, v in raw.items() if k not in ("wav", "wav_len")}
    return {"feats": feats, "feat_mask": mask, **rest}


def speech_batch_factory(
    cfg,
    device: str | torch.device = "cuda",
    wav_batches: Callable[[int], Iterable[dict]] | None = None,
) -> Callable[[int], Iterable[dict]]:
    """epoch → encoder-pretrain batches: the synthetic corpus's precomputed
    features, or ``wav_batches(epoch)`` through :func:`featurize`."""
    if cfg.DATASET_NAME == "synthetic":
        ds = SyntheticSpeechDataset(
            num_classes=int(cfg.ENCODER.N_CLASSES),
            max_frames=int(cfg.AUDIO.MAX_FRAMES),
            n_mels=int(cfg.AUDIO.N_MELS),
            emb_dim=int(cfg.TEXT.DIMENSION),
            seed=int(cfg.SEED),
        )
        batch_size = int(cfg.ENCODER.BATCH_SIZE)
        steps = max(1, ds.n // batch_size)
        return lambda epoch: ds.batches(batch_size, steps, seed=int(cfg.SEED) + epoch)
    if wav_batches is None:
        raise NotImplementedError(
            f"DATASET_NAME={cfg.DATASET_NAME!r}: the StackGAN speech loader is not "
            "ported yet; pass wav_batches(epoch) yielding {'wav', 'wav_len', "
            "'teacher', 'class_id'} batches"
        )
    p = frontend_params_from_cfg(cfg.AUDIO)
    return lambda epoch: (featurize(b, p, device) for b in wav_batches(epoch))


def run_encoder_pretrain(
    cfg,
    steps: int | None = None,
    epochs: int | None = None,
    device: str | torch.device = "cuda",
    run_dir: str | None = None,
    wav_batches: Callable[[int], Iterable[dict]] | None = None,
) -> dict:
    """Distillation pretraining of the speech encoder for ``epochs`` (default
    ``ENCODER.EPOCHS``) or until ``steps`` steps, whichever ends first, from
    weights seeded with ``cfg.SEED``. Every ``ENCODER.LOG_EVERY`` steps it
    appends the step's metrics and ``examples_per_sec`` to
    ``<run_dir>/scalars.jsonl``. Returns the last step's metrics."""
    dev = resolve_device(device)
    run_dir = run_dir or make_run_dir(cfg, "encoder")
    state = init_encoder_state(cfg, device=dev)
    factory = speech_batch_factory(cfg, dev, wav_batches)
    logger = ScalarLogger(run_dir)
    log_every = int(cfg.ENCODER.LOG_EVERY)
    mets: dict = {}
    t0, seen = time.time(), 0
    try:
        for epoch in range(epochs or int(cfg.ENCODER.EPOCHS)):
            for batch in factory(epoch):
                if steps is not None and state.step >= steps:
                    break
                seen += batch["feats"].shape[0]
                mets = encoder_train_step(state, batch)
                if log_every and state.step % log_every == 0:
                    dt = time.time() - t0
                    scalars = {k: float(v) for k, v in mets.items()}
                    scalars["examples_per_sec"] = seen / max(dt, 1e-9)
                    logger.log(state.step, scalars)
                    t0, seen = time.time(), 0
            if steps is not None and state.step >= steps:
                break
    finally:
        logger.close()
    print(f"run dir: {run_dir}")
    return {k: float(v) for k, v in mets.items()}


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


def gan_batch_factory(
    cfg,
    device: str | torch.device = "cuda",
    batches: Callable[[int], Iterable[dict]] | None = None,
) -> Callable[[int], Iterable[dict]]:
    """epoch → GAN batches: ``batches(epoch)`` when given, else the synthetic
    corpus (``DATASET_NAME: synthetic``). In joint mode (``TRAIN.JOINT_FT``)
    each batch carries its captions' wavs, featurized here on ``device`` (K1
    on the card), as the JAX package's real-data joint loader does."""
    if batches is None and cfg.DATASET_NAME == "synthetic":
        batches = synthetic_gan_batches(cfg)
    elif batches is None:
        raise NotImplementedError(
            f"DATASET_NAME={cfg.DATASET_NAME!r}: the StackGAN loader is not ported yet; "
            "pass batches(epoch) yielding {'images', 'embedding', 'class_id'} batches "
            "(+ 'wav', 'wav_len', 'teacher' with TRAIN.JOINT_FT)"
        )
    if not bool(cfg.TRAIN.JOINT_FT):
        return batches
    p = frontend_params_from_cfg(cfg.AUDIO)
    return lambda epoch: (featurize(b, p, device) for b in batches(epoch))


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
    when ``TRAIN.JOINT_FT``) for ``epochs`` (default ``TRAIN.MAX_EPOCH``) or
    until ``steps`` steps, whichever ends first, from weights seeded with
    ``cfg.SEED``. Every ``log_every`` steps it appends the step's metrics and
    ``images_per_sec`` to ``<run_dir>/scalars.jsonl``. Returns the last
    step's metrics."""
    dev = resolve_device(device)
    run_dir = run_dir or make_run_dir(cfg, "train")
    state = gan.init_state(cfg, device=dev)
    factory = gan_batch_factory(cfg, dev, batches)
    logger = ScalarLogger(run_dir)
    mets: dict = {}
    done = lambda: steps is not None and state.step >= steps  # noqa: E731
    t0, seen = time.time(), 0
    try:
        for epoch in range(epochs or int(cfg.TRAIN.MAX_EPOCH)):
            if done():
                break
            for batch in factory(epoch):  # checked after each step: no batch is made in vain
                seen += len(batch["images"][0])
                mets = gan.train_step(state, batch)
                if log_every and state.step % log_every == 0:
                    scalars = {k: float(v) for k, v in mets.items()}
                    scalars["images_per_sec"] = seen / max(time.time() - t0, 1e-9)
                    logger.log(state.step, scalars)
                    t0, seen = time.time(), 0
                if done():
                    break
    finally:
        logger.close()
    print(f"run dir: {run_dir}")
    return {k: float(v) for k, v in mets.items()}
