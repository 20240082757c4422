"""Training and sampling loops of the port, the counterpart of the training
half of ``s2i_tpu/cli.py``:

    from s2i_tpu_torch import config, cli
    cfg = config.cfg_from_file("cfg/pretrain_encoder_birds.yml")
    cli.run_encoder_pretrain(cfg, steps=100)            # on the card
    cfg = config.cfg_from_file("cfg/birds_3stages.yml")  # or birds_joint_ft.yml
    cli.run_gan_training(cfg, steps=100, run_dir=run)    # train.loop.GanTrainer
    cli.run_gan_training(cfg, steps=200, run_dir=run)    # resumes at step 100
    cli.run_sampling(cfg)                                # TRAIN.NET_G's run → PNG tree

Both training loops checkpoint the full state (``<run_dir>/ckpt``, with the
batch stream's place in ``train_progress.json``) and resume when given an
existing ``run_dir``; epochs count in total. Batches come from the synthetic
corpora (``DATASET_NAME: synthetic``) or, for real data, from the caller:
encoder batches as wavs ``{"wav", "wav_len", "teacher", "class_id"}``, GAN
batches ``{"images", "embedding", "class_id"}`` (plus ``"wav"``,
``"wav_len"`` and ``"teacher"`` in joint mode). ``featurize`` turns wavs into
log-mel features on the device (K1 on the card). The StackGAN loaders and
the TensorBoard mirror are not ported (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from s2i_tpu_torch.audio.frontend import featurize, frontend_params_from_cfg
from s2i_tpu_torch.data import SyntheticGanDataset, SyntheticSpeechDataset, synthetic_wavs
from s2i_tpu_torch.device import resolve_device
from s2i_tpu_torch.train.encoder import encoder_train_step, init_encoder_state
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils import CheckpointManager, ScalarLogger


def make_run_dir(cfg, tag: str) -> str:
    """``<OUTPUT_DIR>/<dataset>_<config>_<tag>_<timestamp>``, created."""
    stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    run_dir = os.path.join(cfg.OUTPUT_DIR, f"{cfg.DATASET_NAME}_{cfg.CONFIG_NAME}_{tag}_{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


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
            for batch in factory(epoch):
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
    cfg, batches: Callable[[int], Iterable[dict]] | None = None
) -> Callable[[int], Iterable[dict]]:
    """epoch → host GAN batches: ``batches(epoch)`` when given, else the
    synthetic corpus (``DATASET_NAME: synthetic``). Joint-mode batches carry
    their captions' wavs, which the trainer featurizes on the device (K1 on
    the card) as it takes each batch."""
    if batches is not None:
        return batches
    if cfg.DATASET_NAME == "synthetic":
        return synthetic_gan_batches(cfg)
    raise NotImplementedError(
        f"DATASET_NAME={cfg.DATASET_NAME!r}: the StackGAN loader is not ported yet; "
        "pass batches(epoch) yielding {'images', 'embedding', 'class_id'} batches "
        "(+ 'wav', 'wav_len', 'teacher' with TRAIN.JOINT_FT)"
    )


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
    """The evaluation path: a PNG per test embedding (``<run dir>/samples``),
    ``EVAL.NUM_SAMPLES_PER_EMB`` each, from the G of ``TRAIN.NET_G``'s run
    (its EMA with BN re-estimated when ``EVAL.EMA_BN_RECALC`` > 0; the seeded
    init without ``TRAIN.NET_G``). The synthetic corpus's embeddings (seed
    ``SEED + 999``) stand in for the test split until the loaders are
    ported. Returns the samples' directory."""
    if cfg.DATASET_NAME != "synthetic":
        raise NotImplementedError(
            f"DATASET_NAME={cfg.DATASET_NAME!r}: the StackGAN test split loader is not ported yet"
        )
    dev = resolve_device(device)
    run_dir = make_run_dir(cfg, "sample")
    emb = SyntheticGanDataset(branch_num=int(cfg.TREE.BRANCH_NUM), base_size=int(cfg.TREE.BASE_SIZE),
                              emb_dim=int(cfg.TEXT.DIMENSION), seed=int(cfg.SEED) + 999).embeddings
    trainer = GanTrainer(cfg, run_dir, gan_batch_factory(cfg), device=dev)
    out_dir = os.path.join(run_dir, "samples")
    try:
        trainer.sample_to_dir(emb, out_dir, samples_per_emb=int(cfg.EVAL.NUM_SAMPLES_PER_EMB),
                              seed=int(cfg.SEED))
    finally:
        trainer.close()
    print(f"samples: {out_dir}")
    return out_dir
