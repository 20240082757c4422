"""The trainer, the counterpart of ``s2i_tpu/train/loop.py``
(``GanTrainer``) without the data mesh: it owns the train state, the
checkpoints, the scalar log, the snapshot grids and the epoch loop, and
leaves the step's math to ``train.gan.train_step``.

    trainer = GanTrainer(cfg, run_dir, batch_factory)   # restores run_dir's latest checkpoint
    trainer.train(max_epoch=600)                         # total epochs; SIGTERM stops it cleanly
    trainer.sample_to_dir(embeddings, out_dir)           # PNG tree from the EMA G

``batch_factory(epoch)`` yields host batches in a fixed order for each epoch
(``cli.synthetic_gan_batches`` draws them from (SEED, epoch)); joint-mode
batches may carry wavs, which the loop featurizes on the device just
before their step. A run that stops (``max_steps``, SIGTERM) checkpoints the
full state with its place in the batch stream (``train_progress.json``),
and a trainer on the same directory resumes at the next batch, bitwise as
if it had not stopped.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import time
import warnings
from typing import Callable, Iterable

import numpy as np
import torch

from s2i_tpu_torch.audio.frontend import featurize, frontend_params_from_cfg
from s2i_tpu_torch.device import resolve_device
from s2i_tpu_torch.models.generator import GNet
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.utils import CheckpointManager, ScalarLogger, profile_steps, save_image_grid, save_images

PROFILE_STEPS = 5  # steps in a TRAIN.PROFILE_DIR trace, which starts 5 steps into a train() call


class GanTrainer:
    def __init__(
        self,
        cfg,
        output_dir: str,
        batch_factory: Callable[[int], Iterable[dict]],
        log_every: int = 20,
        image_every: int = 500,
        device: str | torch.device = "cuda",
        max_to_keep: int = 3,
    ):
        self.cfg = cfg
        self.output_dir = output_dir
        self.batch_factory = batch_factory
        self.log_every = log_every
        self.image_every = image_every
        self.device = resolve_device(device)
        self.joint = bool(cfg.TRAIN.JOINT_FT)
        self.p = frontend_params_from_cfg(cfg.AUDIO)
        os.makedirs(output_dir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(output_dir, "ckpt"), max_to_keep)
        self.logger = ScalarLogger(output_dir)  # TRAIN.TENSORBOARD: no event files (utils/logging.py)
        self._viz_emb = None  # the first batch's first 8 embeddings, taken at the first grid

        self.state = gan.init_state(cfg, self.device)
        # The place in the batch stream that the latest checkpoint was cut
        # at, so that a resume continues with the very next batch.
        self._progress = {"epoch": 0, "step_in_epoch": 0}
        restored = self.ckpt.restore_latest(self.state)
        if restored is not None:
            step = restored[1]
            prog = self._read_progress()
            if prog is not None and int(prog.get("step", -1)) == step:
                self._progress = {"epoch": int(prog["epoch"]), "step_in_epoch": int(prog["step_in_epoch"])}
            else:
                print("warning: checkpoint has no matching progress sidecar; resuming the data stream "
                      "from epoch 0")
            print(f"resumed from step {step}")
        elif str(cfg.TRAIN.NET_G):
            # warm start: a fresh run directory, the whole state (step
            # included) from another run's latest checkpoint
            src = CheckpointManager(str(cfg.TRAIN.NET_G))
            if src.restore_latest(self.state) is None:
                raise FileNotFoundError(f"TRAIN.NET_G={cfg.TRAIN.NET_G!r} has no checkpoint")
            print(f"warm-started from {cfg.TRAIN.NET_G} step {self.state.step}")
        if self.joint and str(cfg.TRAIN.NET_E) and restored is None:
            self._graft_encoder(str(cfg.TRAIN.NET_E))
        recalc = int(cfg.EVAL.EMA_BN_RECALC)
        self._recalc_batches = recalc if recalc > 0 and float(cfg.TRAIN.EMA_G) > 0 else 0
        self._write_run_metadata()

    def eval_state(self, embeddings, seed: int = 0) -> GNet:
        """The G to sample from (eval mode, a copy): the EMA weights (when
        the run keeps an EMA) with G's BatchNorm statistics re-estimated
        under them (``gan.bn_recalc``, ``EVAL.EMA_BN_RECALC`` batches of
        ``TRAIN.BATCH_SIZE`` rows of ``embeddings``, draws from ``seed``), or
        with G's running statistics unchanged when ``EVAL.EMA_BN_RECALC`` is
        0. The trainer's G is left as it is."""
        g = gan.sampling_generator(self.state)
        if self._recalc_batches:
            stats = gan.bn_recalc(self.state, embeddings, self._recalc_batches,
                                  int(self.cfg.TRAIN.BATCH_SIZE), seed=seed)
            with torch.no_grad():
                for name, buf in g.named_buffers():
                    buf.copy_(stats[name])
        return g

    def _write_run_metadata(self) -> None:
        """Run provenance: versions, the device and parameter counts."""
        m = self.state.models
        count = lambda mod: 0 if mod is None else sum(p.numel() for p in mod.parameters())  # noqa: E731
        on_card = self.device.type == "cuda"
        meta = {
            "torch_version": torch.__version__,
            "device": torch.cuda.get_device_name(self.device) if on_card else "cpu",
            "n_devices": torch.cuda.device_count() if on_card else 1,
            "perf_levers": None,  # the port computes one layout (train/gan.py)
            "params": {"generator+ca": count(m.g), "encoder": count(m.encoder),
                       "discriminators": [count(d) for d in m.ds]},
        }
        with open(os.path.join(self.output_dir, "run_meta.json"), "w") as f:
            json.dump(meta, f, indent=2)

    def _progress_path(self) -> str:
        return os.path.join(self.output_dir, "train_progress.json")

    def _read_progress(self) -> dict | None:
        try:
            with open(self._progress_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_progress(self, step: int) -> None:
        """Persist the batch-stream position of ``step``'s checkpoint (tmp +
        rename: a torn write must not corrupt a resume)."""
        tmp = self._progress_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, **self._progress}, f)
        os.replace(tmp, self._progress_path())

    def _save_checkpoint(self, step: int, force: bool = False) -> None:
        if self.ckpt.save(step, self.state, force=force):
            self._write_progress(step)

    def _graft_encoder(self, net_e: str) -> None:
        """Load the joint encoder's parameters and BN statistics from the
        latest checkpoint of an encoder pretraining run, key by key. The
        pretraining encoder's extra keys (its class head) are ignored; a key
        it lacks or a shape that differs (ENCODER.* / AUDIO.* drift between
        the two cfgs) raises rather than leave random weights in a run that
        says it warm-started. G's optimizer state is left as it is."""
        restored = CheckpointManager(net_e).restore_latest_raw()
        if restored is None:
            raise FileNotFoundError(f"TRAIN.NET_E={net_e!r} has no checkpoint")
        raw, estep = restored
        src = raw.get("model") if isinstance(raw, dict) else None
        if not isinstance(src, dict):
            raise ValueError(f"TRAIN.NET_E={net_e!r} is not an encoder-pretrain checkpoint (no model)")
        enc = self.state.models.encoder
        problems = []
        for k, v in enc.state_dict().items():
            if k not in src:
                problems.append(f"{k}: missing from pretrain checkpoint")
            elif src[k].shape != v.shape:
                problems.append(f"{k}: checkpoint shape {tuple(src[k].shape)} vs model {tuple(v.shape)}")
        if problems:
            raise ValueError(
                f"TRAIN.NET_E={net_e!r} does not match the joint encoder (ENCODER.*/AUDIO.* config "
                "drift?): " + "; ".join(problems[:8]) + (", ..." if len(problems) > 8 else "")
            )
        enc.load_state_dict({k: src[k] for k in enc.state_dict()})
        print(f"encoder warm-started from {net_e} step {estep}")

    def _prep(self, batch: dict) -> dict:
        return featurize(batch, self.p, self.device) if "wav" in batch else batch

    def train(self, max_epoch: int | None = None, max_steps: int | None = None) -> dict:
        """Train until ``max_epoch`` TOTAL epochs are done (default
        ``TRAIN.MAX_EPOCH``: a resumed run finishes the remaining epochs, a
        finished one does nothing) or the global step reaches ``max_steps``.
        Snapshots every ``TRAIN.SNAPSHOT_INTERVAL`` steps and once at the end,
        each with its place in the batch stream. SIGTERM (handled on the main
        thread only) finishes the step, checkpoints and stops. Returns the
        last step's metrics."""
        cfg = self.cfg
        max_epoch = max_epoch or int(cfg.TRAIN.MAX_EPOCH)
        snapshot = int(cfg.TRAIN.SNAPSHOT_INTERVAL)
        if max_steps is not None and self.state.step >= max_steps:
            return {}
        stop_requested = []
        prev_handler, handler_installed = None, False  # None is also a possible earlier handler
        try:
            prev_handler = signal.signal(signal.SIGTERM, lambda *_: stop_requested.append(True))
            handler_installed = True
        except ValueError:
            pass  # not the main thread: no handler
        debug_nans = bool(cfg.TRAIN.DEBUG_NANS)
        profile_dir = str(cfg.TRAIN.PROFILE_DIR)
        # a window relative to this call's first step, so resumed runs trace too
        profile_at = self.state.step + 5
        profiling = contextlib.ExitStack()
        mets: dict = {}
        t0, imgs_done = time.time(), 0
        step = self.state.step
        try:
            for epoch in range(self._progress["epoch"], max_epoch):
                raw = iter(self.batch_factory(epoch))
                skip = self._progress["step_in_epoch"] if epoch == self._progress["epoch"] else 0
                # mid-epoch resume: the stream is deterministic per epoch, so
                # skipping the consumed batches realigns it exactly
                try:
                    for _ in range(skip):
                        next(raw)
                except StopIteration:
                    self._progress = {"epoch": epoch + 1, "step_in_epoch": 0}
                    continue  # the epoch shrank since the checkpoint: it is done
                self._progress = {"epoch": epoch, "step_in_epoch": skip}
                stopped = False
                for batch in raw:
                    b = len(batch["images"][0])
                    mets = gan.train_step(self.state, self._prep(batch))
                    step = self.state.step
                    self._progress["step_in_epoch"] += 1
                    if debug_nans:
                        bad = {k: float(v) for k, v in mets.items() if not np.isfinite(float(v))}
                        if bad:
                            raise FloatingPointError(f"non-finite metrics at step {step}: {bad}")
                    if profile_dir and step == profile_at:
                        profiling.enter_context(profile_steps(profile_dir))
                    elif step == profile_at + PROFILE_STEPS:
                        profiling.close()
                    imgs_done += b
                    if self.log_every and step % self.log_every == 0:
                        scalars = {k: float(v) for k, v in mets.items()}
                        scalars["images_per_sec"] = imgs_done / max(time.time() - t0, 1e-9)
                        self.logger.log(step, scalars)
                        t0, imgs_done = time.time(), 0
                    if self.image_every and step % self.image_every == 0:
                        self._save_grid(step)
                    if snapshot and step % snapshot == 0:
                        self._save_checkpoint(step)
                    if stop_requested or (max_steps is not None and step >= max_steps):
                        stopped = True
                        break
                if stopped:
                    if stop_requested:
                        print(f"SIGTERM: checkpointing at step {step}")
                    break
                if self._progress["step_in_epoch"] == 0:
                    raise ValueError(
                        f"batch_factory({epoch}) yielded no batches: empty data, or a split smaller "
                        f"than TRAIN.BATCH_SIZE={int(cfg.TRAIN.BATCH_SIZE)}?"
                    )
                self._progress = {"epoch": epoch + 1, "step_in_epoch": 0}
        finally:
            # also when the loop raises: a caller that catches the error
            # keeps neither an open trace nor a hijacked SIGTERM handler
            profiling.close()
            if handler_installed:
                signal.signal(signal.SIGTERM, prev_handler)
        if self.ckpt.latest_step != step:
            self._save_checkpoint(step, force=True)
        else:
            # the checkpoint is current, but the progress may have rolled
            # over to the next epoch since it was cut
            self._write_progress(step)
        return {k: float(v) for k, v in mets.items()}

    def _save_grid(self, step: int) -> None:
        if self._viz_emb is None:
            self._viz_emb = torch.as_tensor(next(iter(self.batch_factory(0)))["embedding"][:8]).float()
        imgs = gan.sample(self.eval_state(self._viz_emb, seed=42), self._viz_emb, seed=42)
        grid = save_image_grid(imgs[-1].permute(0, 2, 3, 1).cpu().numpy(),
                               os.path.join(self.output_dir, "images", f"fake_{step:07d}.png"))
        self.logger.log_image(step, "samples", grid)

    def sample_to_dir(self, embeddings, out_dir: str, names: list[str] | None = None,
                      samples_per_emb: int = 1, batch_size: int = 32, seed: int = 0) -> None:
        """Top-scale PNGs of every embedding (``out_dir/<name>.png``; with
        several samples per embedding, ``out_dir/<s>/<name>.png``), from
        :meth:`eval_state`'s G, ``batch_size`` at a time. Sample s of
        embedding i draws its z from (``seed + s``, i), so an image depends on
        neither the batch size nor the padding of the last batch."""
        if not self._recalc_batches and float(self.cfg.TRAIN.EMA_G) > 0:
            warnings.warn(
                "Sampling EMA params with EVAL.EMA_BN_RECALC=0: BatchNorm running stats were "
                "collected along the RAW parameter trajectory and mismatch the averaged weights "
                "(see docs/QUALITY.md). Set EVAL.EMA_BN_RECALC (certified: 30) unless reproducing "
                "the reference lineage's latent flaw.",
                stacklevel=2,
            )
        embeddings = np.asarray(embeddings, np.float32)
        n = embeddings.shape[0]
        names = names or [f"{i:06d}" for i in range(n)]
        g = self.eval_state(embeddings, seed=seed)
        for s in range(samples_per_emb):
            outs = []
            for i in range(0, n, batch_size):
                e = embeddings[i: i + batch_size]
                pad = batch_size - e.shape[0]
                if pad:
                    e = np.concatenate([e, np.zeros((pad, e.shape[1]), e.dtype)])
                top = gan.sample(g, e, seed=seed + s, offset=i)[-1]
                outs.append(top[: batch_size - pad].permute(0, 2, 3, 1).cpu().numpy())
            save_images(np.concatenate(outs), out_dir if samples_per_emb == 1 else os.path.join(out_dir, str(s)),
                        [f"{nm}.png" for nm in names])

    def close(self) -> None:
        self.ckpt.close()
        self.logger.close()
