"""Encoder-QUALITY certification of the port, the counterpart of
``scripts/encoder_quality_cert.py``: the distillation pretrain CONVERGES —
held-out distill MSE falls and speech→teacher retrieval (R@1 / mAP / medR)
rises over training — on the fixture corpus, with no external assets.

  1. build (or reuse) the fixture tree: per-caption tone WAVs whose audible
     content encodes the class (``tools_torch/make_fixture_dataset.py``);
  2. train the pretrain recipe (``cfg/pretrain_encoder_birds.yml``: MSE to
     the teacher embedding + auxiliary class CE, Adam) with
     ``train.encoder.init_encoder_state`` / ``encoder_train_step`` on the
     train split's captions (``cli.speech_batch_factory``: the prefetch
     thread, featurize on the device: K1, K2 and K3 on the card);
  3. at every ``--eval_every`` steps (and step 0), eval-mode embeddings
     (``train.encoder.extract_all``) of every test caption and of a fixed
     train subset's captions, scored by ``eval.retrieval_metrics``: test
     MSE, test and train speech→teacher R@1 / mAP / medR (multi-positive,
     grouped by image), nearest-train-prototype class accuracy.

A call on an existing ``--out`` resumes from ``train/ckpt`` (saved at each
eval point) at the next batch of the same stream, appends to
``results.jsonl`` and writes ``summary.json`` over every point.

    python -m s2i_tpu_torch.scripts.encoder_quality_cert --out output/encoder_quality
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import os
import time

import torch

from s2i_tpu_torch import cli, config
from s2i_tpu_torch.audio.frontend import frontend_params_from_cfg
from s2i_tpu_torch.data.stackgan import StackGanSplit
from s2i_tpu_torch.eval import cert
from s2i_tpu_torch.train.encoder import encoder_train_step, extract_all, init_encoder_state
from s2i_tpu_torch.utils import CheckpointManager


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="output/encoder_quality")
    ap.add_argument("--cfg", default="cfg/pretrain_encoder_birds.yml")
    ap.add_argument("--fixture", default="", help="reuse an existing fixture tree; empty = build under --out")
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--per_class", type=int, default=100)
    ap.add_argument("--captions", type=int, default=2)
    ap.add_argument("--test_per_class", type=int, default=2,
                    help="held-out images per class; >=2 keeps nearest-prototype accuracy and gallery R@1 apart")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--eval_every", type=int, default=150)
    ap.add_argument("--train_eval_n", type=int, default=160, help="images in the fixed train-subset gallery")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    return cli.add_device_flags(ap)


def main(argv: list[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    device = cli.resolve_args_device(args)
    os.makedirs(args.out, exist_ok=True)
    cfg = config.cfg_from_file(os.path.join(cert.REPO, args.cfg))
    if args.set:
        config.apply_overrides(cfg, args.set)
    cfg.DATA_DIR = fixture = args.fixture or cert.build_fixture(
        args.out, args.classes, args.per_class, args.captions, int(cfg.TEXT.DIMENSION), args.seed,
        test_per_class=args.test_per_class)
    cfg.SEED = args.seed
    cfg.ENCODER.N_CLASSES = args.classes
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    train_split, test_split = StackGanSplit(fixture, "train"), StackGanSplit(fixture, "test")
    bs = int(cfg.ENCODER.BATCH_SIZE)

    state = init_encoder_state(cfg, device)
    ckpt = CheckpointManager(os.path.join(args.out, "train", "ckpt"), max_to_keep=1)
    if ckpt.restore_latest(state) is not None:
        print(f"resumed from step {state.step}")
    # fixed populations: the galleries are the same at every eval point
    pops = cert.retrieval_populations(train_split, test_split, args.classes, args.train_eval_n, args.seed,
                                      frontend_params_from_cfg(cfg.AUDIO), bs, device)
    results = cert.Results(args.out)

    def evaluate(step: int, train_mets: dict, train_s: float) -> None:
        t0 = time.time()
        rec = {"step": step,
               **cert.encoder_record(lambda f, m: extract_all(state.model, f, m, bs), pops, device),
               "eval_s": round(time.time() - t0, 1), "train_s": round(train_s, 1),
               **cert.train_metrics(train_mets, 5)}
        results.add(rec)
        print(f"  step {step}: mse={rec['test_mse']} test R@1={rec['test_r@1']} mAP={rec['test_map']} "
              f"cls_acc={rec['proto_cls_acc']} ({rec['eval_s']}s)")

    factory = cli.speech_batch_factory(cfg, device)
    per_epoch = len(train_split) * train_split.captions_per_image // bs

    def stream(step: int):
        """The batches after ``step``: epoch after epoch of the train
        split's shuffled captions (seed SEED + epoch), as an uninterrupted
        run draws them."""
        epoch, skip = divmod(step, per_epoch)
        while True:
            with contextlib.closing(factory(epoch)) as batches:
                yield from itertools.islice(batches, skip, None)
            epoch, skip = epoch + 1, 0

    print(f"train to step {args.steps}, eval every {args.eval_every} "
          f"(batch {bs}, {len(train_split)}x{train_split.captions_per_image} train utterances)")
    if not results.has(state.step):
        evaluate(state.step, {}, 0.0)
    t0 = time.time()
    with contextlib.closing(stream(state.step)) as batches:
        for batch in batches if state.step < args.steps else ():
            mets = encoder_train_step(state, batch)
            if state.step % args.eval_every == 0 or state.step == args.steps:
                mets = {k: float(v) for k, v in mets.items()}
                train_s = time.time() - t0
                ckpt.save(state.step, state)  # before the point: a cut eval is redone on resume
                evaluate(state.step, mets, train_s)
                t0 = time.time()
            if state.step >= args.steps:
                break

    pts = results.points
    return results.write_summary(args.out, {
        "steps": pts[-1]["step"],
        "test_mse_first": pts[0]["test_mse"],
        "test_mse_best": min(r["test_mse"] for r in pts),
        "test_mse_last": pts[-1]["test_mse"],
        "test_r@1_first": pts[0]["test_r@1"],
        "test_r@1_best": max(r["test_r@1"] for r in pts),
        "test_r@1_last": pts[-1]["test_r@1"],
        "test_map_last": pts[-1]["test_map"],
        "train_r@1_last": pts[-1]["train_r@1"],
        "proto_cls_acc_last": pts[-1]["proto_cls_acc"],
        "train_wall_s": round(sum(r.get("train_s", 0.0) for r in pts), 1),
    })


if __name__ == "__main__":
    main()
