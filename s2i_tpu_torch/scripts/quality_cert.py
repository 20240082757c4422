"""Training-QUALITY certification of the port's GAN, the counterpart of
``scripts/quality_cert.py``: a fixture-FID-vs-step curve showing that the
3-stage recipe converges (``SURVEY.md`` §4: "the training curves and IS/FID
numbers reproduce" is the reference's whole validation story).

Four phases:

  1. build (or reuse) a class-structured fixture dataset
     (``tools_torch/make_fixture_dataset.py``: per-class grating images and
     class-prototype embeddings);
  2. fine-tune the IS/FID classifier on the fixture's classes at 299 px
     (``eval/cert.py::finetune_inception``), or reuse one
     (``--inception_pkl``: the port's ``inception_finetuned.pt`` or a JAX
     run's ``inception_finetuned.pkl``);
  3. train the recipe cfg (``cfg/birds_3stages.yml``) through
     ``train.loop.GanTrainer`` in chunks of ``--eval_every`` steps;
  4. at every chunk boundary (step 0 too) sample the eval embeddings with
     fixed noise and record fixture-FID / IS of the EMA G (BN re-estimated
     under it with ``--ema_bn_recalc``; then ``ema_stale_*`` keeps the EMA
     on the raw trajectory's BN statistics) and of the raw G, against the
     real fixture images, with EMA and raw grids of the test split.

Eval features see uint8-quantized pixels (pytorch-fid's protocol). A call
on an existing ``--out`` resumes: the fixture, the saved classifier, the
trainer's checkpoint and the points of ``results.jsonl`` are reused
(``eval/cert.py``), and ``summary.json`` covers every point.

Outputs under ``--out``: ``results.jsonl`` (floor preamble + one line per
eval point), ``summary.json``, ``grids/``, ``inception_finetuned.pt``,
``train/`` (the trainer's run dir).

    python -m s2i_tpu_torch.scripts.quality_cert --out output/quality --steps 1500 \\
        --per_class 100 --eval_n 640 --ema_bn_recalc 30
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from s2i_tpu_torch import cli, config
from s2i_tpu_torch.data.stackgan import StackGanSplit
from s2i_tpu_torch.eval import cert, gaussian_stats
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils import save_image_grid


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="output/quality")
    ap.add_argument("--cfg", default="cfg/birds_3stages.yml")
    ap.add_argument("--fixture", default="",
                    help="reuse an existing fixture tree (same classes/per_class/seed => identical dataset); "
                    "empty = build under --out")
    ap.add_argument("--inception_pkl", default="",
                    help="reuse a fine-tuned classifier (a port run's inception_finetuned.pt or a JAX run's "
                    "inception_finetuned.pkl) instead of fine-tuning: scores land in that run's feature space")
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--per_class", type=int, default=20)
    ap.add_argument("--captions", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--eval_every", type=int, default=500)
    ap.add_argument("--inc_epochs", type=int, default=40)
    ap.add_argument("--inc_lr", type=float, default=1e-3)
    ap.add_argument("--eval_batch", type=int, default=32)
    ap.add_argument("--eval_n", type=int, default=0,
                    help="sample at most this many embeddings per eval point (fixed seeded subset; 0 = all); "
                    "the real-set statistics still use every real image")
    ap.add_argument("--ema_bn_recalc", type=int, default=0,
                    help="re-estimate G's BN statistics under the EMA weights with this many batches before each "
                    "EMA eval (EVAL.EMA_BN_RECALC; 0 = off); then 'ema_stale_*' keeps the stale-statistics EMA")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE", help="extra config overrides")
    return cli.add_device_flags(ap)


def cert_cfg(args: argparse.Namespace):
    """The recipe cfg of ``args`` (``--cfg``, ``--set``) for the fixture:
    its teacher embeddings, its classes, the run's seed and BN recalc; the
    caller sets ``DATA_DIR``."""
    cfg = config.cfg_from_file(os.path.join(cert.REPO, args.cfg))
    if args.set:
        config.apply_overrides(cfg, args.set)
    cfg.SEED = args.seed
    cfg.TEXT.EMBEDDING_FILE = "char-CNN-RNN-embeddings.pickle"
    cfg.ENCODER.N_CLASSES = args.classes
    cfg.EVAL.EMA_BN_RECALC = args.ema_bn_recalc
    return cfg


def top_size(cfg) -> int:
    return int(cfg.TREE.BASE_SIZE) * 2 ** (int(cfg.TREE.BRANCH_NUM) - 1)


def feature_space(args: argparse.Namespace, cfg, train: StackGanSplit, test: StackGanSplit,
                  device: torch.device) -> dict:
    """Phases 2 and 3: the classifier (``--inception_pkl``, the run's own,
    or fine-tuned), the real set's features, the floor and the classifier's
    eval-mode accuracy on the real images."""
    top = top_size(cfg)
    sd, inc_mets = cert.classifier(args.out, args.inception_pkl, lambda: cert.finetune_inception(
        cfg, train, args.classes, args.inc_epochs, int(cfg.TRAIN.BATCH_SIZE), top, args.inc_lr, device))
    ex = cert.make_extractor(sd, args.classes, device)
    real = cert.load_real_images([train, test], top)
    real_pool, real_logits = ex.extract(real, args.eval_batch)
    floor = cert.interpretability_floor(real_pool, real_logits, args.seed)
    # the classifier must separate the REAL classes or FID/IS carry no
    # signal (the test rows are the last len(test))
    real_cls = np.concatenate([train.class_id, test.class_id])
    hit = real_logits.argmax(1) == real_cls
    return {
        "real": real,
        "fid_is_of": cert.make_fid_is(ex, gaussian_stats(real_pool), args.eval_batch),
        "floor": {**floor, "inception_eval_acc": round(float(hit.mean()), 3),
                  "inception_test_acc": round(float(hit[-len(test):].mean()), 3),
                  "inception_acc": round(inc_mets["acc"], 3) if "acc" in inc_mets else inc_mets.get("loaded")},
    }


def eval_embeddings(train: StackGanSplit, test: StackGanSplit, eval_n: int, seed: int) -> np.ndarray:
    """Caption 0 of every fixture image, or a fixed seeded subset of
    ``eval_n``: the sampling population is the same at every eval point."""
    emb = np.concatenate([train.embeddings[:, 0], test.embeddings[:, 0]]).astype(np.float32)
    if eval_n and emb.shape[0] > eval_n:
        emb = emb[np.sort(np.random.default_rng(seed).permutation(emb.shape[0])[:eval_n])]
    return emb


def main(argv: list[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    device = cli.resolve_args_device(args)
    os.makedirs(os.path.join(args.out, "grids"), exist_ok=True)
    cfg = cert_cfg(args)
    cfg.DATA_DIR = fixture = args.fixture or cert.build_fixture(
        args.out, args.classes, args.per_class, args.captions, int(cfg.TEXT.DIMENSION), args.seed)
    cfg.TRAIN.SNAPSHOT_INTERVAL = args.eval_every
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    train_split, test_split = StackGanSplit(fixture, "train"), StackGanSplit(fixture, "test")

    print("phases 2-3: classifier, real-set features")
    space = feature_space(args, cfg, train_split, test_split, device)
    real, fid_is_of, floor = space["real"], space["fid_is_of"], space["floor"]
    print(f"  floor: real-vs-real FID={floor['real_real_fid']} real IS={floor['real_is_mean']}"
          f"±{floor['real_is_std']}; classifier eval-mode acc: all={floor['inception_eval_acc']} "
          f"test={floor['inception_test_acc']}")
    save_image_grid(real[:16], os.path.join(args.out, "grids", "real.png"))
    emb = eval_embeddings(train_split, test_split, args.eval_n, args.seed)
    test_emb = test_split.embeddings[:16, 0].astype(np.float32)
    print(f"  {real.shape[0]} real images, {emb.shape[0]} eval embeddings")
    results = cert.Results(args.out)
    results.write_floor(floor)

    trainer = GanTrainer(cfg, os.path.join(args.out, "train"), cli.gan_batch_factory(cfg), device=device)
    grid = lambda g, name: save_image_grid(  # noqa: E731
        cert.sample_images(g, test_emb, args.eval_batch), os.path.join(args.out, "grids", name))

    def evaluate(step: int, train_mets: dict, train_s: float) -> None:
        t0 = time.time()
        ema = trainer.eval_state(emb, seed=777)  # the EMA with BN re-estimated under it with --ema_bn_recalc
        stale = {}
        if args.ema_bn_recalc:
            s_fid, s_is, _ = fid_is_of(cert.sample_images(gan.sampling_generator(trainer.state), emb,
                                                          args.eval_batch))
            stale = {"ema_stale_fid": round(s_fid, 3), "ema_stale_is": round(s_is, 4)}
        fid, is_mean, is_std = fid_is_of(cert.sample_images(ema, emb, args.eval_batch))
        # the raw G tells Polyak lag from a failure to train
        raw = gan.sampling_generator(trainer.state, use_ema=False)
        raw_fid, raw_is, _ = fid_is_of(cert.sample_images(raw, emb, args.eval_batch))
        grid(ema, f"step_{step:07d}.png")
        grid(raw, f"step_{step:07d}_raw.png")
        rec = {"step": step, "fid": round(fid, 3), "is_mean": round(is_mean, 4), "is_std": round(is_std, 4),
               "raw_fid": round(raw_fid, 3), "raw_is": round(raw_is, 4), "n_fake": int(emb.shape[0]),
               "n_real": int(real.shape[0]), "eval_s": round(time.time() - t0, 1), **stale,
               "train_s": round(train_s, 1), **cert.train_metrics(train_mets)}
        results.add(rec)
        print(f"  step {step}: FID={rec['fid']} IS={rec['is_mean']}±{rec['is_std']} raw FID={rec['raw_fid']} "
              f"({rec['eval_s']}s)")

    print(f"phase 4: train to step {args.steps}, eval every {args.eval_every}")
    try:
        if not results.has(trainer.state.step):  # step 0, or a boundary a cut call did not score
            evaluate(trainer.state.step, {}, 0.0)
        while trainer.state.step < args.steps:
            t0 = time.time()
            mets = trainer.train(max_epoch=10**6, max_steps=min(trainer.state.step + args.eval_every, args.steps))
            evaluate(trainer.state.step, mets, time.time() - t0)
    finally:
        trainer.close()

    pts = results.points
    fl = results.floor
    return results.write_summary(args.out, {
        **{k: fl[k] for k in ("real_real_fid", "real_is_mean", "real_is_std")},
        "steps": pts[-1]["step"],
        "fid_first": pts[0]["fid"],
        "fid_best": min(r["fid"] for r in pts),
        "fid_last": pts[-1]["fid"],
        "is_last": pts[-1]["is_mean"],
        "raw_fid_best": min(r["raw_fid"] for r in pts),
        "raw_fid_last": pts[-1]["raw_fid"],
        "raw_is_best": max(r["raw_is"] for r in pts),
        **{k: fl.get(k) for k in ("inception_acc", "inception_eval_acc", "inception_test_acc")},
        "train_wall_s": round(sum(r.get("train_s", 0.0) for r in pts), 1),
    })


if __name__ == "__main__":
    main()
