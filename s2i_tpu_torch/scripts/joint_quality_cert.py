"""Joint-finetune QUALITY certification of the port, the counterpart of
``scripts/joint_quality_cert.py``: the joint mode (the speech encoder
inside G's graph with the distillation regularizer, ``cfg/birds_joint_ft.yml``)
trains both halves — fixture-FID falls while held-out speech→teacher
retrieval holds, or the failure is recorded.

  1. build (or reuse) the fixture (``tools_torch/make_fixture_dataset.py``);
  2. encoder pretrain through ``cli.run_encoder_pretrain``
     (``cfg/pretrain_encoder_birds.yml``; a run under ``<out>/encoder``
     resumes or, done, is reused), the ``TRAIN.NET_E`` warm start;
  3. the IS/FID classifier on the fixture classes (``eval/cert.py``);
  4. ``GanTrainer`` on the joint cfg in ``--eval_every`` chunks;
  5. at every boundary, with fixed populations and noise:
       - teacher-conditioned fixture-FID/IS of the EMA G (BN re-estimated
         under it when ``EVAL.EMA_BN_RECALC``) and of the raw G (the GAN
         axis, apart from encoder drift);
       - speech-conditioned fixture-FID/IS of the EMA G, conditioned on
         the CURRENT joint encoder's embeddings of the eval images' caption
         WAVs (the product path, wav → mel → encoder → CA → G);
       - the encoder's held-out distill MSE, speech→teacher retrieval and
         nearest-train-prototype accuracy (the encoder cert's metrics);
       - EMA and raw grids, speech-conditioned.

K1 featurizes each step's WAVs and the eval populations; K2 runs every
encoder forward, K3 every training step's backward through the recurrence.
A call on an existing ``--out`` resumes as ``quality_cert`` does.

Outputs under ``--out``: ``results.jsonl`` (floor preamble + one line per
eval point), ``summary.json``, ``grids/``, ``encoder/`` (pretrain run),
``train/`` (joint run), ``inception_finetuned.pt``.

    python -m s2i_tpu_torch.scripts.joint_quality_cert --out output/joint_quality --steps 1000 --eval_every 500
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from s2i_tpu_torch import cli, config
from s2i_tpu_torch.audio.frontend import frontend_params_from_cfg
from s2i_tpu_torch.data.stackgan import StackGanSplit
from s2i_tpu_torch.eval import cert, gaussian_stats
from s2i_tpu_torch.scripts.quality_cert import top_size
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.train.encoder import extract_all
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils import save_image_grid


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="output/joint_quality")
    ap.add_argument("--cfg", default="cfg/birds_joint_ft.yml")
    ap.add_argument("--pretrain_cfg", default="cfg/pretrain_encoder_birds.yml")
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--per_class", type=int, default=100)
    ap.add_argument("--captions", type=int, default=2)
    ap.add_argument("--test_per_class", type=int, default=2,
                    help=">=2 keeps nearest-prototype accuracy and gallery R@1 apart")
    ap.add_argument("--pretrain_epochs", type=int, default=12,
                    help="encoder pretrain epochs (12 ≈ 600 steps on the 16x100x2 fixture)")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--eval_every", type=int, default=500)
    ap.add_argument("--inc_epochs", type=int, default=40)
    ap.add_argument("--inc_lr", type=float, default=1e-3)
    ap.add_argument("--eval_batch", type=int, default=32)
    ap.add_argument("--eval_n", type=int, default=640,
                    help="sampling population per eval point (fixed seeded subset of the fixture images; 0 = all)")
    ap.add_argument("--train_eval_n", type=int, default=160, help="images in the fixed train-subset gallery")
    ap.add_argument("--audio_frames", type=int, default=256,
                    help="AUDIO.MAX_FRAMES of both phases (the fixture's 2 s WAVs are 201 frames)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="overrides applied to BOTH phase configs (the NET_E graft needs one encoder geometry)")
    return cli.add_device_flags(ap)


def main(argv: list[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    device = cli.resolve_args_device(args)
    os.makedirs(os.path.join(args.out, "grids"), exist_ok=True)
    cfg, cfg_enc = (config.cfg_from_file(os.path.join(cert.REPO, path)) for path in (args.cfg, args.pretrain_cfg))
    for c in (cfg, cfg_enc):
        if args.set:
            config.apply_overrides(c, args.set)
    fixture = cert.build_fixture(args.out, args.classes, args.per_class, args.captions, int(cfg.TEXT.DIMENSION),
                                 args.seed, test_per_class=args.test_per_class)
    enc_dir = os.path.join(args.out, "encoder")
    for c in (cfg, cfg_enc):
        c.DATA_DIR = fixture
        c.SEED = args.seed
        c.ENCODER.N_CLASSES = args.classes
        c.AUDIO.MAX_FRAMES = args.audio_frames
    cfg.TEXT.EMBEDDING_FILE = "char-CNN-RNN-embeddings.pickle"
    cfg.TRAIN.NET_E = os.path.join(enc_dir, "ckpt")
    cfg.TRAIN.SNAPSHOT_INTERVAL = args.eval_every
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")

    print(f"phase 2: encoder pretrain ({args.pretrain_epochs} epochs; a finished run is reused)")
    t0 = time.time()
    os.makedirs(enc_dir, exist_ok=True)
    mets = cli.run_encoder_pretrain(cfg_enc, epochs=args.pretrain_epochs, device=device, run_dir=enc_dir)
    print(f"  pretrain {time.time() - t0:.0f}s: {mets}")

    train_split, test_split = StackGanSplit(fixture, "train"), StackGanSplit(fixture, "test")
    top = top_size(cfg)
    print(f"phase 3: classifier on {args.classes} fixture classes, real-set features, eval populations")
    sd, inc_mets = cert.classifier(args.out, "", lambda: cert.finetune_inception(
        cfg, train_split, args.classes, args.inc_epochs, int(cfg.TRAIN.BATCH_SIZE), top, args.inc_lr, device))
    ex = cert.make_extractor(sd, args.classes, device)
    real = cert.load_real_images([train_split, test_split], top)
    real_pool, real_logits = ex.extract(real, args.eval_batch)
    real_cls = np.concatenate([train_split.class_id, test_split.class_id])
    floor = {**cert.interpretability_floor(real_pool, real_logits, args.seed),
             "inception_eval_acc": round(float((real_logits.argmax(1) == real_cls).mean()), 3),
             "inception_acc": round(inc_mets["acc"], 3) if "acc" in inc_mets else inc_mets.get("loaded")}
    print(f"  floor: {floor}")
    fid_is_of = cert.make_fid_is(ex, gaussian_stats(real_pool), args.eval_batch)

    # the sampling population: (split, image) pairs over train + test, their
    # teacher embedding for the GAN axis, their caption 0's WAV for the speech axis
    pairs = [(train_split, i) for i in range(len(train_split))] + [(test_split, i) for i in range(len(test_split))]
    if args.eval_n and len(pairs) > args.eval_n:
        pairs = [pairs[i] for i in np.sort(np.random.default_rng(args.seed).permutation(len(pairs))[:args.eval_n])]
    teacher_emb = np.stack([s.embeddings[i, 0] for s, i in pairs]).astype(np.float32)
    p = frontend_params_from_cfg(cfg.AUDIO)
    sample_feats = cert.speech_features([(s, i, 0) for s, i in pairs], p, args.eval_batch, device)
    pops = cert.retrieval_populations(train_split, test_split, args.classes, args.train_eval_n, args.seed, p,
                                      args.eval_batch, device)
    caps = test_split.captions_per_image
    grid_feats = tuple(x[::caps][:16] for x in pops["test"])  # caption 0 of the first 16 test images
    print(f"  {real.shape[0]} real images, {len(pairs)} sampling population, {len(pops['test'][0])} test / "
          f"{len(pops['train'][0])} train-gallery retrieval queries")
    results = cert.Results(args.out)
    results.write_floor(floor)

    print(f"phase 4: joint finetune (NET_E={cfg.TRAIN.NET_E}) to step {args.steps}")
    trainer = GanTrainer(cfg, os.path.join(args.out, "train"), cli.gan_batch_factory(cfg), device=device)
    embed = lambda f, m: extract_all(trainer.state.models.encoder, f, m, args.eval_batch)  # noqa: E731
    sample = lambda g, emb: cert.sample_images(g, emb, args.eval_batch)  # noqa: E731

    def evaluate(step: int, train_mets: dict, train_s: float) -> None:
        t0 = time.time()
        enc = cert.encoder_record(embed, pops, device)  # the encoder axis: encoder forwards only
        ema = trainer.eval_state(teacher_emb, seed=777)
        raw = gan.sampling_generator(trainer.state, use_ema=False)
        fid, is_mean, is_std = fid_is_of(sample(ema, teacher_emb))
        raw_fid, raw_is, _ = fid_is_of(sample(raw, teacher_emb))
        sp_fid, sp_is, _ = fid_is_of(sample(ema, embed(*sample_feats)))
        emb_grid = embed(*grid_feats)
        save_image_grid(sample(ema, emb_grid), os.path.join(args.out, "grids", f"step_{step:07d}.png"))
        save_image_grid(sample(raw, emb_grid), os.path.join(args.out, "grids", f"step_{step:07d}_raw.png"))
        rec = {"step": step, "fid": round(fid, 3), "is_mean": round(is_mean, 4), "is_std": round(is_std, 4),
               "raw_fid": round(raw_fid, 3), "raw_is": round(raw_is, 4), "speech_fid": round(sp_fid, 3),
               "speech_is": round(sp_is, 4), **enc, "eval_s": round(time.time() - t0, 1),
               "train_s": round(train_s, 1), **cert.train_metrics(train_mets, 5)}
        results.add(rec)
        print(f"  step {step}: FID={rec['fid']} speechFID={rec['speech_fid']} rawFID={rec['raw_fid']} "
              f"IS={rec['is_mean']} R@1={rec['test_r@1']} mse={rec['test_mse']} ({rec['eval_s']}s)")

    try:
        if not results.has(trainer.state.step):
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
        "speech_fid_first": pts[0]["speech_fid"],
        "speech_fid_best": min(r["speech_fid"] for r in pts),
        "speech_fid_last": pts[-1]["speech_fid"],
        "raw_fid_best": min(r["raw_fid"] for r in pts),
        "is_last": pts[-1]["is_mean"],
        "test_r@1_first": pts[0]["test_r@1"],
        "test_r@1_best": max(r["test_r@1"] for r in pts),
        "test_r@1_last": pts[-1]["test_r@1"],
        "test_mse_first": pts[0]["test_mse"],
        "test_mse_last": pts[-1]["test_mse"],
        **{k: fl.get(k) for k in ("inception_acc", "inception_eval_acc")},
        "train_wall_s": round(sum(r.get("train_s", 0.0) for r in pts), 1),
    })


if __name__ == "__main__":
    main()
