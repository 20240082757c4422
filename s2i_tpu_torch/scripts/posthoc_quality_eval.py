"""Post-hoc quality eval of a quality-cert run's newest checkpoint, the
counterpart of ``scripts/posthoc_quality_eval.py``: the raw G, the EMA G as
stored (the raw trajectory's BN statistics) and the EMA G with BN
statistics re-estimated under the EMA weights (``gan.bn_recalc``).

Scores land in the run's feature space: the classifier is the run's
``inception_finetuned.pt``, else it is re-fit with
the run's protocol (same seed, same data order) and saved for next time.
The helpers are the quality cert's own (``quality_cert.py``).

    python -m s2i_tpu_torch.scripts.posthoc_quality_eval --run output/quality --ema_bn_recalc 30 --eval_n 640

Appends one JSON line to ``<run>/posthoc.jsonl`` and saves
``grids/posthoc_step_*_{raw,ema_stale,ema_recalc}.png``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from s2i_tpu_torch import cli
from s2i_tpu_torch.data.stackgan import StackGanSplit
from s2i_tpu_torch.eval import cert
from s2i_tpu_torch.scripts import quality_cert as qc
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils import save_image_grid


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run", dest="out", required=True, help="a quality_cert --out dir (fixture/ train/ grids/)")
    ap.add_argument("--cfg", default="cfg/birds_3stages.yml")
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--eval_batch", type=int, default=32)
    ap.add_argument("--eval_n", type=int, default=0)
    ap.add_argument("--inc_epochs", type=int, default=40)
    ap.add_argument("--inc_lr", type=float, default=1e-3)
    ap.add_argument("--ema_bn_recalc", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    ap.set_defaults(inception_pkl="")  # the run's own classifier (quality_cert.feature_space)
    return cli.add_device_flags(ap)


def main(argv: list[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    device = cli.resolve_args_device(args)
    cfg = qc.cert_cfg(args)
    cfg.DATA_DIR = fixture = os.path.join(args.out, "fixture")
    train_split, test_split = StackGanSplit(fixture, "train"), StackGanSplit(fixture, "test")
    fid_is_of = qc.feature_space(args, cfg, train_split, test_split, device)["fid_is_of"]
    emb = qc.eval_embeddings(train_split, test_split, args.eval_n, args.seed)
    test_emb = test_split.embeddings[:16, 0]

    trainer = GanTrainer(cfg, os.path.join(args.out, "train"), cli.gan_batch_factory(cfg), device=device)
    try:
        step = trainer.state.step
        if step == 0:
            raise SystemExit(f"no checkpoint under {args.out}/train/ckpt")
        print(f"scoring checkpoint step {step}")
        rec = {"step": step, "n_fake": int(emb.shape[0]), "ema_bn_recalc": args.ema_bn_recalc}
        for tag, g in (("raw", gan.sampling_generator(trainer.state, use_ema=False)),
                       ("ema_stale", gan.sampling_generator(trainer.state)),
                       ("ema_recalc", trainer.eval_state(emb, seed=777))):
            t0 = time.time()
            fid, is_mean, _ = fid_is_of(cert.sample_images(g, emb, args.eval_batch))
            rec[f"{tag}_fid"] = round(fid, 3)
            rec[f"{tag}_is"] = round(is_mean, 4)
            save_image_grid(cert.sample_images(g, test_emb, args.eval_batch),
                            os.path.join(args.out, "grids", f"posthoc_step_{step:07d}_{tag}.png"))
            print(f"  {tag}: FID={fid:.1f} IS={is_mean:.3f} ({time.time() - t0:.0f}s)")
    finally:
        trainer.close()
    with open(os.path.join(args.out, "posthoc.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
