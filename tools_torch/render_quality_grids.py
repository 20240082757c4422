"""Sample grids of a quality-cert run's newest checkpoint, the port's
counterpart of tools/render_quality_grids.py: restore ``<run>/train/ckpt``
and save EMA and raw-G grids of the test split (plus the EMA with BN
re-estimated under it when the cfg's ``EVAL.EMA_BN_RECALC`` is on) as
``<run>/grids/step_<step>_{ema,raw[,ema_recalc]}.png``. Use it to re-render
a run at its final step; checkpoints load on any device:

    python tools_torch/render_quality_grids.py --run output/quality [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from s2i_tpu_torch import cli, config  # noqa: E402
from s2i_tpu_torch.data.stackgan import StackGanSplit  # noqa: E402
from s2i_tpu_torch.eval import cert  # noqa: E402
from s2i_tpu_torch.train import gan  # noqa: E402
from s2i_tpu_torch.train.loop import GanTrainer  # noqa: E402
from s2i_tpu_torch.utils import save_image_grid  # noqa: E402


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run", required=True, help="a quality_cert --out dir (holds fixture/ train/ grids/)")
    ap.add_argument("--cfg", default="cfg/birds_3stages.yml")
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--seed", type=int, default=123, help="sampling-noise seed (123 = quality_cert's grids)")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    cli.add_device_flags(ap)
    args = ap.parse_args(argv)
    device = cli.resolve_args_device(args)

    cfg = config.cfg_from_file(os.path.join(cert.REPO, args.cfg))
    if args.set:
        config.apply_overrides(cfg, args.set)
    cfg.DATA_DIR = fixture = os.path.join(args.run, "fixture")
    cfg.TEXT.EMBEDDING_FILE = "char-CNN-RNN-embeddings.pickle"
    cfg.ENCODER.N_CLASSES = args.classes
    trainer = GanTrainer(cfg, os.path.join(args.run, "train"), cli.gan_batch_factory(cfg), device=device)
    written = []
    try:
        step = trainer.state.step
        if step == 0:
            raise SystemExit(f"no checkpoint under {args.run}/train/ckpt")
        test_emb = StackGanSplit(fixture, "test").embeddings[:16, 0]
        renders = [("ema", gan.sampling_generator(trainer.state)),
                   ("raw", gan.sampling_generator(trainer.state, use_ema=False))]
        if int(cfg.EVAL.EMA_BN_RECALC) > 0:
            # the EMA with BN statistics re-estimated under it on the train
            # split's embeddings, as an eval would
            pool = StackGanSplit(fixture, "train").embeddings[:, 0]
            renders.append(("ema_recalc", trainer.eval_state(pool, seed=args.seed)))
        for tag, g in renders:
            path = os.path.join(args.run, "grids", f"step_{step:07d}_{tag}.png")
            save_image_grid(cert.sample_images(g, test_emb, 16, seed=args.seed), path)
            written.append(path)
            print(f"{tag} grid at step {step}: {path}")
    finally:
        trainer.close()
    return written


if __name__ == "__main__":
    main()
