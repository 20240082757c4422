"""One-command offline eval pipeline smoke of the port, the counterpart of
``scripts/eval_smoke.py``:

    fixture dataset -> short GAN train -> sample the test split ->
    fine-tune Inception on the fixture classes -> IS + FID as JSON.

Every stage after the fixture runs the port's own command in a subprocess
(``python -m s2i_tpu_torch train``, ``sample``, ``finetune-inception``,
``eval --json``), so it exercises what a user types; a stage that fails
ends the run non-zero with its output's tail. Tiny sizes
(``cfg/debug_tiny.yml``, one 64 px stage) keep it to seconds a stage:

    python -m s2i_tpu_torch.scripts.eval_smoke --out output/eval_smoke [--device cpu]

Prints one JSON line: {"is_mean": ..., "is_std": ..., "fid": ..., ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile

from s2i_tpu_torch import cli
from s2i_tpu_torch.scripts import check_stage, device_argv, run_stage


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="work dir (default: a new temporary one)")
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=2, help="GAN epochs")
    cli.add_device_flags(ap)
    args = ap.parse_args(argv)
    cli.resolve_args_device(args)  # no card and no --device cpu: raise before any stage
    out = os.path.abspath(args.out or tempfile.mkdtemp(prefix="eval_smoke_"))
    fixture = os.path.join(out, "fixture")
    from tools_torch.make_fixture_dataset import make_fixture

    # 1. a seeded tree in the StackGAN + speech layout
    make_fixture(fixture, args.classes, 4, 2, 32, image_size=96)
    common = ["--cfg", "cfg/debug_tiny.yml", "--data_dir", fixture, *device_argv(args),
              "--set", "DATASET_NAME=birds", "TREE.BRANCH_NUM=1", "TEXT.DIMENSION=32", "TRAIN.BATCH_SIZE=4"]

    def stage(name: str, argv: list[str], pattern: str | None = None) -> str:
        r, _ = run_stage(argv)
        check_stage(r, name)
        if pattern is None:
            return r.stdout
        m = re.search(pattern, r.stdout)
        if m is None:
            raise SystemExit(f"stage {name}: no {pattern!r} in its output:\n{r.stdout[-2000:]}")
        return m.group(1)

    # 2. a short GAN run on the fixture; 3. the test split through its G
    gan_run = stage("train", ["-m", "s2i_tpu_torch", "train", "--output_dir", os.path.join(out, "gan"), *common,
                              f"TRAIN.MAX_EPOCH={args.epochs}"], r"run dir: (\S+)")
    sample_dir = stage("sample", ["-m", "s2i_tpu_torch", "sample", "--output_dir", os.path.join(out, "sample"),
                                  *common, f"TRAIN.NET_G={os.path.join(gan_run, 'ckpt')}"], r"samples: (\S+)")
    # 4. the classifier on the fixture's classes (at a tiny input size)
    inception_run = stage("finetune-inception", [
        "-m", "s2i_tpu_torch", "finetune-inception", "--output_dir", os.path.join(out, "inception"), *common,
        f"ENCODER.N_CLASSES={args.classes}", "--epochs", "2", "--batch", "6", "--image_size", "96",
        "--base_size", "96"], r"run dir: (\S+)")
    # 5. IS + FID with it
    log = stage("eval", ["-m", "s2i_tpu_torch", "eval", "--gen_dir", sample_dir, "--real_dir",
                         os.path.join(fixture, "images"), "--finetuned_ckpt", os.path.join(inception_run, "ckpt"),
                         "--num_classes", str(args.classes), "--splits", "2", "--batch", "6", "--json",
                         *device_argv(args)])
    rec = json.loads(log.strip().splitlines()[-1])
    rec["pipeline"] = "fixture->train->sample->finetune_inception->eval"
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
