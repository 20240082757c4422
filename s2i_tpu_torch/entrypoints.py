"""The port's entry points: console scripts (``pyproject.toml``:
``s2i-torch-train``, ``s2i-torch-sample``, ``s2i-torch-pretrain-encoder``,
``s2i-torch-finetune-inception``, ``s2i-torch-eval``) and ``python -m
s2i_tpu_torch``, the counterparts of ``main.py``, ``s2i_tpu/entrypoints.py``,
``scripts/pretrain_encoder.py``, ``scripts/finetune_inception.py`` and
``scripts/eval.py``:

    python -m s2i_tpu_torch --cfg cfg/birds_3stages.yml        # TRAIN.FLAG: train, else sample
    python -m s2i_tpu_torch train --cfg cfg/birds_joint_ft.yml --set TRAIN.NET_E=<run>/ckpt
    python -m s2i_tpu_torch sample --cfg cfg/eval_birds.yml --set TRAIN.NET_G=<run>/ckpt
    python -m s2i_tpu_torch pretrain-encoder --cfg cfg/pretrain_encoder_birds.yml [--epochs N]
    python -m s2i_tpu_torch pretrain-encoder --cfg ... --extract <run>/ckpt [--emb_out NAME]
    python -m s2i_tpu_torch finetune-inception --cfg cfg/birds_3stages.yml [--warm_start W.pth] --epochs 20
    python -m s2i_tpu_torch eval --gen_dir <samples> --real_dir <images> [--finetuned_ckpt <run>/ckpt] --json
    python -m s2i_tpu_torch eval --retrieval <speech-embeddings.pickle> <char-CNN-RNN-embeddings.pickle>

Every command but ``eval`` takes ``--cfg --data_dir --output_dir
--manualSeed --gpu --set KEY=VAL ...``; every command runs on the card
(``--gpu N``: ``cuda:N``), and ``--device cpu`` runs the kernels' plain
PyTorch versions on the CPU. Without a card and without ``--device cpu`` a
command raises.
"""

from __future__ import annotations

import argparse
import json
import sys

from s2i_tpu_torch import cli

COMMANDS = ("train", "sample", "pretrain-encoder", "finetune-inception", "eval")


def train_gan(argv: list[str] | None = None) -> dict:
    """GAN training (frozen or joint by ``TRAIN.JOINT_FT``) into a new run dir."""
    args = cli.base_parser("GAN training").parse_args(argv)
    return cli.run_gan_training(cli.resolve_cfg(args), device=cli.resolve_args_device(args))


def sample(argv: list[str] | None = None) -> str:
    """PNGs of the test split's embeddings from ``TRAIN.NET_G``'s G."""
    args = cli.base_parser("Sampling").parse_args(argv)
    cfg = cli.resolve_cfg(args)
    cfg.TRAIN.FLAG = False
    return cli.run_sampling(cfg, device=cli.resolve_args_device(args))


def pretrain_encoder(argv: list[str] | None = None):
    """Encoder distillation pretraining, or with ``--extract`` the speech
    embeddings of every caption from an encoder checkpoint."""
    p = cli.base_parser("Encoder distillation pretraining and embedding extraction")
    p.add_argument("--epochs", type=int, default=None, help="total epochs (default ENCODER.EPOCHS)")
    p.add_argument("--extract", default=None, metavar="CKPT_DIR",
                   help="skip training; extract embeddings with this encoder checkpoint")
    p.add_argument("--emb_out", default="speech-embeddings.pickle",
                   help="per-split output pickle name for --extract")
    args = p.parse_args(argv)
    cfg = cli.resolve_cfg(args)
    device = cli.resolve_args_device(args)
    if args.extract:
        return cli.run_embedding_extraction(cfg, args.extract, args.emb_out, device=device)
    return cli.run_encoder_pretrain(cfg, epochs=args.epochs, device=device)


def finetune_inception(argv: list[str] | None = None) -> str:
    """Fine-tune InceptionV3 on the dataset's classes for the IS/FID
    protocol (``scripts/finetune_inception.py``); returns the run dir."""
    p = cli.base_parser("Fine-tune InceptionV3 on a dataset's classes for the StackGAN IS/FID protocol")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warm_start", default=None, help="torch .pth state_dict")
    p.add_argument("--image_size", type=int, default=299,
                   help="train-time input size (the model is size-agnostic; small values make CPU runs feasible)")
    p.add_argument("--base_size", type=int, default=256, help="loader image size before the train-step resize")
    args = p.parse_args(argv)
    cfg = cli.resolve_cfg(args)
    return cli.run_inception_finetune(cfg, args.epochs, args.batch, args.lr, args.warm_start, args.image_size,
                                      args.base_size, device=cli.resolve_args_device(args))


def evaluate(argv: list[str] | None = None) -> dict:
    """Inception Score + FID over image directories, or retrieval over two
    embedding pickles (``scripts/eval.py``); prints and returns the metrics."""
    p = argparse.ArgumentParser(description="Inception Score + FID over image dirs, retrieval over embedding pickles")
    p.add_argument("--retrieval", nargs=2, metavar=("QUERY_PKL", "TARGET_PKL"),
                   help="speech<->teacher retrieval eval over two embedding pickles")
    p.add_argument("--gen_dir", default=None, help="generated images")
    p.add_argument("--real_dir", default=None, help="real images (for FID)")
    p.add_argument("--weights", default=None, help="torchvision-layout .pth state_dict")
    p.add_argument("--finetuned_ckpt", default=None, help="the ckpt dir of a finetune-inception run")
    p.add_argument("--num_classes", type=int, default=None,
                   help="classes of the random-weight Inception (default 1000); with weights, theirs")
    p.add_argument("--splits", type=int, default=10)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--img_size", type=int, default=None,
                   help="host-side canvas for heterogeneously sized dirs (default: the first image's size; "
                   "uniform dirs are never resampled on the host)")
    p.add_argument("--protocol", choices=("exact", "pytorch-fid"), default="exact",
                   help="'pytorch-fid' quantizes inputs through uint8 before the 299 px resize (the saved-PNG "
                   "protocol); on decoded files the two are the same")
    p.add_argument("--json", action="store_true", help="print one machine-readable JSON line")
    cli.add_device_flags(p)
    args = p.parse_args(argv)
    device = cli.resolve_args_device(args)
    if args.retrieval:
        m = cli.run_retrieval(*args.retrieval, device=device)
        print(json.dumps(m, indent=2))
        return m
    if not args.gen_dir:
        p.error("--gen_dir required (or use --retrieval)")
    rec = cli.run_eval(args.gen_dir, args.real_dir, args.weights, args.finetuned_ckpt, args.num_classes,
                       args.splits, args.batch, args.limit, args.img_size, args.protocol, device=device)
    if args.json:
        print(json.dumps(rec))
    else:
        note = "" if rec["inception"] == "finetuned" else "  [random-weight Inception: plumbing only]"
        print(f"IS: {rec['is_mean']:.4f} +- {rec['is_std']:.4f}{note}")
        if "fid" in rec:
            print(f"FID: {rec['fid']:.4f}")
    return rec


def main(argv: list[str] | None = None):
    """``python -m s2i_tpu_torch [train|sample|pretrain-encoder|finetune-inception|eval] ...``;
    without a command it trains or samples as ``TRAIN.FLAG`` says."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in COMMANDS:
        run = {"train": train_gan, "sample": sample, "pretrain-encoder": pretrain_encoder,
               "finetune-inception": finetune_inception, "eval": evaluate}[argv[0]]
        return run(argv[1:])
    args = cli.base_parser(__doc__).parse_args(argv)
    cfg = cli.resolve_cfg(args)
    device = cli.resolve_args_device(args)
    if bool(cfg.TRAIN.FLAG):
        return cli.run_gan_training(cfg, device=device)
    return cli.run_sampling(cfg, device=device)
