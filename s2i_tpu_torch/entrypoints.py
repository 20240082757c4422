"""The port's entry points: console scripts (``pyproject.toml``:
``s2i-torch-train``, ``s2i-torch-sample``, ``s2i-torch-pretrain-encoder``)
and ``python -m s2i_tpu_torch``, the counterparts of ``main.py``,
``s2i_tpu/entrypoints.py`` and ``scripts/pretrain_encoder.py``:

    python -m s2i_tpu_torch --cfg cfg/birds_3stages.yml        # TRAIN.FLAG: train, else sample
    python -m s2i_tpu_torch train --cfg cfg/birds_joint_ft.yml --set TRAIN.NET_E=<run>/ckpt
    python -m s2i_tpu_torch sample --cfg cfg/eval_birds.yml --set TRAIN.NET_G=<run>/ckpt
    python -m s2i_tpu_torch pretrain-encoder --cfg cfg/pretrain_encoder_birds.yml [--epochs N]
    python -m s2i_tpu_torch pretrain-encoder --cfg ... --extract <run>/ckpt [--emb_out NAME]

Every command takes ``--cfg --data_dir --output_dir --manualSeed --gpu
--set KEY=VAL ...`` and runs on the card (``--gpu N``: ``cuda:N``);
``--device cpu`` runs the kernels' plain PyTorch versions on the CPU.
Without a card and without ``--device cpu`` a command raises.
"""

from __future__ import annotations

import sys

from s2i_tpu_torch import cli

COMMANDS = ("train", "sample", "pretrain-encoder")


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


def main(argv: list[str] | None = None):
    """``python -m s2i_tpu_torch [train|sample|pretrain-encoder] ...``;
    without a command it trains or samples as ``TRAIN.FLAG`` says."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in COMMANDS:
        run = {"train": train_gan, "sample": sample, "pretrain-encoder": pretrain_encoder}[argv[0]]
        return run(argv[1:])
    args = cli.base_parser(__doc__).parse_args(argv)
    cfg = cli.resolve_cfg(args)
    device = cli.resolve_args_device(args)
    if bool(cfg.TRAIN.FLAG):
        return cli.run_gan_training(cfg, device=device)
    return cli.run_sampling(cfg, device=device)
