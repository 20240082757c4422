"""The port's entry points: console scripts (``pyproject.toml``:
``s2i-torch-train``, ``s2i-torch-sample``, ``s2i-torch-pretrain-encoder``,
``s2i-torch-finetune-inception``, ``s2i-torch-eval``, ``s2i-torch-export``,
``s2i-torch-serve``, ``s2i-torch-speech-to-image``) and ``python -m
s2i_tpu_torch``, the counterparts of ``main.py``, ``s2i_tpu/entrypoints.py``,
``scripts/pretrain_encoder.py``, ``scripts/finetune_inception.py``,
``scripts/eval.py``, ``scripts/export.py``, ``scripts/serve.py`` and
``scripts/speech_to_image.py``:

    python -m s2i_tpu_torch --cfg cfg/birds_3stages.yml        # TRAIN.FLAG: train, else sample
    python -m s2i_tpu_torch train --cfg cfg/birds_joint_ft.yml --set TRAIN.NET_E=<run>/ckpt
    python -m s2i_tpu_torch sample --cfg cfg/eval_birds.yml --set TRAIN.NET_G=<run>/ckpt
    python -m s2i_tpu_torch pretrain-encoder --cfg cfg/pretrain_encoder_birds.yml [--epochs N]
    python -m s2i_tpu_torch pretrain-encoder --cfg ... --extract <run>/ckpt [--emb_out NAME]
    python -m s2i_tpu_torch finetune-inception --cfg cfg/birds_3stages.yml [--warm_start W.pth] --epochs 20
    python -m s2i_tpu_torch eval --gen_dir <samples> --real_dir <images> [--finetuned_ckpt <run>/ckpt] --json
    python -m s2i_tpu_torch eval --retrieval <speech-embeddings.pickle> <char-CNN-RNN-embeddings.pickle>
    python -m s2i_tpu_torch export --cfg cfg/birds_joint_ft.yml --gan_ckpt <run>/ckpt --out <dir> --batches 1,8
    python -m s2i_tpu_torch serve --artifact <dir> --port 8500       # or --cfg ... --gan_ckpt <run>/ckpt
    python -m s2i_tpu_torch speech-to-image --cfg ... --gan_ckpt <run>/ckpt --wav a.wav b.wav --out_dir <dir>

Every command but ``eval`` takes ``--cfg --data_dir --output_dir
--manualSeed --gpu --set KEY=VAL ...``; every command runs on the card
(``--gpu N``: ``cuda:N``), and ``--device cpu`` runs the kernels' plain
PyTorch versions on the CPU. Without a card and without ``--device cpu`` a
command raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from s2i_tpu_torch import cli
from s2i_tpu_torch.export import export_pipeline, load, read_meta
from s2i_tpu_torch.pipeline import SpeechToImage
from s2i_tpu_torch.serving import make_server

COMMANDS = ("train", "sample", "pretrain-encoder", "finetune-inception", "eval", "export", "serve",
            "speech-to-image")


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


def _checkpoint_flags(p: argparse.ArgumentParser, gan_required: bool = True) -> None:
    p.add_argument("--encoder_ckpt", default="",
                   help="the encoder run's ckpt dir; not read when TRAIN.JOINT_FT (the GAN checkpoint holds it)")
    p.add_argument("--gan_ckpt", required=gan_required, default="", help="the GAN run's ckpt dir")


def export(argv: list[str] | None = None) -> dict:
    """A trained run's serve program as an AOT artifact (``export.py``;
    ``scripts/export.py``); prints and returns its meta."""
    p = cli.base_parser("Export the speech-to-image pipeline to an AOT artifact (torch.export)")
    _checkpoint_flags(p)
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--batches", default="1,8", help="the batch sizes requests are padded or split to")
    p.add_argument("--stage", type=int, default=-1, help="G's stage (-1: the highest resolution)")
    p.add_argument("--float", action="store_true", help="emit float32 [-1, 1] images instead of uint8")
    p.add_argument("--no_ema", action="store_true", help="G's trained weights instead of their EMA")
    args = p.parse_args(argv)
    device = cli.resolve_args_device(args)
    pipe = SpeechToImage.from_checkpoints(cli.resolve_cfg(args), args.encoder_ckpt or None, args.gan_ckpt,
                                          use_ema=not args.no_ema, device=device)
    meta = export_pipeline(pipe, args.out, tuple(int(b) for b in args.batches.split(",")), args.stage,
                           quantize=not args.float)
    print(json.dumps(meta))
    return meta


def build_server(argv: list[str] | None = None):
    """The ``serve`` command's HTTP server over checkpoints or an artifact,
    warmed up unless ``--no_warmup``, not yet serving."""
    p = cli.base_parser("Serve the speech-to-image pipeline over HTTP (POST /generate, GET /healthz)")
    _checkpoint_flags(p, gan_required=False)
    p.add_argument("--artifact", default="", help="serve an artifact of the export command instead of checkpoints")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--batch", type=int, default=8, help="the device batch requests are collated into")
    p.add_argument("--no_warmup", action="store_true", help="skip the full batch run before listening")
    args = p.parse_args(argv)
    device = cli.resolve_args_device(args)
    if args.artifact:
        if read_meta(args.artifact)["output_dtype"] != "uint8":
            p.error("serving needs a uint8 artifact (PNG responses); re-export without --float")
        pipe = load(args.artifact, device)
    else:
        if not args.gan_ckpt:
            p.error("--gan_ckpt (or --artifact) is required")
        pipe = SpeechToImage.from_checkpoints(cli.resolve_cfg(args), args.encoder_ckpt or None, args.gan_ckpt,
                                              device=device)
    return make_server(pipe, args.host, args.port, args.batch, warmup=not args.no_warmup, device=device)


def serve(argv: list[str] | None = None) -> None:
    """``scripts/serve.py``: :func:`build_server`, then serve until interrupted."""
    srv = build_server(argv)
    host, port = srv.server_address[:2]
    print(f"serving on http://{host}:{port}  (POST /generate, GET /healthz)", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


def speech_to_image(argv: list[str] | None = None) -> list[str]:
    """WAV files → PNG files, one device pass (``scripts/speech_to_image.py``);
    prints and returns the PNGs' paths."""
    p = cli.base_parser("Speech to image: wav files -> PNG images")
    _checkpoint_flags(p)
    p.add_argument("--wav", nargs="+", required=True)
    p.add_argument("--out_dir", default="generated")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = cli.resolve_args_device(args)
    pipe = SpeechToImage.from_checkpoints(cli.resolve_cfg(args), args.encoder_ckpt or None, args.gan_ckpt,
                                          device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    outs = [os.path.join(args.out_dir, os.path.splitext(os.path.basename(w))[0] + ".png") for w in args.wav]
    pipe.generate_files(args.wav, outs, seed=args.seed)
    print("\n".join(outs))
    return outs


def main(argv: list[str] | None = None):
    """``python -m s2i_tpu_torch [train|sample|pretrain-encoder|finetune-inception|eval|export|serve|
    speech-to-image] ...``; without a command it trains or samples as ``TRAIN.FLAG`` says."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in COMMANDS:
        run = {"train": train_gan, "sample": sample, "pretrain-encoder": pretrain_encoder,
               "finetune-inception": finetune_inception, "eval": evaluate, "export": export, "serve": serve,
               "speech-to-image": speech_to_image}[argv[0]]
        return run(argv[1:])
    args = cli.base_parser(__doc__).parse_args(argv)
    cfg = cli.resolve_cfg(args)
    device = cli.resolve_args_device(args)
    if bool(cfg.TRAIN.FLAG):
        return cli.run_gan_training(cfg, device=device)
    return cli.run_sampling(cfg, device=device)
