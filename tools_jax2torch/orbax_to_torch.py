"""Convert a checkpoint of the JAX package (Orbax) into one of the PyTorch
port (``s2i_tpu_torch/utils/checkpoint.py``), so that the port serves or
warm-starts from a run that ``s2i_tpu`` trained:

    python tools_jax2torch/orbax_to_torch.py JAX_RUN PORT_RUN [--cfg CFG] [--set KEY=VAL ...]

``JAX_RUN`` is an ``s2i_tpu`` run directory (its ``ckpt/`` and
``config.yml``) or a checkpoint directory itself. Its latest checkpoint is
restored as a raw tree, without a template, and recognized by its fields:

- an encoder pretraining state (``params``, ``batch_stats``, ``step``) →
  the port's ``EncoderTrainState`` layout;
- a GAN state (``g_params``/``g_stats``/``ema_g``/``d_params``/
  ``d_stats``, with the finetuned encoder under ``enc`` in joint mode) →
  the port's ``GanTrainState`` layout;
- an Inception finetune state of ``scripts/finetune_inception.py``
  (``params`` holding ``Conv2d_1a_3x3``..``fc``, ``batch_stats``,
  ``step``) → the port's ``InceptionTrainState`` layout.

The weights go through ``s2i_tpu_torch.bridge`` (``encoder_state_dict``,
``gnet_state_dict``, ``dnet_state_dict``, ``inception_state_dict``) into
modules built from the run's config (``--cfg``, default ``JAX_RUN/config.yml``), and the port checkpoint
lands in ``PORT_RUN/ckpt/<step>.pt`` beside a ``config.yml``. Then:

    SpeechToImage.from_checkpoints(cfg, "<encoder PORT_RUN>/ckpt", "<gan PORT_RUN>/ckpt")
    python -m s2i_tpu_torch eval --gen_dir ... --finetuned_ckpt <inception PORT_RUN>/ckpt
    python -m s2i_tpu_torch train --cfg ... --set TRAIN.NET_G=<gan PORT_RUN>/ckpt
    python -m s2i_tpu_torch train --cfg cfg/birds_joint_ft.yml --set TRAIN.NET_E=<encoder PORT_RUN>/ckpt

Optax's Adam moments are not converted: the port checkpoint carries fresh
optimizer states, so training from it is a warm start (the step count
kept), not an exact resume.

This is the one file of the repository that imports both packages (JAX and
Orbax to read, the port to write); the port never imports it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from s2i_tpu.utils import CheckpointManager as OrbaxCheckpoints  # noqa: E402
from s2i_tpu_torch import bridge, config  # noqa: E402
from s2i_tpu_torch.eval.finetune import init_inception_state  # noqa: E402
from s2i_tpu_torch.train import gan  # noqa: E402
from s2i_tpu_torch.train.encoder import init_encoder_state  # noqa: E402
from s2i_tpu_torch.utils import CheckpointManager  # noqa: E402

WARM_START_NOTE = ("Adam moments are not converted: training from this checkpoint is a warm start "
                   "with fresh optimizer states, not an exact resume")


def _host(tree):
    """A restored tree with every array as numpy."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    return tree if tree is None else np.asarray(tree)


def _load(module: torch.nn.Module, sd: dict, what: str) -> None:
    """``sd`` (numpy) into ``module``, every key and shape required."""
    want = module.state_dict()
    problems = [f"{k}: missing" for k in want if k not in sd]
    problems += [f"{k}: unexpected" for k in sd if k not in want]
    problems += [f"{k}: {tuple(np.shape(sd[k]))} vs {tuple(v.shape)}"
                 for k, v in want.items() if k in sd and tuple(np.shape(sd[k])) != tuple(v.shape)]
    if problems:
        raise ValueError(f"{what} does not match the config's modules: " + "; ".join(problems[:8])
                         + (", ..." if len(problems) > 8 else ""))
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()})


def convert_encoder(raw: dict, cfg) -> dict:
    """A restored JAX ``EncoderTrainState`` → the port's encoder train
    state dict (``{"step", "model", "opt"}``; ``opt`` fresh)."""
    state = init_encoder_state(cfg, device="cpu")
    sd = bridge.encoder_state_dict({"params": raw["params"], "batch_stats": raw["batch_stats"]})
    _load(state.model, sd, "the encoder checkpoint")
    state.step = int(raw["step"])
    return state.state_dict()


def convert_gan(raw: dict, cfg) -> dict:
    """A restored JAX ``GanTrainState`` → the port's GAN train state dict
    (G with CA, the Ds, the joint encoder, the EMA and the step; optimizer
    states fresh)."""
    g_params, g_stats = raw["g_params"], raw["g_stats"]
    joint = "enc" in g_params
    if joint != bool(cfg.TRAIN.JOINT_FT):
        raise ValueError(f"the checkpoint holds a {'joint' if joint else 'frozen'} GAN state; the config's "
                         f"TRAIN.JOINT_FT is {bool(cfg.TRAIN.JOINT_FT)}")
    state = gan.init_state(cfg, device="cpu")
    m = state.models
    if len(raw["d_params"]) != len(m.ds):
        raise ValueError(f"the checkpoint has {len(raw['d_params'])} Ds, the config {len(m.ds)}")
    _load(m.g, bridge.gnet_state_dict({"ca": g_params["ca"], "g": g_params["g"]}, g_stats), "G")
    for i, (d, p, s) in enumerate(zip(m.ds, raw["d_params"], raw["d_stats"])):
        _load(d, bridge.dnet_state_dict(p, s), f"D{i}")
    if joint:
        _load(m.encoder, bridge.encoder_state_dict({"params": g_params["enc"], "batch_stats": g_stats["enc"]}),
              "the joint encoder")
    ema_g = raw.get("ema_g") or {}
    if bool(ema_g) != bool(state.ema):
        raise ValueError(f"the checkpoint {'has' if ema_g else 'has no'} EMA weights; the config's TRAIN.EMA_G "
                         f"is {float(cfg.TRAIN.EMA_G)}")
    if ema_g:
        ema_sd = bridge.gnet_state_dict(ema_g, g_stats)
        with torch.no_grad():
            for name, t in state.ema.items():
                t.copy_(torch.from_numpy(np.array(ema_sd[name], np.float32)))
    state.step = int(raw["step"])
    return state.state_dict()


def convert_inception(raw: dict) -> dict:
    """A restored JAX ``InceptionTrainState`` → the port's Inception train
    state dict (``{"step", "model", "opt"}``; ``opt`` fresh), the classes
    from its ``fc`` kernel."""
    sd = bridge.inception_state_dict({"params": raw["params"], "batch_stats": raw["batch_stats"]})
    state = init_inception_state(int(sd["fc.weight"].shape[0]), device="cpu")
    _load(state.model, sd, "the Inception checkpoint")
    state.step = int(raw["step"])
    return state.state_dict()


def _ckpt_dir(jax_run: str) -> str:
    sub = os.path.join(jax_run, "ckpt")
    return sub if os.path.isdir(sub) else jax_run


def convert(jax_run: str, port_run: str, cfg) -> tuple[str, int]:
    """Convert ``jax_run``'s latest checkpoint into ``port_run/ckpt``;
    returns (kind, step)."""
    restored = OrbaxCheckpoints(_ckpt_dir(jax_run)).restore_latest_raw()
    if restored is None:
        raise FileNotFoundError(f"no Orbax checkpoint under {jax_run}")
    raw, step = _host(restored[0]), restored[1]
    if "g_params" in raw:
        kind, sd = "gan", convert_gan(raw, cfg)
    elif "Conv2d_1a_3x3" in raw.get("params", {}):
        kind, sd = "inception", convert_inception(raw)
    elif "params" in raw and "batch_stats" in raw:
        kind, sd = "encoder", convert_encoder(raw, cfg)
    else:
        raise ValueError(f"{jax_run}: not an encoder, GAN or Inception train state (fields {sorted(raw)})")
    os.makedirs(port_run, exist_ok=True)
    config.dump_cfg(cfg, os.path.join(port_run, "config.yml"))
    CheckpointManager(os.path.join(port_run, "ckpt")).save(step, sd, force=True)
    return kind, step


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("jax_run", help="an s2i_tpu run directory, or its checkpoint directory")
    p.add_argument("port_run", help="the port run directory to write (ckpt/<step>.pt, config.yml)")
    p.add_argument("--cfg", default=None, help="the run's YAML config (default: JAX_RUN/config.yml)")
    p.add_argument("--set", dest="overrides", nargs="*", default=[], metavar="KEY=VAL",
                   help="config overrides")
    args = p.parse_args(argv)
    cfg_file = args.cfg or os.path.join(args.jax_run, "config.yml")
    if not os.path.exists(cfg_file):
        p.error(f"no config: {cfg_file} does not exist; pass --cfg")
    cfg = config.apply_overrides(config.cfg_from_file(cfg_file), args.overrides)
    kind, step = convert(args.jax_run, args.port_run, cfg)
    print(f"converted the {kind} checkpoint of step {step} into {os.path.join(args.port_run, 'ckpt')}")
    print(WARM_START_NOTE)


if __name__ == "__main__":
    main()
