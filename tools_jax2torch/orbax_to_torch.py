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
lands in ``PORT_RUN/ckpt/<step>.pt`` beside a ``config.yml``.

The encoder's and the GAN's Adam states go along: optax's ``mu`` / ``nu`` /
``count`` become ``torch.optim.Adam``'s ``exp_avg`` / ``exp_avg_sq`` / ``step``
(the one count on every parameter of its optimizer), each moment tree through
the same bridge function as its weights (the conv transposes, G's init-fc
column permutation, the condition's row and channel swaps), in the order of
the port's optimizer groups (``train.gan.g_opt_names``). With
``TRAIN.MOMENT_DTYPE: bfloat16`` the JAX package keeps two masked Adam
states, the large leaves' moments in bfloat16; they are merged, and the port's
``CastMomentAdam`` keeps those leaves' moments in bfloat16. So training from a
converted encoder or Adam GAN checkpoint resumes exactly where the JAX run
stopped. A ``TRAIN.OPTIMIZER: sgd`` run has no moments, and an Inception
finetune state's are not converted: those are warm starts (``WARM_START_NOTE``).
Then:

    SpeechToImage.from_checkpoints(cfg, "<encoder PORT_RUN>/ckpt", "<gan PORT_RUN>/ckpt")
    python -m s2i_tpu_torch eval --gen_dir ... --finetuned_ckpt <inception PORT_RUN>/ckpt
    python -m s2i_tpu_torch train --cfg ... --set TRAIN.NET_G=<gan PORT_RUN>/ckpt
    python -m s2i_tpu_torch train --cfg cfg/birds_joint_ft.yml --set TRAIN.NET_E=<encoder PORT_RUN>/ckpt

This is the one file of the repository that imports both packages (JAX and
Orbax to read, the port to write); the port never imports it.
"""

from __future__ import annotations

import argparse
import functools
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
from s2i_tpu_torch.utils.checkpoint import load_optimizer  # noqa: E402

WARM_START_NOTE = ("no Adam moments were converted (an SGD run or an Inception finetune state): training from "
                   "this checkpoint is a warm start with fresh optimizer states, not an exact resume")
EXACT_NOTE = "Adam moments and steps converted: training from this checkpoint resumes exactly"


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


def _merge(a, b):
    """Two trees of one structure whose leaves are each None in one of them."""
    if a is None or b is None:
        return b if a is None else a
    return {k: _merge(a[k], b[k]) for k in a}


def adam_moments(opt) -> dict | None:
    """The Adam state of a restored optax state (``optax.adam``'s
    ``ScaleByAdamState``, or the two ``optax.masked`` halves of the JAX
    package's ``TRAIN.MOMENT_DTYPE`` chain, masked leaves None) as
    ``{"count", "mu", "nu"}``, the halves merged; None where there is no
    Adam state (SGD)."""
    found = []

    def walk(t) -> None:
        if isinstance(t, dict) and {"count", "mu", "nu"} <= set(t):
            found.append(t)
        elif isinstance(t, (dict, list)):
            for v in t.values() if isinstance(t, dict) else t:
                walk(v)

    walk(opt)
    if not found:
        return None
    counts = {int(s["count"]) for s in found}
    if len(counts) != 1:
        raise ValueError(f"the optimizer's Adam states disagree on the step count: {sorted(counts)}")
    return {"count": counts.pop(), "mu": functools.reduce(_merge, (s["mu"] for s in found)),
            "nu": functools.reduce(_merge, (s["nu"] for s in found))}


def carry_moments(opt: torch.optim.Optimizer, opt_raw, names: list[str], named, what: str) -> None:
    """The Adam state of ``opt_raw`` (a restored optax state) into ``opt``,
    whose parameters ``names`` lists in its order: ``named`` maps a moment
    tree to port-named arrays (a bridge function), ``mu`` / ``nu`` become
    ``exp_avg`` / ``exp_avg_sq`` and the count every parameter's ``step``. The
    optimizer's own ``load_state_dict`` sets each moment's type (the
    parameter's, or ``CastMomentAdam``'s for a large leaf). An SGD state has
    no moments and is left fresh; raises where the checkpoint and the
    config's ``TRAIN.OPTIMIZER`` disagree."""
    adam = adam_moments(opt_raw)
    if (adam is None) == isinstance(opt, torch.optim.Adam):
        raise ValueError(f"{what}: the checkpoint {'has no' if adam is None else 'has an'} Adam state; the "
                         f"config's optimizer is {type(opt).__name__} (TRAIN.OPTIMIZER)")
    if adam is None:
        return
    mu, nu = named(adam["mu"]), named(adam["nu"])
    sd = opt.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(adam["count"])), "exp_avg": torch.from_numpy(mu[n]),
                       "exp_avg_sq": torch.from_numpy(nu[n])} for i, n in enumerate(names)}
    load_optimizer(opt, sd, what)


def convert_encoder(raw: dict, cfg) -> dict:
    """A restored JAX ``EncoderTrainState`` → the port's encoder train
    state dict (``{"step", "model", "opt"}``, Adam's moments and steps
    included)."""
    state = init_encoder_state(cfg, device="cpu")
    sd = bridge.encoder_state_dict({"params": raw["params"], "batch_stats": raw["batch_stats"]})
    _load(state.model, sd, "the encoder checkpoint")
    carry_moments(state.opt, raw["opt"], [n for n, _ in state.model.named_parameters()],
                  lambda tree: bridge.encoder_state_dict({"params": tree, "batch_stats": raw["batch_stats"]}),
                  "encoder Adam")
    state.step = int(raw["step"])
    return state.state_dict()


def convert_gan(raw: dict, cfg) -> dict:
    """A restored JAX ``GanTrainState`` → the port's GAN train state dict
    (G with CA, the Ds, the joint encoder, the EMA, the step and, for Adam,
    every optimizer's moments and steps)."""
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

    def g_named(tree: dict) -> dict:  # a tree of G's optimizer group → g_opt_names' names
        out = {f"g.{k}": v for k, v in bridge.gnet_state_dict({"ca": tree["ca"], "g": tree["g"]}, g_stats).items()}
        if joint:
            enc = bridge.encoder_state_dict({"params": tree["enc"], "batch_stats": g_stats["enc"]})
            out.update({f"enc.{k}": v for k, v in enc.items()})
        return out

    carry_moments(state.g_opt, raw["g_opt"], gan.g_opt_names(m), g_named, "g_opt")
    for i, (opt, opt_raw, d, stats) in enumerate(zip(state.d_opts, raw["d_opt"], m.ds, raw["d_stats"])):
        carry_moments(opt, opt_raw, [n for n, _ in d.named_parameters()],
                      functools.partial(bridge.dnet_state_dict, stats=stats), f"d_opts[{i}]")
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


def convert(jax_run: str, port_run: str, cfg) -> tuple[str, int, bool]:
    """Convert ``jax_run``'s latest checkpoint into ``port_run/ckpt``;
    returns (kind, step, whether Adam's moments were carried)."""
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
    return kind, step, kind == "encoder" or (kind == "gan" and adam_moments(raw["g_opt"]) is not None)


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
    kind, step, exact = convert(args.jax_run, args.port_run, cfg)
    print(f"converted the {kind} checkpoint of step {step} into {os.path.join(args.port_run, 'ckpt')}")
    print(EXACT_NOTE if exact else WARM_START_NOTE)


if __name__ == "__main__":
    main()
