"""Reference torch GAN checkpoints in and out, the counterpart of
``s2i_tpu/port/stackgan_torch.py``: ``netG.pth`` / ``netD{64,128,256}.pth``
of the StackGAN-v2 lineage.

The port's ``models.generator.GNet`` and ``models.discriminator.DNet``
already carry the reference's module names (``ca_net.fc``, ``h_net1.fc.{0,1}``,
``h_net{i}.upsample*``, ``h_net{2,3}.jointConv`` / ``.residual.{r}.block``,
``img_net{i}.img.0``; ``img_code_s16``, ``img_code_s32[_1]``,
``img_code_s64[_1,_2]``, ``logits``, ``uncond_logits``), parameter for
parameter in the reference's layouts. So a reference state_dict loads as it
is: none of the JAX porter's transposes and permutations. What this module
does is the rest of that porter's contract:

- :func:`load_torch_state_dict`: ``torch.load`` on the CPU, a
  ``{'state_dict': ...}`` container unwrapped, DataParallel's ``module.``
  prefix stripped;
- :func:`port_gnet` / :func:`port_dnet`: the architecture's dims inferred
  from the tensor shapes (the JAX porter's ``meta``), every key checked
  against the module those dims build, loudly: a key missing, left over or of
  another shape raises and lists the keys. ``num_batches_tracked`` is
  dropped (the port's ``BatchNorm`` keeps none). ``running_var`` is copied as
  stored: the reference's torch BN keeps the unbiased variance, and the JAX
  package and the port both normalize by the stored value, so one file gives
  both packages the same images;
- :func:`export_gnet` / :func:`export_dnet`: the way back, what the JAX
  exporter writes: reference-layout float32 tensors, no ``module.``, no
  ``num_batches_tracked`` (a torch ``BatchNorm2d`` loads that strictly).

    g_sd, meta = port_gnet(load_torch_state_dict("netG.pth"))
    GNet(gf_dim=meta["gf_dim"], ...).load_state_dict(g_sd)   # strict
    torch.save(export_gnet(g.state_dict()), "netG.pth")

The commands ``port-torch-gan`` and ``export-torch-gan`` (``cli.run_port_gan``,
``cli.run_export_gan``) go between these files and the port's checkpoints.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch

from s2i_tpu_torch.models.discriminator import DNet
from s2i_tpu_torch.models.generator import GNet

__all__ = [
    "load_torch_state_dict",
    "normalize_state_dict",
    "port_gnet",
    "port_dnet",
    "port_dnet_scale",
    "export_gnet",
    "export_dnet",
]

_SHOWN = 8  # keys listed in an error, as the JAX porter lists them


def normalize_state_dict(obj: Any, what: str = "checkpoint") -> dict[str, Any]:
    """A loaded checkpoint as a flat state_dict: a ``{'state_dict': ...}``
    container unwrapped, the ``module.`` prefix stripped."""
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, Mapping):
        raise ValueError(f"{what}: expected a state_dict, got {type(obj)}")
    return {k.removeprefix("module."): v for k, v in obj.items()}


def load_torch_state_dict(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """``torch.load`` a checkpoint on the CPU (tensors only) and normalize
    it (:func:`normalize_state_dict`)."""
    return normalize_state_dict(torch.load(path, map_location="cpu", weights_only=True), str(path))


def _listed(keys: list[str]) -> str:
    more = ", ..." if len(keys) > _SHOWN else ""
    return f"{len(keys)} {sorted(keys)[:_SHOWN]}{more}"


def _shape(sd: Mapping, key: str, what: str) -> tuple[int, ...]:
    if key not in sd:
        raise ValueError(f"{what}: the checkpoint is missing {key!r}: not a StackGAN-v2-layout state_dict?")
    return tuple(sd[key].shape)


def _matched(sd: Mapping, model: torch.nn.Module, what: str) -> dict[str, torch.Tensor]:
    """``sd`` checked key for key and shape for shape against ``model``'s
    state_dict (``num_batches_tracked`` aside), as float32 CPU copies in the
    model's order; raises ValueError listing every key that does not map."""
    want = model.state_dict()
    got = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    missing = [k for k in want if k not in got]
    extra = [k for k in got if k not in want]
    shapes = [f"{k}: {tuple(got[k].shape)} vs {tuple(v.shape)}" for k, v in want.items()
              if k in got and tuple(got[k].shape) != tuple(v.shape)]
    problems = ([f"missing keys {_listed(missing)}"] if missing else []) + (
        [f"unrecognized keys (naming drift?) {_listed(extra)}"] if extra else []) + (
        [f"shape mismatches {shapes[:_SHOWN]}"] if shapes else [])
    if problems:
        raise ValueError(f"{what}: the state_dict does not match the StackGAN-v2 layout: " + "; ".join(problems))
    return {k: torch.as_tensor(got[k]).detach().to("cpu", torch.float32).clone() for k in want}


def gnet_meta(sd: Mapping) -> dict[str, int | None]:
    """G's dims from the tensor shapes: the JAX porter's ``meta``
    (``gf_dim``, ``z_dim``, ``c_dim``, ``t_dim``, ``branch_num``, ``r_num``,
    None for one stage)."""
    fc = _shape(sd, "h_net1.fc.0.weight", "netG")  # [16·gf · 32, c_dim + z_dim]
    ca = _shape(sd, "ca_net.fc.weight", "netG")  # [4·c_dim, t_dim]
    c_dim = ca[0] // 4
    branch_num = 1 + sum(f"h_net{i}.jointConv.0.weight" in sd for i in (2, 3))
    r_num = sum(k.startswith("h_net2.residual.") and k.endswith(".block.0.weight") for k in sd)
    return {"gf_dim": fc[0] // 32 // 16, "z_dim": fc[1] - c_dim, "c_dim": c_dim, "t_dim": ca[1],
            "branch_num": branch_num, "r_num": r_num if branch_num > 1 else None}


def _gnet(meta: Mapping) -> GNet:
    with torch.device("meta"):  # names and shapes only, no storage
        return GNet(gf_dim=meta["gf_dim"], z_dim=meta["z_dim"], c_dim=meta["c_dim"], t_dim=meta["t_dim"],
                    branch_num=meta["branch_num"], num_res=meta["r_num"] or 0)


def port_gnet(sd: Mapping) -> tuple[dict[str, torch.Tensor], dict]:
    """A reference ``netG`` state_dict → (the port's ``GNet`` state_dict,
    ``meta``). Set the cfg from ``meta`` (``GAN.GF_DIM``, ``GAN.Z_DIM``,
    ``GAN.EMBEDDING_DIM``, ``TEXT.DIMENSION``, ``TREE.BRANCH_NUM``,
    ``GAN.R_NUM``) and the state_dict loads into its ``GNet`` strictly."""
    sd = normalize_state_dict(sd, "netG")
    meta = gnet_meta(sd)
    return _matched(sd, _gnet(meta), "netG"), meta


def port_dnet_scale(sd: Mapping) -> int:
    """Which per-scale D a ``netD`` state_dict belongs to."""
    if "img_code_s64_2.0.weight" in sd:
        return 256
    if "img_code_s32_1.0.weight" in sd:
        return 128
    return 64


def dnet_meta(sd: Mapping) -> dict[str, int]:
    """A D's ``scale``, ``df_dim`` and ``ef_dim`` from the tensor shapes."""
    what = f"netD{port_dnet_scale(sd)}"
    ndf = _shape(sd, "img_code_s16.0.weight", what)[0]
    joint_in = _shape(sd, "logits.jointConv.0.weight", what)[1]
    return {"scale": port_dnet_scale(sd), "df_dim": ndf, "ef_dim": joint_in - ndf * 8}


def _dnet(meta: Mapping) -> DNet:
    with torch.device("meta"):
        return DNet(meta["scale"], meta["df_dim"], meta["ef_dim"], b_condition=True)


def port_dnet(sd: Mapping) -> tuple[dict[str, torch.Tensor], dict]:
    """A reference per-scale ``netD`` state_dict → (the port's ``DNet``
    state_dict, ``meta``): ``DNet(scale, df_dim, ef_dim)`` loads it
    strictly."""
    sd = normalize_state_dict(sd, "netD")
    meta = dnet_meta(sd)
    return _matched(sd, _dnet(meta), f"netD{meta['scale']}"), meta


def export_gnet(g_state_dict: Mapping) -> dict[str, torch.Tensor]:
    """The port's ``GNet`` state_dict (raw, or with the EMA weights over it)
    → a reference ``netG`` state_dict for ``torch.save``."""
    return _matched(g_state_dict, _gnet(gnet_meta(g_state_dict)), "G")


def export_dnet(d_state_dict: Mapping) -> dict[str, torch.Tensor]:
    """The port's ``DNet`` state_dict → a reference ``netD{scale}``
    state_dict for ``torch.save``."""
    meta = dnet_meta(d_state_dict)
    return _matched(d_state_dict, _dnet(meta), f"D{meta['scale']}")
