"""Carry weights from the JAX package's parameter trees into the port.

Input: nested dicts of numpy arrays (``jax.device_get`` of a Flax variable
tree, or a restored checkpoint); nothing here imports JAX. Output: flat
``{name: numpy array}`` state_dicts that the port's modules load with
``strict=True``:

- :func:`encoder_state_dict`: a ``SpeechEncoder``'s ``{"params",
  "batch_stats"}`` → ``models.encoder.SpeechEncoder`` (the inverse of
  ``s2i_tpu.port.port_encoder``: kernels transposed, GRU gates kept r|z|n);
- :func:`gnet_state_dict`: the ``{"ca", "g"}`` generator params (raw or the
  EMA copy) with ``{"g"}`` batch stats → ``models.generator.GNet`` (the
  port's own copy of ``s2i_tpu.port.export_gnet``);
- :func:`states_from_gan`: both at once from a GAN state's trees, picking the
  joint checkpoint's ``enc`` subtrees and the EMA weights as the JAX
  ``SpeechToImage`` does.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _conv2d(k) -> np.ndarray:
    return _np(k).transpose(3, 2, 0, 1).copy()  # HWIO → OIHW


def _bn(sd: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])
    sd[f"{prefix}.running_mean"] = _np(s["mean"])
    sd[f"{prefix}.running_var"] = _np(s["var"])


def encoder_state_dict(variables: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """``{"params", "batch_stats"}`` of a Flax ``SpeechEncoder`` → the port's
    ``SpeechEncoder`` state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, np.ndarray] = {}
    i = 0
    while f"conv{i}" in params:
        sd[f"convs.{i}.weight"] = _np(params[f"conv{i}"]["kernel"]).transpose(2, 1, 0).copy()
        _bn(sd, f"bns.{i}", params[f"bn{i}"], stats[f"bn{i}"])
        i += 1
    for name, d in params["BiGRU_0"].items():
        layer = int(name[3:])
        sfx = "_reverse" if name.startswith("bwd") else ""
        sd[f"rnn.weight_ih_l{layer}{sfx}"] = _np(d["input_proj"]["kernel"]).T.copy()
        sd[f"rnn.bias_ih_l{layer}{sfx}"] = _np(d["input_proj"]["bias"])
        sd[f"rnn.weight_hh_l{layer}{sfx}"] = _np(d["recurrent_kernel"]).T.copy()
        sd[f"rnn.bias_hh_l{layer}{sfx}"] = _np(d["recurrent_bias"])
    for head in ("head", "cls"):
        if head in params:
            sd[f"{head}.weight"] = _np(params[head]["kernel"]).T.copy()
            sd[f"{head}.bias"] = _np(params[head]["bias"])
    return sd


def _conv3x3_block(sd: dict, prefix: str, p: Mapping, s: Mapping, swap_c: int = 0) -> None:
    """Conv3x3_0 + BatchNorm_0 → ``{prefix}.0`` / ``{prefix}.1``. ``swap_c``
    moves the JAX trailing condition channels (h ‖ c) to the front (c ‖ h)."""
    k = _np(p["Conv3x3_0"]["Conv_0"]["kernel"])
    if swap_c:
        k = np.concatenate([k[:, :, -swap_c:], k[:, :, :-swap_c]], axis=2)
    sd[f"{prefix}.0.weight"] = _conv2d(k)
    _bn(sd, f"{prefix}.1", p["BatchNorm_0"]["BatchNorm_0"], s["BatchNorm_0"]["BatchNorm_0"])


def _up_block(sd: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    sd[f"{prefix}.1.weight"] = _conv2d(p["UpConv3x3_0"]["kernel"])
    _bn(sd, f"{prefix}.2", p["BatchNorm_0"]["BatchNorm_0"], s["BatchNorm_0"]["BatchNorm_0"])


def gnet_state_dict(g_params: Mapping, g_stats: Mapping) -> dict[str, np.ndarray]:
    """``{"ca", "g"}`` params + ``{"g"}`` stats → the port's ``GNet``
    state_dict (StackGAN-v2 names)."""
    ca, g, gs = g_params["ca"], g_params["g"], g_stats["g"]
    sd: dict[str, np.ndarray] = {}
    ca_kernel = _np(ca["Dense_0"]["kernel"])  # [t_dim, 4·c_dim]
    c_dim = ca_kernel.shape[1] // 4
    sd["ca_net.fc.weight"] = ca_kernel.T.copy()
    sd["ca_net.fc.bias"] = _np(ca["Dense_0"]["bias"])

    init_p, init_s = g["init"], gs["init"]
    dense = _np(init_p["Dense_0"]["kernel"])  # [z + c, ngf16·32], rows (z, c)
    n_out = dense.shape[1]
    ngf16 = n_out // 32
    z_dim = dense.shape[0] - c_dim
    # input rows (z, c) → (c, z); output columns (4, 4, C) → (C, 4, 4) within
    # each GLU half: torch column c·16 + s is JAX column s·ngf16 + c
    perm_in = np.concatenate([np.arange(z_dim, z_dim + c_dim), np.arange(z_dim)])
    f = np.arange(n_out // 2)
    half = (f % 16) * ngf16 + f // 16
    perm_out = np.concatenate([half, half + n_out // 2])
    sd["h_net1.fc.0.weight"] = dense[perm_in][:, perm_out].T.copy()
    bn_p = init_p["BatchNorm_0"]["BatchNorm_0"]
    bn_s = init_s["BatchNorm_0"]["BatchNorm_0"]
    _bn(
        sd,
        "h_net1.fc.1",
        {k: _np(v)[perm_out] for k, v in bn_p.items()},
        {k: _np(v)[perm_out] for k, v in bn_s.items()},
    )
    for i in range(4):
        _up_block(sd, f"h_net1.upsample{i + 1}", init_p[f"UpBlockGLU_{i}"], init_s[f"UpBlockGLU_{i}"])

    branch_num = 1 + sum(f"next{i}" in g for i in (1, 2))
    for i in range(1, branch_num):
        tp, sp, ss = f"h_net{i + 1}", g[f"next{i}"], gs[f"next{i}"]
        _conv3x3_block(sd, f"{tp}.jointConv", sp["Block3x3GLU_0"], ss["Block3x3GLU_0"], swap_c=c_dim)
        r = 0
        while f"ResBlockGLU_{r}" in sp:
            rp, rs = sp[f"ResBlockGLU_{r}"], ss[f"ResBlockGLU_{r}"]
            pre = f"{tp}.residual.{r}.block"
            sd[f"{pre}.0.weight"] = _conv2d(rp["Conv3x3_0"]["Conv_0"]["kernel"])
            _bn(sd, f"{pre}.1", rp["BatchNorm_0"]["BatchNorm_0"], rs["BatchNorm_0"]["BatchNorm_0"])
            sd[f"{pre}.3.weight"] = _conv2d(rp["Conv3x3_1"]["Conv_0"]["kernel"])
            _bn(sd, f"{pre}.4", rp["BatchNorm_1"]["BatchNorm_0"], rs["BatchNorm_1"]["BatchNorm_0"])
            r += 1
        _up_block(sd, f"{tp}.upsample", sp["UpBlockGLU_0"], ss["UpBlockGLU_0"])

    for i in range(branch_num):
        sd[f"img_net{i + 1}.img.0.weight"] = _conv2d(g[f"to_rgb{i}"]["Conv3x3_0"]["Conv_0"]["kernel"])
    return sd


def states_from_gan(
    g_params: Mapping,
    g_stats: Mapping,
    ema_g: Mapping | None = None,
    encoder_vars: Mapping | None = None,
    use_ema: bool = True,
) -> tuple[dict, dict, bool]:
    """(encoder state_dict, GNet state_dict, joint) from a GAN state's
    ``g_params``/``g_stats``/``ema_g`` trees. A joint checkpoint carries the
    fine-tuned encoder in its ``enc`` subtrees and that one is used;
    otherwise ``encoder_vars`` (a frozen encoder's ``{"params",
    "batch_stats"}``) is required. The EMA weights win when present and
    ``use_ema`` is set."""
    joint = "enc" in g_params
    if joint:
        encoder_vars = {"params": g_params["enc"], "batch_stats": g_stats["enc"]}
    elif encoder_vars is None:
        raise ValueError("encoder_vars is required for non-joint GAN states")
    gen = ema_g if (use_ema and ema_g) else {"ca": g_params["ca"], "g": g_params["g"]}
    return encoder_state_dict(encoder_vars), gnet_state_dict(gen, g_stats), joint
