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
- :func:`dnet_state_dict`: one per-scale D's params + batch stats →
  ``models.discriminator.DNet`` (the port's own copy of
  ``s2i_tpu.port.export_dnet``);
- :func:`states_from_gan`: both at once from a GAN state's trees, picking the
  joint checkpoint's ``enc`` subtrees and the EMA weights as the JAX
  ``SpeechToImage`` does.

And the inverse, port state_dicts → Flax trees of numpy arrays, so that a
state the port made can be handed to the JAX package (the step parity
tests start both from the port's seeded init this way):
:func:`gnet_trees`, :func:`dnet_trees` (the port's copies of
``port_gnet``/``port_dnet``) and :func:`encoder_trees`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)  # a copy: no output aliases an input


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


def _conv_block(sd: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """A {Conv3x3_0, BatchNorm_0} block → ``{prefix}.0`` / ``{prefix}.1``."""
    sd[f"{prefix}.0.weight"] = _conv2d(p["Conv3x3_0"]["Conv_0"]["kernel"])
    _bn(sd, f"{prefix}.1", p["BatchNorm_0"]["BatchNorm_0"], s["BatchNorm_0"]["BatchNorm_0"])


# D trunk: DownBlock_{1,2,3} → img_code_s16 conv/BN indices; the deeper
# DownBlocks and the channel-resqueeze blocks per scale
_S16 = ((1, 2, 3), (2, 5, 6), (3, 8, 9))
_EXTRA = {64: (), 128: ("img_code_s32",), 256: ("img_code_s32", "img_code_s64")}
_SQUEEZE = {64: (), 128: ("img_code_s32_1",), 256: ("img_code_s64_1", "img_code_s64_2")}


def dnet_state_dict(params: Mapping, stats: Mapping) -> dict[str, np.ndarray]:
    """One per-scale D's ``params`` + ``batch_stats`` trees → the port's
    ``DNet`` state_dict (StackGAN-v2 names)."""
    tp, ts, hp, hs = params["trunk"], stats["trunk"], params["heads"], stats["heads"]
    scale = {4: 64, 5: 128, 6: 256}[sum(k.startswith("DownBlock_") for k in tp)]
    sd: dict[str, np.ndarray] = {"img_code_s16.0.weight": _conv2d(tp["DownBlock_0"]["Conv_0"]["kernel"])}
    for n, ci, bi in _S16:
        sd[f"img_code_s16.{ci}.weight"] = _conv2d(tp[f"DownBlock_{n}"]["Conv_0"]["kernel"])
        _bn(sd, f"img_code_s16.{bi}", tp[f"DownBlock_{n}"]["BatchNorm_0"]["BatchNorm_0"],
            ts[f"DownBlock_{n}"]["BatchNorm_0"]["BatchNorm_0"])
    for n, prefix in enumerate(_EXTRA[scale], start=4):
        sd[f"{prefix}.0.weight"] = _conv2d(tp[f"DownBlock_{n}"]["Conv_0"]["kernel"])
        _bn(sd, f"{prefix}.1", tp[f"DownBlock_{n}"]["BatchNorm_0"]["BatchNorm_0"],
            ts[f"DownBlock_{n}"]["BatchNorm_0"]["BatchNorm_0"])
    for n, prefix in enumerate(_SQUEEZE[scale]):
        _conv_block(sd, prefix, tp[f"Block3x3LeakyReLU_{n}"], ts[f"Block3x3LeakyReLU_{n}"])
    if "joint" in hp:  # GAN.B_CONDITION
        _conv_block(sd, "logits.jointConv", hp["joint"], hs["joint"])
        sd["logits.outlogits.0.weight"] = _conv2d(hp["cond_logit"]["kernel"])
        sd["logits.outlogits.0.bias"] = _np(hp["cond_logit"]["bias"])
    sd["uncond_logits.outlogits.0.weight"] = _conv2d(hp["uncond_logit"]["kernel"])
    sd["uncond_logits.outlogits.0.bias"] = _np(hp["uncond_logit"]["bias"])
    return sd


# ---------------------------------------------------------------------------
# port state_dicts → Flax trees
# ---------------------------------------------------------------------------


def _hwio(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0).copy()  # OIHW → HWIO


def _bn_trees(sd: Mapping, prefix: str, perm=slice(None)) -> tuple[dict, dict]:
    """``{prefix}.*`` → ({"BatchNorm_0": params}, {"BatchNorm_0": stats})."""
    p = {"scale": _np(sd[f"{prefix}.weight"])[perm], "bias": _np(sd[f"{prefix}.bias"])[perm]}
    s = {"mean": _np(sd[f"{prefix}.running_mean"])[perm], "var": _np(sd[f"{prefix}.running_var"])[perm]}
    return {"BatchNorm_0": p}, {"BatchNorm_0": s}


def _conv_block_trees(sd: Mapping, prefix: str, swap_c: int = 0) -> tuple[dict, dict]:
    """``{prefix}.0`` / ``{prefix}.1`` → a {Conv3x3_0, BatchNorm_0} block;
    ``swap_c`` moves the torch-leading condition channels (c ‖ h) to the
    end (h ‖ c)."""
    k = _hwio(sd[f"{prefix}.0.weight"])
    if swap_c:
        k = np.concatenate([k[:, :, swap_c:], k[:, :, :swap_c]], axis=2)
    bp, bs = _bn_trees(sd, f"{prefix}.1")
    return {"Conv3x3_0": {"Conv_0": {"kernel": k}}, "BatchNorm_0": bp}, {"BatchNorm_0": bs}


def _up_block_trees(sd: Mapping, prefix: str) -> tuple[dict, dict]:
    bp, bs = _bn_trees(sd, f"{prefix}.2")
    return {"UpConv3x3_0": {"kernel": _hwio(sd[f"{prefix}.1.weight"])}, "BatchNorm_0": bp}, {"BatchNorm_0": bs}


def gnet_trees(sd: Mapping) -> tuple[dict, dict]:
    """The port's ``GNet`` state_dict → (``{"ca", "g"}`` params, ``{"g"}``
    batch stats), the inverse of :func:`gnet_state_dict`."""
    ca_w = _np(sd["ca_net.fc.weight"])  # [4·c_dim, t_dim]
    c_dim = ca_w.shape[0] // 4
    fc_w = _np(sd["h_net1.fc.0.weight"])  # [ngf16·32, c + z], columns (c, z)
    n_out = fc_w.shape[0]
    ngf16, z_dim = n_out // 32, fc_w.shape[1] - c_dim
    perm_in = np.concatenate([np.arange(c_dim, c_dim + z_dim), np.arange(c_dim)])
    f = np.arange(n_out // 2)
    half = (f % ngf16) * 16 + f // ngf16  # JAX column s·ngf16 + c is torch column c·16 + s
    perm_out = np.concatenate([half, half + n_out // 2])
    bp, bs = _bn_trees(sd, "h_net1.fc.1", perm_out)
    init_p = {"Dense_0": {"kernel": fc_w.T[perm_in][:, perm_out].copy()}, "BatchNorm_0": bp}
    init_s = {"BatchNorm_0": bs}
    for i in range(4):
        init_p[f"UpBlockGLU_{i}"], init_s[f"UpBlockGLU_{i}"] = _up_block_trees(sd, f"h_net1.upsample{i + 1}")
    g_p, g_s = {"init": init_p}, {"init": init_s}
    branch_num = 1 + sum(f"h_net{i}.jointConv.0.weight" in sd for i in (2, 3))
    for i in range(1, branch_num):
        tp = f"h_net{i + 1}"
        sp, ss = {}, {}
        sp["Block3x3GLU_0"], ss["Block3x3GLU_0"] = _conv_block_trees(sd, f"{tp}.jointConv", swap_c=c_dim)
        r = 0
        while f"{tp}.residual.{r}.block.0.weight" in sd:
            pre = f"{tp}.residual.{r}.block"
            b0p, b0s = _bn_trees(sd, f"{pre}.1")
            b1p, b1s = _bn_trees(sd, f"{pre}.4")
            sp[f"ResBlockGLU_{r}"] = {
                "Conv3x3_0": {"Conv_0": {"kernel": _hwio(sd[f"{pre}.0.weight"])}}, "BatchNorm_0": b0p,
                "Conv3x3_1": {"Conv_0": {"kernel": _hwio(sd[f"{pre}.3.weight"])}}, "BatchNorm_1": b1p,
            }
            ss[f"ResBlockGLU_{r}"] = {"BatchNorm_0": b0s, "BatchNorm_1": b1s}
            r += 1
        sp["UpBlockGLU_0"], ss["UpBlockGLU_0"] = _up_block_trees(sd, f"{tp}.upsample")
        g_p[f"next{i}"], g_s[f"next{i}"] = sp, ss
    for i in range(branch_num):
        g_p[f"to_rgb{i}"] = {"Conv3x3_0": {"Conv_0": {"kernel": _hwio(sd[f"img_net{i + 1}.img.0.weight"])}}}
    ca = {"Dense_0": {"kernel": ca_w.T.copy(), "bias": _np(sd["ca_net.fc.bias"])}}
    return {"ca": ca, "g": g_p}, {"g": g_s}


def dnet_trees(sd: Mapping) -> tuple[dict, dict]:
    """The port's ``DNet`` state_dict → (params, batch stats) of one
    per-scale Flax D, the inverse of :func:`dnet_state_dict`."""
    scale = 256 if "img_code_s64.0.weight" in sd else 128 if "img_code_s32.0.weight" in sd else 64
    tp: dict = {"DownBlock_0": {"Conv_0": {"kernel": _hwio(sd["img_code_s16.0.weight"])}}}
    ts: dict = {}
    down = [(n, f"img_code_s16.{ci}", f"img_code_s16.{bi}") for n, ci, bi in _S16]
    down += [(n, f"{prefix}.0", f"{prefix}.1") for n, prefix in enumerate(_EXTRA[scale], start=4)]
    for n, conv, bn in down:
        bp, bs = _bn_trees(sd, bn)
        tp[f"DownBlock_{n}"] = {"Conv_0": {"kernel": _hwio(sd[f"{conv}.weight"])}, "BatchNorm_0": bp}
        ts[f"DownBlock_{n}"] = {"BatchNorm_0": bs}
    for n, prefix in enumerate(_SQUEEZE[scale]):
        tp[f"Block3x3LeakyReLU_{n}"], ts[f"Block3x3LeakyReLU_{n}"] = _conv_block_trees(sd, prefix)
    logit = lambda prefix: {"kernel": _hwio(sd[f"{prefix}.0.weight"]), "bias": _np(sd[f"{prefix}.0.bias"])}  # noqa: E731
    hp: dict = {"uncond_logit": logit("uncond_logits.outlogits")}
    hs: dict = {}
    if "logits.jointConv.0.weight" in sd:
        hp["joint"], hs["joint"] = _conv_block_trees(sd, "logits.jointConv")
        hp["cond_logit"] = logit("logits.outlogits")
    return {"trunk": tp, "heads": hp}, {"trunk": ts, "heads": hs}


def encoder_trees(sd: Mapping) -> dict:
    """The port's ``SpeechEncoder`` state_dict → Flax ``{"params",
    "batch_stats"}``, the inverse of :func:`encoder_state_dict`."""
    params: dict = {}
    stats: dict = {}
    i = 0
    while f"convs.{i}.weight" in sd:
        params[f"conv{i}"] = {"kernel": _np(sd[f"convs.{i}.weight"]).transpose(2, 1, 0).copy()}
        bp, bs = _bn_trees(sd, f"bns.{i}")
        params[f"bn{i}"], stats[f"bn{i}"] = bp["BatchNorm_0"], bs["BatchNorm_0"]
        i += 1
    gru: dict = {}
    for key in sd:
        if key.startswith("rnn.weight_ih_l"):
            rest = key[len("rnn.weight_ih_l"):]
            layer, rev = int(rest.split("_")[0]), rest.endswith("_reverse")
            sfx = rest[len(str(layer)):]
            gru[f"{'bwd' if rev else 'fwd'}{layer}"] = {
                "input_proj": {"kernel": _np(sd[f"rnn.weight_ih_l{layer}{sfx}"]).T.copy(),
                               "bias": _np(sd[f"rnn.bias_ih_l{layer}{sfx}"])},
                "recurrent_kernel": _np(sd[f"rnn.weight_hh_l{layer}{sfx}"]).T.copy(),
                "recurrent_bias": _np(sd[f"rnn.bias_hh_l{layer}{sfx}"]),
            }
    params["BiGRU_0"] = gru
    for head in ("head", "cls"):
        if f"{head}.weight" in sd:
            params[head] = {"kernel": _np(sd[f"{head}.weight"]).T.copy(), "bias": _np(sd[f"{head}.bias"])}
    return {"params": params, "batch_stats": stats}
