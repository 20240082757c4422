"""Reference torch speech-encoder checkpoints (``audio_encoder/`` lineage)
into the port's :class:`models.encoder.SpeechEncoder`, the counterpart of
``s2i_tpu/port/audio_encoder_torch.py``, with the same contract: dims
inferred from tensor shapes, ``module.`` prefixes stripped, and a loud
failure on anything that does not map.

The reference encoder's module names are not published, so the match is
structural, as in the JAX porter: tensors are classified by shape and
suffix and grouped by module prefix in the state_dict's insertion order
(torch keeps module definition order): Conv1d kernels [O, I, K] and their
BatchNorm1d groups in order, ``nn.GRU`` keys by regex, the Linear heads by
width. Any parameter that cannot be classified, and any architecture off
the topology (a conv bias, a second RNN, a broken channel chain, an
ambiguous head), raises with the keys at fault. The port's encoder keeps
``nn.GRU``'s gate order (r|z|n) and torch's layouts, so the tensors go over
as they are, renamed to ``convs.{i}``, ``bns.{i}``, ``rnn.*_l{k}[_reverse]``,
``head`` and ``cls``.

Torch's symmetric ``padding=k//2`` is not XLA's "SAME" at even lengths, so
the ported encoder computes with ``conv_padding="torch"`` (in ``meta``; a
cfg serves it with ``ENCODER.CONV_PADDING: torch`` and ``TRAIN.JOINT_FT``
off, since a joint checkpoint's encoder is built "SAME"):

    sd, meta = port_encoder("audio_encoder.pth")
    enc = SpeechEncoder(**meta)          # n_mels and conv_padding included
    enc.load_state_dict(sd)              # strict
    emb = enc.eval()(feats, mask)

The layout is matched, not known: validate a ported encoder's outputs
against the source model's before use.
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping

import torch

from s2i_tpu_torch.port.stackgan_torch import load_torch_state_dict, normalize_state_dict

__all__ = ["port_encoder"]

_GRU_RE = re.compile(
    r"(?P<mod>.*?)(?P<kind>weight_ih|weight_hh|bias_ih|bias_hh)"
    r"_l(?P<layer>\d+)(?P<rev>_reverse)?$"
)
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _fail(problems: list[str]) -> None:
    if problems:
        raise ValueError("state_dict does not match the SpeechEncoder topology: " + "; ".join(problems))


def port_encoder(
    state_dict: Mapping[str, Any] | str | os.PathLike,
    conv_stride: int = 2,
    emb_dim: int | None = None,
) -> tuple[dict[str, torch.Tensor], dict]:
    """A torch speech-encoder state_dict (or the path of its ``.pth``) →
    (the port's ``SpeechEncoder`` state_dict, ``meta``).

    ``conv_stride`` is the one hyperparameter the shapes cannot carry (torch
    keeps it in code): pass the source model's. ``emb_dim`` picks the
    embedding head among two Linears (head + auxiliary class head) when
    neither or both give 1024 (``TEXT.DIMENSION``); with one Linear, or one
    of width 1024, it is inferred. ``meta`` is the JAX porter's (conv_channels,
    conv_kernel, conv_stride, conv_padding "torch", rnn_hidden, rnn_layers,
    bidirectional, pool, emb_dim, n_classes) plus ``n_mels``, the first
    conv's in-channels: ``SpeechEncoder(**meta)`` loads the state_dict
    strictly.
    """
    if isinstance(state_dict, (str, os.PathLike)):
        sd = load_torch_state_dict(state_dict)
    else:
        sd = normalize_state_dict(state_dict)
    sd = {k: torch.as_tensor(v).detach() for k, v in sd.items() if not k.endswith("num_batches_tracked")}

    convs: list[tuple[str, torch.Tensor]] = []  # (module, [O, I, K])
    bns: dict[str, dict[str, torch.Tensor]] = {}
    gru: dict[tuple[int, bool], dict[str, torch.Tensor]] = {}
    linears: list[tuple[str, torch.Tensor]] = []
    unmatched: list[str] = []
    conv_bias: list[str] = []
    for key, v in sd.items():
        m = _GRU_RE.match(key)
        if m is not None:
            gru.setdefault((int(m.group("layer")), m.group("rev") is not None), {})[m.group("kind")] = v
            continue
        mod, _, leaf = key.rpartition(".")
        if leaf == "weight" and v.ndim == 3:
            convs.append((mod, v))
        elif leaf == "bias" and v.ndim == 1 and any(c == mod for c, _ in convs):
            conv_bias.append(key)
        elif leaf in _BN_LEAVES and v.ndim == 1:
            bns.setdefault(mod, {})[leaf] = v
        elif leaf == "weight" and v.ndim == 2:
            linears.append((mod, v))
        else:
            unmatched.append(key)
    # the Linears' 1-d biases went into the BN groups above; a true BN group
    # has running statistics
    lin_bias = {}
    for mod, _ in linears:
        if mod in bns and set(bns[mod]) <= {"weight", "bias"}:
            lin_bias[mod] = bns.pop(mod).get("bias")

    problems: list[str] = []
    if conv_bias:
        problems.append(f"conv layers carry biases ({conv_bias[:3]}...) but the target "
                        "conv stack is bias-free (BN absorbs it)")
    if unmatched:
        problems.append(f"unclassifiable keys: {sorted(unmatched)[:8]}")
    for mod, leaves in bns.items():
        missing = set(_BN_LEAVES) - set(leaves)
        if missing:
            problems.append(f"BatchNorm {mod!r} missing {sorted(missing)}")
    if len(bns) != len(convs):
        problems.append(f"{len(convs)} convs vs {len(bns)} BatchNorms — topology is conv+BN pairs")
    if not convs:
        problems.append("no Conv1d weights ([O, I, K]) found")
    if not gru:
        problems.append("no GRU weights (weight_ih_l0 etc.) found")
    _fail(problems)

    # ---- conv/BN chain (insertion order == definition order) ----
    out: dict[str, torch.Tensor] = {}
    n_mels, kernel = convs[0][1].shape[1], convs[0][1].shape[2]
    conv_channels = []
    prev = n_mels
    for i, ((cmod, w), (bmod, bn)) in enumerate(zip(convs, bns.items())):
        o, c, k = w.shape
        if c != prev:
            problems.append(f"conv {cmod!r} expects {c} in-channels, previous stage emits {prev}")
        if k != kernel:
            problems.append(f"conv {cmod!r} kernel {k} != first conv's {kernel} "
                            "(the target stack uses one kernel size)")
        if bn["weight"].shape[0] != o:
            problems.append(f"BatchNorm {bmod!r} width {bn['weight'].shape[0]} != conv {cmod!r} out {o}")
        out[f"convs.{i}.weight"] = w
        for leaf in _BN_LEAVES:
            out[f"bns.{i}.{leaf}"] = bn[leaf]
        conv_channels.append(o)
        prev = o

    # ---- GRU layers ----
    layers = sorted({layer for layer, _ in gru})
    if layers != list(range(len(layers))):
        problems.append(f"non-contiguous GRU layers {layers}")
    bidirectional = (0, True) in gru
    first = gru.get((0, False), {})
    if "weight_hh" not in first:
        problems.append(f"GRU layer 0 forward incomplete: has {sorted(first)}")
        _fail(problems)
    hidden = first["weight_hh"].shape[1]
    for layer in layers:
        expect_in = prev if layer == 0 else hidden * (2 if bidirectional else 1)
        for rev in (False, True) if bidirectional else (False,):
            g = gru.get((layer, rev))
            sfx = "_reverse" if rev else ""
            if g is None or set(g) != {"weight_ih", "weight_hh", "bias_ih", "bias_hh"}:
                problems.append(f"GRU layer {layer} {'reverse' if rev else 'forward'} "
                                f"incomplete: has {sorted(g or {})}")
                continue
            if tuple(g["weight_ih"].shape) != (3 * hidden, expect_in):
                problems.append(f"GRU l{layer}{sfx} weight_ih {tuple(g['weight_ih'].shape)} != "
                                f"{(3 * hidden, expect_in)}")
                continue
            for kind, v in g.items():
                out[f"rnn.{kind}_l{layer}{sfx}"] = v

    # ---- heads: the pool falls out of the Linears' input width ----
    rnn_out = hidden * (2 if bidirectional else 1)
    pools = {rnn_out: "mean", 2 * rnn_out: "mean_max"}
    widths = {w.shape[1] for _, w in linears}
    pool = "mean"
    if len(widths) != 1 or next(iter(widths)) not in pools:
        problems.append(f"Linear input widths {sorted(widths)} do not match a pooled GRU output "
                        f"(expected {sorted(pools)} for hidden={hidden}, bidirectional={bidirectional})")
    else:
        # width rnn_out is 'mean' or 'max', which the shapes cannot tell
        # apart: 'mean' is assumed (validate the outputs)
        pool = pools[next(iter(widths))]
    head = cls = None
    if len(linears) == 1:
        head = linears[0]
    else:
        want = 1024 if emb_dim is None else int(emb_dim)
        match = [t for t in linears if t[1].shape[0] == want]
        if len(linears) == 2 and len(match) == 1:
            head = match[0]
            cls = next(t for t in linears if t is not head)
        else:
            problems.append(f"cannot identify the embedding head among "
                            f"{[(m, tuple(w.shape)) for m, w in linears]} — pass emb_dim=")
    _fail(problems)
    for name, lin in (("head", head), ("cls", cls)):
        if lin is None:
            continue
        mod, w = lin
        if lin_bias.get(mod) is None:
            raise ValueError(f"Linear {mod!r} has no bias (target has one)")
        out[f"{name}.weight"], out[f"{name}.bias"] = w, lin_bias[mod]

    meta = {
        "emb_dim": int(head[1].shape[0]),
        "conv_channels": tuple(int(c) for c in conv_channels),
        "conv_kernel": int(kernel),
        "conv_stride": int(conv_stride),
        "conv_padding": "torch",
        "rnn_hidden": int(hidden),
        "rnn_layers": len(layers),
        "bidirectional": bool(bidirectional),
        "pool": pool,
        "n_classes": int(cls[1].shape[0]) if cls is not None else 0,
        "n_mels": int(n_mels),
    }
    return {k: v.to("cpu", torch.float32).clone() for k, v in out.items()}, meta
