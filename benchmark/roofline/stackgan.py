"""FLOPs of the model's work, from the configuration's shapes: the products
of every convolution and dense layer (2 per multiply-add), as
``torch.utils.flop_counter`` counts them; normalization, activations and
losses are left out. A training step counts each forward once and its
backward twice (the weights' and the inputs' gradients); the G phase's
pass through the frozen Ds counts its forward and its input gradients.

An up-block's 3×3 convolution of a nearest-×2 upsample needs ``taps`` = 4
multiply-adds per output pixel and channel pair (each output pixel sees a
2×2 neighbourhood of the input); ``taps`` = 9 counts it as the plain
upsample-then-convolve (what the reference computes).

The encoder's convolutions and input projection run over every frame of
the fixed-length input (MAX_FRAMES); the recurrence's product only over
the valid (row, step) pairs, as a masked step needs no work.
"""

from __future__ import annotations

from roofline import k1_logmel, shapes


def conv(b, cin, cout, k, out_hw):
    return 2.0 * b * cin * cout * k * out_hw


def g_forward(cfg: dict, b: int, taps: int = 4) -> float:
    gan = cfg["GAN"]
    gf, z, c, t_dim = int(gan["GF_DIM"]), int(gan["Z_DIM"]), int(gan["EMBEDDING_DIM"]), int(cfg["TEXT"]["DIMENSION"])
    ngf = gf * 16
    f = 2.0 * b * t_dim * 4 * c  # CA
    f += 2.0 * b * (z + c) * ngf * 32  # init fc
    ch, res = ngf, 4
    for _ in range(4):
        res *= 2
        f += conv(b, ch, ch, taps, res * res)  # up-block: 2·(ch/2) outputs
        ch //= 2
    f += conv(b, ch, 3, 9, res * res)  # to RGB at 64 px
    for _ in range(1, int(cfg["TREE"]["BRANCH_NUM"])):
        f += conv(b, ch + c, 2 * ch, 9, res * res)  # joint conv
        f += int(gan["R_NUM"]) * (conv(b, ch, 2 * ch, 9, res * res) + conv(b, ch, ch, 9, res * res))
        res *= 2
        f += conv(b, ch, ch, taps, res * res)
        ch //= 2
        f += conv(b, ch, 3, 9, res * res)
    return f


def d_trunk(cfg: dict, b: int, scale: int) -> float:
    ndf = int(cfg["GAN"]["DF_DIM"])
    f, res, ch = conv(b, 3, ndf, 16, (scale // 2) ** 2), scale // 2, ndf
    for _ in range(3):
        res //= 2
        f += conv(b, ch, 2 * ch, 16, res * res)
        ch *= 2
    if scale == 128:
        f += conv(b, 8 * ndf, 16 * ndf, 16, 16) + conv(b, 16 * ndf, 8 * ndf, 9, 16)
    if scale == 256:
        f += conv(b, 8 * ndf, 16 * ndf, 16, 64) + conv(b, 16 * ndf, 32 * ndf, 16, 16)
        f += conv(b, 32 * ndf, 16 * ndf, 9, 16) + conv(b, 16 * ndf, 8 * ndf, 9, 16)
    return f


def d_cond_head(cfg: dict, b: int) -> float:
    ndf, nef = int(cfg["GAN"]["DF_DIM"]), int(cfg["GAN"]["EMBEDDING_DIM"])
    return conv(b, 8 * ndf + nef, 8 * ndf, 9, 16) + d_uncond_head(cfg, b)


def d_uncond_head(cfg: dict, b: int) -> float:
    return conv(b, 8 * int(cfg["GAN"]["DF_DIM"]), 1, 16, 1)


def scales(cfg: dict) -> list[int]:
    return [64 * 2**i for i in range(int(cfg["TREE"]["BRANCH_NUM"]))]


def d_phase_forward(cfg: dict, b: int) -> float:
    """Every D on real and fake: two trunks, three conditional heads (real,
    wrong pair, fake), two unconditional ones."""
    return sum(2 * d_trunk(cfg, b, s) + 3 * d_cond_head(cfg, b) + 2 * d_uncond_head(cfg, b) for s in scales(cfg))


def d_fake_forward(cfg: dict, b: int) -> float:
    return sum(d_trunk(cfg, b, s) + d_cond_head(cfg, b) + d_uncond_head(cfg, b) for s in scales(cfg))


def encoder_forward(cfg: dict, lengths, cls_head: bool) -> float:
    e = cfg["ENCODER"]
    b = len(lengths)
    t, f = int(cfg["AUDIO"]["MAX_FRAMES"]), 0.0
    chans = [int(cfg["AUDIO"]["N_MELS"]), *map(int, e["CONV_CHANNELS"])]
    for cin, cout in zip(chans[:-1], chans[1:]):
        t = -(-t // int(e["CONV_STRIDE"]))
        f += 2.0 * b * cin * cout * int(e["CONV_KERNEL"]) * t
    d, h = (2 if e["BIDIRECTIONAL"] else 1), int(e["RNN_HIDDEN"])
    f += d * 2.0 * b * t * chans[-1] * 3 * h  # input projection
    f += d * 2.0 * sum(shapes.valid_steps(int(n), cfg) for n in lengths) * h * 3 * h  # recurrence
    pooled = 2 * d * h
    f += 2.0 * b * pooled * int(cfg["TEXT"]["DIMENSION"])
    if cls_head:
        f += 2.0 * b * pooled * int(e["N_CLASSES"])
    return f


def logmel(cfg: dict, rec: dict) -> float:
    c = k1_logmel.cost(cfg, rec)
    return c[0] if c else 0.0


def step_flops(cfg: dict, rec: dict) -> float:
    """The FLOPs of one step (the work record of a task)."""
    kind, b = rec["model"], int(rec["batch"])
    if kind in ("gan", "joint"):
        g = g_forward(cfg, b)
        f = 3 * g + 3 * d_phase_forward(cfg, b) + 2 * d_fake_forward(cfg, b)
        if kind == "joint":
            f += logmel(cfg, rec) + 3 * encoder_forward(cfg, rec["gru"], cls_head=False)
        return f
    if kind == "encoder":
        return logmel(cfg, rec) + 3 * encoder_forward(cfg, rec["gru"], cls_head=bool(cfg["ENCODER"]["CLS_HEAD"]))
    raise ValueError(f"unknown work record {kind!r}")
