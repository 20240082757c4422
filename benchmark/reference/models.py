"""The model in plain float32 PyTorch: the speech encoder (strided Conv1d +
BatchNorm + ReLU, a bidirectional GRU, masked mean/max pooling, dense head
and class head), Conditioning Augmentation, the three-stage StackGAN-v2
generator and one discriminator per scale.

Parameter names and shapes follow the StackGAN-v2 and speech-encoder torch
layouts (``ca_net.fc.weight``, ``h_net1.fc.0.weight``,
``img_code_s16.0.weight``, ``rnn.weight_hh_l0_reverse``, ...), so that one
seeded state_dict loads into the reference and into the program alike.
BatchNorm uses the batch's statistics in train mode (biased variance
``max(0, E[x²] - E[x]²)``, running statistics moved with momentum 0.9) and
the running ones in eval mode. Every product's operands pass through
``precision`` (the control's rounding; the identity for the reference).
"""

from __future__ import annotations


import torch
import torch.nn.functional as F
from torch import nn

from reference import precision


class BatchNorm(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = [0, *range(2, x.ndim)]
            mean, var = x.mean(dims), torch.clamp((x * x).mean(dims) - x.mean(dims) ** 2, min=0.0)
            with torch.no_grad():
                m = 0.9
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean.view(shape)) * (torch.rsqrt(var + 1e-5) * self.weight).view(shape) + self.bias.view(shape)


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, bias=False, dims=2):
        super().__init__()
        shape = (cout, cin, k) if dims == 1 else (cout, cin, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.dims = stride, padding, dims

    def forward(self, x):
        conv = F.conv1d if self.dims == 1 else F.conv2d
        y = conv(precision.low(x), precision.low(self.weight), None, self.stride, self.padding)
        return y if self.bias is None else y + self.bias.view((1, -1) + (1,) * (y.ndim - 2))


class Dense(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        y = precision.low(x) @ precision.low(self.weight).T
        return y if self.bias is None else y + self.bias


def glu(x, dim=1):
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


class GLU(nn.Module):
    def forward(self, x):
        return glu(x, 1)


class Leaky(nn.Module):
    def forward(self, x):
        return F.leaky_relu(x, 0.2)


class Identity(nn.Module):
    def forward(self, x):
        return x


class Up(nn.Module):
    """Nearest ×2, then a 3×3 'same' conv with no bias."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return F.conv2d(precision.low(x), precision.low(self.weight), None, 1, 1)


def up_block(cin, cout):
    return nn.Sequential(Identity(), Up(cin, cout * 2), BatchNorm(cout * 2), GLU())


def block3x3_glu(cin, cout):
    return nn.Sequential(Conv(cin, cout * 2, 3, padding=1), BatchNorm(cout * 2), GLU())


class ResBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.block = nn.Sequential(Conv(c, c * 2, 3, padding=1), BatchNorm(c * 2), GLU(),
                                   Conv(c, c, 3, padding=1), BatchNorm(c))

    def forward(self, x):
        return x + self.block(x)


class CANet(nn.Module):
    def __init__(self, t_dim, c_dim):
        super().__init__()
        self.c_dim = c_dim
        self.fc = Dense(t_dim, c_dim * 4)

    def forward(self, emb):
        x = glu(self.fc(emb), -1)
        return x[:, : self.c_dim], x[:, self.c_dim:]


class InitStage(nn.Module):
    def __init__(self, ngf, z_dim, c_dim):
        super().__init__()
        self.ngf = ngf
        self.fc = nn.Sequential(Dense(z_dim + c_dim, ngf * 32, bias=False), BatchNorm(ngf * 32), GLU())
        self.upsample1 = up_block(ngf, ngf // 2)
        self.upsample2 = up_block(ngf // 2, ngf // 4)
        self.upsample3 = up_block(ngf // 4, ngf // 8)
        self.upsample4 = up_block(ngf // 8, ngf // 16)

    def forward(self, z, c):
        x = self.fc(torch.cat([c, z], 1)).view(-1, self.ngf, 4, 4)
        return self.upsample4(self.upsample3(self.upsample2(self.upsample1(x))))


class NextStage(nn.Module):
    def __init__(self, ngf, c_dim, num_res):
        super().__init__()
        self.jointConv = block3x3_glu(ngf + c_dim, ngf)
        self.residual = nn.Sequential(*[ResBlock(ngf) for _ in range(num_res)])
        self.upsample = up_block(ngf, ngf // 2)

    def forward(self, h, c):
        c = c[:, :, None, None].expand(-1, -1, h.shape[2], h.shape[3])
        return self.upsample(self.residual(self.jointConv(torch.cat([c, h], 1))))


class ToRGB(nn.Module):
    def __init__(self, ngf):
        super().__init__()
        self.img = nn.Sequential(Conv(ngf, 3, 3, padding=1))

    def forward(self, h):
        return torch.tanh(self.img(h))


class Generator(nn.Module):
    """CA + generator: ``forward(z, c)`` → one NCHW image per stage in [-1, 1]."""

    def __init__(self, gf=64, z_dim=100, c_dim=128, t_dim=1024, branches=3, num_res=2):
        super().__init__()
        self.branches, self.z_dim = branches, z_dim
        self.ca_net = CANet(t_dim, c_dim)
        self.h_net1 = InitStage(gf * 16, z_dim, c_dim)
        self.img_net1 = ToRGB(gf)
        ngf = gf
        for i in range(2, branches + 1):
            setattr(self, f"h_net{i}", NextStage(ngf, c_dim, num_res))
            setattr(self, f"img_net{i}", ToRGB(ngf // 2))
            ngf //= 2

    def forward(self, z, c):
        h = self.h_net1(z, c)
        imgs = [self.img_net1(h)]
        for i in range(2, self.branches + 1):
            h = getattr(self, f"h_net{i}")(h, c)
            imgs.append(getattr(self, f"img_net{i}")(h))
        return imgs


def down_block(cin, cout):
    return [Conv(cin, cout, 4, stride=2, padding=1), BatchNorm(cout), Leaky()]


def block3x3_leaky(cin, cout):
    return nn.Sequential(Conv(cin, cout, 3, padding=1), BatchNorm(cout), Leaky())


class DLogits(nn.Module):
    def __init__(self, ndf, nef, cond):
        super().__init__()
        if cond:
            self.jointConv = block3x3_leaky(ndf * 8 + nef, ndf * 8)
        self.outlogits = nn.Sequential(Conv(ndf * 8, 1, 4, stride=4, bias=True))

    def forward(self, code, c=None):
        if c is not None:
            c = c[:, :, None, None].expand(-1, -1, code.shape[2], code.shape[3])
            code = self.jointConv(torch.cat([code, c], 1))
        return self.outlogits(code).view(-1)


TRUNK = {64: (), 128: ("img_code_s32", "img_code_s32_1"),
         256: ("img_code_s32", "img_code_s64", "img_code_s64_1", "img_code_s64_2")}


class Discriminator(nn.Module):
    def __init__(self, scale, ndf=64, nef=128):
        super().__init__()
        self.scale = scale
        self.img_code_s16 = nn.Sequential(Conv(3, ndf, 4, stride=2, padding=1), Leaky(),
                                          *down_block(ndf, ndf * 2), *down_block(ndf * 2, ndf * 4),
                                          *down_block(ndf * 4, ndf * 8))
        if scale >= 128:
            self.img_code_s32 = nn.Sequential(*down_block(ndf * 8, ndf * 16))
        if scale == 128:
            self.img_code_s32_1 = block3x3_leaky(ndf * 16, ndf * 8)
        if scale == 256:
            self.img_code_s64 = nn.Sequential(*down_block(ndf * 16, ndf * 32))
            self.img_code_s64_1 = block3x3_leaky(ndf * 32, ndf * 16)
            self.img_code_s64_2 = block3x3_leaky(ndf * 16, ndf * 8)
        self.logits = DLogits(ndf, nef, True)
        self.uncond_logits = DLogits(ndf, nef, False)

    def trunk(self, img):
        x = self.img_code_s16(img)
        for name in TRUNK[self.scale]:
            x = getattr(self, name)(x)
        return x

    def forward(self, img, c):
        code = self.trunk(img)
        return self.logits(code, c), self.uncond_logits(code)


def same_pads(t, k, s):
    out = -(-t // s)
    total = max((out - 1) * s + k - t, 0)
    return total // 2, total - total // 2


class BiGRU(nn.Module):
    """One bidirectional GRU layer, gates r | z | n, b_hn inside r · (...);
    the reverse direction runs backwards over the whole padded sequence;
    a masked step carries h."""

    def __init__(self, cin, hidden):
        super().__init__()
        self.hidden = hidden
        for sfx in ("", "_reverse"):
            for name, shape in (("weight_ih", (3 * hidden, cin)), ("weight_hh", (3 * hidden, hidden)),
                                ("bias_ih", (3 * hidden,)), ("bias_hh", (3 * hidden,))):
                self.register_parameter(f"{name}_l0{sfx}", nn.Parameter(torch.zeros(shape)))

    def _direction(self, x, mask, sfx, reverse):
        w_ih, w_hh = getattr(self, f"weight_ih_l0{sfx}"), getattr(self, f"weight_hh_l0{sfx}")
        b_ih, b_hh = getattr(self, f"bias_ih_l0{sfx}"), getattr(self, f"bias_hh_l0{sfx}")
        xw = precision.low(x) @ precision.low(w_ih).T + b_ih  # [B, T, 3H]
        h = x.new_zeros(x.shape[0], self.hidden)
        ys = [None] * x.shape[1]
        steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
        w = precision.f32(w_hh).T
        for t in steps:
            hw = precision.f32(h) @ w + b_hh
            xr, xz, xn = xw[:, t].chunk(3, -1)
            hr, hz, hn = hw.chunk(3, -1)
            r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = torch.where(mask[:, t, None], (1 - z) * n + z * h, h)
            ys[t] = h
        return torch.stack(ys, 1)

    def forward(self, x, mask):
        return torch.cat([self._direction(x, mask, "", False), self._direction(x, mask, "_reverse", True)], -1)


class SpeechEncoder(nn.Module):
    """feats [B, T, n_mels], mask [B, T] → emb [B, emb_dim] (and class logits)."""

    def __init__(self, n_mels=40, emb_dim=1024, channels=(64, 128, 256), kernel=5, stride=2, hidden=512,
                 n_classes=0):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        chans = (n_mels, *channels)
        self.convs = nn.ModuleList(Conv(i, o, kernel, stride=stride, dims=1) for i, o in zip(chans[:-1], chans[1:]))
        self.bns = nn.ModuleList(BatchNorm(o) for o in channels)
        self.rnn = BiGRU(chans[-1], hidden)
        self.head = Dense(4 * hidden, emb_dim)
        self.cls = Dense(4 * hidden, n_classes) if n_classes else None

    def forward(self, feats, mask):
        x = (feats * mask[:, :, None]).transpose(1, 2)
        for conv, bn in zip(self.convs, self.bns):
            x = torch.relu(bn(conv(F.pad(x, same_pads(x.shape[-1], self.kernel, self.stride)))))
            mask = mask[:, :: self.stride][:, : x.shape[-1]]
        x = self.rnn(x.transpose(1, 2), mask)
        m = mask[:, :, None].float()
        n = m.sum(1)
        mean = (x * m).sum(1) / n.clamp(min=1.0)
        mx = torch.where(m > 0, x, torch.full_like(x, -1e30)).amax(1)
        pooled = torch.cat([mean, torch.where(n > 0, mx, torch.zeros_like(mx))], -1)
        emb = self.head(pooled)
        return (emb, self.cls(pooled)) if self.cls is not None else emb


def build(cfg: dict, part: str, joint: bool = False) -> nn.Module:
    """``part``: "g" (CA + G), "d64" / "d128" / "d256", or "encoder" (with the
    class head unless ``joint`` or ``ENCODER.CLS_HEAD`` is off)."""
    gan, e = cfg["GAN"], cfg["ENCODER"]
    if part == "g":
        return Generator(gan["GF_DIM"], gan["Z_DIM"], gan["EMBEDDING_DIM"], cfg["TEXT"]["DIMENSION"],
                         cfg["TREE"]["BRANCH_NUM"], gan["R_NUM"])
    if part.startswith("d"):
        return Discriminator(int(part[1:]), gan["DF_DIM"], gan["EMBEDDING_DIM"])
    if part == "encoder":
        n_classes = 0 if joint or not e["CLS_HEAD"] else e["N_CLASSES"]
        return SpeechEncoder(cfg["AUDIO"]["N_MELS"], cfg["TEXT"]["DIMENSION"], tuple(e["CONV_CHANNELS"]),
                             e["CONV_KERNEL"], e["CONV_STRIDE"], e["RNN_HIDDEN"], n_classes)
    raise ValueError(part)


def check_supported(cfg: dict) -> None:
    """The reference covers the architecture the configurations state."""
    e, g = cfg["ENCODER"], cfg["GAN"]
    want = [(e["CONV_PADDING"], "SAME"), (e["RNN_LAYERS"], 1), (e["BIDIRECTIONAL"], True),
            (e["POOL"], "mean_max"), (e["NORM_OUT"], False), (g["B_CONDITION"], True),
            (cfg["TRAIN"]["WRONG_PAIR"], "roll"), (cfg["TRAIN"]["OPTIMIZER"], "adam"),
            (cfg["TRAIN"]["MOMENT_DTYPE"], "float32")]
    for got, w in want:
        if got != w:
            raise ValueError(f"the reference model takes {w!r}, the configuration states {got!r}")
