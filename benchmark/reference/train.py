"""Training steps in plain float32 PyTorch.

``gan_step``: the conditional StackGAN-v2 step with the speech-embedding
condition. One generator forward (joint mode: the speech encoder first, in
train mode, on the batch's log-mel features); the D phase, each D on
(real, wrong pair = the conditions rolled by one, detached fake) with one
backward over the sum of the scales' losses and an Adam step per D; the G
phase against the updated Ds (per-scale non-saturating terms, KL of the CA
posterior, the color-consistency term between consecutive stages and, in
joint mode, the distillation MSE to the teacher), one Adam step over G, CA
and the encoder; the Polyak average of G's parameters (decay 0 for the
first ``EMA_WARMUP`` steps).

``encoder_step``: MSE to the teacher embedding plus ``CE_COEFF`` times the
class cross-entropy, one Adam step.

Each returns its losses; the first gradients stay on the parameters'
``.grad`` until the next step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import audio


def bce(logits, target: float):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


def images_pyramid(images_u8: torch.Tensor, branches: int) -> list[torch.Tensor]:
    """uint8 NHWC top-scale images → float NCHW in [-1, 1], smallest scale first
    (each lower scale the 2× area mean of the next)."""
    top = images_u8.float().permute(0, 3, 1, 2) / 127.5 - 1.0
    out = [top]
    for _ in range(branches - 1):
        out.insert(0, F.avg_pool2d(out[0], 2))
    return out


def step_noise(seed: int, step: int, b: int, z_dim: int, c_dim: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The noise of training step ``step``: z and the CA eps from a generator
    on the device seeded with (SEED, step)."""
    gen = torch.Generator(device=device).manual_seed(seed * 2**32 + step)
    return (torch.randn(b, z_dim, generator=gen, device=device),
            torch.randn(b, c_dim, generator=gen, device=device))


def adam(params, lr: float, beta1: float, beta2: float = 0.999):
    return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=1e-8, foreach=False)


def color_loss(imgs: list[torch.Tensor]) -> torch.Tensor:
    def stats(img):
        b, c, h, w = img.shape
        x = img.reshape(b, c, h * w)
        mu = x.mean(2)
        xc = x - mu[:, :, None]
        return mu, xc @ xc.transpose(1, 2) / (h * w - 1)

    loss = imgs[0].new_zeros(())
    s = [stats(i) for i in imgs]
    for (m1, c1), (m2, c2) in zip(s[:-1], s[1:]):
        loss = loss + (m1 - m2).square().sum(-1).mean() + 5.0 * (c1 - c2).square().sum((-2, -1)).mean()
    return loss


class GanReference:
    """G (with CA), the Ds and, in joint mode, the encoder, with their Adams
    and the EMA copy; ``step(batch, z, eps)`` runs one training step."""

    def __init__(self, cfg: dict, g, ds, encoder=None):
        t = cfg["TRAIN"]
        self.cfg, self.g, self.ds, self.encoder = cfg, g, list(ds), encoder
        self.coeff = t["COEFF"]
        self.geom = audio.geometry(cfg["AUDIO"])
        g_params = list(g.parameters()) + (list(encoder.parameters()) if encoder is not None else [])
        self.g_opt = adam(g_params, t["GENERATOR_LR"], t["ADAM_BETA1"], t["ADAM_BETA2"])
        self.d_opts = [adam(d.parameters(), t["DISCRIMINATOR_LR"], t["ADAM_BETA1"], t["ADAM_BETA2"]) for d in self.ds]
        self.ema = {n: p.detach().clone() for n, p in g.named_parameters()}
        self.step_index = 0

    def step(self, batch: dict, z: torch.Tensor, eps: torch.Tensor) -> dict:
        c = self.coeff
        for m in (self.g, *self.ds, self.encoder):
            if m is not None:
                m.train()
        reals = images_pyramid(batch["images"], len(self.ds))
        if self.encoder is not None:
            feats, mask = audio.features(batch["wav"], batch["wav_len"], self.geom)
            emb = self.encoder(feats, mask)
        else:
            emb = batch["embedding"].float()
        mu, logvar = self.g.ca_net(emb)
        fakes = self.g(z, mu + eps * torch.exp(0.5 * logvar))

        cond = mu.detach()
        wrong = torch.roll(cond, 1, 0)
        d_total = mu.new_zeros(())
        u = float(c["UNCOND_LOSS"])
        for d, real, fake in zip(self.ds, reals, fakes):
            code_r, code_f = d.trunk(real), d.trunk(fake.detach())
            unc_r, cond_r = d.uncond_logits(code_r), d.logits(code_r, cond)
            cond_w = d.logits(code_r, wrong)
            unc_f, cond_f = d.uncond_logits(code_f), d.logits(code_f, cond)
            d_total = d_total + bce(cond_r, 1.0) + bce(cond_w, 0.0) + bce(cond_f, 0.0) \
                + u * (bce(unc_r, 1.0) + bce(unc_r, 1.0) + bce(unc_f, 0.0))
        for o in self.d_opts:
            o.zero_grad(set_to_none=True)
        d_total.backward()
        for o in self.d_opts:
            o.step()

        saved = [(b, b.clone()) for d in self.ds for b in d.buffers()]
        for d in self.ds:
            d.requires_grad_(False)
        adv = mu.new_zeros(())
        for d, fake in zip(self.ds, fakes):
            cond_f, unc_f = d(fake, mu)
            adv = adv + bce(cond_f, 1.0) + u * bce(unc_f, 1.0)
        for d in self.ds:
            d.requires_grad_(True)
        with torch.no_grad():
            for b, old in saved:
                b.copy_(old)
        kl = -0.5 * torch.mean(1.0 + logvar - mu.square() - logvar.exp())
        g_total = adv + float(c["KL"]) * kl
        if float(c["COLOR_LOSS"]) > 0 and len(fakes) > 1:
            g_total = g_total + float(c["COLOR_LOSS"]) * color_loss(fakes)
        if self.encoder is not None and float(c["DISTILL"]) > 0:
            g_total = g_total + float(c["DISTILL"]) * torch.mean((emb - batch["teacher"].float()).square())
        self.g_opt.zero_grad(set_to_none=True)
        g_total.backward()
        self.g_opt.step()
        decay = 0.0 if self.step_index < int(self.cfg["TRAIN"]["EMA_WARMUP"]) else float(self.cfg["TRAIN"]["EMA_G"])
        with torch.no_grad():
            for n, p in self.g.named_parameters():
                self.ema[n].mul_(decay).add_(p, alpha=1.0 - decay)
        self.step_index += 1
        return {"d_loss": float(d_total.detach()), "g_loss": float(g_total.detach())}

    def leaves(self) -> dict[str, torch.Tensor]:
        """Every trained tensor by the harness's leaf names."""
        out = {f"g.{n}": p for n, p in self.g.named_parameters()}
        for i, d in enumerate(self.ds):
            out.update({f"d{i}.{n}": p for n, p in d.named_parameters()})
        if self.encoder is not None:
            out.update({f"enc.{n}": p for n, p in self.encoder.named_parameters()})
        out.update({f"ema.{n}": t for n, t in self.ema.items()})
        return out


class EncoderReference:
    def __init__(self, cfg: dict, encoder):
        e = cfg["ENCODER"]
        self.encoder, self.ce = encoder, float(e["CE_COEFF"]) if e["CLS_HEAD"] else 0.0
        self.geom = audio.geometry(cfg["AUDIO"])
        self.opt = adam(encoder.parameters(), float(e["LR"]), 0.9)

    def step(self, batch: dict) -> dict:
        self.encoder.train()
        feats, mask = audio.features(batch["wav"], batch["wav_len"], self.geom)
        out = self.encoder(feats, mask)
        emb, logits = out if isinstance(out, tuple) else (out, None)
        loss = torch.mean((emb - batch["teacher"].float()).square())
        if self.ce > 0 and logits is not None:
            loss = loss + self.ce * F.cross_entropy(logits, batch["class_id"].long())
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return {"loss": float(loss.detach())}

    def leaves(self) -> dict[str, torch.Tensor]:
        return {f"enc.{n}": p for n, p in self.encoder.named_parameters()}
