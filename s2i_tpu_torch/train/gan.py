"""Alternating G/D conditional-GAN training, the counterpart of
``s2i_tpu/train/gan.py`` (frozen-embedding and joint speech-encoder modes).

One step, in the JAX package's order (``make_train_step``):
  1. draw z and the CA noise, run ONE generator forward with G's BN in
     train mode (in joint mode the speech encoder first, also in train
     mode, on the batch's log-mel features): (fakes, μ, logσ², emb);
  2. D phase: each D on (real, wrong pair, detached fake) with conditions
     μ.detach() and its wrong-pair permutation (``TRAIN.WRONG_PAIR`` roll or
     class_aware); one backward over the sum, one optimizer step per D;
  3. G phase against the UPDATED Ds: per-scale adversarial terms + KL·kl
     (+ COLOR·color consistency, + DISTILL·mse to the teacher in joint mode),
     backward through the same generator graph, one optimizer step over G,
     CA (and the encoder). The Ds run in train mode here too (batch
     statistics of the fakes), but the running statistics they would fold
     in are discarded, as the JAX step keeps the D phase's, and no gradient
     of this phase reaches a D parameter;
  4. Polyak average (EMA) of the generator's parameters, CA included, with
     decay 0 for the first ``TRAIN.EMA_WARMUP`` steps.

The models compute in ``DTYPE.COMPUTE`` (bfloat16 in the shipped cfgs)
with float32 parameters, at the JAX package's cast points
(``models/layers.py``); losses, the CA sample and KL, images and logits
are float32. ``GAN.UPSAMPLE_MODE`` picks the up-convolution's numerics.
``TRAIN.MOMENT_DTYPE=bfloat16`` keeps Adam's moments of the large leaves
in bfloat16 (:class:`CastMomentAdam`). The layout levers of the JAX package
(``GAN.S2D``, ``GAN.S2D_MID``, ``GAN.D_TRUNK_BATCH``, ``GAN.REMAT``) are the
same math in another layout; the port computes the plain formulation
whatever they say.

    state = init_state(cfg)                      # on the card, seeded
    metrics = train_step(state, batch)           # {"d_loss", "g_loss", ...}
    ckpt = state.state_dict()                    # load_state_dict(ckpt) resumes

Evaluation (forward only): ``bn_recalc`` re-estimates G's BatchNorm
statistics under the EMA weights, ``sampling_generator`` is the G to sample
from and ``sample`` draws images from it with noise keyed by each example's
global index.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import torch
from torch import nn

from s2i_tpu_torch.device import compute_dtype, moment_dtype, resolve_device
from s2i_tpu_torch.models.ca_net import kl_divergence
from s2i_tpu_torch.models.discriminator import DNet, build_discriminators
from s2i_tpu_torch.models.encoder import SpeechEncoder
from s2i_tpu_torch.models.generator import GNet
from s2i_tpu_torch.models.layers import BatchNorm
from s2i_tpu_torch.pipeline import build_encoder, build_generator
from s2i_tpu_torch.train import encoder as encoder_train
from s2i_tpu_torch.train import losses
from s2i_tpu_torch.utils.checkpoint import load_optimizer


@dataclasses.dataclass
class GanModels:
    g: GNet  # CA net included, as ``g.ca_net``
    ds: list[DNet]
    encoder: SpeechEncoder | None = None  # joint mode


def build_models(cfg, joint: bool = False) -> GanModels:
    """G (with CA), one D per scale and, in joint mode, the speech encoder
    without a class head; all on the CPU, not initialized."""
    ds = build_discriminators(int(cfg.TREE.BRANCH_NUM), int(cfg.GAN.DF_DIM),
                              int(cfg.GAN.EMBEDDING_DIM), bool(cfg.GAN.B_CONDITION), compute_dtype(cfg))
    return GanModels(build_generator(cfg), ds, build_encoder(cfg, joint=True) if joint else None)


@torch.no_grad()
def init_weights(g: GNet, ds: list[DNet], gen: torch.Generator) -> None:
    """The JAX package's GAN init (``s2i_tpu/models/layers.py``), every draw
    from ``gen``: orthogonal conv and linear kernels, zero biases, BN scale
    ~ N(1, 0.02) with bias 0, running statistics 0 and 1."""
    for m in (mod for net in (g, *ds) for mod in net.modules()):
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.orthogonal_(m.weight, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.normal_(1.0, 0.02, generator=gen)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


class CastMomentAdam(torch.optim.Adam):
    """``torch.optim.Adam`` whose leaves of at least ``min_size`` elements
    keep ``exp_avg`` and ``exp_avg_sq`` in ``moment_dtype``, the JAX
    package's ``_scale_by_adam_cast`` (``TRAIN.MOMENT_DTYPE``): such a
    leaf's update runs in float32 with optax's formula (the bias corrected
    by the count, eps outside the square root) and its moments are cast
    back. Smaller leaves take ``torch.optim.Adam``'s own step, whose
    moments keep the parameter's type (torch's foreach and fused Adam need
    that). The state_dict has ``torch.optim.Adam``'s layout, the large
    leaves' moments in ``moment_dtype``."""

    def __init__(self, params, lr: float, betas: tuple[float, float], eps: float,
                 moment_dtype: torch.dtype, min_size: int):
        super().__init__(params, lr=lr, betas=betas, eps=eps)
        self.moment_dtype, self.min_size = moment_dtype, min_size

    def _cast(self, p: torch.Tensor) -> bool:
        return p.numel() >= self.min_size

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CastMomentAdam takes no closure")
        cast = [p for group in self.param_groups for p in group["params"] if p.grad is not None and self._cast(p)]
        grads = [p.grad for p in cast]
        for p in cast:  # torch.optim.Adam skips a parameter with no gradient
            p.grad = None
        try:
            super().step()
        finally:
            for p, grad in zip(cast, grads):
                p.grad = grad
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None or not self._cast(p):
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.moment_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=self.moment_dtype)
                g = p.grad.float()
                m = b1 * st["exp_avg"].float() + (1.0 - b1) * g
                v = b2 * st["exp_avg_sq"].float() + (1.0 - b2) * g.square()
                st["step"] += 1
                bc1, bc2 = 1.0 - b1 ** st["step"], 1.0 - b2 ** st["step"]
                p.add_(-group["lr"] * ((m / bc1) / (torch.sqrt(v / bc2) + group["eps"])))
                st["exp_avg"].copy_(m)
                st["exp_avg_sq"].copy_(v)

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)  # casts every moment to its parameter's type
        for p, st in self.state.items():
            if self._cast(p):
                for k in ("exp_avg", "exp_avg_sq"):
                    st[k] = st[k].to(self.moment_dtype)


def make_optimizer(cfg, params, lr: float) -> torch.optim.Optimizer:
    """``TRAIN.OPTIMIZER``: Adam with the cfg's betas (optax ``adam``: eps
    1e-8 outside the square root) or plain SGD. ``TRAIN.MOMENT_DTYPE``
    float32 is ``torch.optim.Adam``; bfloat16 is :class:`CastMomentAdam`
    over leaves of at least ``TRAIN.MOMENT_DTYPE_MIN_SIZE`` elements."""
    name = str(cfg.TRAIN.OPTIMIZER).lower()
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if name != "adam":
        raise ValueError(f"unknown TRAIN.OPTIMIZER {name!r}")
    betas = (float(cfg.TRAIN.ADAM_BETA1), float(cfg.TRAIN.ADAM_BETA2))
    mdt = moment_dtype(cfg)
    if mdt == torch.float32:
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    return CastMomentAdam(params, lr, betas, 1e-8, mdt, int(cfg.TRAIN.MOMENT_DTYPE_MIN_SIZE))


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """What the step reads from the cfg."""

    branch_num: int
    z_dim: int
    c_dim: int
    b_condition: bool
    uncond: float
    kl: float
    color: float
    distill: float
    ema_decay: float
    ema_warmup: int
    wrong_pair: str
    seed: int

    @classmethod
    def from_cfg(cls, cfg) -> "StepConfig":
        c = cfg.TRAIN.COEFF
        return cls(int(cfg.TREE.BRANCH_NUM), int(cfg.GAN.Z_DIM), int(cfg.GAN.EMBEDDING_DIM),
                   bool(cfg.GAN.B_CONDITION), float(c.UNCOND_LOSS), float(c.KL),
                   float(c.COLOR_LOSS), float(c.DISTILL), float(cfg.TRAIN.EMA_G),
                   int(cfg.TRAIN.EMA_WARMUP), str(cfg.TRAIN.WRONG_PAIR).lower(), int(cfg.SEED))


def g_opt_names(models: GanModels) -> list[str]:
    """The parameters of G's optimizer group, in its order: G's (CA
    included), then in joint mode the encoder's."""
    names = [f"g.{n}" for n, _ in models.g.named_parameters()]
    if models.encoder is not None:
        names += [f"enc.{n}" for n, _ in models.encoder.named_parameters()]
    return names


@dataclasses.dataclass
class GanTrainState:
    models: GanModels
    g_opt: torch.optim.Optimizer  # over G, CA and, in joint mode, the encoder
    d_opts: list[torch.optim.Optimizer]
    ema: dict[str, torch.Tensor]  # Polyak copy of g's parameters; {} when EMA_G is 0
    sc: StepConfig
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.models.g.parameters()).device

    def state_dict(self) -> dict:
        """Everything an exact resume needs: each module's parameters and
        buffers (G with CA, every D, the joint encoder), every optimizer's
        state, the EMA copy and the step. Nothing else is: the step noise is
        keyed by (SEED, step) (:func:`step_noise`) and the synthetic batch
        stream by (SEED, epoch). ``g_opt_names`` records the order of G's
        optimizer group, which the optimizer's state is indexed by."""
        m = self.models
        return {
            "step": self.step,
            "g": m.g.state_dict(),
            "ds": [d.state_dict() for d in m.ds],
            "enc": None if m.encoder is None else m.encoder.state_dict(),
            "g_opt": self.g_opt.state_dict(),
            "g_opt_names": g_opt_names(m),
            "d_opts": [o.state_dict() for o in self.d_opts],
            "ema": dict(self.ema),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Load what :meth:`state_dict` returned (from any device) into this
        state's tensors; raises ValueError where the two states differ in
        kind (joint or not, number of Ds, EMA or not) or in layout."""
        m = self.models
        if (sd["enc"] is None) != (m.encoder is None) or len(sd["ds"]) != len(m.ds):
            raise ValueError(
                f"checkpoint of a {'frozen' if sd['enc'] is None else 'joint'} state with "
                f"{len(sd['ds'])} Ds, this state is {'frozen' if m.encoder is None else 'joint'} "
                f"with {len(m.ds)}"
            )
        if list(sd["g_opt_names"]) != g_opt_names(m):
            raise ValueError("the checkpoint's G optimizer group holds other parameters, or another order")
        if sd["ema"].keys() != self.ema.keys():
            raise ValueError("the checkpoint's EMA covers other parameters (TRAIN.EMA_G on one side only?)")
        m.g.load_state_dict(sd["g"])
        for d, dsd in zip(m.ds, sd["ds"]):
            d.load_state_dict(dsd)
        if m.encoder is not None:
            m.encoder.load_state_dict(sd["enc"])
        load_optimizer(self.g_opt, sd["g_opt"], "g_opt")
        for i, (opt, osd) in enumerate(zip(self.d_opts, sd["d_opts"])):
            load_optimizer(opt, osd, f"d_opts[{i}]")
        with torch.no_grad():
            for name, t in self.ema.items():
                t.copy_(sd["ema"][name])
        self.step = int(sd["step"])


def init_state(cfg, device: str | torch.device = "cuda") -> GanTrainState:
    """Models of ``cfg`` on ``device`` in train mode with weights drawn from
    a ``torch.Generator`` seeded with ``cfg.SEED`` (the same weights on every
    device), fresh optimizers and the EMA copy. In joint mode
    (``TRAIN.JOINT_FT``) the encoder starts from the seeded init too;
    ``train.loop.GanTrainer`` grafts a pretrained one (``TRAIN.NET_E``)."""
    dev = resolve_device(device)
    joint = bool(cfg.TRAIN.JOINT_FT)
    models = build_models(cfg, joint)
    gen = torch.Generator().manual_seed(int(cfg.SEED))
    init_weights(models.g, models.ds, gen)
    g_params = list(models.g.parameters())
    if joint:
        encoder_train.init_weights(models.encoder, gen)
        models.encoder.to(dev).train()
        g_params += list(models.encoder.parameters())
    models.g.to(dev).train()
    for d in models.ds:
        d.to(dev).train()
    g_opt = make_optimizer(cfg, g_params, float(cfg.TRAIN.GENERATOR_LR))
    d_opts = [make_optimizer(cfg, d.parameters(), float(cfg.TRAIN.DISCRIMINATOR_LR)) for d in models.ds]
    sc = StepConfig.from_cfg(cfg)
    ema = {n: p.detach().clone() for n, p in models.g.named_parameters()} if sc.ema_decay > 0 else {}
    return GanTrainState(models, g_opt, d_opts, ema, sc)


def normalize_images(images, device: torch.device) -> tuple[torch.Tensor, ...]:
    """NHWC image batches (numpy or tensors) → NCHW float32 on ``device``:
    ``DATA.IMAGE_DTYPE=uint8`` bytes are shipped as they are and mapped to
    [-1, 1] on the device; float images pass through."""
    out = []
    for im in images:
        t = torch.as_tensor(im).to(device)
        t = t.float() if t.is_floating_point() else t.float() * (1.0 / 127.5) - 1.0
        out.append(t.permute(0, 3, 1, 2).contiguous())
    return tuple(out)


def expand_image_pyramid(images: tuple, branch_num: int) -> tuple:
    """``DATA.SHIP_SCALES=top``: derive the lower scales from the top one by
    2× area pooling on the device; a full per-scale tuple passes through."""
    if len(images) == branch_num:
        return tuple(images)
    if len(images) != 1:
        raise ValueError(f"batch has {len(images)} image scales; expected 1 or {branch_num}")
    out = [images[0]]
    for _ in range(branch_num - 1):
        out.insert(0, nn.functional.avg_pool2d(out[0], 2))
    return tuple(out)


def wrong_pair_sources(class_id: torch.Tensor) -> torch.Tensor:
    """Per-example source of a class-aware wrong pair: the nearest preceding
    batch element (smallest roll shift ≥ 1) whose class differs; shift 1
    (the plain roll) where the whole batch shares the class."""
    b = class_id.shape[0]
    ar = torch.arange(b, device=class_id.device)
    if b == 1:
        return torch.zeros_like(ar)
    s = torch.arange(1, b, device=class_id.device)
    differs = class_id[(ar[:, None] - s[None, :]) % b] != class_id[:, None]  # [B, B-1]
    shift = torch.where(differs.any(dim=1), 1 + differs.int().argmax(dim=1), 1)
    return (ar - shift) % b


def wrong_conditions(cond: torch.Tensor, class_id, mode: str) -> torch.Tensor:
    """Conditions of the D's wrong-pair term (``TRAIN.WRONG_PAIR``)."""
    if mode == "roll":
        return torch.roll(cond, 1, dims=0)
    if mode != "class_aware":
        raise ValueError(f"unknown TRAIN.WRONG_PAIR {mode!r}")
    if class_id is None:
        raise ValueError("TRAIN.WRONG_PAIR=class_aware needs class_id in the batch")
    return cond[wrong_pair_sources(class_id)]


def prepare_batch(state: GanTrainState, batch: dict) -> dict:
    """A host batch → tensors on the state's device: the image pyramid
    (NCHW, [-1, 1]), ``embedding`` or, in joint mode, ``feats`` /
    ``feat_mask`` / ``teacher``, and ``class_id``."""
    dev = state.device
    out = {"images": expand_image_pyramid(normalize_images(batch["images"], dev), state.sc.branch_num)}
    for k in ("embedding", "feats", "teacher"):
        if k in batch:
            out[k] = torch.as_tensor(batch[k], device=dev).float()
    if "feat_mask" in batch:
        out["feat_mask"] = torch.as_tensor(batch["feat_mask"], device=dev).bool()
    if batch.get("class_id") is not None:
        out["class_id"] = torch.as_tensor(batch["class_id"], device=dev).long()
    return out


def step_noise(state: GanTrainState, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(z [B, Z_DIM], CA eps [B, EMBEDDING_DIM]) from a generator seeded
    with ``cfg.SEED`` and the step counter, so a run draws the same noise
    each time it passes a step."""
    dev = state.device
    gen = torch.Generator(device=dev).manual_seed(state.sc.seed * 2**32 + state.step)
    z = torch.randn(b, state.sc.z_dim, generator=gen, device=dev)
    return z, torch.randn(b, state.sc.c_dim, generator=gen, device=dev)


@dataclasses.dataclass
class GForward:
    fakes: list[torch.Tensor]  # NCHW, one per scale
    mu: torch.Tensor
    logvar: torch.Tensor
    emb: torch.Tensor


def g_forward(state: GanTrainState, batch: dict, z: torch.Tensor, eps: torch.Tensor) -> GForward:
    """Step part 1: the one generator forward (train-mode BN)."""
    m = state.models
    if m.encoder is not None:
        m.encoder.train()
        emb = m.encoder(batch["feats"], batch.get("feat_mask"))
    else:
        emb = batch["embedding"]
    m.g.train()
    c, mu, logvar = m.g.ca_net.sample(emb, eps)
    return GForward(m.g(z, c), mu, logvar, emb)


def d_phase(state: GanTrainState, batch: dict, fwd: GForward) -> dict:
    """Step part 2: every D against (real, wrong pair, detached fake), one
    backward over the sum, one optimizer step per D."""
    sc = state.sc
    cond = fwd.mu.detach()
    cond_wrong = wrong_conditions(cond, batch.get("class_id"), sc.wrong_pair)
    if not sc.b_condition:
        cond = cond_wrong = None
    total = fwd.mu.new_zeros((), dtype=torch.float32)
    mets = {}
    for i, (d, real, fake) in enumerate(zip(state.models.ds, batch["images"], fwd.fakes)):
        d.train()
        li, aux = losses.discriminator_loss(*d.train_logits(real, fake.detach(), cond, cond_wrong), sc.uncond)
        total = total + li
        mets[f"d{i}_loss"] = li.detach()
        mets[f"d{i}_real_acc"] = aux["real_acc"]
        mets[f"d{i}_fake_acc"] = aux["fake_acc"]
    for opt in state.d_opts:
        opt.zero_grad(set_to_none=True)
    total.backward()
    for opt in state.d_opts:
        opt.step()
    return {"d_loss": total.detach(), **mets}


def _adversarial(state: GanTrainState, fwd: GForward) -> torch.Tensor:
    """The G phase's D terms against the updated Ds, in train mode, with
    their running statistics put back afterwards and no D gradient."""
    ds = state.models.ds
    saved = [(buf, buf.clone()) for d in ds for buf in d.buffers()]
    for d in ds:
        d.requires_grad_(False)
    try:
        adv = fwd.mu.new_zeros((), dtype=torch.float32)
        for d, fake in zip(ds, fwd.fakes):
            d.train()
            cond_f, uncond_f = d(fake, fwd.mu if state.sc.b_condition else None)
            adv = adv + losses.generator_adversarial_loss(cond_f, uncond_f, state.sc.uncond)
    finally:
        for d in ds:
            d.requires_grad_(True)
        with torch.no_grad():
            for buf, old in saved:
                buf.copy_(old)
    return adv


def g_phase(state: GanTrainState, batch: dict, fwd: GForward) -> dict:
    """Step part 3: the G loss, its backward through the generator graph of
    part 1, the G optimizer step and the EMA update."""
    sc = state.sc
    adv = _adversarial(state, fwd)
    kl = kl_divergence(fwd.mu, fwd.logvar)
    total = adv + sc.kl * kl
    mets = {"g_adv": adv.detach(), "kl": kl.detach()}
    if sc.color > 0 and len(fwd.fakes) > 1:
        closs = losses.color_consistency_loss(fwd.fakes)
        total = total + sc.color * closs
        mets["color"] = closs.detach()
    if state.models.encoder is not None and sc.distill > 0:
        dloss, dmets = losses.distillation_loss(fwd.emb, batch["teacher"])
        total = total + sc.distill * dloss
        mets["distill_mse"] = dmets["mse"].detach()
    mets["g_loss"] = total.detach()
    state.g_opt.zero_grad(set_to_none=True)
    total.backward()
    state.g_opt.step()
    if state.ema:
        decay = 0.0 if state.step < sc.ema_warmup else sc.ema_decay
        with torch.no_grad():
            for name, p in state.models.g.named_parameters():
                state.ema[name].mul_(decay).add_(p, alpha=1.0 - decay)
    return mets


def train_step(state: GanTrainState, batch: dict, z=None, eps=None,
               mark: Callable[[str], None] | None = None) -> dict:
    """One GAN step on a host batch ``{"images": (top scale or every scale,
    NHWC), "embedding" | "feats" + "feat_mask" + "teacher", "class_id"}``;
    updates ``state`` in place and returns the metrics as 0-d tensors on the
    device. ``z`` / ``eps`` replace the step's own noise draw. ``mark(part)``,
    when given, is called as each part ends (``"g_forward"``, ``"d_phase"``,
    ``"g_phase"``), e.g. to record a CUDA event there."""
    mark = mark or (lambda part: None)
    batch = prepare_batch(state, batch)
    if z is None or eps is None:
        z, eps = step_noise(state, batch["images"][0].shape[0])
    else:
        z = torch.as_tensor(z, device=state.device).float()
        eps = torch.as_tensor(eps, device=state.device).float()
    fwd = g_forward(state, batch, z, eps)
    mark("g_forward")
    mets = d_phase(state, batch, fwd)
    mark("d_phase")
    mets.update(g_phase(state, batch, fwd))
    mark("g_phase")
    state.step += 1
    return mets


def sampling_generator(state: GanTrainState) -> GNet:
    """A copy of G (CA included) in eval mode to sample from: the EMA
    weights when the state keeps an EMA (``TRAIN.EMA_G`` > 0), else G's own,
    with G's running statistics. The state's G is left as it is."""
    g = copy.deepcopy(state.models.g).requires_grad_(False)
    if state.ema:
        with torch.no_grad():
            for name, p in g.named_parameters():
                p.copy_(state.ema[name])
    return g.eval()


@torch.no_grad()
def bn_recalc(state: GanTrainState, embeddings, batches: int, batch_size: int, seed: int = 0,
              idx=None, z=None) -> dict[str, torch.Tensor]:
    """G's BatchNorm running statistics re-estimated under the EMA weights,
    the counterpart of ``make_bn_recalc_fn``: ``batches`` train-mode
    forwards of :func:`sampling_generator`'s copy, starting from G's running
    statistics, each on CA's mean (c = μ) of ``batch_size`` random rows of the
    ``embeddings`` pool with fresh z. Returns the copy's buffers by name
    (``state_dict`` keys of G); the state's G is left as it is.

    The draws come from a generator on the state's device seeded with
    ``seed``, or from ``idx`` [batches, batch_size] (rows of the pool) and
    ``z`` [batches, batch_size, Z_DIM] when given."""
    dev = state.device
    g = sampling_generator(state).train()
    pool = torch.as_tensor(embeddings, device=dev).float()
    if idx is None or z is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        idx = torch.randint(0, pool.shape[0], (batches, batch_size), generator=gen, device=dev)
        z = torch.randn(batches, batch_size, g.z_dim, generator=gen, device=dev)
    idx = torch.as_tensor(idx, device=dev).long()
    z = torch.as_tensor(z, device=dev).float()
    for rows, zb in zip(idx, z):
        g(zb, g.ca_net(pool[rows])[0])
    return dict(g.named_buffers())


def example_noise(seed: int, indices, dim: int) -> torch.Tensor:
    """Sampling noise [len(indices), dim] on the CPU: row j from a generator
    seeded with (seed, indices[j]), so an example's noise depends on its
    global index only, never on the batch it lands in."""
    return torch.stack([torch.randn(dim, generator=torch.Generator().manual_seed((seed << 32) + int(i)))
                        for i in indices])


@torch.no_grad()
def sample(g: GNet, embeddings, seed: int = 0, offset: int = 0, z=None) -> list[torch.Tensor]:
    """Images of every stage, NCHW in [-1, 1], of eval-mode ``g`` (e.g.
    :func:`sampling_generator`'s) for ``embeddings`` [B, TEXT.DIMENSION]
    through CA's mean (c = μ), the counterpart of ``make_sample_fn``.
    Example j's noise is :func:`example_noise` of global index
    ``offset + j``; ``z`` [B, Z_DIM] replaces it."""
    dev = next(g.parameters()).device
    emb = torch.as_tensor(embeddings, device=dev).float()
    if z is None:
        z = example_noise(seed, range(offset, offset + emb.shape[0]), g.z_dim)
    return g(torch.as_tensor(z).float().to(dev), g.ca_net(emb)[0])
