"""What the training tasks share: the configuration as the program reads
it, the seeded weights for the program's modules and the reference's, the
per-leaf norms that the comparison reads, and the faults that the harness's
own tests plant in the timed path."""

from __future__ import annotations

import time

import torch

from harness import weights


def start_device(device, parts: dict) -> None:
    """Create the device's context (timed apart in the set-up's parts)."""
    t = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    parts["cuda_init_s"] = time.perf_counter() - t


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_cfg(cell):
    from s2i_tpu_torch import config

    cfg = config.AttrDict(cell.cfg)
    cfg.SEED = int(cell.seed) % 2**32
    return cfg


def adam_first_grads(opt, names: list[str], beta1: float) -> dict[str, float]:
    """‖g₁‖ of each leaf from Adam's first moment after one step, m₁ / (1 - β₁)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    if len(params) != len(names):
        raise ValueError("the optimizer holds other leaves than named")
    out = {}
    for n, p in zip(names, params):
        st = opt.state.get(p, {})
        out[n] = float(st["exp_avg"].float().norm() / (1.0 - beta1)) if "exp_avg" in st else 0.0
    return out


def norms(tensors: dict[str, torch.Tensor], base: dict[str, torch.Tensor]) -> dict[str, float]:
    return {n: float((t.detach().float() - base[n].float()).norm()) for n, t in tensors.items()}


def grads(leaves: dict[str, torch.Tensor]) -> dict[str, float]:
    return {n: float(p.grad.norm()) if p.grad is not None else 0.0
            for n, p in leaves.items() if not n.startswith("ema.")}


def reference_modules(cell, parts: list[tuple[str, str, bool]], device, seed):
    """The reference's modules of ``parts`` [(prefix, part, joint)], on
    ``device`` in float32 with the run's seeded weights."""
    from reference import audio, models

    models.check_supported(cell.cfg)
    audio.check_supported(cell.cfg["AUDIO"])
    built = []
    for prefix, part, joint in parts:
        with torch.device("meta"):
            built.append((prefix, models.build(cell.cfg, part, joint)))
    shapes = {}
    for prefix, m in built:
        shapes.update(weights.shapes_of(prefix, m))
    state = weights.seeded_state(shapes, seed, device)
    return [weights.materialize(m, state, prefix, device) for prefix, m in built], state


class Fault:
    """A fault planted in the timed path by the harness's tests and the
    calibration: "unchanged" (a step that leaves the state as it was) or
    "half" (half of the batch left out, the mean taken over the rest)."""

    def __init__(self, kind: str | None):
        if kind not in (None, "unchanged", "half"):
            raise ValueError(f"unknown fault {kind!r}")
        self.kind = kind

    def batch(self, batch: dict) -> dict:
        if self.kind != "half":
            return batch
        return {k: (v[: v.shape[0] // 2] if isinstance(v, torch.Tensor) and v.ndim else
                    tuple(x[: x.shape[0] // 2] for x in v) if isinstance(v, tuple) else v)
                for k, v in batch.items()}

    def around(self, tensors: list[torch.Tensor], step):
        if self.kind != "unchanged":
            return step()
        saved = [t.detach().clone() for t in tensors]
        out = step()
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        return out
