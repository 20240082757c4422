"""GAN training steps (``s2i_tpu_torch.train.gan.train_step``), frozen
embeddings or joint (``TRAIN.JOINT_FT``: ``audio.frontend.featurize`` on the
batch's WAVs first, then the step with features, mask and teacher).

Set-up builds one ``GanTrainState`` with the program's ``init_state``, loads
the run's seeded weights into its modules and its EMA copy, makes a
pool of ``pool_batches`` batches on the card and drives the state through
its first three steps on the pool's first three batches (this warms every
shape up and records what the comparison reads); the window then steps the
same state over the pool, round and round, until the deadline. The rate is
the images of every step started in the window over the window's time,
the device drained. With ``--trace 1`` CUDA events at the step's own
``mark`` hook time its D and G phases.
"""

from __future__ import annotations

import time

import torch

from harness import feed as feeding
from harness import weights
from harness import trace
from tasks.common import Fault, adam_first_grads, grads, norms, program_cfg, reference_modules, start_device, sync

CHECK_STEPS = 3


class Task:
    def __init__(self, cell, device, fault: str | None = None):
        self.cell, self.device, self.fault = cell, device, Fault(fault)
        self.cfg = program_cfg(cell)
        self.joint = bool(self.cfg.TRAIN.JOINT_FT)
        self.spans = {"gan_d_phase_ms": [], "gan_g_phase_ms": []}
        self.counters, self.work = {}, []
        self.attempted = self.failed = 0

    # ---- set-up -------------------------------------------------------
    def setup(self) -> dict:
        t = time.perf_counter()
        from s2i_tpu_torch.audio.frontend import frontend_params_from_cfg
        from s2i_tpu_torch.ops import build
        from s2i_tpu_torch.train import gan

        parts = {"imports_s": time.perf_counter() - t}
        start_device(self.device, parts)
        t = time.perf_counter()
        if self.joint and self.device.type == "cuda":
            build.build_all(["mel_fused", "gru_fwd", "gru_bwd"])
        parts["build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        import torch._dynamo  # noqa: F401  (torch imports it on the first optimizer or module move; timed apart)

        parts["dynamo_import_s"] = time.perf_counter() - t
        t = time.perf_counter()
        cfg, dev = self.cfg, self.device
        self.state = gan.init_state(cfg, dev)
        sync(dev)
        parts["init_state_s"] = time.perf_counter() - t
        t = time.perf_counter()
        models = self.state.models
        mods = [("g.", models.g)] + [(f"d{i}.", d) for i, d in enumerate(models.ds)]
        if self.joint:
            mods.append(("enc.", models.encoder))
        shapes = {}
        for prefix, m in mods:
            shapes.update(weights.shapes_of(prefix, m))
        w0 = weights.seeded_state(shapes, self.cell.seed, dev)
        with torch.no_grad():
            for prefix, m in mods:
                weights.load(m, w0, prefix)
            for n, p in models.g.named_parameters():
                if n in self.state.ema:
                    self.state.ema[n].copy_(p)
        g_opt, d_opts = self.state.g_opt, self.state.d_opts
        self.g_names = gan.g_opt_names(models)
        self.d_names = [[f"d{i}.{n}" for n, _ in d.named_parameters()] for i, d in enumerate(models.ds)]
        sync(dev)
        parts["weights_s"] = time.perf_counter() - t

        t = time.perf_counter()
        tr = self.cell.traffic
        self.b, self.n_batches = int(tr["batch"]), int(tr["pool_batches"])
        n = self.b * self.n_batches
        fd = feeding.Feed(self.cell.seed, dev)
        size = 64 * 2 ** (int(cfg.TREE.BRANCH_NUM) - 1)
        pool = {"images": fd.images(n, size), "class_id": fd.classes(n, int(cfg.ENCODER.N_CLASSES))}
        if self.joint:
            lo, hi = tr["wav_samples"]
            lens = fd.lengths(n, lo, hi)
            pool.update(wav=fd.wavs(lens, hi), wav_len=lens.to(dev), teacher=fd.normal(n, int(cfg.TEXT.DIMENSION)))
            self.p = frontend_params_from_cfg(cfg.AUDIO)
            self.lens = lens.view(self.n_batches, self.b).tolist()
        else:
            pool["embedding"] = fd.normal(n, int(cfg.TEXT.DIMENSION))
        self.pool = feeding.batches(pool, self.b, self.n_batches)
        parts["inputs_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.next = 0
        losses = []
        for i in range(CHECK_STEPS):
            mets = self.step()
            losses.append({k: float(mets[k]) for k in ("d_loss", "g_loss")})
            if i == 0:
                b1 = float(cfg.TRAIN.ADAM_BETA1)
                first = adam_first_grads(g_opt, self.g_names, b1)
                for opt, names in zip(d_opts, self.d_names):
                    first.update(adam_first_grads(opt, names, b1))
        change = norms(self.leaves(), {**w0, **{f"ema.{k[2:]}": v for k, v in w0.items() if k.startswith("g.")}})
        self.prog = {"losses": losses, "grad": first, "change": change}
        del w0
        sync(dev)
        parts["first_steps_s"] = time.perf_counter() - t
        self.work.clear()
        return parts

    def leaves(self) -> dict[str, torch.Tensor]:
        m = self.state.models
        out = {f"g.{n}": p for n, p in m.g.named_parameters()}
        for i, d in enumerate(m.ds):
            out.update({f"d{i}.{n}": p for n, p in d.named_parameters()})
        if m.encoder is not None:
            out.update({f"enc.{n}": p for n, p in m.encoder.named_parameters()})
        out.update({f"ema.{n}": t for n, t in self.state.ema.items()})
        return out

    # ---- the timed path ------------------------------------------------
    def step(self, mark=None):
        from s2i_tpu_torch.audio.frontend import featurize
        from s2i_tpu_torch.train import gan

        k = self.next % self.n_batches
        b = self.pool[k]
        self.next += 1
        batch = {"images": (b["images"],), "class_id": b["class_id"]}
        if self.joint:
            trace.mark("gan.featurize")
            batch.update(featurize({"wav": b["wav"], "wav_len": b["wav_len"]}, self.p, self.device))
            batch["teacher"] = b["teacher"]
        else:
            batch["embedding"] = b["embedding"]
        batch = self.fault.batch(batch)
        if self.joint:
            self.work.append({"model": "joint", "batch": self.b, "logmel": list(b["wav"].shape),
                              "gru": self.lens[k], "gru_bwd": True})
        else:
            self.work.append({"model": "gan", "batch": self.b})
        if self.fault.kind == "unchanged":
            return self.fault.around(list(self.leaves().values()), lambda: gan.train_step(self.state, batch))
        trace.mark("gan.train_step")
        return gan.train_step(self.state, batch, mark=mark)

    def window(self, deadline: float) -> None:
        events = []

        def mark(part):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((part, ev))
            trace.mark(f"gan.{part} queued")

        while time.perf_counter() < deadline:
            self.step(mark if self.cell.trace else None)
        self.attempted = len(self.work)
        self._events = events

    def end_to_end(self, window_s: float) -> dict:
        if self._events:
            torch.cuda.synchronize()
            ev = self._events
            for (p0, e0), (p1, e1) in zip(ev, ev[1:]):
                if p1 == "d_phase" and p0 == "g_forward":
                    self.spans["gan_d_phase_ms"].append(e0.elapsed_time(e1))
                elif p1 == "g_phase" and p0 == "d_phase":
                    self.spans["gan_g_phase_ms"].append(e0.elapsed_time(e1))
        return {"gan_images_per_s": len(self.work) * self.b / window_s}

    # ---- the check ---------------------------------------------------
    def release(self) -> None:
        del self.state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: bool = False) -> dict:
        """The reference's record (``control``: computed in the lower precision,
        the control that the comparison has to fail)."""
        from reference import precision

        with precision.computed_in("control" if control else "float32"):
            return self._reference()

    def _reference(self) -> dict:
        """The losses, first gradients and changes of the reference's first
        three steps from the run's seeded weights, inputs and noise."""
        from reference.train import GanReference, step_noise

        n_ds = int(self.cfg.TREE.BRANCH_NUM)
        parts = [("g.", "g", False)] + [(f"d{i}.", f"d{64 * 2 ** i}", False) for i in range(n_ds)]
        if self.joint:
            parts.append(("enc.", "encoder", True))
        mods, w0 = reference_modules(self.cell, parts, self.device, self.cell.seed)
        ref = GanReference(self.cell.cfg, mods[0], mods[1:1 + n_ds], mods[1 + n_ds] if self.joint else None)
        cfg = self.cfg
        losses = []
        for i in range(CHECK_STEPS):
            z, eps = step_noise(int(cfg.SEED), i, self.b, int(cfg.GAN.Z_DIM), int(cfg.GAN.EMBEDDING_DIM), self.device)
            losses.append(ref.step(self.pool[i], z, eps))
            if i == 0:
                first = grads(ref.leaves())
        change = norms(ref.leaves(), {**w0, **{f"ema.{k[2:]}": v for k, v in w0.items() if k.startswith("g.")}})
        return {"losses": losses, "grad": first, "change": change}

    def check(self):
        from harness.compare import training_numbers

        got = training_numbers(self.prog, self.reference())
        return {k: v for k, (v, _) in got.items()}, {k: w for k, (_, w) in got.items()}
