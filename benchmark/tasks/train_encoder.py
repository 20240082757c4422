"""Speech-encoder distillation steps as ``cli.run_encoder_pretrain`` takes
them: ``audio.frontend.featurize`` on a batch of WAVs, then
``train.encoder.encoder_train_step`` with features, mask, teacher and class
ids.

Set-up builds one ``EncoderTrainState`` with the program's
``init_encoder_state`` (the encoder and a fresh Adam), loads the run's
seeded weights into it, makes a pool of ``pool_batches`` batches of WAVs,
teachers and class ids on the card, and drives the state through its first three
steps on the pool's first three batches; the window then steps the same
state round the pool until the deadline. With ``--trace 1`` CUDA events
around the two calls time them.
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
        self.spans = {"encoder_featurize_ms": [], "encoder_step_ms": []}
        self.counters, self.work = {}, []
        self.attempted = self.failed = 0
        self._events = []

    def setup(self) -> dict:
        t = time.perf_counter()
        from s2i_tpu_torch.audio.frontend import frontend_params_from_cfg
        from s2i_tpu_torch.ops import build
        from s2i_tpu_torch.train.encoder import init_encoder_state

        parts = {"imports_s": time.perf_counter() - t}
        start_device(self.device, parts)
        t = time.perf_counter()
        if self.device.type == "cuda":
            build.build_all(["mel_fused", "gru_fwd", "gru_bwd"])
        parts["build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        import torch._dynamo  # noqa: F401  (torch imports it on the first optimizer or module move; timed apart)

        parts["dynamo_import_s"] = time.perf_counter() - t
        t = time.perf_counter()
        cfg, dev = self.cfg, self.device
        self.state = init_encoder_state(cfg, dev)
        sync(dev)
        parts["init_state_s"] = time.perf_counter() - t
        t = time.perf_counter()
        model, opt = self.state.model, self.state.opt
        w0 = weights.seeded_state(weights.shapes_of("enc.", model), self.cell.seed, dev)
        with torch.no_grad():
            weights.load(model, w0, "enc.")
        self.names = [f"enc.{n}" for n, _ in model.named_parameters()]
        sync(dev)
        parts["weights_s"] = time.perf_counter() - t

        t = time.perf_counter()
        tr = self.cell.traffic
        self.b, self.n_batches = int(tr["batch"]), int(tr["pool_batches"])
        n = self.b * self.n_batches
        fd = feeding.Feed(self.cell.seed, dev)
        lo, hi = tr["wav_samples"]
        lens = fd.lengths(n, lo, hi)
        pool = {"wav": fd.wavs(lens, hi), "wav_len": lens.to(dev), "teacher": fd.normal(n, int(cfg.TEXT.DIMENSION)),
                "class_id": fd.classes(n, int(cfg.ENCODER.N_CLASSES))}
        self.lens = lens.view(self.n_batches, self.b).tolist()
        self.pool = feeding.batches(pool, self.b, self.n_batches)
        self.p = frontend_params_from_cfg(cfg.AUDIO)
        parts["inputs_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.next = 0
        losses = []
        for i in range(CHECK_STEPS):
            mets = self.step()
            losses.append({"loss": float(mets["loss"])})
            if i == 0:
                first = adam_first_grads(opt, self.names, 0.9)
        change = norms(self.leaves(), w0)
        self.prog = {"losses": losses, "grad": first, "change": change}
        del w0
        parts["first_steps_s"] = time.perf_counter() - t
        self.work.clear()
        return parts

    def leaves(self) -> dict[str, torch.Tensor]:
        return {f"enc.{n}": p for n, p in self.state.model.named_parameters()}

    def step(self, events=None):
        from s2i_tpu_torch.audio.frontend import featurize
        from s2i_tpu_torch.train.encoder import encoder_train_step

        k = self.next % self.n_batches
        b = self.pool[k]
        self.next += 1
        self.work.append({"model": "encoder", "batch": self.b, "logmel": list(b["wav"].shape),
                          "gru": self.lens[k], "gru_bwd": True})
        trace.mark("encoder.featurize")
        if events is not None:
            events[0].record()
        batch = featurize(b, self.p, self.device)
        if events is not None:
            events[1].record()
        batch = self.fault.batch(batch)
        trace.mark("encoder.train_step")
        if self.fault.kind == "unchanged":
            out = self.fault.around(list(self.leaves().values()), lambda: encoder_train_step(self.state, batch))
        else:
            out = encoder_train_step(self.state, batch)
        if events is not None:
            events[2].record()
        return out

    def window(self, deadline: float) -> None:
        while time.perf_counter() < deadline:
            ev = None
            if self.cell.trace:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                self._events.append(ev)
            self.step(ev)
        self.attempted = len(self.work)

    def end_to_end(self, window_s: float) -> dict:
        for e0, e1, e2 in self._events:
            self.spans["encoder_featurize_ms"].append(e0.elapsed_time(e1))
            self.spans["encoder_step_ms"].append(e1.elapsed_time(e2))
        return {"encoder_utts_per_s": len(self.work) * self.b / window_s}

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
        from reference.train import EncoderReference

        (enc,), w0 = reference_modules(self.cell, [("enc.", "encoder", False)], self.device, self.cell.seed)
        ref = EncoderReference(self.cell.cfg, enc)
        losses = []
        for i in range(CHECK_STEPS):
            losses.append(ref.step(self.pool[i]))
            if i == 0:
                first = grads(ref.leaves())
        change = norms(ref.leaves(), w0)
        return {"losses": losses, "grad": first, "change": change}

    def check(self):
        from harness.compare import training_numbers

        got = training_numbers(self.prog, self.reference())
        return {k: v for k, (v, _) in got.items()}, {k: w for k, (_, w) in got.items()}
