"""One run of one cell: set-up, the measured window, the readings, the
comparison with the reference, the result line."""

from __future__ import annotations

import json
import math
import sys
import time

import torch

from harness import compare, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "s2i_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (up to the first dot, whole) is
    one of ``FORBIDDEN``."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


class Readings:
    """What the per-layer readers read: the trace (None without one), the
    task's spans (ms lists), counters and per-step work records, the
    configuration, the peaks table and the window's length."""

    def __init__(self, cell, trace_, spans, counters, work, window_s):
        self.cell, self.trace, self.spans, self.counters = cell, trace_, spans, counters
        self.work, self.window_s = work, window_s
        self.peaks = spec.peaks()

    def roofline_share(self, kernel: str):
        """Σ least time over Σ device time of ``kernel``'s launches, in %."""
        mod = spec.roofline(kernel)
        t = self.trace.device_s(mod.PATTERNS) if self.trace else 0.0
        costs = [mod.cost(self.cell.cfg, rec) for rec in self.work]
        costs = [c for c in costs if c is not None]
        if t <= 0 or not costs:
            return None
        peak = self.peaks[mod.PEAK]
        bound = sum(max(f / peak, b / self.peaks["hbm_bytes_per_s"]) for f, b in costs)
        return 100.0 * bound / t

    def mfu(self, model: str):
        """The work's FLOPs over the window at the bf16 dense peak, in %."""
        mod = spec.roofline(model)
        flops = sum(mod.step_flops(self.cell.cfg, rec) for rec in self.work)
        if flops <= 0:
            return None
        return 100.0 * flops / (self.window_s * self.peaks["bf16_flops"])


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(cell: spec.Cell, started: float, device: str = "cuda") -> int:
    """One run; prints the result line and returns the exit code. ``device``
    "cpu" serves the harness's own tests (the program's plain versions, no
    trace, no device metric)."""
    from s2i_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    task = spec.task(cell.traffic["task"]).Task(cell, dev, fault=cell.fault)
    parts = task.setup()
    sync(dev)
    setup_s = time.perf_counter() - started
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out: dict = {}
    with trace.traced(cell.trace, out):
        t0 = time.perf_counter()
        task.window(t0 + cell.seconds)
        sync(dev)
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    values = task.end_to_end(window_s)
    values["setup_s"] = setup_s
    readings = Readings(cell, out.get("trace"), task.spans, task.counters, task.work, window_s)
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu", "count": cell.chips,
              "memory_peak_bytes": int(peak)}
    metrics = {}
    if cell.trace:
        tr = out["trace"]
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"]).read(readings, m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    t_check = time.perf_counter()
    task.release()
    numbers, notes = task.check()
    correct, checks = compare.judge(numbers, cell.limits)
    attempted, failed = task.attempted, task.failed
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    info = {"setup_parts_s": parts, "check_s": time.perf_counter() - t_check, "notes": notes,
            "trace_exit_s": out.get("trace_exit_s")}
    print(f"benchmark: {json.dumps(info)}", file=sys.stderr)
    if cell.trace:
        print(f"benchmark: spans {json.dumps({k: _summary(v) for k, v in task.spans.items()})}", file=sys.stderr)
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if cell.trace:
        line["breakdown"] = out["trace"].breakdown()
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    print(json.dumps(line), flush=True)
    return 0


def _summary(xs):
    xs = [x for x in xs if math.isfinite(x)]
    return {"n": len(xs), "mean": sum(xs) / len(xs)} if xs else {"n": 0}
