"""The port's own host spans (``s2i_tpu_torch.utils.logging.span``) in a
``--trace 1`` run, read for the ``program_span`` metrics of the host layer.

The program records its spans while a profiler runs, on ``time.time_ns()``,
the clock of the trace's events. Only spans that start inside the traced
window count. They are joined with the trace's CUDA runtime calls
(``Trace.host``) and the device's busy intervals (``Trace.intervals``):

  * a step is one ``gan.step`` (metrics ``<name>.gan``) or ``encoder.step``
    (``<name>.encoder``) root span;
  * the root spans are those steps and ``audio.featurize`` where no span
    encloses it (the cells featurize before each step): together, the host's
    time issuing the work of the steps;
  * a launch is a runtime call named ``cudaLaunch*``, ``cudaMemcpyAsync`` or
    ``cudaMemsetAsync`` that starts inside a root span, on any thread
    (autograd's backward may launch from its own device thread while the
    caller waits in ``*.backward``);
  * the optimizer spans are ``gan.d_opt``, ``gan.g_opt``, ``gan.ema`` and
    ``encoder.opt``; the backward spans ``gan.d_backward``,
    ``gan.g_backward`` and ``encoder.backward``.

Every reading is None where the program recorded no step of the kind (a
program without spans records none)."""

from __future__ import annotations

import bisect

STEPS = {"gan": "gan.step", "encoder": "encoder.step"}
FEATURIZE = "audio.featurize"
OPTIMIZER = frozenset({"gan.d_opt", "gan.g_opt", "gan.ema", "encoder.opt"})
BACKWARD = frozenset({"gan.d_backward", "gan.g_backward", "encoder.backward"})
COPIES = ("cudaMemcpyAsync", "cudaMemsetAsync")


def program_records():
    """The program's span records, or None where it has no recorder."""
    try:
        from s2i_tpu_torch.utils.logging import span_records
    except ImportError:
        return None
    return span_records()[0]


def is_launch(name: str) -> bool:
    return name.startswith("cudaLaunch") or name in COPIES


def merged(intervals) -> list[list[int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def overlap(a, b) -> int:
    """The measure of the intersection of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(trace) -> list[list[int]]:
    """The window's intervals in which the device ran nothing."""
    out, prev = [], trace.window_ns[0]
    for s, e in trace.intervals():
        if s > prev:
            out.append([prev, s])
        prev = max(prev, e)
    if trace.window_ns[1] > prev:
        out.append([prev, trace.window_ns[1]])
    return out


class StepSpans:
    """The window's spans of one kind of step and what the metrics read."""

    def __init__(self, records, trace, kind: str):
        lo, hi = trace.window_ns
        self.trace = trace
        self.spans = [r for r in records if lo <= r.start_ns < hi]
        self.steps = sum(1 for r in self.spans if r.name == STEPS[kind] and r.parent is None)
        self.roots = sorted((r.start_ns, r.end_ns) for r in self.spans
                            if r.parent is None and r.name in (STEPS[kind], FEATURIZE))

    def per_step_ms(self, names) -> float:
        return sum(r.end_ns - r.start_ns for r in self.spans if r.name in names) / self.steps / 1e6

    def host_step_ms(self) -> float:
        return sum(e - s for s, e in self.roots) / self.steps / 1e6

    def launches_per_step(self) -> float:
        starts = [s for s, _ in self.roots]
        n = 0
        for name, t, _ in self.trace.host:
            if is_launch(name):
                i = bisect.bisect_right(starts, t) - 1
                n += i >= 0 and t < self.roots[i][1]
        return n / self.steps

    def optimizer_idle_pct(self):
        gaps = idle(self.trace)
        total = sum(e - s for s, e in gaps)
        if total <= 0:
            return None
        lo, hi = self.trace.window_ns
        opt = merged((max(r.start_ns, lo), min(r.end_ns, hi)) for r in self.spans if r.name in OPTIMIZER)
        return 100.0 * overlap(gaps, opt) / total


def of(r, metric: str) -> StepSpans | None:
    """The spans of ``metric``'s kind of step (its suffix, ``gan`` or
    ``encoder``) in ``r``'s traced window, or None without a trace or a step."""
    kind = metric.rsplit(".", 1)[-1]
    if r.trace is None or kind not in STEPS:
        return None
    records = program_records()
    if not records:
        return None
    got = StepSpans(records, r.trace, kind)
    return got if got.steps else None


def innermost(records, t: int) -> str:
    """The name of the innermost span open at ``t`` (the latest started
    among those that hold it), or "no span"."""
    best = None
    for rec in records:
        if rec.start_ns <= t < rec.end_ns and (best is None or rec.start_ns > best.start_ns):
            best = rec
    return best.name if best else "no span"


def idle_gaps(trace, records, n: int = 10) -> list[list]:
    """The ``n`` longest idle gaps of the window, longest first, each as
    [innermost program span at its start, seconds]: the breakdown by span
    that PERF.md §5 reports, for the harness's ``breakdown`` to take up."""
    gaps = sorted(idle(trace), key=lambda g: g[0] - g[1])[:n]
    return [[innermost(records, s), (e - s) / 1e9] for s, e in gaps]
