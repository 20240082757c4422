"""The device trace of a ``--trace 1`` run and its reduction.

``torch.profiler`` records the device's activity (kernels, copies, sets)
and the CUDA runtime calls over the whole measured window, CUDA activity
only: recording every CPU op as well slowed the host-bound steps about
twofold on the H100 machine. The harness's tasks mark their own host
phases with :func:`mark` (a name and ``time.time_ns()``, the clock the
profiler's events carry). The raw Kineto events are reduced here, not
through ``key_averages`` (too slow for a window of ~10⁵ launches):
  * ``busy_s``: the union of the device's activity intervals in the window;
  * ``device_s(patterns)``: the summed duration of the activities whose name
    holds any of the patterns (a kernel's share of the window);
  * ``breakdown``: the ten device operations that took the most time, and
    the ten longest idle gaps, each named by the harness's host phase and
    the CUDA runtime call under way when the gap began.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

_PHASES: list | None = None


def mark(name: str) -> None:
    """Note that the host enters phase ``name`` (only while tracing)."""
    if _PHASES is not None:
        _PHASES.append((time.time_ns(), name))


class Trace:
    def __init__(self, device_events, host_events, window_ns, phases):
        self.device = device_events  # [(name, start_ns, dur_ns)], in the window
        self.host = host_events  # CUDA runtime calls
        self.window_ns = window_ns
        self.phases = phases

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def intervals(self):
        merged = []
        for _, s, d in sorted(self.device, key=lambda e: e[1]):
            s, e = max(s, self.window_ns[0]), min(s + d, self.window_ns[1])
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e9

    def device_s(self, patterns) -> float:
        return sum(d for n, _, d in self.device if any(p in n for p in patterns)) / 1e9

    def breakdown(self) -> dict:
        by_name: dict[str, int] = {}
        for n, _, d in self.device:
            by_name[n] = by_name.get(n, 0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps, prev = [], self.window_ns[0]
        for s, e in self.intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.window_ns[1] > prev:
            gaps.append((prev, self.window_ns[1]))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:160], d / 1e9] for n, d in ops],
                "idle_gaps": [[self._host_at(s), (e - s) / 1e9] for s, e in gaps]}

    def _host_at(self, t: int) -> str:
        times = [p[0] for p in self.phases]
        i = bisect.bisect_right(times, t) - 1
        phase = self.phases[i][1] if i >= 0 else "set-up"
        call = None
        for n, s, d in self.host:
            if s <= t < s + d and (call is None or d < call[1]):
                call = (n, d)
        return f"{phase}: {call[0] if call else 'no CUDA call'}"[:160]


@contextlib.contextmanager
def traced(on: bool, out: dict):
    """Profile the body when ``on``; ``out["trace"]`` is then a :class:`Trace`.
    The body has to end with the device synchronized."""
    global _PHASES
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    _PHASES = phases = []
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start = time.time_ns()
            yield
            end = time.time_ns()
    finally:
        _PHASES = None
    out["trace_exit_s"] = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns(), e.duration_ns())
        if e.device_type() == cuda:
            if not e.is_user_annotation() and rec[1] + rec[2] > start and rec[1] < end:
                dev.append(rec)
        elif e.name().startswith("cuda"):
            host.append(rec)
    out["trace"] = Trace(dev, host, (start, end), phases)
