"""The host layer's readers (``metrics/{host_step_ms, launches_per_step,
optimizer_host_ms, backward_host_ms, optimizer_idle_pct}.py``) and their
helper ``harness/program_spans.py``, on synthetic spans and a synthetic
trace: the window's clipping, launches attributed across threads, the idle
overlap, None without a step; and the program's own recorder read back."""

from __future__ import annotations

import bench_tiny  # noqa: F401  (the benchmark's folder on the path)

import pytest
import torch

from s2i_tpu_torch.utils.logging import SpanRecord, clear_spans, span

MS = 1_000_000  # ns


def rec(name, id_, parent, start_ms, end_ms, thread=1, **attrs):
    return SpanRecord(name, id_, parent, thread, int(start_ms * MS), int(end_ms * MS), attrs)


# window [10, 50] ms; gan.step 1 starts before it, steps 2 and 3 inside;
# featurize (a root of its own) before step 3; one encoder.step nested in a
# foreign span, so not a root
RECORDS = [
    rec("gan.step", 1, None, 5, 12, step=0),
    rec("gan.d_opt", 2, 1, 9, 11),
    rec("gan.step", 3, None, 14, 24, step=1),
    rec("gan.d_backward", 4, 3, 15, 17),
    rec("gan.d_opt", 5, 3, 17, 19),
    rec("gan.g_backward", 6, 3, 19, 20),
    rec("gan.g_opt", 7, 3, 20, 22),
    rec("gan.ema", 8, 3, 22, 23),
    rec("audio.featurize", 9, None, 30, 32),
    rec("gan.step", 10, None, 32, 40, step=2),
    rec("gan.g_opt", 11, 10, 36, 39),
    rec("outer", 12, None, 41, 48),
    rec("encoder.step", 13, 12, 42, 47, step=0),
]
DEVICE = [("k", 0, 20 * MS), ("k", 21 * MS, 10 * MS), ("k", 37 * MS, 3 * MS)]  # busy [10,20], [21,31], [37,40]
HOST = [
    ("cudaLaunchKernel", 11 * MS, 1000),  # step 1: starts before the window, not counted
    ("cudaLaunchKernel", 15 * MS, 1000),  # step 2
    ("cudaLaunchKernelExC", 16 * MS, 1000),  # step 2, autograd's device thread
    ("cudaMemcpyAsync", 18 * MS, 1000),  # step 2
    ("cudaMemsetAsync", 23 * MS, 1000),  # step 2
    ("cudaStreamSynchronize", 23 * MS + 5, 1000),  # not a launch
    ("cudaLaunchKernel", 26 * MS, 1000),  # between roots
    ("cudaLaunchKernel", 31 * MS, 1000),  # featurize
    ("cudaLaunchKernel", 33 * MS, 1000),  # step 3
    ("cudaLaunchKernel", 44 * MS, 1000),  # the nested encoder.step: no root
]


@pytest.fixture
def readings(monkeypatch):
    """Readings of the synthetic window with ``RECORDS`` as the program's spans."""
    from harness import program_spans
    from harness.runner import Readings
    from harness.spec import cell
    from harness.trace import Trace

    def make(records=RECORDS, device=DEVICE, host=HOST):
        monkeypatch.setattr(program_spans, "program_records", lambda: records)
        return Readings(cell("birds3-gan-b24"), Trace(device, host, (10 * MS, 50 * MS), []), {}, {}, [], 0.04)

    return make


def read(name, r):
    from harness import spec

    return spec.metric_reader(name).read(r, name)


def test_host_times_per_step_count_the_window_only(readings):
    r = readings()
    assert read("host_step_ms.gan", r) == pytest.approx((10 + 2 + 8) / 2)  # steps 2 and 3 and featurize
    assert read("optimizer_host_ms.gan", r) == pytest.approx((2 + 2 + 1 + 3) / 2)  # d_opt of step 1 is out
    assert read("backward_host_ms.gan", r) == pytest.approx((2 + 1) / 2)


def test_launches_are_the_calls_that_start_inside_a_root(readings):
    assert read("launches_per_step.gan", readings()) == pytest.approx((4 + 1 + 1) / 2)


def test_optimizer_share_of_the_idle_time(readings):
    # idle [20,21], [31,37], [40,50] = 17 ms; optimizer spans in the window
    # [17,19], [20,23], [36,39]: idle inside them [20,21] and [36,37]
    assert read("optimizer_idle_pct.gan", readings()) == pytest.approx(100 * 2 / 17)
    assert read("optimizer_idle_pct.gan", readings(device=[("k", 0, 60 * MS)])) is None  # never idle


@pytest.mark.parametrize("name", ["host_step_ms", "launches_per_step", "optimizer_host_ms", "backward_host_ms",
                                  "optimizer_idle_pct"])
def test_no_step_reads_none(readings, name):
    assert read(f"{name}.encoder", readings()) is None  # its one encoder.step is not a root
    assert read(f"{name}.gan", readings(records=[r for r in RECORDS if r.name != "gan.step"])) is None
    assert read(f"{name}.gan", readings(records=None)) is None  # a program without the recorder
    r = readings()
    r.trace = None
    assert read(f"{name}.gan", r) is None


def test_idle_gaps_are_named_by_the_innermost_span():
    from harness import program_spans
    from harness.trace import Trace

    tr = Trace(DEVICE, HOST, (10 * MS, 50 * MS), [])
    assert program_spans.idle_gaps(tr, RECORDS, 2) == [["no span", pytest.approx(0.010)],  # [40, 50]
                                                       ["audio.featurize", pytest.approx(0.006)]]  # [31, 37]
    assert program_spans.idle_gaps(tr, RECORDS)[2] == ["gan.g_opt", pytest.approx(0.001)]


def test_the_programs_own_spans_are_read(readings, monkeypatch):
    """The recorder's records as the helper reads them: a profiled window of
    two nested spans."""
    from harness import program_spans

    clear_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with span("encoder.step", step=0):
                with span("encoder.opt"):
                    pass
        records = program_spans.program_records()
    finally:
        clear_spans()
    (opt, step) = records
    assert (step.name, step.parent, opt.parent) == ("encoder.step", None, step.id)
    r = readings(records=records, device=[], host=[])
    r.trace.window_ns = (step.start_ns, step.end_ns + 1)
    assert read("host_step_ms.encoder", r) == pytest.approx((step.end_ns - step.start_ns) / 1e6)
    assert read("optimizer_host_ms.encoder", r) == pytest.approx((opt.end_ns - opt.start_ns) / 1e6)
    assert read("optimizer_idle_pct.encoder", r) == pytest.approx(
        100 * (opt.end_ns - opt.start_ns) / (step.end_ns + 1 - step.start_ns))
