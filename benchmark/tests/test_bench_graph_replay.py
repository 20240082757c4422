"""The GAN step layer's reader ``metrics/graph_replay_pct.py`` on synthetic
spans: the share of the window's ``gan.step`` roots that say they were
replayed from their CUDA graphs, and None where no step says how it ran."""

from __future__ import annotations

import bench_tiny  # noqa: F401  (the benchmark's folder on the path)

import pytest

from s2i_tpu_torch.utils.logging import SpanRecord

MS = 1_000_000  # ns


def rec(name, id_, parent, start_ms, end_ms, **attrs):
    return SpanRecord(name, id_, parent, 1, int(start_ms * MS), int(end_ms * MS), attrs)


def steps(*graphs):
    """``gan.step`` roots with the given ``graph`` attributes (None: no
    attribute), the first starting before the window [10, 50] ms, each with
    a child; then an ``encoder.step`` root that says nothing."""
    out = []
    for i, graph in enumerate(graphs):
        attrs = {"step": i} if graph is None else {"step": i, "graph": graph}
        out += [rec("gan.step", 2 * i + 1, None, 5 + 8 * i, 12 + 8 * i, **attrs),
                rec("gan.prepare", 2 * i + 2, 2 * i + 1, 6 + 8 * i, 7 + 8 * i)]
    return out + [rec("encoder.step", 99, None, 45, 48, step=0)]


@pytest.fixture
def reading(monkeypatch):
    """``graph_replay_pct.<kind>`` of the synthetic window with ``records``
    as the program's spans."""
    from harness import program_spans, spec
    from harness.runner import Readings
    from harness.trace import Trace

    def read(name, records):
        monkeypatch.setattr(program_spans, "program_records", lambda: records)
        r = Readings(spec.cell("birds3-gan-b24"), Trace([("k", 0, 20 * MS)], [], (10 * MS, 50 * MS), []),
                     {}, {}, [], 0.04)
        return spec.metric_reader(name).read(r, name)

    return read


@pytest.mark.parametrize("graphs, pct", [
    (("replay", "eager", "capture", "replay", "replay"), 100 * 2 / 4),  # step 0 starts before the window
    (("eager", "replay", "replay", "replay"), 100.0),
    (("replay", "eager", "eager", "capture"), 0.0),
    (("eager", None, "replay"), 100 * 1 / 1),  # a step that says nothing is not counted
])
def test_share_of_the_windows_steps_that_replayed(reading, graphs, pct):
    assert reading("graph_replay_pct.gan", steps(*graphs)) == pytest.approx(pct)


@pytest.mark.parametrize("records", [
    steps(None, None, None),  # a program whose step does not say how it ran
    [r for r in steps("eager", "replay") if r.name != "gan.step"],  # no step
    None,  # a program without the recorder
])
def test_none_where_no_step_says_how_it_ran(reading, records):
    assert reading("graph_replay_pct.gan", records) is None


def test_the_encoder_step_reads_none(reading):
    assert reading("graph_replay_pct.encoder", steps("replay", "replay")) is None
