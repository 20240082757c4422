"""The port's host spans (``utils.logging.span``) on the CPU at tiny widths
(the GAN of cfg/debug_tiny.yml, a small encoder): nothing recorded and one
shared object handed back while no profiler runs; under ``torch.profiler``
the GAN and encoder steps' span trees, each span's ``record_function``
range inside its record on the shared clock, and the buffer's cap."""

import itertools
import sys
import threading
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from s2i_tpu_torch import config
from s2i_tpu_torch.audio.frontend import featurize, frontend_params_from_cfg
from s2i_tpu_torch.data import synthetic_wavs
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.train.encoder import encoder_train_step, init_encoder_state
from s2i_tpu_torch.utils import logging as span_log
from s2i_tpu_torch.utils import clear_spans, span, span_records

B = 4
CLOCK_NS = 50_000  # the profiler's events and time.time_ns() agree to well within this
TINY = Path(__file__).resolve().parent.parent / "cfg" / "debug_tiny.yml"
AUDIO = ["AUDIO.N_MELS=8", "AUDIO.MAX_FRAMES=32", "ENCODER.CONV_CHANNELS=[8, 16]", "ENCODER.RNN_HIDDEN=16",
         "ENCODER.N_CLASSES=8", "TEXT.DIMENSION=32"]
GAN_CHILDREN = {
    "gan.step": {"gan.prepare", "gan.g_forward", "gan.d_phase", "gan.g_phase"},
    "gan.d_phase": {"gan.d_forward", "gan.d_opt", "gan.d_backward"},
    "gan.g_phase": {"gan.adversarial", "gan.g_opt", "gan.g_backward", "gan.ema"},
    "gan.adversarial": {"gan.d_stats_save", "gan.d_stats_restore"},
}


@pytest.fixture(autouse=True)
def one_thread_and_no_spans():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    clear_spans()
    yield
    clear_spans()
    torch.set_num_threads(n)


def cfg_of(*over):
    cfg = config.cfg_from_file(str(TINY))
    return config.apply_overrides(cfg, ["DTYPE.COMPUTE=float32", *AUDIO, *over])


def gan_batch(cfg, joint: bool) -> dict:
    rng = np.random.default_rng(0)
    size = 64 * 2 ** (int(cfg.TREE.BRANCH_NUM) - 1)
    batch = {"images": (rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),), "class_id": np.arange(B)}
    if joint:
        frames, mels = int(cfg.AUDIO.MAX_FRAMES), int(cfg.AUDIO.N_MELS)
        batch.update(feats=rng.standard_normal((B, frames, mels)).astype(np.float32),
                     feat_mask=np.ones((B, frames), bool),
                     teacher=rng.standard_normal((B, int(cfg.TEXT.DIMENSION))).astype(np.float32))
    else:
        batch["embedding"] = rng.standard_normal((B, int(cfg.TEXT.DIMENSION))).astype(np.float32)
    return batch


def encoder_batch(cfg) -> dict:
    p = frontend_params_from_cfg(cfg.AUDIO)
    cls = np.arange(B) % int(cfg.ENCODER.N_CLASSES)
    wav, lens = synthetic_wavs(cls, 4000, seed=1)
    teacher = np.random.default_rng(2).standard_normal((B, int(cfg.TEXT.DIMENSION))).astype(np.float32)
    return {"wav": wav, "wav_len": lens, "teacher": teacher, "class_id": cls}, p


def encoder_step(state, raw, p):
    return encoder_train_step(state, featurize(raw, p, "cpu"))


def profiled(fn, steps: int):
    """Run ``fn`` ``steps`` times under a CPU ``torch.profiler``: (span
    records, the profiler's events as (name, start_ns, end_ns))."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    records, dropped = span_records()
    assert dropped == 0
    return records, events


def check_tree(records, children: dict[str, set]) -> dict:
    """Every child inside its parent on the parent's thread; a parent at
    least as long as its children together; the child names of each parent
    name as ``children`` says. Returns {id: record}."""
    by_id = {r.id: r for r in records}
    kids: dict[int, list] = {}
    for r in records:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, (p.name, r.name)
            assert p.thread == r.thread
            kids.setdefault(p.id, []).append(r)
    for pid, ks in kids.items():
        p = by_id[pid]
        assert sum(k.end_ns - k.start_ns for k in ks) <= p.end_ns - p.start_ns, p.name
        if p.name in children:
            assert {k.name for k in ks} == children[p.name], p.name
    return by_id


def check_ranges(records, events) -> None:
    """Each span's record_function range lies inside its record, to within
    the shared clock's agreement."""
    for name in {r.name for r in records}:
        recs = sorted((r for r in records if r.name == name), key=lambda r: r.start_ns)
        evs = sorted((e for e in events if e[0] == name), key=lambda e: e[1])
        assert len(evs) == len(recs), name
        for r, (_, s, e) in zip(recs, evs):
            assert r.start_ns - CLOCK_NS <= s <= e <= r.end_ns + CLOCK_NS, name


def left_behind(n: int) -> int:
    """Bytes still allocated after ``n`` nested pairs of spans."""
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, n):
            with span("gan.step", step=0):
                with span("gan.prepare"):
                    pass
        return tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()


def test_spans_are_a_shared_no_op_without_a_profiler():
    """No profiler: a GAN step and an encoder step record nothing, every
    span() is one object, and 10 000 spans leave no memory behind."""
    cfg = cfg_of()
    state = gan.init_state(cfg, "cpu")
    gan.train_step(state, gan_batch(cfg, False))
    raw, p = encoder_batch(cfg)
    encoder_step(init_encoder_state(cfg, "cpu"), raw, p)
    assert span_records() == ([], 0)
    assert span("gan.step", step=3) is span("gan.prepare") is span("encoder.opt")
    assert left_behind(10_000) == left_behind(10)
    assert span_records() == ([], 0)


@pytest.mark.parametrize("joint", [False, True], ids=["frozen", "joint"])
def test_gan_step_spans_under_the_profiler(joint):
    """Two steps: one gan.step root each carrying its step index, the parts
    nested under it, the joint encoder's forward under gan.g_forward, every
    range of the profiler inside its record."""
    cfg = cfg_of("TRAIN.JOINT_FT=true", "TRAIN.COEFF.DISTILL=1.0") if joint else cfg_of()
    state = gan.init_state(cfg, "cpu")
    batch = gan_batch(cfg, joint)
    gan.train_step(state, batch)  # outside the profiler: not recorded
    records, events = profiled(lambda: gan.train_step(state, batch), 2)
    roots = [r for r in records if r.parent is None]
    assert [(r.name, r.attrs) for r in sorted(roots, key=lambda r: r.start_ns)] == [
        ("gan.step", {"step": 1}), ("gan.step", {"step": 2})]
    children = dict(GAN_CHILDREN, **{"gan.g_forward": {"gan.encoder_forward"}} if joint else {})
    check_tree(records, children)
    names = [r.name for r in records]
    assert names.count("gan.d_forward") == 2 * 2 and names.count("gan.d_opt") == 2 * 2  # 2 Ds; zero_grad, step
    assert ("gan.encoder_forward" in names) == joint
    check_ranges(records, events)


def test_encoder_step_spans_under_the_profiler():
    """featurize is a root of its own beside encoder.step, which carries its
    step index and holds the forward, the backward and the optimizer."""
    cfg = cfg_of()
    state = init_encoder_state(cfg, "cpu")
    raw, p = encoder_batch(cfg)
    encoder_step(state, raw, p)
    records, events = profiled(lambda: encoder_step(state, raw, p), 2)
    roots = sorted((r for r in records if r.parent is None), key=lambda r: r.start_ns)
    assert [(r.name, r.attrs) for r in roots] == [("audio.featurize", {}), ("encoder.step", {"step": 1}),
                                                  ("audio.featurize", {}), ("encoder.step", {"step": 2})]
    check_tree(records, {"encoder.step": {"encoder.forward", "encoder.backward", "encoder.opt"}})
    assert [r.name for r in records].count("encoder.opt") == 2 * 2  # zero_grad, step
    check_ranges(records, events)


def test_span_buffer_drops_past_its_cap_and_counts(monkeypatch):
    monkeypatch.setattr(span_log, "SPAN_CAP", 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(5):
            with span("s", i=i):
                pass
    records, dropped = span_records()
    assert [r.attrs["i"] for r in records] == [0, 1, 2] and dropped == 2
    clear_spans()
    assert span_records() == ([], 0)


def test_spans_from_many_threads_keep_their_own_nesting():
    """Threads opening spans at once under a short switch interval: every
    record kept, ids unique, each child's parent on its own thread."""
    threads, pairs = 16, 300

    def work():
        for _ in range(pairs):
            with span("outer"):
                with span("inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    records, dropped = span_records()
    by_id = {r.id: r for r in records}
    assert dropped == 0 and len(records) == len(by_id) == threads * pairs * 2
    inner = [r for r in records if r.name == "inner"]
    assert all(by_id[r.parent].name == "outer" and by_id[r.parent].thread == r.thread for r in inner)
    assert all(r.parent is None for r in records if r.name == "outer")
