"""Serving on the port (s2i_tpu_torch/serving.py): the Batcher's bounded
queue, draining close, failure propagation and depth-1 pipelining with a
stub pipeline (as tests/test_serving.py does for the JAX package), and one
real HTTP round trip through a tiny torch pipeline on the CPU."""

import io
import queue
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from s2i_tpu_torch import config
from s2i_tpu_torch.audio.wavio import write_wav
from s2i_tpu_torch.pipeline import SpeechToImage, build_encoder, build_generator
from s2i_tpu_torch.serving import Batcher, make_server


class _StubParams:
    max_frames = 4
    hop_length = 2
    win_length = 4
    sample_rate = 16000


class _Lazy:
    """Stands in for a result tensor still being computed: its readback
    (``.cpu().numpy()``) is logged, or fails on demand."""

    def __init__(self, arr, idx, events, fail=False):
        self._arr, self._idx, self._events, self._fail = arr, idx, events, fail

    def cpu(self):
        return self

    def numpy(self):
        if self._fail:
            raise RuntimeError("readback gone")
        self._events.append(("readback", self._idx))
        return self._arr


class _StubPipe:
    """generate_async stand-in: rows stamped with each job's first sample."""

    def __init__(self, delay_s=0.0, fail=False, fail_readback=False):
        self.p = _StubParams()
        self.device = torch.device("cpu")
        self.delay_s, self.fail, self.fail_readback = delay_s, fail, fail_readback
        self.calls = 0
        self.events = []

    def generate_async(self, wavs, lens, output_dtype="uint8"):
        self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail:
            raise RuntimeError("device gone")
        self.events.append(("dispatch", self.calls))
        stamp = wavs[:, 0].astype(np.uint8)
        tile = np.broadcast_to(stamp[:, None, None, None], (wavs.shape[0], 8, 8, 3)).copy()
        return _Lazy(tile, self.calls, self.events, self.fail_readback)

    def generate(self, wavs, lens, output_dtype="uint8"):
        return self.generate_async(wavs, lens, output_dtype).numpy()


def test_batcher_roundtrip_and_close():
    b = Batcher(_StubPipe(), batch_size=2, max_pending=8)
    jobs = [b.submit(np.zeros(4, np.float32)) for _ in range(3)]
    for j in jobs:
        assert j.done.wait(timeout=10)
        assert j.error is None and j.result is not None
    b.close()
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError):
        b.submit(np.zeros(4, np.float32))
    b.close()  # idempotent


def test_batcher_backpressure_full_queue_rejects():
    b = Batcher(_StubPipe(delay_s=0.2), batch_size=1, max_pending=2, wait_ms=1)
    try:
        admitted = []
        with pytest.raises(queue.Full):
            for _ in range(32):  # far beyond capacity + in-flight
                admitted.append(b.submit(np.zeros(4, np.float32)))
        for j in admitted:  # bounded, not lossy
            assert j.done.wait(timeout=30)
            assert j.error is None
    finally:
        b.close()


def test_batcher_close_drains_or_fails_every_job():
    b = Batcher(_StubPipe(delay_s=0.3), batch_size=1, max_pending=16, wait_ms=1)
    jobs = [b.submit(np.zeros(4, np.float32)) for _ in range(6)]
    closer = threading.Thread(target=b.close)
    closer.start()
    for j in jobs:
        assert j.done.wait(timeout=30), "waiter blocked through shutdown"
        assert j.result is not None or j.error == "server shutting down"
    closer.join(timeout=30)
    assert not closer.is_alive() and not b._thread.is_alive()


@pytest.mark.parametrize("kind", ["dispatch", "readback"])
def test_batcher_failures_reach_every_waiter(kind):
    pipe = _StubPipe(fail=kind == "dispatch", fail_readback=kind == "readback")
    b = Batcher(pipe, batch_size=2, max_pending=4)
    try:
        j = b.submit(np.zeros(4, np.float32))
        assert j.done.wait(timeout=10)
        assert j.error is not None and "gone" in j.error
    finally:
        b.close()


def test_batcher_pipelines_one_batch_deep_and_keeps_rows():
    pipe = _StubPipe(delay_s=0.05)
    b = Batcher(pipe, batch_size=2, max_pending=64, wait_ms=1)
    try:
        jobs = [(v, b.submit(np.full(4, float(v), np.float32))) for v in range(1, 11)]
        for v, j in jobs:
            assert j.done.wait(timeout=30)
            assert j.error is None
            assert int(j.result[0, 0, 0]) == v, "pipelined rows crossed jobs"
    finally:
        b.close()
    pos = {e: k for k, e in enumerate(pipe.events)}
    reads = [i for kind, i in pipe.events if kind == "readback"]
    assert reads == list(range(1, pipe.calls + 1))  # all, in batch order
    assert any(
        pos.get(("dispatch", i + 1), 1 << 30) < pos[("readback", i)]
        for i in range(1, pipe.calls)
    )


def _tiny_cfg():
    cfg = config.default_cfg()
    cfg.TREE.BRANCH_NUM = 2
    cfg.GAN.GF_DIM = 4
    cfg.GAN.Z_DIM = 6
    cfg.GAN.EMBEDDING_DIM = 6
    cfg.GAN.R_NUM = 1
    cfg.TEXT.DIMENSION = 12
    cfg.AUDIO.N_MELS = 8
    cfg.AUDIO.MAX_FRAMES = 16
    cfg.ENCODER.CONV_CHANNELS = [6, 8]
    cfg.ENCODER.RNN_HIDDEN = 8
    cfg.ENCODER.CLS_HEAD = False
    return cfg


def test_http_round_trip_on_cpu():
    cfg = _tiny_cfg()
    torch.manual_seed(0)
    pipe = SpeechToImage(
        cfg, build_encoder(cfg).state_dict(), build_generator(cfg).state_dict(), device="cpu"
    )
    with pytest.raises(ValueError, match="unsupported device"):
        make_server(_StubPipe(), port=0, device="meta")
    srv = make_server(pipe, "127.0.0.1", 0, batch_size=2, max_body_bytes=1 << 16,
                      job_timeout_s=60, device="cpu")
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert r.status == 200
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                urllib.request.Request(f"{url}/generate", data=b"\0" * (1 << 17)), timeout=30
            )
        assert exc.value.code == 413
        rng = np.random.default_rng(0)
        bodies = []
        for n in (1200, 2000, 3000):  # ragged lengths, tone + noise floor
            t = np.arange(n) / 16000.0
            buf = io.BytesIO()
            write_wav(buf, 0.3 * np.sin(2 * np.pi * 300 * t) + 0.02 * rng.standard_normal(n), 16000)
            bodies.append(buf.getvalue())
        results = [None] * len(bodies)

        def post(i):
            req = urllib.request.Request(f"{url}/generate", data=bodies[i], method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                results[i] = (r.status, r.headers["Content-Type"], r.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        for status, ctype, png in results:
            assert (status, ctype) == (200, "image/png")
            assert png[:8] == b"\x89PNG\r\n\x1a\n"
            assert int.from_bytes(png[16:20], "big") == 128  # IHDR width: top stage
    finally:
        srv.shutdown()
        srv.server_close()
    assert not srv.batcher._thread.is_alive()
