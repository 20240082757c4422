"""HTTP serving on the torch pipeline, the counterpart of
``s2i_tpu/serving.py``. Stdlib ``http.server``; a background collator thread
micro-batches requests so concurrent clients share one device batch of a
fixed shape.

    POST /generate   body: WAV bytes (PCM 8/16/24/32-bit)   → PNG bytes
    GET  /healthz                                       → {"status": "ok"}
"""

from __future__ import annotations

import io
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from s2i_tpu_torch.audio.wavio import read_wav, resample_linear
from s2i_tpu_torch.device import resolve_device


class _Job:
    def __init__(self, wav: np.ndarray, n: int):
        self.wav = wav
        self.n = n
        self.done = threading.Event()
        self.result: np.ndarray | None = None
        self.error: str | None = None


class Batcher:
    """Collates jobs into fixed-size device batches (pad with zeros).

    Backpressure: the queue is bounded (``max_pending``); a submit against
    a full queue raises ``queue.Full`` at once (the HTTP layer maps it to
    503) instead of growing a backlog behind a slow device.
    Throughput: dispatch is pipelined one batch deep (see :meth:`_run`): the
    card computes batch i+1 while the host reads back batch i. The readback
    runs on a stream of its own, behind an event recorded when batch i was
    queued, so it does not wait for batch i+1's compute.
    Shutdown: :meth:`close` drains: queued jobs still run, new submits are
    rejected, the collator thread is joined, and anything the collator never
    reached is failed so no waiter blocks forever.
    """

    def __init__(self, pipe, batch_size: int = 8, wait_ms: int = 5,
                 max_pending: int = 64):
        self.pipe = pipe
        self.batch_size = batch_size
        self.wait_s = wait_ms / 1000.0
        p = pipe.p
        self.max_samples = (p.max_frames - 1) * p.hop_length + p.win_length
        self._q: queue.Queue[_Job] = queue.Queue(maxsize=max_pending)
        self._closed = threading.Event()
        # Serializes submit's closed-check + put against close's closed-set,
        # so no job lands after close drained the queue.
        self._submit_lock = threading.Lock()
        self._copy_stream = None  # created by the collator on first CUDA result
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, wav: np.ndarray) -> _Job:
        job = _Job(wav, min(len(wav), self.max_samples))
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("batcher is shut down")
            self._q.put_nowait(job)  # raises queue.Full when saturated
        return job

    def close(self, timeout: float = 60.0) -> None:
        """Idempotent: reject new work, drain the queue, join the thread.
        Every job enqueued before close is either processed by the collator
        or failed by the drain below."""
        with self._submit_lock:
            if self._closed.is_set():
                return
            self._closed.set()
        self._thread.join(timeout)
        while True:  # fail anything the collator never picked up
            try:
                job = self._q.get_nowait()
            except queue.Empty:
                break
            job.error = "server shutting down"
            job.done.set()

    def _mark(self, dev):
        """An event after the work that produces ``dev``, if it is on a card."""
        if not (isinstance(dev, torch.Tensor) and dev.is_cuda):
            return None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev.device))
        return ready

    def _finalize(self, jobs, dev, ready) -> None:
        """Read a dispatched batch back to the host and release its waiters."""
        try:
            if ready is None:
                imgs = dev.cpu().numpy()
            else:
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(dev.device)
                with torch.cuda.stream(self._copy_stream):
                    self._copy_stream.wait_event(ready)
                    imgs = dev.cpu().numpy()
            for j, job in enumerate(jobs):
                job.result = imgs[j]
        except Exception as e:  # propagate to every waiter
            for job in jobs:
                job.error = f"{type(e).__name__}: {e}"
        for job in jobs:
            job.done.set()

    def _run(self) -> None:
        # Depth-1 dispatch pipeline: `pending` is a batch whose device work
        # is queued but whose readback has not been forced yet. Under load
        # the collator dispatches batch i+1 BEFORE reading back batch i;
        # under sporadic load the empty-queue branch finalizes at once, so a
        # single request pays no added latency.
        pending = None
        while True:
            if pending is not None:
                try:
                    jobs = [self._q.get_nowait()]
                except queue.Empty:
                    self._finalize(*pending)
                    pending = None
                    continue
            else:
                try:
                    jobs = [self._q.get(timeout=0.1)]
                except queue.Empty:
                    if self._closed.is_set():
                        return  # drained + closed: exit
                    continue
            try:
                while len(jobs) < self.batch_size:
                    if pending is not None:
                        # a batch is in flight: dispatch now with what is
                        # queued rather than wait for fill
                        jobs.append(self._q.get_nowait())
                    else:
                        jobs.append(self._q.get(timeout=self.wait_s))
            except queue.Empty:
                pass
            wavs = np.zeros((self.batch_size, self.max_samples), np.float32)
            lens = np.zeros(self.batch_size, np.int32)
            for j, job in enumerate(jobs):
                wavs[j, : job.n] = job.wav[: job.n]
                lens[j] = job.n
            try:
                # uint8: PNG-ready bytes, 4x less device→host
                dev = self.pipe.generate_async(wavs, lens, output_dtype="uint8")
                ready = self._mark(dev)
            except Exception as e:  # dispatch error: fail this batch
                dev = None
                for job in jobs:
                    job.error = f"{type(e).__name__}: {e}"
            if pending is not None:
                self._finalize(*pending)
                pending = None
            if dev is None:
                for job in jobs:
                    job.done.set()
            else:
                pending = (jobs, dev, ready)


def _decode_wav_bytes(data: bytes, target_sr: int) -> np.ndarray:
    x, sr = read_wav(io.BytesIO(data))
    return resample_linear(x, sr, target_sr)


def make_server(
    pipe, host: str = "127.0.0.1", port: int = 8500,
    batch_size: int = 8, max_pending: int = 64, warmup: bool = True,
    max_body_bytes: int = 8 << 20, job_timeout_s: float = 120.0,
    device: str | torch.device = "cuda",
) -> ThreadingHTTPServer:
    """An HTTP server over ``pipe`` (a ``SpeechToImage`` built for the same
    ``device``). ``max_body_bytes`` caps the request body before it is read
    (oversize → 413); ``job_timeout_s`` bounds how long a handler waits for
    its batch. ``warmup`` runs one full batch before accepting traffic."""
    dev = resolve_device(device)
    if pipe.device.type != dev.type:
        raise ValueError(f"pipeline runs on {pipe.device}, server asked for {dev}")
    batcher = Batcher(pipe, batch_size, max_pending=max_pending)
    if warmup:
        wavs = np.zeros((batch_size, batcher.max_samples), np.float32)
        lens = np.ones(batch_size, np.int32)
        pipe.generate(wavs, lens, output_dtype="uint8")
    sample_rate = pipe.p.sample_rate

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._json(400, {"error": "bad Content-Length"})
                return
            if n > max_body_bytes:
                # reject by the declared length BEFORE reading the body
                self._json(413, {"error": f"body {n} bytes exceeds cap {max_body_bytes}"})
                return
            try:
                wav = _decode_wav_bytes(self.rfile.read(n), sample_rate)
            except Exception as e:
                self._json(400, {"error": f"bad wav: {e}"})
                return
            try:
                job = batcher.submit(wav)
            except queue.Full:
                self._json(503, {"error": "queue full, retry later"})
                return
            except RuntimeError:
                self._json(503, {"error": "server shutting down"})
                return
            job.done.wait(timeout=job_timeout_s)
            if job.error or job.result is None:
                self._json(500, {"error": job.error or "timeout"})
                return
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(job.result).save(buf, format="PNG")
            png = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            self.end_headers()
            self.wfile.write(png)

    class Server(ThreadingHTTPServer):
        def server_close(self):  # stop/restart-safe: join the collator
            super().server_close()
            batcher.close()

    srv = Server((host, port), Handler)
    srv.batcher = batcher
    return srv
