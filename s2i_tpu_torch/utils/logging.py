"""Scalar logging and profiling hooks, the counterpart of
``s2i_tpu/utils/logging.py``.

JSONL is the primary sink. With ``use_tensorboard`` (``TRAIN.TENSORBOARD``)
the logger also writes TensorBoard event files under ``<run_dir>/tb``, where
the JAX package's logger writes them through ``tf.summary``. They are written
by :class:`EventWriter`, which needs neither TensorBoard, TensorFlow nor
protobuf (the card's machine has none of them): TFRecord framing with masked
CRC32C checksums around ``Event`` messages encoded here by hand, a scalar
summary (``simple_value``) per logged key and a PNG image summary per
``log_image``, the records ``torch.utils.tensorboard`` writes.
:func:`read_events` reads such a file back and checks every checksum.
``profile_steps`` wraps a block in a ``torch.profiler`` trace written as a
Chrome trace (chrome://tracing, Perfetto).

:func:`span` marks a part of the program's host work (the GAN and encoder
steps' parts, featurize, the trainer loop's waits). It records only while a
``torch.profiler`` runs in the process (``profile_steps``, an operator's own
profiler, a benchmark's traced window): then each span is kept in memory
with ``time.time_ns()``, the clock the profiler's events carry, and shows in
the exported trace as a ``record_function`` range. Otherwise it hands back
one shared object that does nothing.

    with span("gan.step", step=state.step):
        ...
    records, dropped = span_records()   # SpanRecord tuples, oldest first
    clear_spans()
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import socket
import struct
import threading
import time
from typing import Any, Iterator, NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1  # Castagnoli, reflected
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def masked_crc32c(data: bytes) -> int:
    """TFRecord's checksum: CRC-32C of ``data``, rotated right by 15 bits
    plus 0xa282ead8 (mod 2**32)."""
    crc, table = 0xFFFFFFFF, _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # a negative int64 is ten bytes of two's complement
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def _field(number: int, value) -> bytes:
    """One protobuf field: a float (32-bit; a ``double`` goes as
    ``("d", x)``), an int (varint) or bytes (length-delimited)."""
    if isinstance(value, tuple):
        return _varint(number << 3 | 1) + struct.pack("<d", value[1])
    if isinstance(value, float):
        return _varint(number << 3 | 5) + struct.pack("<f", value)
    if isinstance(value, int):
        return _varint(number << 3) + _varint(value)
    return _varint(number << 3 | 2) + _varint(len(value)) + bytes(value)


def _event(step: int | None, what: bytes) -> bytes:
    """An ``Event``: wall_time (1), step (2), then ``what``, a file_version
    (3) or summary (5) field."""
    head = _field(1, ("d", time.time()))
    return head + (_field(2, int(step)) if step else b"") + what


def _png(image) -> tuple[bytes, int, int, int]:
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3):
        raise ValueError(f"an image summary takes uint8 [H, W] or [H, W, C], got {arr.dtype} {arr.shape}")
    arr = arr[..., 0] if arr.ndim == 3 and arr.shape[2] == 1 else arr
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue(), arr.shape[0], arr.shape[1], 1 if arr.ndim == 2 else arr.shape[2]


class EventWriter:
    """One TensorBoard event file, ``<logdir>/events.out.tfevents.<time>.<host>.<pid>.<n>``,
    opened with the ``file_version: "brain.Event:2"`` record. Each call
    writes its records and flushes them to the OS, so a killed run keeps
    every record of the calls it finished."""

    _count = itertools.count()

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}.{os.getpid()}.{next(self._count)}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "wb")
        self._write(_event(None, _field(3, b"brain.Event:2")))

    def _write(self, *events: bytes) -> None:
        for data in events:
            head = struct.pack("<Q", len(data))
            self._f.write(head + struct.pack("<I", masked_crc32c(head)) + data
                          + struct.pack("<I", masked_crc32c(data)))
        self._f.flush()

    def scalars(self, step: int, scalars: dict[str, Any]) -> None:
        """A scalar summary (tag, ``simple_value``: float32) per key."""
        self._write(*(_event(step, _field(5, _field(1, _field(1, str(k).encode()) + _field(2, float(v)))))
                      for k, v in scalars.items()))

    def image(self, step: int, tag: str, image) -> None:
        """A PNG image summary of a uint8 [H, W(, C)] image."""
        png, h, w, c = _png(image)
        img = _field(1, h) + _field(2, w) + _field(3, c) + _field(4, png)
        self._write(_event(step, _field(5, _field(1, _field(1, tag.encode()) + _field(4, img)))))

    def close(self) -> None:
        self._f.close()


def _fields(buf: bytes) -> Iterator[tuple[int, Any]]:
    """The (number, value) fields of one protobuf message: varints as ints,
    32- and 64-bit fields as their 4 or 8 bytes, length-delimited as bytes."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, i = buf[i: i + n], i + n
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i: i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, value


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        n |= (b & 0x7F) << shift
        i += 1
        shift += 7
        if not b & 0x80:
            return n, i


def read_events(path: str) -> list[dict]:
    """The records of an event file, each ``{"wall_time", "step"}`` plus
    ``"file_version"`` or ``"values"``: a list of ``{"tag", "simple_value"}``
    or ``{"tag", "image": {"height", "width", "colorspace", "png"}}``.
    Raises ``ValueError`` on a checksum that does not match or a torn
    record."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        head = data[i: i + 8]
        n = struct.unpack("<Q", head)[0] if len(head) == 8 else 0
        if len(data) < i + 16 + n:
            raise ValueError(f"{path}: torn record at byte {i}")
        (crc,) = struct.unpack("<I", data[i + 8: i + 12])
        body = data[i + 12: i + 12 + n]
        (body_crc,) = struct.unpack("<I", data[i + 12 + n: i + 16 + n])
        if crc != masked_crc32c(head) or body_crc != masked_crc32c(body):
            raise ValueError(f"{path}: checksum mismatch in the record at byte {i}")
        i += 16 + n
        rec: dict = {"wall_time": 0.0, "step": 0}
        for number, value in _fields(body):
            if number == 1:
                rec["wall_time"] = struct.unpack("<d", value)[0]
            elif number == 2:
                rec["step"] = value - (1 << 64) if value >> 63 else value
            elif number == 3:
                rec["file_version"] = value.decode()
            elif number == 5:
                rec["values"] = [_summary_value(v) for k, v in _fields(value) if k == 1]
        out.append(rec)
    return out


def _summary_value(buf: bytes) -> dict:
    val: dict = {}
    for number, value in _fields(buf):
        if number == 1:
            val["tag"] = value.decode()
        elif number == 2:
            val["simple_value"] = struct.unpack("<f", value)[0]
        elif number == 4:
            img = dict(_fields(value))
            val["image"] = {"height": img.get(1, 0), "width": img.get(2, 0), "colorspace": img.get(3, 0),
                            "png": img.get(4, b"")}
    return val


class ScalarLogger:
    """JSONL scalars, one line per ``log`` call: ``{"step", "time", **scalars}``
    in ``<run_dir>/scalars.jsonl``. Non-finite values are written as
    strings: bare NaN/Infinity tokens are not valid JSON. With
    ``use_tensorboard`` the same scalars, and the images of ``log_image``, go
    to an :class:`EventWriter` under ``<run_dir>/tb`` too. A logger that is
    not the ``writer`` (a rank other than 0) writes nothing."""

    def __init__(self, run_dir: str, writer: bool = True, use_tensorboard: bool = False):
        self._f = self._tb = None
        if writer:
            os.makedirs(run_dir, exist_ok=True)
            self._f = open(os.path.join(run_dir, "scalars.jsonl"), "a", buffering=1)
            if use_tensorboard:
                self._tb = EventWriter(os.path.join(run_dir, "tb"))

    def log(self, step: int, scalars: dict[str, Any]) -> None:
        if self._f is None:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (f if math.isfinite(f) else str(f))
                    for k, v in scalars.items() for f in (float(v),)})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.scalars(step, scalars)

    def log_image(self, step: int, tag: str, image) -> None:
        """Mirror a uint8 [H, W, C] image (the trainer's sample grid) into
        the event files; without them this does nothing (the PNG on disk is
        the sink)."""
        if self._tb is not None:
            self._tb.image(step, tag, image)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_steps(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` trace of the block (host and, with a card, device
    activity), written to ``log_dir/trace_<time>.json`` as it ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


SPAN_CAP = 1 << 20  # records kept; later ones are counted as dropped


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: int | None  # the id of the span open around it on its thread
    thread: int  # native thread id
    start_ns: int  # time.time_ns()
    end_ns: int
    attrs: dict


class _OpenSpans(threading.local):
    def __init__(self):
        self.stack: list[int] = []  # this thread's open span ids, innermost last


class _SpanBuffer:
    """The recorded spans, the count dropped past ``SPAN_CAP`` and each
    thread's open spans."""

    def __init__(self):
        self.records: list[SpanRecord] = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.lock = threading.Lock()
        self.open = _OpenSpans()

    def add(self, rec: SpanRecord) -> None:
        with self.lock:
            if len(self.records) < SPAN_CAP:
                self.records.append(rec)
            else:
                self.dropped += 1


_SPANS = _SpanBuffer()
_NO_SPAN = contextlib.nullcontext()  # what span() hands back while no profiler runs


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _SPANS.open.stack
        self.parent = stack[-1] if stack else None
        self.id = next(_SPANS.ids)
        stack.append(self.id)
        self.start = time.time_ns()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)
        end = time.time_ns()
        _SPANS.open.stack.pop()
        _SPANS.add(SpanRecord(self.name, self.id, self.parent, threading.get_native_id(), self.start, end,
                              self.attrs))


def span(name: str, **attrs):
    """A context manager over a part of the program's host work: recorded
    (see :func:`span_records`) and shown as a ``record_function`` range in
    the profiler's trace while a profiler runs, else a shared no-op.
    ``attrs`` (the root spans' ``step``) go into the record."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, attrs)


def span_records() -> tuple[list[SpanRecord], int]:
    """(the spans recorded since the last :func:`clear_spans`, in the order
    they ended; the number dropped past ``SPAN_CAP``)."""
    with _SPANS.lock:
        return list(_SPANS.records), _SPANS.dropped


def clear_spans() -> None:
    with _SPANS.lock:
        _SPANS.records.clear()
        _SPANS.dropped = 0
