"""Host input pipeline, the port's copy of ``s2i_tpu/data/pipeline.py``: a
bounded background producer, so that host work (JPEG decode, WAV reads) and
the host-to-device copy of the next batches overlap the current step.

    for batch in prefetch(loader, depth=4, device="cuda"):   # tensors on the card
        train_step(state, batch)

With ``device`` set, the producer thread also moves each batch's numpy
arrays to the device, as the JAX loops ``device_put`` inside their prefetch
worker. On a CUDA device (:class:`_CudaStager`) it copies each array into a
pinned host buffer and from there to the card with ``non_blocking=True`` on
a side stream; the consumer's stream waits on an event recorded after the
batch's copies before it takes the batch. On the CPU the arrays become
tensors with ``torch.as_tensor`` (no copy). Under a data axis each rank
runs its own prefetcher onto its own card (``cuda:LOCAL_RANK``), fed its
rows of each global batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch


def _map_arrays(fn: Callable[[tuple, np.ndarray], Any], tree: Any, path: tuple = ()) -> Any:
    """``tree`` (dicts, tuples and lists of numpy arrays and other leaves)
    with ``fn(path, array)`` in place of every numpy array."""
    if isinstance(tree, np.ndarray):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_arrays(fn, v, path + (i,)) for i, v in enumerate(tree))
    return tree


class _CpuStager:
    """Numpy arrays → CPU tensors sharing their memory."""

    def __call__(self, batch: Any) -> tuple[Any, None]:
        return _map_arrays(lambda _, a: torch.as_tensor(a), batch), None

    def ready(self, staged: tuple[Any, None]) -> Any:
        return staged[0]


class _CudaStager:
    """Numpy arrays → tensors on a CUDA device, copied from pinned host
    buffers on a side stream, from the producer thread.

    Three hazards, and what guards each:
    - a pinned buffer refilled while the card still copies out of it: each
      array's key has a ring of ``slots`` buffers, each with the event of
      its last copy, and a buffer is refilled only after its event;
    - the caching allocator handing a batch's device memory to the next
      copy while the consumer's stream still reads it: the tensors are
      allocated on the side stream and marked ``record_stream(consumer)``,
      so their blocks return to the pool only after the consumer's work;
    - the consumer reading a batch before its copy ends: :meth:`ready`
      makes the consumer's current stream wait on the batch's event.
    """

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.slots = slots
        self.stream = torch.cuda.Stream(device)
        self.consumer = torch.cuda.current_stream(device)
        self._rings: dict[tuple, list[list]] = {}  # key → [[pinned buffer, event of its last copy], ...]
        self._turn: dict[tuple, int] = {}

    def _copy(self, key: tuple, arr: np.ndarray, used: list) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(arr))
        ring = self._rings.setdefault(key, [[None, None] for _ in range(self.slots)])
        turn = self._turn.get(key, 0)
        self._turn[key] = (turn + 1) % self.slots
        slot = ring[turn]
        if slot[1] is not None:
            slot[1].synchronize()  # this buffer's previous copy has left it
        if slot[0] is None or slot[0].shape != src.shape or slot[0].dtype != src.dtype:
            slot[0] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        slot[0].copy_(src)
        dev = slot[0].to(self.device, non_blocking=True)
        dev.record_stream(self.consumer)
        used.append(slot)
        return dev

    def __call__(self, batch: Any) -> tuple[Any, torch.cuda.Event]:
        done = torch.cuda.Event()
        used: list = []
        with torch.cuda.stream(self.stream):
            out = _map_arrays(lambda key, a: self._copy(key, a, used), batch)
            done.record(self.stream)
        for slot in used:
            slot[1] = done
        return out, done

    def ready(self, staged: tuple[Any, torch.cuda.Event]) -> Any:
        out, done = staged
        torch.cuda.current_stream(self.device).wait_event(done)
        return out


def _stager(device: str | torch.device, depth: int):
    dev = torch.device(device)
    if dev.type == "cpu":
        return _CpuStager()
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    # depth batches queued, one in the producer's hands, one with the consumer
    return _CudaStager(dev, slots=depth + 2)


class Prefetcher:
    """Wrap an iterable: produce items in a daemon thread, buffer up to
    ``depth`` items ahead, and (with ``device``) move each item's numpy
    arrays to ``device`` in that thread. Exceptions in the producer, CUDA
    errors included, are raised again on the consumer.

    The consumer may stop early (``max_steps``, SIGTERM): the iterator's
    ``finally`` calls :meth:`close`, which tells the producer to stop
    instead of blocking forever in ``put``, drops the buffered items and
    reaps the thread."""

    _DONE = object()

    def __init__(self, iterable: Iterable, depth: int = 4, device: str | torch.device | None = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: list[BaseException] = []
        self._stop = threading.Event()
        # made here, on the consumer's thread: a CUDA stager records the
        # consumer's current stream
        self._stage = None if device is None else _stager(device, depth)
        self._thread = threading.Thread(target=self._run, args=(iterable,), daemon=True)
        self._thread.start()

    def _put(self, item: Any) -> bool:
        """Blocking put that aborts when the consumer closed us."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, iterable: Iterable) -> None:
        try:
            for item in iterable:
                if self._stage is not None:
                    item = self._stage(item)
                if not self._put(item):
                    return  # consumer gone: drop in-flight work, exit
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            self._err.append(e)
        finally:
            # must block (with the same stop check): dropping _DONE when the
            # queue is momentarily full would leave the consumer waiting in
            # get() forever after it drains the buffered items
            self._put(self._DONE)

    def close(self, join_timeout: float = 30.0) -> None:
        """Idempotent: stop the producer, release buffered items, and reap
        the producer thread. After ``_stop`` is set the producer exits
        within one ``_put`` poll of finishing its current item, so the join
        waits for at most one upstream ``next()``; ``join_timeout`` caps it
        against a pathological producer."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=join_timeout)

    def __iter__(self) -> Iterator:
        try:
            while True:
                item = self._q.get()
                if item is self._DONE:
                    if self._err:
                        raise self._err[0]
                    return
                yield item if self._stage is None else self._stage.ready(item)
        finally:
            self.close()


def prefetch(iterable: Iterable, depth: int = 4, device: str | torch.device | None = None) -> Iterator:
    return iter(Prefetcher(iterable, depth, device))


class ParallelMap:
    """Ordered parallel map over an index sequence (image decode pool)."""

    def __init__(self, fn: Callable[[Any], Any], workers: int = 8):
        self.fn = fn
        self.pool = ThreadPoolExecutor(max_workers=workers)

    def __call__(self, items: Iterable) -> list:
        return list(self.pool.map(self.fn, items))

    def close(self) -> None:
        self.pool.shutdown(wait=False)
