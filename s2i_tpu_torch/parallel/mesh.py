"""Data parallelism over processes, the counterpart of
``s2i_tpu/parallel/mesh.py``.

The JAX package runs its steps under ``shard_map`` over a 1-D ``data``
mesh: parameters replicated, the batch split by rows, BatchNorm statistics
and gradients ``pmean``-ed over the axis. Here each rank is a process with
one card (``torchrun --nproc_per_node N``, or a test that spawns its ranks),
and :class:`DataAxis` stands in for the axis name: it holds the rank, the
world size and the process group, and offers the collectives the steps
need. A step on N ranks, each on its rows of one global batch, gives the
one-process step's result on that global batch, up to the order of the
all-reduce's sums:

- every BatchNorm ``pmean``s its float32 (mean, E[x²]) before
  ``max(0, E[x²] - E[x]²)`` (``models.layers.BatchNorm(axis=)``), so the
  running statistics move identically on every rank;
- the step's noise is drawn for the global batch from (SEED, step) on every
  rank, and each keeps its rows (``train.gan.step_noise``);
- the wrong pair looks across ranks (:meth:`DataAxis.global_roll1`, or the
  class-aware pick over the gathered conditions);
- gradients are averaged in one flat all-reduce per optimizer step
  (:meth:`DataAxis.pmean_grads`), and so are the metrics.

Where the JAX package shrinks its mesh to a divisor of the batch,
:func:`make_mesh_if_configured` raises: processes are launched, and a
launched rank cannot be taken away.

    if maybe_initialize_distributed("cuda"):      # torchrun's environment
        axis = make_mesh_if_configured(cfg, 24)   # DataAxis over every rank; 24 rows a global batch
    step = make_parallel_train_step(state, axis)  # step(global_batch) → metrics
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from s2i_tpu_torch.utils.logging import span

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT_S = 600.0  # a collective that waits longer than this raises instead of hanging


def launched_world_size() -> int:
    """The world size torchrun's environment names (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def maybe_initialize_distributed(device: str | torch.device = "cuda", backend: str | None = None,
                                 timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); returns False without that environment. On a card
    the rank takes ``cuda:LOCAL_RANK`` (or ``device``'s index) as its
    current device and the backend is NCCL; ``device`` "cpu" takes gloo.
    ``backend`` overrides the choice (gloo ranks may share one card). An
    init that fails raises, and so does a missing backend: nothing falls
    back to one process."""
    if dist.is_available() and dist.is_initialized():
        return True
    if "RANK" not in os.environ and "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"a distributed launch needs {', '.join(TORCHRUN_ENV)}; {', '.join(missing)} unset")
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if not dist.is_available():
        raise RuntimeError(f"WORLD_SIZE={world}, but this torch has no torch.distributed")
    dev = local_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not {"nccl": dist.is_nccl_available, "gloo": dist.is_gloo_available}[backend]():
        raise RuntimeError(f"WORLD_SIZE={world}, but this torch has no {backend} backend")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        # With this variable unset, a BN pmean cost the host 98-326 µs on
        # the card against ~65 with it 0, and the GAN step issues ~150 of
        # them on a host about as slow as its device (PERF.md §6). Off
        # unless the caller sets it.
        os.environ.setdefault("TORCH_NCCL_TRACE_BUFFER_SIZE", "0")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=dev if backend == "nccl" else None)
    return True


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: the CPU, ``device`` when it names a card's
    index, else ``cuda:LOCAL_RANK``. Raises without a card."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    index = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", "0"))
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"cuda:{index} asked for, but this machine has {torch.cuda.device_count()} card(s)")
    return torch.device("cuda", index)


def mesh_rank() -> int:
    """This process's rank in the joined process group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def destroy() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class _PMean(torch.autograd.Function):
    """The mean over the ranks, whose backward is the mean of the
    cotangents over the ranks: JAX's ``pmean`` and its transpose."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, axis: "DataAxis") -> torch.Tensor:
        ctx.axis = axis
        return axis.mean_(x.clone())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.axis.mean_(g.clone()), None


class DataAxis:
    """The ``data`` axis of the JAX package's mesh as processes: this rank
    and the world size of the joined process group, and a gloo group for
    host flags (None: the joined group, when its backend is gloo). Every
    method but :meth:`rows` is a collective: every rank calls it, in the
    same order."""

    def __init__(self, name: str = "data", host_group=None):
        self.name = name
        self.group = None  # the joined process group, every rank
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.host_group = host_group

    def __deepcopy__(self, memo) -> "DataAxis":
        return self  # a module copied with its BatchNorms keeps the one axis

    def __repr__(self) -> str:
        return f"DataAxis({self.name!r}, rank {self.rank} of {self.size})"

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n`` global rows; raises unless the world
        size divides ``n``."""
        if n % self.size:
            raise ValueError(f"global batch {n} not divisible by the {self.name} axis's {self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` replaced in place by its mean over the ranks (no gradient)."""
        dist.all_reduce(t, group=self.group)
        return t.div_(self.size)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks, differentiable (the backward
        averages the cotangents over the ranks)."""
        return _PMean.apply(x, self)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along dim 0 in rank order (a tiled
        gather), with no gradient. It runs as an all-reduce of a zero
        buffer holding this rank's rows, which is exact and which gloo
        offers for CUDA tensors (its all-gather takes CPU tensors only)."""
        x = x.detach()
        b = x.shape[0]
        buf = x.new_zeros((self.size * b, *x.shape[1:]))
        buf[self.rank * b:(self.rank + 1) * b] = x
        dist.all_reduce(buf, group=self.group)
        return buf

    def global_roll1(self, x: torch.Tensor) -> torch.Tensor:
        """``torch.roll(x, 1, 0)`` over the global batch, with no gradient:
        the first row is the previous rank's last row (the JAX package's
        ``ppermute`` hop, ``s2i_tpu/train/gan.py::global_roll1``)."""
        last = self.all_gather(x[-1:])
        return torch.cat([last[(self.rank - 1) % self.size][None], x.detach()[:-1]])

    def pmean_grads(self, params) -> None:
        """Average the gradients of ``params`` over the ranks in one flat
        all-reduce. A parameter without a gradient has none on every rank
        (the ranks run one program) and is skipped. Host span
        ``parallel.pmean_grads``."""
        with span("parallel.pmean_grads"):
            grads = [p.grad for p in params if p.grad is not None]
            if not grads:
                return
            flat = torch.cat([g.reshape(-1).float() for g in grads])
            self.mean_(flat)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def pmean_metrics(self, mets: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The metrics (0-d tensors) averaged over the ranks, in one all-reduce."""
        if not mets:
            return mets
        flat = self.mean_(torch.stack([v.detach().float() for v in mets.values()]))
        return dict(zip(mets, flat.unbind()))

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on some rank, agreed on the host (no sync
        with the card)."""
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        dist.all_reduce(t, group=self.host_group)
        return bool(t.item())

    def barrier(self) -> None:
        """Wait on the host until every rank is here."""
        self.any(False)

    def broadcast_(self, tensors) -> None:
        """Overwrite each tensor in place with rank 0's: a card's tensors over
        the joined group, the host's over the gloo group (NCCL moves no CPU
        tensor, and an optimizer's ``step`` counts live on the host)."""
        for t in tensors:
            dist.broadcast(t, 0, group=self.host_group if t.device.type == "cpu" else self.group)

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` (picklable) on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, 0, group=self.host_group)
        return box[0]


def make_mesh(name: str = "data") -> DataAxis:
    """The axis over every rank of the joined process group (a gloo group
    is made beside an NCCL one for the host flags)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: launch with torchrun (maybe_initialize_distributed)")
    host = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    return DataAxis(name, host_group=host)


def make_mesh_if_configured(cfg=None, batch_size: int | None = None) -> DataAxis | None:
    """The data axis of a command (``s2i_tpu/cli.py::make_mesh_if_configured``):
    None in a process that joined no process group, else a
    :class:`DataAxis` over every rank (one rank included, so that a
    one-card torchrun still runs the collectives). ``MESH.NUM_DEVICES``
    other than 0 must be the world size, and the world size must divide
    ``batch_size``, the global batch the command splits (None for one that
    pads its batches, as sampling does): where the JAX package would shrink
    its mesh, this raises and names the world size to launch with."""
    want = int(cfg.MESH.NUM_DEVICES) if cfg is not None else 0
    launched = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if launched else 1
    if want not in (0, world):
        raise ValueError(f"MESH.NUM_DEVICES={want}, but {world} rank(s) were launched: "
                         f"launch with torchrun --nproc_per_node {want}, or set MESH.NUM_DEVICES=0")
    if not launched:
        return None
    if batch_size is not None and batch_size % world:
        fits = [n for n in range(1, world + 1) if batch_size % n == 0]
        raise ValueError(f"the global batch {batch_size} does not split over {world} ranks: launch with "
                         f"--nproc_per_node in {fits}, or pick a batch that {world} divides")
    return make_mesh(str(cfg.MESH.DATA_AXIS) if cfg is not None else "data")


def _map_rows(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_rows(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_rows(fn, v) for v in tree)
    return tree


def shard_batch(batch: Any, axis: DataAxis | None) -> Any:
    """This rank's rows of every array (numpy or tensor) of a global batch
    (``s2i_tpu/parallel/mesh.py::shard_batch``); raises on a batch that the
    world size does not divide. No axis: the batch as it is."""
    if axis is None:
        return batch
    return _map_rows(lambda a: a[axis.rows(a.shape[0])], batch)


def replicate_state(state, axis: DataAxis | None) -> Any:
    """Every tensor of a train state (parameters, buffers, optimizer
    moments, the EMA) overwritten with rank 0's, in place; returns the
    state. The seeded init and a restore give every rank the same state
    already: this makes it so whatever the state went through."""
    if axis is None:
        return state
    tensors = []

    def collect(obj):
        if isinstance(obj, torch.Tensor):
            tensors.append(obj)
        elif isinstance(obj, dict):
            for v in obj.values():
                collect(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                collect(v)

    models = getattr(state, "models", None)
    mods = [state.model] if models is None else [models.g, *models.ds, models.encoder]
    for m in mods:
        if m is not None:
            tensors += list(m.parameters()) + list(m.buffers())
    opts = [state.opt] if models is None else [state.g_opt, *state.d_opts]
    for opt in opts:
        collect(list(opt.state.values()))
    collect(getattr(state, "ema", {}))
    with torch.no_grad():
        axis.broadcast_([t for t in tensors if t.numel()])
    return state


def make_parallel_train_step(state, axis: DataAxis) -> Callable:
    """The GAN step over the axis (``s2i_tpu/parallel/mesh.py::make_parallel_train_step``):
    ``state`` takes the axis (its BatchNorms sync over it) and the returned
    ``step(global_batch, **kw)`` runs ``train.gan.train_step`` on this rank's
    rows, metrics averaged over the ranks."""
    from s2i_tpu_torch.train import gan

    gan.use_axis(state, axis)
    return lambda batch, **kw: gan.train_step(state, shard_batch(batch, axis), **kw)


def make_parallel_encoder_step(state, axis: DataAxis) -> Callable:
    """The encoder distillation step over the axis
    (``make_parallel_encoder_step``): ``step(global_batch)`` on this rank's
    rows, with the encoder's BatchNorms synced and gradients, loss and
    metrics averaged."""
    from s2i_tpu_torch.train import encoder

    encoder.use_axis(state, axis)
    return lambda batch: encoder.encoder_train_step(state, shard_batch(batch, axis))


def make_parallel_sample_fn(g, axis: DataAxis | None) -> Callable:
    """Sampling over the axis (``make_parallel_sample_fn``):
    ``fn(embeddings, seed=0, offset=0)`` samples this rank's rows of the
    global ``embeddings`` with eval-mode ``g``, their noise keyed by global
    index (``offset`` + the rank's first row), and returns every stage's
    images of the global batch on every rank: bitwise the one-process
    ``train.gan.sample`` where the forward is batch-invariant."""
    from s2i_tpu_torch.train import gan

    def fn(embeddings, seed: int = 0, offset: int = 0) -> list[torch.Tensor]:
        if axis is None:
            return gan.sample(g, embeddings, seed=seed, offset=offset)
        rows = axis.rows(len(embeddings))
        imgs = gan.sample(g, embeddings[rows], seed=seed, offset=offset + rows.start)
        return [axis.all_gather(im) for im in imgs]

    return fn
