"""``DATA.PIPELINE: grain``, the counterpart of ``s2i_tpu/data/grain_pipeline.py``
without Grain: the same batches, in Grain's own order, from a map-style
``torch.utils.data.Dataset`` and, with ``DATA.GRAIN_WORKERS`` > 0, a
``DataLoader`` whose worker processes decode the images.

    factory = grain_batch_factory(cfg)        # epoch → host batch dicts
    for batch in factory(0): ...              # {"images", "embedding", "class_id"}

Epoch ``e`` visits the train split in the order of Grain's
``MapDataset.shuffle(seed=SEED + e)``: position ``p`` holds record
:func:`index_shuffle` ``(p, n - 1, SEED + e)``, this module's copy of Grain's
C++ permutation (not of its pure-Python ``index_shuffle_python``, which
gives another order). Batches are consecutive ``TRAIN.BATCH_SIZE``
positions, the remainder dropped. Each example draws its crop, flip and
caption from ``np.random.default_rng([SEED + e, record])``, so it depends on
neither its position nor the process that decodes it: a worker, or a rank
of a data axis that decodes only its rows of each global batch, yields the
rows of the one-process batch.

Workers are forked (start method ``fork``) when an epoch's iterator starts,
and the loader is rebuilt every epoch, as the JAX factory rebuilds its
``mp_prefetch`` pool. Forking after CUDA is initialised is safe for what
they run: the dataset they inherit holds numpy arrays and file names only,
they decode with PIL and numpy, and PyTorch marks a forked child so that a
CUDA call there raises instead of touching the parent's context. A
``spawn`` or ``forkserver`` worker would start an interpreter and import
torch first, seconds a worker an epoch, and be sent the split's embeddings.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from s2i_tpu_torch.data.stackgan import StackGanSplit, multiscale

ROUNDS = 4  # Grain's ShuffleMapDataset passes rounds=4
MIN_BLOCK_BITS = 16  # the permutation's smallest block: 2**16 values
TABLE_BITS = 20  # blocks up to 2**20 values are permuted through a lookup table
_M32 = 0xFFFFFFFF


def _round_keys(seed: int, rounds: int) -> list[int]:
    """``std::seed_seq{seed}.generate`` of ``rounds`` 32-bit words (the
    C++ standard's algorithm): the round keys of Grain's cipher."""
    n, v = rounds, [seed & _M32]
    s = len(v)
    out = [0x8B8B8B8B] * n
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    mix = lambda x: x ^ (x >> 27)  # noqa: E731
    m = max(s + 1, n)
    for k in range(m):
        r1 = (1664525 * mix(out[k % n] ^ out[(k + p) % n] ^ out[(k - 1) % n])) & _M32
        r2 = r1 + (s if k == 0 else k % n + v[k - 1] if k <= s else k % n)
        r2 &= _M32
        out[(k + p) % n] = (out[(k + p) % n] + r1) & _M32
        out[(k + q) % n] = (out[(k + q) % n] + r2) & _M32
        out[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((out[k % n] + out[(k + p) % n] + out[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        out[(k + p) % n] ^= r3
        out[(k + q) % n] ^= r4
        out[k % n] = r4
    return out


def _encrypt(x: np.ndarray, keys: list[int], w: int) -> np.ndarray:
    """One pass of the Simon-style Feistel cipher on ``2w``-bit blocks
    (uint64 lanes): two rounds a key pair, each
    ``left ^= F(right) ^ k``, ``F(a) = (rotl(a, 1) & rotl(a, 8)) ^ rotl(a, 2)``
    on ``w``-bit halves, each key cut to its low ``w`` bits."""
    mask = np.uint64((1 << w) - 1)

    def rotl(a: np.ndarray, r: int) -> np.ndarray:
        return ((a << np.uint64(r)) | (a >> np.uint64(w - r))) & mask

    def f(a: np.ndarray) -> np.ndarray:
        return (rotl(a, 1) & rotl(a, 8)) ^ rotl(a, 2)

    left, right = (x >> np.uint64(w)) & mask, x & mask
    for i in range(0, len(keys) - 1, 2):
        left = left ^ f(right) ^ np.uint64(keys[i] & ((1 << w) - 1))
        right = right ^ f(left) ^ np.uint64(keys[i + 1] & ((1 << w) - 1))
    return (left << np.uint64(w)) | right


def _block_bits(max_index: int) -> int:
    """The cipher's block: ``ceil(log2(max_index))`` bits rounded up to even,
    at least ``MIN_BLOCK_BITS``, as the C++ code computes it."""
    bits = math.ceil(math.log2(float(max_index)))
    return max(bits + bits % 2, MIN_BLOCK_BITS)


def _first_in_range(table: np.ndarray, x: np.ndarray, max_index: int) -> np.ndarray:
    """The cycle walk of ``x`` through the permutation ``table``: for each
    value, the first one along its orbit (after itself) that is at most
    ``max_index``. Pointer doubling: ``hop[y]`` jumps over values known to be
    out of range, so the rounds grow with the log of the longest walk, where
    a walk one step a round takes about ``2**bits / (max_index + 1)``."""
    none = np.uint64(2**64 - 1)
    top = np.uint64(max_index)
    found = np.where(table <= top, table, none)
    hop = table.copy()
    while (found[x] == none).any():
        todo = np.flatnonzero(found == none)
        ahead = hop[todo]
        got = found[ahead]
        known = got != none
        found[todo[known]] = got[known]
        hop[todo[~known]] = hop[ahead[~known]]
    return found[x]


def index_shuffle(index, max_index: int, seed: int, rounds: int = ROUNDS):
    """Where a pseudorandom permutation of ``[0, max_index]`` sends ``index``
    (an int, or an array of them, permuted together): Grain's C++
    ``index_shuffle`` (a Feistel cipher on a block of at least 16 bits,
    cycle-walked until the value falls in range), bit for bit."""
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds must be even and at least 4, got {rounds}")
    scalar = np.ndim(index) == 0
    x = np.array(index, dtype=np.uint64, ndmin=1)
    if max_index == 0:
        out = np.zeros_like(x)
    else:
        keys = _round_keys(int(seed), rounds)
        bits = _block_bits(int(max_index))
        if bits <= TABLE_BITS:
            out = _first_in_range(_encrypt(np.arange(1 << bits, dtype=np.uint64), keys, bits // 2), x, max_index)
        else:
            top = np.uint64(max_index)
            out = _encrypt(x, keys, bits // 2)
            out_of_range = np.flatnonzero(out > top)
            while out_of_range.size:  # cycle-walking
                walked = _encrypt(out[out_of_range], keys, bits // 2)
                out[out_of_range] = walked
                out_of_range = out_of_range[walked > top]
    return int(out[0]) if scalar else out.astype(np.int64)


def epoch_order(n: int, seed: int) -> np.ndarray:
    """The records of an ``n``-record epoch in Grain's shuffled order for
    ``seed``: position ``p`` holds ``index_shuffle(p, n - 1, seed)``."""
    return index_shuffle(np.arange(n), n - 1, seed)


class GanSource(Dataset):
    """One example per record of a split, as ``_GanSource`` makes it: the
    StackGAN transform of its image (all scales or the top one, by
    ``ship_scales``) and one of its captions, both drawn from
    ``np.random.default_rng([seed, i])``, with that caption's embedding and
    the class id."""

    def __init__(self, split: StackGanSplit, branch_num: int, base_size: int = 64, image_dtype: str = "float32",
                 ship_scales: str = "all", seed: int = 0):
        if ship_scales not in ("all", "top"):
            raise ValueError(f"unknown ship_scales {ship_scales!r}")
        self.split = split
        self.branch_num = branch_num
        self.base_size = base_size
        self.image_dtype = image_dtype
        self.ship_scales = ship_scales
        self.seed = seed

    def __len__(self) -> int:
        return len(self.split)

    def __getitem__(self, i: int) -> dict:
        i = int(i)
        rng = np.random.default_rng([self.seed, i])
        top = self.base_size * 2 ** (self.branch_num - 1)
        img = self.split.load_image(i, top, rng, dtype=self.image_dtype)
        scales = [img] if self.ship_scales == "top" else multiscale(img, self.branch_num, self.base_size)
        cap = int(rng.integers(0, self.split.captions_per_image))
        return {"images": tuple(scales), "embedding": self.split.embeddings[i, cap],
                "class_id": np.int64(self.split.class_id[i])}


def stack_batch(examples: list[dict]) -> dict:
    """Examples stacked into a trainer batch, as ``_stack_batch`` stacks
    them: ``images`` per scale [B, S, S, 3], ``embedding`` [B, D],
    ``class_id`` [B] int64 (numpy: no tensor crosses a worker's queue)."""
    scales = range(len(examples[0]["images"]))
    return {"images": tuple(np.stack([e["images"][s] for e in examples]) for s in scales),
            "embedding": np.stack([e["embedding"] for e in examples]),
            "class_id": np.stack([e["class_id"] for e in examples])}


def grain_batches(split: StackGanSplit, batch_size: int, branch_num: int, base_size: int = 64, seed: int = 0,
                  num_workers: int = 0, image_dtype: str = "float32", ship_scales: str = "all",
                  rows: slice | None = None) -> Iterator[dict]:
    """One epoch of ``make_grain_gan_dataset``'s batches (:func:`stack_batch`).
    ``rows``: only those rows of each batch are decoded and yielded.
    ``num_workers`` > 0 decodes in that many forked ``DataLoader`` workers,
    in order."""
    n = len(split)
    order = epoch_order(n, seed)
    batches = [order[b * batch_size: (b + 1) * batch_size][rows or slice(None)] for b in range(n // batch_size)]
    source = GanSource(split, branch_num, base_size, image_dtype, ship_scales, seed)
    if not num_workers:
        return (stack_batch([source[i] for i in idx]) for idx in batches)
    # a private generator: the loader's worker seeds do not draw from torch's global one
    return iter(DataLoader(source, batch_sampler=batches, collate_fn=stack_batch, num_workers=num_workers,
                           multiprocessing_context="fork", generator=torch.Generator().manual_seed(seed)))


def grain_batch_factory(cfg, axis=None) -> Callable[[int], Iterator[dict]]:
    """epoch → host GAN batches of ``DATA_DIR``'s train split in Grain's
    order (``grain_batches`` with ``seed = SEED + epoch``), the counterpart
    of ``s2i_tpu.data.grain_pipeline.grain_batch_factory``. Over ``axis`` (a
    ``parallel.DataAxis``), this rank's rows of each global batch of
    ``TRAIN.BATCH_SIZE``, the only images it decodes. ``factory(epoch)``
    restarts that epoch's stream, so a mid-epoch resume realigns by
    skipping the batches it consumed."""
    split = StackGanSplit(cfg.DATA_DIR, "train", embedding_file=str(cfg.TEXT.EMBEDDING_FILE))
    batch_size = int(cfg.TRAIN.BATCH_SIZE)
    rows = None if axis is None else axis.rows(batch_size)

    def factory(epoch: int) -> Iterator[dict]:
        return grain_batches(split, batch_size, int(cfg.TREE.BRANCH_NUM), int(cfg.TREE.BASE_SIZE),
                             seed=int(cfg.SEED) + epoch, num_workers=int(cfg.DATA.GRAIN_WORKERS),
                             image_dtype=str(cfg.DATA.IMAGE_DTYPE), ship_scales=str(cfg.DATA.SHIP_SCALES),
                             rows=rows)

    return factory
