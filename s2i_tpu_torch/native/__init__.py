"""The host JPEG loader (decode + bbox crop + resize + random crop and flip
+ pyramid in C++ threads), the port's copy of ``s2i_tpu/native``.

``image_loader.cpp`` is compiled with ``g++`` at first use into
``s2i_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of the
source, the flags and the host (``-march=native`` code, linked against the
host's libjpeg, is not for another machine that shares the directory), and
loaded with ctypes. This is host code, not a kernel of the card. Where ``g++`` or libjpeg is missing, :func:`get_lib`
returns None and the loaders take the PIL path (``DATA.PIPELINE: native``
auto-detects, as in the JAX package); :func:`unavailable_reason` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "image_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_unavailable: str | None = None


def _target() -> Path:
    host = f"{platform.node()} {platform.machine()}"
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS + LIBS + (host,)).encode())
    return BUILD_DIR / f"libimage_loader-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp), *LIBS],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)  # atomic: a concurrent builder never loads half a file
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.il_load_batch.restype = ctypes.c_int
    lib.il_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_uint64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.il_load_batch_u8.restype = ctypes.c_int
    lib.il_load_batch_u8.argtypes = lib.il_load_batch.argtypes
    lib.il_probe.restype = ctypes.c_int
    lib.il_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None when it cannot be
    built or loaded here (no ``g++``, no libjpeg)."""
    global _lib, _unavailable
    with _lock:
        if _lib is not None or _unavailable is not None:
            return _lib
        out = _target()
        try:
            if not out.exists():
                _build(out)
            _lib = _bind(ctypes.CDLL(str(out)))
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or ""
            _unavailable = f"{e}{': ' + detail.strip() if detail else ''}"
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def unavailable_reason() -> str | None:
    """Why the library could not be built or loaded (None when it loaded or
    was not tried yet)."""
    return _unavailable


_SEED_MUL = 0x9E3779B97F4A7C15  # image_loader.cpp seeds image i with seed * _SEED_MUL + i + 1
_SEED_MUL_INV = pow(_SEED_MUL, -1, 2**64)


def load_batch(
    paths: list[str],
    bboxes: np.ndarray | None,
    imsize: int,
    branch_num: int,
    seed: int,
    augment: bool,
    num_threads: int = 8,
    dtype: str = "float32",
    fast_decode: bool = False,
    first_row: int = 0,
) -> tuple[list[np.ndarray], int]:
    """Decode and transform a batch of JPEGs.

    Returns ([branch_num arrays [N, S, S, 3]], n_failed). ``dtype="float32"``
    yields [-1, 1] values, ``"uint8"`` raw [0, 255] for normalization on the
    device (``DATA.IMAGE_DTYPE``). ``fast_decode`` takes libjpeg's
    DCT-scaled decode (``DATA.FAST_DECODE``), an approximation. Failed slots
    are zeroed; the caller backfills them through PIL. ``first_row``: the
    paths are rows ``first_row``.. of a larger batch with this ``seed``, and
    each image takes the crop and flip it has there (a rank's share of a
    global batch): the seed moves by ``first_row / _SEED_MUL`` modulo 2^64,
    so that the library's ``seed * _SEED_MUL + i + 1`` is the larger
    batch's.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native image loader unavailable: {_unavailable}")
    if dtype not in ("float32", "uint8"):
        raise ValueError(f"unsupported loader dtype {dtype!r}")
    n = len(paths)
    base = imsize >> (branch_num - 1)
    np_dtype = np.float32 if dtype == "float32" else np.uint8
    outs = [np.empty((n, base << i, base << i, 3), np_dtype) for i in range(branch_num)]
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if bboxes is not None:
        bb = np.ascontiguousarray(bboxes, dtype=np.float32)
        if bb.shape != (n, 4):
            raise ValueError(f"bboxes must be [{n}, 4], got {bb.shape}")
        c_bb = bb.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    else:
        c_bb = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    c_outs = (ctypes.c_void_p * branch_num)(*[o.ctypes.data_as(ctypes.c_void_p) for o in outs])
    entry = lib.il_load_batch if dtype == "float32" else lib.il_load_batch_u8
    failed = entry(
        c_paths,
        n,
        c_bb,
        imsize,
        branch_num,
        ctypes.c_uint64((seed + first_row * _SEED_MUL_INV) & (2**64 - 1)),
        1 if augment else 0,
        c_outs,
        num_threads,
        1 if fast_decode else 0,
    )
    return outs, int(failed)
