"""GRU forward recurrence: the hand-written CUDA kernel and its plain version.

``gru_scan(xw, w_h, b_h, mask, h0)`` has the contract of the JAX package's
``fused_gru`` forward:

    xw   [T, B, 3H]  precomputed input projections, gate order r | z | n
    w_h  [H, 3H]     recurrent kernel
    b_h  [3H]        recurrent bias (b_hn sits inside r * (...))
    mask [T, B]      > 0 for valid steps; h is carried through the others
    h0   [B, H]      initial hidden state
    → ys [T, B, H]

A CUDA tensor goes through ``csrc/gru_fwd.cu``; a CPU tensor through
:func:`gru_scan_plain`. Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from s2i_tpu_torch.ops import build


def gru_scan_plain(xw, w_h, b_h, mask, h0):
    """Plain PyTorch recurrence, one step per loop iteration."""
    h = h0
    ys = []
    for t in range(xw.shape[0]):
        hw = h @ w_h + b_h
        xr, xz, xn = xw[t].chunk(3, dim=-1)
        hr, hz, hn = hw.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        h = torch.where(mask[t, :, None] > 0, h_new, h)
        ys.append(h)
    return torch.stack(ys)


def _lib() -> ctypes.CDLL:
    lib = build.load("gru_fwd")
    if lib.s2i_gru_fwd.argtypes is None:
        lib.s2i_gru_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        lib.s2i_gru_fwd.restype = ctypes.c_int
        lib.s2i_gru_fwd_max_batch.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.s2i_gru_fwd_max_batch.restype = ctypes.c_int
        lib.s2i_gru_fwd_error_string.argtypes = [ctypes.c_int]
        lib.s2i_gru_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(xw, w_h, b_h, mask, h0) -> None:
    t, b, h3 = xw.shape
    h = h3 // 3
    want = {
        "xw": (xw, (t, b, 3 * h)),
        "w_h": (w_h, (h, 3 * h)),
        "b_h": (b_h, (3 * h,)),
        "mask": (mask, (t, b)),
        "h0": (h0, (b, h)),
    }
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
        if x.device != xw.device:
            raise ValueError(f"{name} is on {x.device}, xw on {xw.device}")
        if name != "mask" and x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {x.dtype}")


def gru_scan(xw, w_h, b_h, mask, h0):
    """ys [T, B, H]: the kernel for CUDA tensors, :func:`gru_scan_plain` for
    CPU tensors."""
    if xw.ndim != 3 or xw.shape[-1] % 3:
        raise ValueError(f"xw must be [T, B, 3H], got {tuple(xw.shape)}")
    _check_args(xw, w_h, b_h, mask, h0)
    if xw.device.type == "cpu":
        return gru_scan_plain(xw, w_h, b_h, mask, h0)
    if xw.device.type != "cuda":
        raise ValueError(f"unsupported device {xw.device}")
    t, b, h3 = xw.shape
    h = h3 // 3
    ys = torch.empty((t, b, h), device=xw.device)
    if t == 0:
        return ys
    xw, w_h, b_h, h0 = (x.contiguous() for x in (xw, w_h, b_h, h0))
    mask = (mask > 0).float()
    n_sm = torch.cuda.get_device_properties(xw.device).multi_processor_count
    units = -(-h // n_sm)  # hidden units per block: one block per SM at most
    lib = _lib()
    rows = lib.s2i_gru_fwd_max_batch(h, units)
    if rows <= 0:
        raise ValueError(f"hidden size {h} needs more shared memory than a block has")
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    # Batch rows are independent: a batch too large for one block's shared
    # memory runs as several launches over row chunks.
    for r0 in range(0, b, rows):
        r1 = min(b, r0 + rows)
        # slices of the whole batch are the tensors themselves: no copies
        x_c = xw[:, r0:r1].contiguous()
        m_c = mask[:, r0:r1].contiguous()
        h_c = h0[r0:r1].contiguous()
        y_c = ys[:, r0:r1].contiguous()
        barrier = torch.zeros(2, dtype=torch.int32, device=xw.device)
        err = lib.s2i_gru_fwd(
            x_c.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), m_c.data_ptr(),
            h_c.data_ptr(), y_c.data_ptr(), barrier.data_ptr(),
            t, r1 - r0, h, units, stream,
        )
        if err:
            raise RuntimeError(
                f"gru_fwd kernel: {lib.s2i_gru_fwd_error_string(err).decode()}"
            )
        gru_scan.launches += 1
        if y_c.data_ptr() != ys[:, r0:r1].data_ptr():
            ys[:, r0:r1] = y_c
    return ys


gru_scan.launches = 0  # kernel launches since the last reset
