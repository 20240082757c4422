"""GRU recurrence and its gradient: the hand-written CUDA kernels and their
plain versions.

``gru_scan(xw, w_h, b_h, mask, h0)`` has the contract of the JAX package's
``fused_gru``, custom VJP included:

    xw   [T, B, 3H]  precomputed input projections, gate order r | z | n
    w_h  [H, 3H]     recurrent kernel
    b_h  [3H]        recurrent bias (b_hn sits inside r * (...))
    mask [T, B]      > 0 for valid steps; h is carried through the others
    h0   [B, H]      initial hidden state
    → ys [T, B, H]

It is :class:`GRUScan`: the forward saves only its inputs and ``ys`` and the
backward recomputes the gates, as the JAX VJP does. A CUDA tensor goes
through ``csrc/gru_fwd.cu`` forward and ``csrc/gru_bwd.cu`` backward; a CPU
tensor through :func:`gru_scan_plain` and :func:`gru_scan_bwd_plain`, by the
same autograd wiring. Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from s2i_tpu_torch.ops import build


def _gates(xw_t, hw):
    xr, xz, xn = xw_t.chunk(3, dim=-1)
    hr, hz, hn = hw.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return r, z, n, hn


def gru_scan_plain(xw, w_h, b_h, mask, h0):
    """Plain PyTorch recurrence, one step per loop iteration."""
    h = h0
    ys = []
    for t in range(xw.shape[0]):
        r, z, n, _ = _gates(xw[t], h @ w_h + b_h)
        h_new = (1.0 - z) * n + z * h
        h = torch.where(mask[t, :, None] > 0, h_new, h)
        ys.append(h)
    return torch.stack(ys)


def gru_scan_bwd_plain(xw, w_h, b_h, mask, h0, ys, dys):
    """Plain PyTorch reverse scan with the Pallas ``_bwd_kernel``'s math:
    (dxw [T, B, 3H], dw_h [H, 3H], db_h [3H], dh0 [B, H])."""
    dh = torch.zeros_like(h0)
    dw_h = torch.zeros_like(w_h)
    db_h = torch.zeros_like(b_h)
    dxw = torch.empty_like(xw)
    for t in reversed(range(xw.shape[0])):
        h_prev = ys[t - 1] if t > 0 else h0
        r, z, n, hn = _gates(xw[t], h_prev @ w_h + b_h)
        dh_total = dys[t] + dh
        valid = mask[t, :, None] > 0
        dh_upd = torch.where(valid, dh_total, 0.0)  # grad into the GRU update
        dh_skip = torch.where(valid, 0.0, dh_total)  # masked steps: pass-through
        dn_pre = dh_upd * (1.0 - z) * (1.0 - n * n)
        dz_pre = dh_upd * (h_prev - n) * z * (1.0 - z)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dhg = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
        dxw[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dh = dh_upd * z + dh_skip + dhg @ w_h.T
        dw_h += h_prev.T @ dhg
        db_h += dhg.sum(dim=0)
    return dxw, dw_h, db_h, dh


def _fwd_lib() -> ctypes.CDLL:
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


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("gru_bwd")
    if lib.s2i_gru_bwd.argtypes is None:
        lib.s2i_gru_bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        lib.s2i_gru_bwd.restype = ctypes.c_int
        lib.s2i_gru_bwd_workspace.argtypes = [ctypes.c_int] * 3
        lib.s2i_gru_bwd_workspace.restype = ctypes.c_long
        lib.s2i_gru_bwd_error_string.argtypes = [ctypes.c_int]
        lib.s2i_gru_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(xw, w_h, b_h, mask, h0, **states) -> None:
    """Shapes, devices and dtypes; ``states`` are ys/dys [T, B, H]."""
    if xw.ndim != 3 or xw.shape[-1] % 3:
        raise ValueError(f"xw must be [T, B, 3H], got {tuple(xw.shape)}")
    t, b, h3 = xw.shape
    h = h3 // 3
    want = {
        "xw": (xw, (t, b, 3 * h)),
        "w_h": (w_h, (h, 3 * h)),
        "b_h": (b_h, (3 * h,)),
        "mask": (mask, (t, b)),
        "h0": (h0, (b, h)),
        **{name: (x, (t, b, h)) for name, x in states.items()},
    }
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
        if x.device != xw.device:
            raise ValueError(f"{name} is on {x.device}, xw on {xw.device}")
        if name != "mask" and x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {x.dtype}")
    if xw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xw.device}")


def _gru_fwd(xw, w_h, b_h, mask, h0):
    """ys [T, B, H]: K2 for CUDA tensors, :func:`gru_scan_plain` for CPU
    tensors. Counts its launches on :func:`gru_scan`."""
    if xw.device.type == "cpu":
        return gru_scan_plain(xw, w_h, b_h, mask, h0)
    t, b, h3 = xw.shape
    h = h3 // 3
    ys = torch.empty((t, b, h), device=xw.device)
    if t == 0:
        return ys
    xw, w_h, b_h, h0 = (x.contiguous() for x in (xw, w_h, b_h, h0))
    mask = (mask > 0).float()
    n_sm = torch.cuda.get_device_properties(xw.device).multi_processor_count
    units = -(-h // n_sm)  # hidden units per block: one block per SM at most
    lib = _fwd_lib()
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


def gru_scan_bwd(xw, w_h, b_h, mask, h0, ys, dys):
    """(dxw, dw_h, db_h, dh0): K3 for CUDA tensors, :func:`gru_scan_bwd_plain`
    for CPU tensors. ``ys`` is the forward's output and ``dys`` its incoming
    gradient (made contiguous here: it arrives from flips and transposes)."""
    _check_args(xw, w_h, b_h, mask, h0, ys=ys, dys=dys)
    dys = dys.contiguous()
    if xw.device.type == "cpu":
        return gru_scan_bwd_plain(xw, w_h, b_h, mask, h0, ys, dys)
    t, b, h3 = xw.shape
    h = h3 // 3
    if t == 0:
        return torch.zeros_like(xw), torch.zeros_like(w_h), torch.zeros_like(b_h), torch.zeros_like(h0)
    if h % 4:
        raise ValueError(f"the GRU backward kernel reads rows in 16-byte pieces: H={h} is not a multiple of 4")
    xw, w_h, b_h, h0, ys = (x.contiguous() for x in (xw, w_h, b_h, h0, ys))
    mask = (mask > 0).float().contiguous()
    dxw, dw_h, db_h, dh0 = (torch.empty_like(x) for x in (xw, w_h, b_h, h0))
    lib = _bwd_lib()
    workspace = torch.empty(lib.s2i_gru_bwd_workspace(t, b, h), device=xw.device)
    # one arrival counter per row group of the scan (at most b), zeroed by s2i_gru_bwd
    barrier = torch.empty(b, dtype=torch.int32, device=xw.device)
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    err = lib.s2i_gru_bwd(
        xw.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), mask.data_ptr(), h0.data_ptr(),
        ys.data_ptr(), dys.data_ptr(), dxw.data_ptr(), dw_h.data_ptr(), db_h.data_ptr(),
        dh0.data_ptr(), workspace.data_ptr(), barrier.data_ptr(), t, b, h, stream,
    )
    if err:
        raise RuntimeError(f"gru_bwd kernel: {lib.s2i_gru_bwd_error_string(err).decode()}")
    gru_scan_bwd.launches += 1
    return dxw, dw_h, db_h, dh0


class GRUScan(torch.autograd.Function):
    """The recurrence with its gradient: forward K2 (plain on the CPU), saving
    the inputs and ``ys``; backward K3 (plain on the CPU). The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, xw, w_h, b_h, mask, h0):
        ys = _gru_fwd(xw, w_h, b_h, mask, h0)
        ctx.save_for_backward(xw, w_h, b_h, mask, h0, ys)
        return ys

    @staticmethod
    def backward(ctx, dys):
        dxw, dw_h, db_h, dh0 = gru_scan_bwd(*ctx.saved_tensors, dys)
        return dxw, dw_h, db_h, None, dh0


def gru_scan(xw, w_h, b_h, mask, h0):
    """ys [T, B, H] through :class:`GRUScan`."""
    _check_args(xw, w_h, b_h, mask, h0)
    return GRUScan.apply(xw, w_h, b_h, mask, h0)


gru_scan.launches = 0  # K2 launches since the last reset
gru_scan_bwd.launches = 0  # K3 launches since the last reset
