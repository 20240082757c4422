"""GRU recurrence and its gradient: the hand-written CUDA kernels and their
plain versions.

``gru_scan(xw, w_h, b_h, mask, h0)`` runs the directions of one layer at
once. Each direction has the contract of the JAX package's ``fused_gru``,
custom VJP included; the directions come stacked on a leading axis D (1 or
2) and share the mask:

    xw   [D, T, B, 3H]  precomputed input projections, gate order r | z | n
    w_h  [D, H, 3H]     recurrent kernel
    b_h  [D, 3H]        recurrent bias (b_hn sits inside r * (...))
    mask [T, B]         > 0 for valid steps; h is carried through the others
    h0   [D, B, H]      initial hidden state
    → ys [D, T, B, H]

Direction 1 runs backwards in time over the unflipped arrays: its result
is direction 0's scan of the flipped sequence and mask, flipped back, so
the leading masked steps of a reversed padded row keep h = h0.

It is the ``torch.library`` custom op ``s2i::gru_scan``, whose registered
backward is the op ``s2i::gru_scan_bwd``: the forward saves only its inputs
and ``ys`` and the backward recomputes the gates, as the JAX VJP does. A
CUDA tensor goes through ``csrc/gru_fwd.cu`` forward and ``csrc/gru_bwd.cu``
backward, one launch each for all directions; a CPU tensor through
:func:`gru_scan_plain` and :func:`gru_scan_bwd_plain`. The dispatcher picks
the registration by the tensors' device, and nothing falls back from one to
the other. Serving, training and ``torch.export`` (``s2i_tpu_torch/export.py``)
go through the same op; its fake registrations give the outputs' shapes for
tracing and leave the per-batch launch plan (:func:`_plan`) to run time.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from s2i_tpu_torch.ops import build
from s2i_tpu_torch.ops.counted import counted

_PLAN_INTS = 8


def _gates(xw_t, hw):
    xr, xz, xn = xw_t.chunk(3, dim=-1)
    hr, hz, hn = hw.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return r, z, n, hn


def _scan_plain(xw, w_h, b_h, mask, h0):
    """One direction forward in time: ys [T, B, H]."""
    h = h0
    ys = []
    for t in range(xw.shape[0]):
        r, z, n, _ = _gates(xw[t], h @ w_h + b_h)
        h_new = (1.0 - z) * n + z * h
        h = torch.where(mask[t, :, None] > 0, h_new, h)
        ys.append(h)
    return torch.stack(ys)


def _scan_bwd_plain(xw, w_h, b_h, mask, h0, ys, dys):
    """The reverse scan of one forward-in-time direction, with the Pallas
    ``_bwd_kernel``'s math: (dxw, dw_h, db_h, dh0)."""
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


def gru_scan_plain(xw, w_h, b_h, mask, h0):
    """Plain PyTorch recurrence, one step per loop iteration: ys [D, T, B, H]."""
    ys = []
    for d in range(xw.shape[0]):
        if d == 0:
            ys.append(_scan_plain(xw[d], w_h[d], b_h[d], mask, h0[d]))
        else:
            ys.append(_scan_plain(xw[d].flip(0), w_h[d], b_h[d], mask.flip(0), h0[d]).flip(0))
    return torch.stack(ys)


def gru_scan_bwd_plain(xw, w_h, b_h, mask, h0, ys, dys):
    """Plain PyTorch reverse scan of every direction: (dxw [D, T, B, 3H],
    dw_h [D, H, 3H], db_h [D, 3H], dh0 [D, B, H])."""
    grads = []
    for d in range(xw.shape[0]):
        if d == 0:
            grads.append(_scan_bwd_plain(xw[d], w_h[d], b_h[d], mask, h0[d], ys[d], dys[d]))
        else:
            dxw, dw_h, db_h, dh0 = _scan_bwd_plain(
                xw[d].flip(0), w_h[d], b_h[d], mask.flip(0), h0[d], ys[d].flip(0), dys[d].flip(0))
            grads.append((dxw.flip(0), dw_h, db_h, dh0))
    return tuple(torch.stack(g) for g in zip(*grads))


def _fwd_lib() -> ctypes.CDLL:
    lib = build.load("gru_fwd")
    if lib.s2i_gru_fwd.argtypes is None:
        lib.s2i_gru_fwd_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.s2i_gru_fwd_plan.restype = ctypes.c_int
        lib.s2i_gru_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        lib.s2i_gru_fwd.restype = ctypes.c_int
        lib.s2i_gru_fwd_error_string.argtypes = [ctypes.c_int]
        lib.s2i_gru_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("gru_bwd")
    if lib.s2i_gru_bwd.argtypes is None:
        lib.s2i_gru_bwd_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.s2i_gru_bwd_plan.restype = ctypes.c_int
        lib.s2i_gru_bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        lib.s2i_gru_bwd.restype = ctypes.c_int
        lib.s2i_gru_bwd_workspace.argtypes = [ctypes.c_int] * 4
        lib.s2i_gru_bwd_workspace.restype = ctypes.c_long
        lib.s2i_gru_bwd_error_string.argtypes = [ctypes.c_int]
        lib.s2i_gru_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _plan(kind: str, d: int, b: int, h: int, device: int):
    """(rows per launch, the kernel's launch plan) for ``kind`` ("fwd" or
    "bwd"): all ``b`` rows in one launch if a plan fits the card, else the
    largest row count that does (the rows are independent chains)."""
    lib = _fwd_lib() if kind == "fwd" else _bwd_lib()
    plan_fn = lib.s2i_gru_fwd_plan if kind == "fwd" else lib.s2i_gru_bwd_plan
    plan = (ctypes.c_int * _PLAN_INTS)()
    with torch.cuda.device(device):
        rows = b
        while plan_fn(d, rows, h, plan) != 0:
            if rows == 1:
                raise ValueError(f"the GRU {kind} kernel has no launch plan for D={d}, H={h} on this card")
            rows = (rows + 1) // 2
    return rows, plan


def _check_args(xw, w_h, b_h, mask, h0, **states) -> None:
    """Shapes, devices and dtypes; ``states`` are ys/dys [D, T, B, H]."""
    if xw.ndim != 4 or xw.shape[-1] % 3 or xw.shape[0] not in (1, 2):
        raise ValueError(f"xw must be [D, T, B, 3H] with D 1 or 2, got {tuple(xw.shape)}")
    d, t, b, h3 = xw.shape
    h = h3 // 3
    want = {
        "xw": (xw, (d, t, b, 3 * h)),
        "w_h": (w_h, (d, h, 3 * h)),
        "b_h": (b_h, (d, 3 * h)),
        "mask": (mask, (t, b)),
        "h0": (h0, (d, b, h)),
        **{name: (x, (d, t, b, h)) for name, x in states.items()},
    }
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
        if x.device != xw.device:
            raise ValueError(f"{name} is on {x.device}, xw on {xw.device}")
        if name != "mask" and x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {x.dtype}")
    if xw.device.type == "cuda" and h % 4:
        raise ValueError(f"the GRU kernels copy rows in 16-byte pieces: H={h} is not a multiple of 4")


def _row_chunks(b: int, rows: int):
    """(r0, r1) slices of the batch, one per launch."""
    return [(r0, min(b, r0 + rows)) for r0 in range(0, b, rows)]


def _rows(x, r0, r1, b, axis):
    """Rows [r0, r1) of x along ``axis`` as a contiguous tensor (x itself
    when that is all of it)."""
    return x if (r0, r1) == (0, b) else x.narrow(axis, r0, r1 - r0).contiguous()


# The ops' definitions; their registrations last as long as this object.
_LIB = torch.library.Library("s2i", "FRAGMENT")
_LIB.define("gru_scan(Tensor xw, Tensor w_h, Tensor b_h, Tensor mask, Tensor h0) -> Tensor")
_LIB.define("gru_scan_bwd(Tensor xw, Tensor w_h, Tensor b_h, Tensor mask, Tensor h0, Tensor ys, Tensor dys) "
            "-> (Tensor, Tensor, Tensor, Tensor)")


def gru_scan(xw, w_h, b_h, mask, h0):
    """ys [D, T, B, H] through ``s2i::gru_scan``, differentiable in every
    input but the mask. The op's registrations check the arguments."""
    return torch.ops.s2i.gru_scan(xw, w_h, b_h, mask, h0)


def _gru_fwd_cpu(xw, w_h, b_h, mask, h0):
    _check_args(xw, w_h, b_h, mask, h0)
    return gru_scan_plain(xw, w_h, b_h, mask, h0)


def _gru_fwd(xw, w_h, b_h, mask, h0):
    """ys [D, T, B, H] by K2, one launch per row chunk of the launch plan.
    Counts its launches on :func:`gru_scan`."""
    _check_args(xw, w_h, b_h, mask, h0)
    d, t, b, h3 = xw.shape
    h = h3 // 3
    ys = torch.empty((d, t, b, h), device=xw.device)
    if t == 0:
        return ys
    xw, w_h, b_h, h0 = (x.contiguous() for x in (xw, w_h, b_h, h0))
    mask = (mask > 0).float().contiguous()
    lib = _fwd_lib()
    rows = _plan("fwd", d, b, h, xw.device.index)[0]
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    for r0, r1 in _row_chunks(b, rows):
        plan = _plan("fwd", d, r1 - r0, h, xw.device.index)[1]
        x_c, m_c, h_c = _rows(xw, r0, r1, b, 2), _rows(mask, r0, r1, b, 1), _rows(h0, r0, r1, b, 1)
        y_c = ys if (r0, r1) == (0, b) else torch.empty((d, t, r1 - r0, h), device=xw.device)
        count = torch.zeros(d * plan[0], dtype=torch.int32, device=xw.device)
        err = lib.s2i_gru_fwd(
            x_c.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), m_c.data_ptr(), h_c.data_ptr(),
            y_c.data_ptr(), count.data_ptr(), d, t, r1 - r0, h, plan, stream,
        )
        if err:
            raise RuntimeError(f"gru_fwd kernel: {lib.s2i_gru_fwd_error_string(err).decode()}")
        gru_scan.launches += 1
        if y_c is not ys:
            ys[:, :, r0:r1] = y_c
    return ys


def gru_scan_bwd(xw, w_h, b_h, mask, h0, ys, dys, events=None):
    """(dxw, dw_h, db_h, dh0) through ``s2i::gru_scan_bwd``: K3 for CUDA
    tensors, :func:`gru_scan_bwd_plain` for CPU tensors. ``ys`` is the
    forward's output and ``dys`` its incoming gradient (made contiguous: it
    arrives from slices and transposes). ``events``: None, or four
    ``torch.cuda.Event(enable_timing=True)`` that the kernel records before
    its gate SGEMM, after it, after the chain and after dW_h and db_h (a
    batch too large for one launch records them on its last launch); event
    handles cannot go through an op's schema, so a call with events
    launches K3 directly."""
    if events is not None:
        if xw.device.type != "cuda":
            raise ValueError(f"events time K3 on a card; the tensors are on {xw.device}")
        return _gru_bwd(xw, w_h, b_h, mask, h0, ys, dys, events)
    return torch.ops.s2i.gru_scan_bwd(xw, w_h, b_h, mask, h0, ys, dys)


def _gru_bwd_cpu(xw, w_h, b_h, mask, h0, ys, dys):
    _check_args(xw, w_h, b_h, mask, h0, ys=ys, dys=dys)
    return gru_scan_bwd_plain(xw, w_h, b_h, mask, h0, ys, dys.contiguous())


def _gru_bwd(xw, w_h, b_h, mask, h0, ys, dys, events=None):
    """K3, one launch per row chunk of the launch plan. Counts its launches
    on :func:`gru_scan_bwd`."""
    _check_args(xw, w_h, b_h, mask, h0, ys=ys, dys=dys)
    dys = dys.contiguous()
    d, t, b, h3 = xw.shape
    h = h3 // 3
    if t == 0:
        return torch.zeros_like(xw), torch.zeros_like(w_h), torch.zeros_like(b_h), torch.zeros_like(h0)
    xw, w_h, b_h, h0, ys = (x.contiguous() for x in (xw, w_h, b_h, h0, ys))
    mask = (mask > 0).float().contiguous()
    lib = _bwd_lib()
    rows = _plan("bwd", d, b, h, xw.device.index)[0]
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    handles = None
    if events is not None:
        for ev in events:
            ev.record()  # creates the event the kernel records into
        handles = (ctypes.c_void_p * 4)(*(ev.cuda_event for ev in events))
    dxw, dh0 = torch.empty_like(xw), torch.empty_like(h0)
    dw_h = db_h = None
    for r0, r1 in _row_chunks(b, rows):
        n = r1 - r0
        plan = _plan("bwd", d, n, h, xw.device.index)[1]
        x_c, m_c, h_c, y_c, g_c = (_rows(x, r0, r1, b, ax) for x, ax in
                                   ((xw, 2), (mask, 1), (h0, 1), (ys, 2), (dys, 2)))
        dx_c = dxw if n == b else torch.empty_like(x_c)
        dh_c = dh0 if n == b else torch.empty_like(h_c)
        dw_c, db_c = torch.empty_like(w_h), torch.empty_like(b_h)
        workspace = torch.empty(lib.s2i_gru_bwd_workspace(d, t, n, h), device=xw.device)
        count = torch.zeros(d * plan[0], dtype=torch.int32, device=xw.device)
        err = lib.s2i_gru_bwd(
            x_c.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), m_c.data_ptr(), h_c.data_ptr(),
            y_c.data_ptr(), g_c.data_ptr(), dx_c.data_ptr(), dw_c.data_ptr(), db_c.data_ptr(),
            dh_c.data_ptr(), workspace.data_ptr(), count.data_ptr(), d, t, n, h, plan,
            handles if r1 == b else None, stream,
        )
        if err:
            raise RuntimeError(f"gru_bwd kernel: {lib.s2i_gru_bwd_error_string(err).decode()}")
        gru_scan_bwd.launches += 1
        if n != b:
            dxw[:, :, r0:r1] = dx_c
            dh0[:, r0:r1] = dh_c
        # row chunks' weight gradients are added in order: the same every run
        dw_h, db_h = (dw_c, db_c) if dw_h is None else (dw_h + dw_c, db_h + db_c)
    return dxw, dw_h, db_h, dh0


_LIB.impl("gru_scan", _gru_fwd_cpu, "CPU")
_LIB.impl("gru_scan", _gru_fwd, "CUDA")
_LIB.impl("gru_scan_bwd", _gru_bwd_cpu, "CPU")
_LIB.impl("gru_scan_bwd", _gru_bwd, "CUDA")


@torch.library.register_fake("s2i::gru_scan", lib=_LIB)
def _gru_scan_fake(xw, w_h, b_h, mask, h0):
    d, t, b, h3 = xw.shape
    return xw.new_empty((d, t, b, h3 // 3))


@torch.library.register_fake("s2i::gru_scan_bwd", lib=_LIB)
def _gru_scan_bwd_fake(xw, w_h, b_h, mask, h0, ys, dys):
    return tuple(x.new_empty(x.shape) for x in (xw, w_h, b_h, h0))


def _save_for_backward(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output)


def _gru_scan_backward(ctx, dys):
    """The mask gets no gradient."""
    dxw, dw_h, db_h, dh0 = torch.ops.s2i.gru_scan_bwd(*ctx.saved_tensors, dys)
    return dxw, dw_h, db_h, None, dh0


torch.library.register_autograd("s2i::gru_scan", _gru_scan_backward, setup_context=_save_for_backward, lib=_LIB)

counted(gru_scan)  # K2 launches
counted(gru_scan_bwd)  # K3 launches
