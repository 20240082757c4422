"""The port's GRU recurrence and its gradient (s2i_tpu_torch/ops/gru_kernel.py)
against the JAX package's: the plain PyTorch versions must equal both the
lax.scan reference and the Pallas kernels (interpret mode on the CPU), with a
ragged mask, an all-masked row and a non-zero h0. Forward tolerance 2e-6
absolute: float32 sums of H products taken in another order, over T
dependent steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2i_tpu.ops.gru_kernel import fused_gru, gru_scan_reference
from s2i_tpu_torch.ops import gru_kernel

ATOL = 2e-6


def _inputs(seed: int, t: int = 12, b: int = 3, h: int = 16):
    rng = np.random.default_rng(seed)
    lens = np.array([t, t // 2 + 1, 0][:b])  # full, ragged, all-masked
    return dict(
        xw=rng.standard_normal((t, b, 3 * h)).astype(np.float32),
        w_h=(rng.standard_normal((h, 3 * h)) / np.sqrt(h)).astype(np.float32),
        b_h=(0.1 * rng.standard_normal(3 * h)).astype(np.float32),
        mask=(np.arange(t)[:, None] < lens[None, :]).astype(np.float32),
        h0=(0.5 * rng.standard_normal((b, h))).astype(np.float32),
    )


def _port(args):
    return gru_kernel.gru_scan(**{k: torch.from_numpy(v) for k, v in args.items()}).numpy()


@pytest.mark.parametrize("seed,shape", [(0, (12, 3, 16)), (1, (5, 2, 8))])
def test_plain_matches_scan_reference(seed, shape):
    args = _inputs(seed, *shape)
    want = np.asarray(gru_scan_reference(**{k: jnp.asarray(v) for k, v in args.items()}))
    np.testing.assert_allclose(_port(args), want, atol=ATOL, rtol=0)


def test_plain_matches_pallas_kernel_interpret():
    args = _inputs(2)
    want = np.asarray(fused_gru(**{k: jnp.asarray(v) for k, v in args.items()}))
    got = _port(args)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the all-masked row carries h0 through every step
    np.testing.assert_array_equal(got[:, 2], np.broadcast_to(args["h0"][2], got[:, 2].shape))


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = gru_kernel.gru_scan.launches
    args = {k: torch.from_numpy(v) for k, v in _inputs(3).items()}
    out = gru_kernel.gru_scan(**args)
    np.testing.assert_array_equal(out.numpy(), gru_kernel.gru_scan_plain(**args).numpy())
    assert gru_kernel.gru_scan.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = {k: torch.from_numpy(v) for k, v in _inputs(4).items()}
    with pytest.raises(ValueError, match="w_h"):
        gru_kernel.gru_scan(**dict(args, w_h=args["w_h"][:, :-3]))
    with pytest.raises(ValueError, match="h0"):
        gru_kernel.gru_scan(**dict(args, h0=args["h0"].double()))
    with pytest.raises(ValueError, match="xw"):
        gru_kernel.gru_scan(**dict(args, xw=args["xw"][..., :-1]))


# The backward: gru_scan_bwd_plain against jax.vjp of the Pallas kernel
# (its _bwd_kernel in interpret mode) and of the lax.scan reference, and
# against torch autograd of gru_scan_plain. Tolerance 1e-5 absolute for
# gradients of magnitude ~1-10: float32 sums of H or T·B products taken in
# another order, carried over T reverse steps.
ATOL_GRAD = 1e-5


def _vjp(fn, args, dys):
    _, pullback = jax.vjp(fn, *(jnp.asarray(args[k]) for k in ("xw", "w_h", "b_h", "mask", "h0")))
    dxw, dw_h, db_h, _, dh0 = pullback(jnp.asarray(dys))
    return [np.asarray(g) for g in (dxw, dw_h, db_h, dh0)]


def _bwd_port(args, dys):
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    ys = gru_kernel.gru_scan_plain(**t)
    return [g.numpy() for g in gru_kernel.gru_scan_bwd_plain(**t, ys=ys, dys=torch.from_numpy(dys))]


@pytest.mark.parametrize("reference", ["pallas", "scan"])
def test_bwd_plain_matches_jax_vjp(reference):
    args = _inputs(5)
    dys = np.random.default_rng(6).standard_normal((12, 3, 16)).astype(np.float32)
    want = _vjp(fused_gru if reference == "pallas" else gru_scan_reference, args, dys)
    got = _bwd_port(args, dys)
    for name, g, w in zip(("dxw", "dw_h", "db_h", "dh0"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL_GRAD, rtol=0, err_msg=name)
    # the all-masked row: nothing reaches its gates, dh0 is the sum of its dys
    np.testing.assert_array_equal(got[0][:, 2], 0.0)
    np.testing.assert_allclose(got[3][2], dys[:, 2].sum(0), atol=ATOL_GRAD, rtol=0)


@pytest.mark.parametrize("seed,shape", [(7, (12, 3, 16)), (8, (5, 2, 8))])
def test_bwd_plain_matches_torch_autograd(seed, shape):
    args = {k: torch.from_numpy(v) for k, v in _inputs(seed, *shape).items()}
    grads = {k: args[k].requires_grad_() for k in ("xw", "w_h", "b_h", "h0")}
    ys = gru_kernel.gru_scan_plain(**args)
    dys = torch.from_numpy(np.random.default_rng(seed).standard_normal(ys.shape).astype(np.float32))
    want = torch.autograd.grad(ys, list(grads.values()), dys)
    with torch.no_grad():
        got = gru_kernel.gru_scan_bwd_plain(**args, ys=ys, dys=dys)
    for name, g, w in zip(grads, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL_GRAD, rtol=0, err_msg=name)


def test_gru_scan_backward_goes_through_the_bwd_wrapper(monkeypatch):
    calls = []
    plain = gru_kernel.gru_scan_bwd_plain
    monkeypatch.setattr(gru_kernel, "gru_scan_bwd_plain", lambda *a: calls.append(a[-1]) or plain(*a))
    args = {k: torch.from_numpy(v) for k, v in _inputs(9).items()}
    for k in ("xw", "w_h", "b_h", "h0"):
        args[k].requires_grad_()
    before = gru_kernel.gru_scan_bwd.launches
    ys = gru_kernel.gru_scan(**args)
    assert type(ys.grad_fn).__name__ == "GRUScanBackward"
    # a gradient that arrives transposed, as the encoder's reverse direction gives it
    dys = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 12, 16)).astype(np.float32))
    got = torch.autograd.grad(ys, [args[k] for k in ("xw", "w_h", "b_h", "h0")], dys.transpose(0, 1))
    assert len(calls) == 1 and calls[0].is_contiguous()
    assert gru_kernel.gru_scan_bwd.launches == before  # CPU tensors launch nothing
    want = plain(*(args[k].detach() for k in ("xw", "w_h", "b_h", "mask", "h0")), ys.detach(),
                 dys.transpose(0, 1).contiguous())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_bwd_wrapper_rejects_what_the_kernel_does_not_take():
    args = {k: torch.from_numpy(v) for k, v in _inputs(10).items()}
    ys = gru_kernel.gru_scan_plain(**args)
    with pytest.raises(ValueError, match="dys"):
        gru_kernel.gru_scan_bwd(**args, ys=ys, dys=ys[:-1])
    with pytest.raises(ValueError, match="ys"):
        gru_kernel.gru_scan_bwd(**args, ys=ys.double(), dys=ys)
