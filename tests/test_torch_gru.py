"""The port's GRU recurrence and its gradient (s2i_tpu_torch/ops/gru_kernel.py)
against the JAX package's: the plain PyTorch versions must equal both the
lax.scan reference and the Pallas kernels (interpret mode on the CPU), with a
ragged mask, an all-masked row and a non-zero h0. The port stacks the
directions of a layer on a leading axis D; one direction is D=1, and the
stacked form at D=2 is held against two D=1 calls and a reverse-time loop
(torch only, no JAX compile). Forward tolerance 2e-6 absolute: float32 sums
of H products taken in another order, over T dependent steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


def _stacked(args):
    """One direction's arrays as the port's D=1 tensors (the mask is shared, unstacked)."""
    return {k: torch.from_numpy(v if k == "mask" else v[None]) for k, v in args.items()}


def _port(args):
    return gru_kernel.gru_scan(**_stacked(args))[0].numpy()


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
    args = _stacked(_inputs(3))
    out = gru_kernel.gru_scan(**args)
    np.testing.assert_array_equal(out.numpy(), gru_kernel.gru_scan_plain(**args).numpy())
    assert gru_kernel.gru_scan.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = _stacked(_inputs(4))
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
    t = _stacked(args)
    ys = gru_kernel.gru_scan_plain(**t)
    return [g[0].numpy() for g in gru_kernel.gru_scan_bwd_plain(**t, ys=ys, dys=torch.from_numpy(dys[None]))]


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
    args = _stacked(_inputs(seed, *shape))
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
    args = _stacked(_inputs(9))
    for k in ("xw", "w_h", "b_h", "h0"):
        args[k].requires_grad_()
    before = gru_kernel.gru_scan_bwd.launches
    ys = gru_kernel.gru_scan(**args)
    assert "s2i_gru_scan" in type(ys.grad_fn).__name__  # the backward registered on the op s2i::gru_scan
    # a gradient that arrives permuted, as the encoder's [B, T, D*H] output gives it
    dys = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 12, 1, 16)).astype(np.float32))
    got = torch.autograd.grad(ys, [args[k] for k in ("xw", "w_h", "b_h", "h0")], dys.permute(2, 1, 0, 3))
    assert len(calls) == 1 and calls[0].is_contiguous()
    assert gru_kernel.gru_scan_bwd.launches == before  # CPU tensors launch nothing
    want = plain(*(args[k].detach() for k in ("xw", "w_h", "b_h", "mask", "h0")), ys.detach(),
                 dys.permute(2, 1, 0, 3).contiguous())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_bwd_wrapper_rejects_what_the_kernel_does_not_take():
    args = _stacked(_inputs(10))
    ys = gru_kernel.gru_scan_plain(**args)
    with pytest.raises(ValueError, match="dys"):
        gru_kernel.gru_scan_bwd(**args, ys=ys, dys=ys[:-1])
    with pytest.raises(ValueError, match="ys"):
        gru_kernel.gru_scan_bwd(**args, ys=ys.double(), dys=ys)


# The stacked form: direction 1 runs backwards in time over the unflipped
# arrays, sharing the mask, which is direction 0's scan of the flipped
# sequence and mask, flipped back.


def _two_directions(seed: int, t: int = 12, b: int = 3, h: int = 16):
    one, two = _inputs(seed, t, b, h), _inputs(seed + 100, t, b, h)
    args = {k: torch.from_numpy(one[k] if k == "mask" else np.stack([one[k], two[k]])) for k in one}
    dys = torch.from_numpy(np.random.default_rng(seed).standard_normal((2, t, b, h)).astype(np.float32))
    return args, dys


def _direction(args, d, flip):
    """Direction d's arrays as D=1 tensors, its sequence and mask flipped in time if asked."""
    f = (lambda x: x.flip(0)) if flip else (lambda x: x)  # noqa: E731
    return dict(xw=f(args["xw"][d])[None], w_h=args["w_h"][d:d + 1], b_h=args["b_h"][d:d + 1],
                mask=f(args["mask"]), h0=args["h0"][d:d + 1])


def test_stacked_plain_equals_two_calls_on_flipped_inputs():
    args, dys = _two_directions(11)
    ys = gru_kernel.gru_scan_plain(**args)
    grads = gru_kernel.gru_scan_bwd_plain(**args, ys=ys, dys=dys)
    fwd = _direction(args, 0, flip=False)
    ys0 = gru_kernel.gru_scan_plain(**fwd)
    g0 = gru_kernel.gru_scan_bwd_plain(**fwd, ys=ys0, dys=dys[:1])
    rev = _direction(args, 1, flip=True)
    ys1 = gru_kernel.gru_scan_plain(**rev)
    g1 = gru_kernel.gru_scan_bwd_plain(**rev, ys=ys1, dys=dys[1:].flip(1))
    np.testing.assert_array_equal(ys[0].numpy(), ys0[0].numpy())
    np.testing.assert_array_equal(ys[1].numpy(), ys1[0].flip(0).numpy())
    for name, g, a, b in zip(("dxw", "dw_h", "db_h", "dh0"), grads, g0, g1):
        b = b.flip(1) if name == "dxw" else b  # dxw is per step: back to the unflipped order
        np.testing.assert_array_equal(g.numpy(), torch.cat([a, b]).numpy(), err_msg=name)


def test_stacked_reverse_direction_matches_a_reverse_time_loop():
    """Direction 1 against a loop written backwards in time, and the stacked
    backward against torch autograd of that loop (no flips anywhere)."""
    args, dys = _two_directions(12)
    leaves = {k: args[k].clone().requires_grad_() for k in ("xw", "w_h", "b_h", "h0")}
    h = leaves["h0"][1]
    want = [None] * args["xw"].shape[1]
    for t in reversed(range(args["xw"].shape[1])):
        hw = h @ leaves["w_h"][1] + leaves["b_h"][1]
        xr, xz, xn = leaves["xw"][1, t].chunk(3, dim=-1)
        hr, hz, hn = hw.chunk(3, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        h_new = (1.0 - z) * torch.tanh(xn + r * hn) + z * h
        h = torch.where(args["mask"][t, :, None] > 0, h_new, h)
        want[t] = h
    want = torch.stack(want)
    ys = gru_kernel.gru_scan_plain(**args)
    np.testing.assert_allclose(ys[1].numpy(), want.detach().numpy(), atol=ATOL, rtol=0)
    # the all-masked row keeps h0 at every step, the leading masked steps of the ragged one too
    np.testing.assert_array_equal(ys[1, :, 2].numpy(), np.broadcast_to(args["h0"][1, 2].numpy(), (12, 16)))
    n_valid = int(args["mask"][:, 1].sum())
    np.testing.assert_array_equal(ys[1, n_valid:, 1].numpy(),
                                  np.broadcast_to(args["h0"][1, 1].numpy(), (12 - n_valid, 16)))
    auto = torch.autograd.grad(want, list(leaves.values()), dys[1])
    got = gru_kernel.gru_scan_bwd_plain(**args, ys=ys, dys=dys)
    for name, g, w in zip(leaves, got, auto):
        np.testing.assert_allclose(g[1].numpy(), w[1].numpy(), atol=ATOL_GRAD, rtol=0, err_msg=name)


@pytest.mark.parametrize("layers,bidirectional", [(2, True), (1, False)], ids=["2-layers-bi", "1-layer-uni"])
def test_bigru_makes_one_gru_scan_call_per_layer(layers, bidirectional):
    from s2i_tpu_torch.models.encoder import BiGRU

    calls = []

    class OpCalls(TorchDispatchMode):
        """Records the xw shape of every call of the op s2i::gru_scan."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.s2i.gru_scan.default:
                calls.append(tuple(args[0].shape))
            return func(*args, **(kwargs or {}))

    torch.manual_seed(0)
    rnn = BiGRU(6, 8, layers, bidirectional)
    x = torch.randn(3, 10, 6, requires_grad=True)
    mask = torch.arange(10)[None, :] < torch.tensor([10, 4, 0])[:, None]
    with OpCalls():
        out = rnn(x, mask)
    n_dir = 2 if bidirectional else 1
    assert out.shape == (3, 10, 8 * n_dir)
    assert calls == [(n_dir, 10, 3, 24)] * layers
    out.square().sum().backward()
    assert all(p.grad is not None and p.grad.abs().max() > 0 for p in rnn.parameters())


def test_wrapper_rejects_mismatched_directions():
    args, dys = _two_directions(13)
    for name in ("w_h", "b_h", "h0"):
        with pytest.raises(ValueError, match=name):
            gru_kernel.gru_scan(**dict(args, **{name: args[name][:1]}))
    with pytest.raises(ValueError, match="xw"):
        gru_kernel.gru_scan(**dict(args, xw=torch.cat([args["xw"], args["xw"][:1]])))  # D=3
    with pytest.raises(ValueError, match="mask"):
        gru_kernel.gru_scan(**dict(args, mask=args["mask"][None].expand(2, -1, -1)))
    ys = gru_kernel.gru_scan_plain(**args)
    with pytest.raises(ValueError, match="dys"):
        gru_kernel.gru_scan_bwd(**args, ys=ys, dys=dys[:1])
