"""The port's GRU recurrence (s2i_tpu_torch/ops/gru_kernel.py) against the
JAX package's: the plain PyTorch version must equal both the lax.scan
reference and the Pallas kernel (interpret mode on the CPU), with a ragged
mask, an all-masked row and a non-zero h0. Tolerance 2e-6 absolute: float32
sums of H products taken in another order, over T dependent steps."""

import numpy as np
import jax.numpy as jnp
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
