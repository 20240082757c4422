"""The port's models (s2i_tpu_torch/models/) against the JAX package's Flax
modules in eval mode, with the Flax weights carried over by
s2i_tpu_torch/bridge.py and loaded with strict=True.

Every parameter and batch statistic is random, away from any init value
(zero biases, unit BN stats), so a mis-mapped tensor cannot hide
(tests/_flax_random.py). Tolerance 2e-5 absolute: float32 products and
convolutions summed in another order by another library (XLA on one side,
ATen on the other)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2i_tpu.models.ca_net import CANet as JaxCANet
from s2i_tpu.models.encoder import SpeechEncoder as JaxEncoder
from s2i_tpu.models.generator import GNet as JaxGNet
from s2i_tpu_torch import bridge
from s2i_tpu_torch.models.encoder import SpeechEncoder, conv_pads
from s2i_tpu_torch.models.generator import GNet
from tests._flax_random import random_variables

ATOL = 2e-5


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return module.eval()


@pytest.mark.parametrize(
    "kw",
    [
        dict(conv_padding="SAME", pool="mean_max", n_classes=5),
        dict(conv_padding="torch", pool="mean", norm_out=True, rnn_layers=2),
        dict(conv_padding="SAME", pool="max", bidirectional=False),
    ],
    ids=["same-meanmax-cls", "torch-mean-norm-2layers", "same-max-unidirectional"],
)
def test_encoder_matches_flax(kw):
    arch = dict(emb_dim=12, conv_channels=(6, 8), conv_kernel=5, conv_stride=2,
                rnn_hidden=8, **kw)
    b, t, n_mels = 3, 24, 8
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((b, t, n_mels)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([t, 13, 0])[:, None]  # ragged, all-masked
    jm = JaxEncoder(dtype=jnp.float32, **arch)
    variables = random_variables(jm.init, feats, mask, seed=1, train=False)
    want = jax.jit(functools.partial(jm.apply, train=False))(variables, feats, mask)

    tm = _load(SpeechEncoder(n_mels=n_mels, **arch), bridge.encoder_state_dict(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(mask))
    if kw.get("n_classes"):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL, rtol=0)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_same_padding_is_xla_asymmetric_split():
    assert conv_pads(1024, 5, 2, "SAME") == (1, 2)
    assert conv_pads(512, 5, 2, "SAME") == (1, 2)
    assert conv_pads(37, 5, 2, "SAME") == (2, 2)
    assert conv_pads(1024, 5, 2, "torch") == (2, 2)
    with pytest.raises(ValueError):
        conv_pads(8, 5, 2, "valid")


@pytest.mark.parametrize("branch_num", [1, 2, 3])
def test_gnet_and_ca_match_flax(branch_num):
    gf, z_dim, c_dim, t_dim, b = 4, 6, 6, 12, 2
    rng = np.random.default_rng(branch_num)
    emb = rng.standard_normal((b, t_dim)).astype(np.float32)
    z = rng.standard_normal((b, z_dim)).astype(np.float32)

    ca = JaxCANet(c_dim=c_dim)
    ca_params = random_variables(ca.init, emb, seed=2, train=False)["params"]
    _, mu, logvar = ca.apply({"params": ca_params}, emb, train=False)
    g = JaxGNet(gf_dim=gf, branch_num=branch_num, num_res=2)
    g_vars = random_variables(g.init, z, mu, seed=3)
    want = jax.jit(functools.partial(g.apply, train=False))(g_vars, z, mu)

    sd = bridge.gnet_state_dict(
        {"ca": ca_params, "g": g_vars["params"]}, {"g": g_vars["batch_stats"]}
    )
    tg = _load(GNet(gf, z_dim, c_dim, t_dim, branch_num, num_res=2), sd)
    with torch.no_grad():
        t_mu, t_logvar = tg.ca_net(torch.from_numpy(emb))
        imgs = tg(torch.from_numpy(z), t_mu)
    np.testing.assert_allclose(t_mu.numpy(), np.asarray(mu), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_logvar.numpy(), np.asarray(logvar), atol=ATOL, rtol=0)
    assert len(imgs) == len(want) == branch_num
    for i, (got, ref) in enumerate(zip(imgs, want)):
        assert got.shape == (b, 3, 64 * 2**i, 64 * 2**i)
        np.testing.assert_allclose(
            got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=ATOL, rtol=0
        )
