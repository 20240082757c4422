"""The port's encoder distillation training (s2i_tpu_torch/train/, cli.py,
data/synthetic.py, the train mode of models/layers.py::BatchNorm) against
the JAX package's, on the CPU at the tiny shapes of
tests/test_encoder_train.py, from the same weights (Flax tree →
bridge.encoder_state_dict) on the same batches.

Tolerances, each for float32 sums taken in another order by another library:
- BatchNorm and the train-mode encoder forward: 2e-5 absolute on outputs and
  running statistics, as tests/test_torch_models.py holds the eval forward;
- train steps: atol 3e-5, rtol 1e-4 on losses, metrics, post-step params and
  running statistics, as tests/test_train_parity.py holds the GAN step;
  Adam's first moments (0.1 × the gradient after one step) at atol 1e-6,
  rtol 1e-4, which compares gradients without Adam's sign amplification of
  near-zero ones."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from s2i_tpu.data import SyntheticSpeechDataset as JaxSpeechDataset
from s2i_tpu.train import encoder as jax_train
from s2i_tpu_torch import bridge, cli, config
from s2i_tpu_torch.data import SyntheticSpeechDataset
from s2i_tpu_torch.models.layers import BatchNorm
from s2i_tpu_torch.ops import gru_kernel
from s2i_tpu_torch.train import encoder as enc_train
from tests._flax_random import random_variables

ATOL = 2e-5
STEP_ATOL, STEP_RTOL = 3e-5, 1e-4
MU_ATOL = 1e-6
BATCH = 8


def tiny_cfg():
    c = config.default_cfg()
    c.TEXT.DIMENSION = 32
    c.ENCODER.CONV_CHANNELS = [8, 16]
    c.ENCODER.RNN_HIDDEN = 16
    c.ENCODER.N_CLASSES = 4
    c.ENCODER.LR = 3.0e-3
    c.ENCODER.BATCH_SIZE = BATCH
    c.AUDIO.N_MELS = 8
    c.AUDIO.MAX_FRAMES = 32
    c.DTYPE.COMPUTE = "float32"
    return c


def make_ds(cfg, cls=SyntheticSpeechDataset):
    return cls(num_classes=4, examples_per_class=8, max_frames=int(cfg.AUDIO.MAX_FRAMES),
               n_mels=int(cfg.AUDIO.N_MELS), emb_dim=int(cfg.TEXT.DIMENSION))


@pytest.mark.parametrize("shape", [(6, 5, 11), (7, 3)], ids=["BCT", "BC"])
def test_batchnorm_train_matches_flax(shape):
    rng = np.random.default_rng(0)
    c = shape[1]
    x = (1.5 + 2.0 * rng.standard_normal(shape)).astype(np.float32)  # mean far from 0
    x_last = np.moveaxis(x, 1, -1)  # Flax normalizes the last axis
    bn = fnn.BatchNorm(momentum=0.9)
    variables = random_variables(bn.init, x_last, seed=1, use_running_average=False)
    want, new = bn.apply(variables, x_last, use_running_average=False, mutable=["batch_stats"])

    tb = BatchNorm(c)
    p, s = variables["params"], variables["batch_stats"]
    tb.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in (
        ("weight", p["scale"]), ("bias", p["bias"]), ("running_mean", s["mean"]),
        ("running_var", s["var"]))})
    got = tb.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.moveaxis(np.asarray(want), -1, 1), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tb.running_mean.numpy(), new["batch_stats"]["mean"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tb.running_var.numpy(), new["batch_stats"]["var"], atol=ATOL, rtol=0)
    # eval mode normalizes with the (updated) running statistics
    ev = tb.eval()(torch.from_numpy(x)).detach().numpy()
    want_ev = bn.apply({"params": p, "batch_stats": new["batch_stats"]}, x_last, use_running_average=True)
    np.testing.assert_allclose(ev, np.moveaxis(np.asarray(want_ev), -1, 1), atol=ATOL, rtol=0)


def test_synthetic_dataset_matches_jax():
    cfg = tiny_cfg()
    got, want = make_ds(cfg), make_ds(cfg, JaxSpeechDataset)
    for name in ("feats", "mask", "teacher", "class_id", "lengths"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for a, b in zip(got.batches(BATCH, 2, seed=3), want.batches(BATCH, 2, seed=3)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_setup(cfg, batch):
    model = jax_train.build_encoder(cfg)
    variables = random_variables(model.init, batch["feats"], batch["feat_mask"], seed=4)
    return model, variables


def _port_state(cfg, variables):
    """The port's train state holding the Flax variables' weights."""
    state = enc_train.init_encoder_state(cfg, device="cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in bridge.encoder_state_dict(variables).items()})
    return state


def test_train_mode_encoder_matches_flax():
    cfg = tiny_cfg()
    batch = make_ds(cfg).batch(np.arange(BATCH))
    model, variables = _jax_setup(cfg, batch)
    apply = jax.jit(functools.partial(model.apply, train=True, mutable=["batch_stats"]))
    (emb, logits), new = apply(variables, batch["feats"], batch["feat_mask"])

    state = _port_state(cfg, variables)
    got_emb, got_logits = state.model(torch.from_numpy(batch["feats"]), torch.from_numpy(batch["feat_mask"]))
    np.testing.assert_allclose(got_emb.detach().numpy(), np.asarray(emb), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(logits), atol=ATOL, rtol=0)
    want_sd = bridge.encoder_state_dict({"params": variables["params"], "batch_stats": new["batch_stats"]})
    for k, v in state.model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_sd[k], atol=ATOL, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def three_steps():
    """Per step, the JAX and the port's metrics, Adam first moments,
    params and running statistics, as torch-named numpy dicts."""
    cfg = tiny_cfg()
    batches = list(make_ds(cfg).batches(BATCH, 3, seed=5))
    model, variables = _jax_setup(cfg, batches[0])
    jstate = jax_train.EncoderTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt=optax.adam(float(cfg.ENCODER.LR)).init(variables["params"]),
    )
    jstep = jax.jit(jax_train.make_encoder_train_step(cfg, model))
    tstate = _port_state(cfg, variables)
    names = {p: n for n, p in tstate.model.named_parameters()}
    out = []
    for b in batches:
        jstate, jm = jstep(jstate, b, jax.random.key(0))
        tm = enc_train.encoder_train_step(tstate, b)
        mu = bridge.encoder_state_dict({"params": jstate.opt[0].mu, "batch_stats": jstate.batch_stats})
        out.append(dict(
            jax_mets={k: float(v) for k, v in jm.items()},
            port_mets={k: float(v) for k, v in tm.items()},
            jax_mu={k: mu[k] for k in names.values()},
            port_mu={names[p]: s["exp_avg"].numpy().copy() for p, s in tstate.opt.state.items()},
            jax_sd=bridge.encoder_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats}),
            port_sd={k: v.detach().numpy().copy() for k, v in tstate.model.state_dict().items()},
        ))
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(three_steps, n_steps):
    for i, rec in enumerate(three_steps[:n_steps]):
        assert rec["port_mets"].keys() == rec["jax_mets"].keys() == {"loss", "mse", "ce", "cls_acc"}
        for k, v in rec["jax_mets"].items():
            np.testing.assert_allclose(rec["port_mets"][k], v, atol=STEP_ATOL, rtol=STEP_RTOL, err_msg=f"step {i} {k}")
        assert rec["port_mu"].keys() == rec["jax_mu"].keys()
        for k, v in rec["jax_mu"].items():
            np.testing.assert_allclose(rec["port_mu"][k], v, atol=MU_ATOL, rtol=STEP_RTOL, err_msg=f"step {i} mu {k}")
        assert rec["port_sd"].keys() == rec["jax_sd"].keys()
        for k, v in rec["jax_sd"].items():
            np.testing.assert_allclose(rec["port_sd"][k], v, atol=STEP_ATOL, rtol=STEP_RTOL, err_msg=f"step {i} {k}")


def test_gradients_reach_every_parameter_through_gru_scan(monkeypatch):
    calls = []
    plain = gru_kernel.gru_scan_bwd_plain
    monkeypatch.setattr(gru_kernel, "gru_scan_bwd_plain", lambda *a: calls.append(a[0].shape[0]) or plain(*a))
    cfg = tiny_cfg()
    state = enc_train.init_encoder_state(cfg, device="cpu")
    mets = enc_train.encoder_train_step(state, make_ds(cfg).batch(np.arange(BATCH)))
    assert calls == [2]  # both directions of the layer in one call of GRUScan's backward
    assert np.isfinite(float(mets["loss"]))
    for name, p in state.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name
    assert state.model.convs[0].weight.grad.abs().max() > 0


def test_init_is_seeded_and_independent_of_the_global_rng():
    cfg = tiny_cfg()
    cfg.SEED = 7
    torch.manual_seed(123)
    a = enc_train.init_encoder_state(cfg, device="cpu").model.state_dict()
    torch.manual_seed(456)
    b = enc_train.init_encoder_state(cfg, device="cpu").model.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w_h = a["rnn.weight_hh_l0"].T  # [H, 3H]: orthonormal rows, as Flax's orthogonal init
    torch.testing.assert_close(w_h @ w_h.T, torch.eye(w_h.shape[0]), atol=1e-5, rtol=0)
    assert not a["rnn.bias_hh_l0"].any()


def test_extract_all_is_batch_size_invariant():
    cfg = tiny_cfg()
    ds = make_ds(cfg)
    state = enc_train.init_encoder_state(cfg, device="cpu")
    enc_train.encoder_train_step(state, ds.batch(np.arange(BATCH)))  # away from the init statistics
    e1 = enc_train.extract_all(state.model, ds.feats, ds.mask, batch_size=8)
    e2 = enc_train.extract_all(state.model, ds.feats, ds.mask, batch_size=5)
    assert e1.shape == (ds.n, 32) and state.model.training
    np.testing.assert_allclose(e1, e2, rtol=2e-5, atol=2e-5)


def test_run_encoder_pretrain_logs_scalars(tmp_path):
    cfg = tiny_cfg()
    cfg.DATASET_NAME = "synthetic"
    cfg.ENCODER.LOG_EVERY = 1
    mets = cli.run_encoder_pretrain(cfg, steps=3, device="cpu", run_dir=str(tmp_path))
    lines = (tmp_path / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 3 and set(mets) == {"loss", "mse", "ce", "cls_acc"}
    rec = json.loads(lines[-1])
    assert rec["step"] == 3 and rec["examples_per_sec"] > 0 and rec["loss"] == mets["loss"]


def test_wav_batches_are_featurized(tmp_path):
    cfg = tiny_cfg()
    cfg.AUDIO.MAX_FRAMES = 16
    p = cli.frontend_params_from_cfg(cfg.AUDIO)
    rng = np.random.default_rng(0)
    raw = {"wav": 0.1 * rng.standard_normal((2, p.max_samples)).astype(np.float32),
           "wav_len": np.array([p.max_samples, 900], np.int32),
           "teacher": rng.standard_normal((2, 32)).astype(np.float32), "class_id": np.array([0, 3])}
    cfg.DATA_DIR = str(tmp_path / "no_data")
    with pytest.raises(FileNotFoundError, match="filenames.pickle"):  # the StackGAN loader, on a missing tree
        cli.speech_batch_factory(cfg, "cpu")
    (batch,) = list(cli.speech_batch_factory(cfg, "cpu", wav_batches=lambda epoch: [raw])(0))
    assert batch["feats"].shape == (2, 16, 8) and batch["feat_mask"][1].sum() < 16
    mets = cli.run_encoder_pretrain(cfg, steps=1, device="cpu", run_dir=str(tmp_path),
                                    wav_batches=lambda epoch: [raw])
    assert np.isfinite(mets["loss"])


def test_training_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points rightly run on it")
    cfg = tiny_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enc_train.init_encoder_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_encoder_pretrain(cfg, steps=1, run_dir="unused")
