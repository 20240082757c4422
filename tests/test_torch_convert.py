"""The Orbax → torch converter (tools_jax2torch/orbax_to_torch.py) on the
CPU at tiny widths (2 stages, GF/DF 4, a small encoder): JAX train states
(``s2i_tpu``'s ``EncoderTrainState`` / ``GanTrainState`` with optax Adam
states) whose weights ``bridge.encoder_trees`` / ``gnet_trees`` /
``dnet_trees`` build from seeded port modules (BN statistics and the EMA
moved off their init, so that each is seen), saved by the JAX package's
Orbax ``CheckpointManager`` beside its ``config.yml``, are converted into
port checkpoints. Those must hold every weight bitwise, serve through
``SpeechToImage.from_checkpoints`` bitwise as the source modules do, and
warm-start a trainer. No JAX step is compiled."""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from s2i_tpu import config as jax_config
from s2i_tpu.eval.finetune import InceptionTrainState as JaxInceptionTrainState
from s2i_tpu.train.encoder import EncoderTrainState
from s2i_tpu.train.gan import GanTrainState
from s2i_tpu.utils import CheckpointManager as OrbaxCheckpoints
from s2i_tpu_torch import bridge, cli, config
from s2i_tpu_torch.audio.frontend import frontend_params_from_cfg
from s2i_tpu_torch.eval.finetune import init_inception_state
from s2i_tpu_torch.pipeline import SpeechToImage
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.train.encoder import init_encoder_state
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils import CheckpointManager
from tools_jax2torch import orbax_to_torch

TINY = [
    "TREE.BRANCH_NUM=2", "GAN.GF_DIM=4", "GAN.DF_DIM=4", "GAN.Z_DIM=8", "GAN.EMBEDDING_DIM=16", "GAN.R_NUM=1",
    "TEXT.DIMENSION=32", "DTYPE.COMPUTE=float32", "AUDIO.N_MELS=8", "AUDIO.MAX_FRAMES=32",
    "ENCODER.CONV_CHANNELS=[8, 16]", "ENCODER.RNN_HIDDEN=16", "ENCODER.N_CLASSES=8",
]
STEP = 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(*over):
    """(the port's cfg, the JAX package's) from the same overrides."""
    over = TINY + list(over)
    return (config.apply_overrides(config.default_cfg(), over),
            jax_config.apply_overrides(jax_config.default_cfg(), over))


def moved(module: torch.nn.Module, gen: torch.Generator) -> dict:
    """``module``'s state dict as numpy, its BN running statistics moved off
    their init (0 and 1) by seeded noise, loaded back into ``module``."""
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if "running" in name:
                buf.add_(0.1 * torch.rand(buf.shape, generator=gen))
    return {k: v.numpy().copy() for k, v in module.state_dict().items()}


def save_jax_run(run: str, state, step: int, jax_cfg) -> None:
    mgr = OrbaxCheckpoints(os.path.join(run, "ckpt"))
    mgr.save(step, state)
    mgr.wait()
    mgr.close()
    jax_config.dump_cfg(jax_cfg, os.path.join(run, "config.yml"))


def jax_encoder_run(run: str, cfg, jax_cfg) -> dict:
    """A JAX encoder pretraining run from the port's seeded encoder; returns
    the encoder's state dict."""
    src = init_encoder_state(cfg, device="cpu").model
    sd = moved(src, torch.Generator().manual_seed(1))
    trees = bridge.encoder_trees(sd)
    state = EncoderTrainState(step=np.int32(STEP), params=trees["params"], batch_stats=trees["batch_stats"],
                              opt=optax.adam(1e-3).init(trees["params"]))
    save_jax_run(run, state, STEP, jax_cfg)
    return sd


def jax_gan_run(run: str, cfg, jax_cfg) -> dict:
    """A JAX GAN run (joint when the cfg says so) from the port's seeded
    state, its EMA apart from the raw weights; returns the source's state
    dicts as numpy: g, ds, enc (or None), ema."""
    st = gan.init_state(cfg, device="cpu")
    gen = torch.Generator().manual_seed(2)
    m = st.models
    src = {"g": moved(m.g, gen), "ds": [moved(d, gen) for d in m.ds],
           "enc": None if m.encoder is None else moved(m.encoder, gen),
           "ema": {k: (v + 0.01 * torch.randn(v.shape, generator=gen)).numpy() for k, v in st.ema.items()}}
    g_params, g_stats = bridge.gnet_trees(src["g"])
    ema_g, _ = bridge.gnet_trees({**src["g"], **src["ema"]})
    if src["enc"] is not None:
        enc = bridge.encoder_trees(src["enc"])
        g_params["enc"], g_stats["enc"] = enc["params"], enc["batch_stats"]
    d_trees = [bridge.dnet_trees(sd) for sd in src["ds"]]
    adam = optax.adam(2e-4)
    state = GanTrainState(
        step=np.int32(STEP), g_params=g_params, g_stats=g_stats, g_opt=adam.init(g_params),
        d_params=tuple(p for p, _ in d_trees), d_stats=tuple(s for _, s in d_trees),
        d_opt=tuple(adam.init(p) for p, _ in d_trees), ema_g=ema_g)
    save_jax_run(run, state, STEP, jax_cfg)
    return src


def assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k


def wavs(cfg):
    n = frontend_params_from_cfg(cfg.AUDIO).max_samples
    rng = np.random.default_rng(3)
    return (0.1 * rng.standard_normal((3, n))).astype(np.float32), np.array([n, 2000, 900])


@pytest.mark.parametrize("mode", ["frozen", "joint"])
def test_converted_checkpoints_serve_and_warm_start_as_their_source(tmp_path, mode, capsys):
    joint = mode == "joint"
    cfg, jax_cfg = cfgs(f"TRAIN.JOINT_FT={str(joint).lower()}")
    src = jax_gan_run(str(tmp_path / "jax_gan"), cfg, jax_cfg)
    orbax_to_torch.main([str(tmp_path / "jax_gan"), str(tmp_path / "port_gan")])
    assert "warm start" in capsys.readouterr().out
    raw, step = CheckpointManager(str(tmp_path / "port_gan" / "ckpt")).restore_latest_raw()
    assert step == STEP and raw["step"] == STEP
    assert_same(raw["g"], src["g"])
    for got, want in zip(raw["ds"], src["ds"]):
        assert_same(got, want)
    assert_same(raw["ema"], src["ema"])
    assert raw["g_opt"]["state"] == {}  # Adam moments are not converted
    enc_ckpt = None
    if joint:
        assert_same(raw["enc"], src["enc"])
        enc_sd = src["enc"]
    else:
        assert raw["enc"] is None
        enc_sd = jax_encoder_run(str(tmp_path / "jax_enc"), cfg, jax_cfg)
        orbax_to_torch.main([str(tmp_path / "jax_enc" / "ckpt"), str(tmp_path / "port_enc"),
                             "--cfg", str(tmp_path / "jax_enc" / "config.yml")])
        enc_raw, _ = CheckpointManager(str(tmp_path / "port_enc" / "ckpt")).restore_latest_raw()
        assert enc_raw["step"] == STEP and enc_raw["opt"]["state"] == {}
        assert_same(enc_raw["model"], enc_sd)
        enc_ckpt = str(tmp_path / "port_enc" / "ckpt")

    served = SpeechToImage.from_checkpoints(cfg, enc_ckpt, str(tmp_path / "port_gan" / "ckpt"), device="cpu")
    source = SpeechToImage(cfg, enc_sd, {**src["g"], **src["ema"]}, joint=joint, device="cpu")
    w, lens = wavs(cfg)
    assert np.array_equal(served.generate(w, lens, seed=4), source.generate(w, lens, seed=4))

    cfg.TRAIN.NET_G = str(tmp_path / "port_gan" / "ckpt")
    warm = GanTrainer(cfg, str(tmp_path / "warm"), lambda epoch: iter(()), device="cpu")
    assert warm.state.step == STEP
    assert_same({k: v.detach() for k, v in warm.state.models.g.state_dict().items()}, src["g"])
    warm.close()


def test_converter_refuses_a_mismatched_config(tmp_path):
    cfg, jax_cfg = cfgs("TRAIN.JOINT_FT=true")
    jax_gan_run(str(tmp_path / "jax"), cfg, jax_cfg)
    with pytest.raises(ValueError, match="joint GAN state"):
        orbax_to_torch.main([str(tmp_path / "jax"), str(tmp_path / "port"), "--set", "TRAIN.JOINT_FT=false"])
    with pytest.raises(ValueError, match="Ds"):
        orbax_to_torch.main([str(tmp_path / "jax"), str(tmp_path / "port"), "--set", "TREE.BRANCH_NUM=1"])


def test_converted_inception_run_is_what_eval_scores_with(tmp_path, capsys):
    """A ``scripts/finetune_inception.py`` state (InceptionV3 params, BN
    statistics, optax Adam's state, built here from numpy zeros: optax's own
    ``init`` would compile a JAX op per leaf shape) → a port checkpoint
    holding every tensor bitwise, which ``eval --finetuned_ckpt`` loads
    (``cli.inception_weights``, the command's reader)."""
    _, jax_cfg = cfgs()
    sd = moved(init_inception_state(3, seed=5, device="cpu").model, torch.Generator().manual_seed(6))
    trees = bridge.inception_trees(sd)
    zeros = lambda: jax.tree.map(np.zeros_like, trees["params"])  # noqa: E731
    opt = (optax.ScaleByAdamState(count=np.zeros((), np.int32), mu=zeros(), nu=zeros()), optax.EmptyState())
    state = JaxInceptionTrainState(step=np.int32(STEP), params=trees["params"], batch_stats=trees["batch_stats"],
                                   opt=opt)
    save_jax_run(str(tmp_path / "jax_inc"), state, STEP, jax_cfg)
    orbax_to_torch.main([str(tmp_path / "jax_inc"), str(tmp_path / "port_inc")])
    assert "inception checkpoint of step 7" in capsys.readouterr().out
    ckpt = str(tmp_path / "port_inc" / "ckpt")
    raw, step = CheckpointManager(ckpt).restore_latest_raw()
    assert step == STEP == raw["step"] and raw["opt"]["state"] == {}
    assert_same(raw["model"], sd)
    got, n = cli.inception_weights(finetuned_ckpt=ckpt)
    assert n == 3
    assert_same(got, sd)
