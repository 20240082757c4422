"""wav → image through the port (s2i_tpu_torch/pipeline.py) against the JAX
package's SpeechToImage, on the CPU, at a tiny width of the 3-stage tree
(64/128/256 px), with the same weights (carried by bridge.py) and the same z
(drawn here exactly as s2i_tpu/pipeline.py draws it, then injected).

Tolerances: 5e-5 absolute on float32 images (float32 sums in another order
through the frontend, the encoder and ~20 generator layers); uint8 images
may differ by one level where a value sits within rounding of a .5 edge,
and on no more than 1% of the pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from s2i_tpu import config
from s2i_tpu.pipeline import SpeechToImage as JaxPipe
from s2i_tpu.train import encoder as enc_train
from s2i_tpu.train import gan as gan_train
from s2i_tpu.train.encoder import EncoderTrainState
from s2i_tpu.train.gan import GanTrainState
from s2i_tpu_torch import bridge
from s2i_tpu_torch import config as port_config
from s2i_tpu_torch.pipeline import SpeechToImage
from tests._flax_random import random_variables

ATOL = 5e-5


def _cfg(joint: bool):
    cfg = config.default_cfg()
    cfg.TREE.BRANCH_NUM = 3
    cfg.GAN.GF_DIM = 4
    cfg.GAN.Z_DIM = 6
    cfg.GAN.EMBEDDING_DIM = 6
    cfg.GAN.R_NUM = 1
    cfg.TEXT.DIMENSION = 12
    cfg.DTYPE.COMPUTE = "float32"
    cfg.AUDIO.N_MELS = 8
    cfg.AUDIO.MAX_FRAMES = 32
    cfg.ENCODER.CONV_CHANNELS = [6, 8]
    cfg.ENCODER.RNN_HIDDEN = 8
    cfg.ENCODER.N_CLASSES = 5
    cfg.TRAIN.JOINT_FT = joint
    return cfg


def _states(cfg, joint: bool, seed: int = 0):
    """Random JAX encoder/GAN states (no discriminators: serving never
    reads them) with an EMA copy that differs from the raw weights."""
    n_mels, frames = int(cfg.AUDIO.N_MELS), int(cfg.AUDIO.MAX_FRAMES)
    feats = np.zeros((1, frames, n_mels), np.float32)
    mask = np.ones((1, frames), bool)
    models = gan_train.build_models(cfg, joint=joint)
    emb = np.zeros((1, int(cfg.TEXT.DIMENSION)), np.float32)
    z = np.zeros((1, int(cfg.GAN.Z_DIM)), np.float32)
    c = np.zeros((1, int(cfg.GAN.EMBEDDING_DIM)), np.float32)
    ca = lambda s: random_variables(models.ca.init, emb, seed=s, train=False)["params"]  # noqa: E731
    g_vars = random_variables(models.g.init, z, c, seed=seed + 1)
    g_params = {"ca": ca(seed + 2), "g": g_vars["params"]}
    g_stats = {"g": g_vars["batch_stats"]}
    enc_state = None
    encoder = models.encoder if joint else enc_train.build_encoder(cfg)
    e_vars = random_variables(encoder.init, feats, mask, seed=seed + 3)
    if joint:
        g_params["enc"], g_stats["enc"] = e_vars["params"], e_vars["batch_stats"]
    else:
        enc_state = EncoderTrainState(
            step=jnp.zeros((), jnp.int32), params=e_vars["params"],
            batch_stats=e_vars["batch_stats"], opt=None,
        )
    ema = {"ca": ca(seed + 4), "g": random_variables(models.g.init, z, c, seed=seed + 5)["params"]}
    gan_state = GanTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_params, g_stats=g_stats,
        g_opt=None, d_params=(), d_stats=(), d_opt=(), ema_g=ema,
    )
    return enc_state, gan_state


def _port_pipe(cfg, enc_state, gan_state):
    enc_vars = (
        None if enc_state is None
        else {"params": enc_state.params, "batch_stats": enc_state.batch_stats}
    )
    enc_sd, g_sd, joint = bridge.states_from_gan(
        gan_state.g_params, gan_state.g_stats, gan_state.ema_g, enc_vars
    )
    port_cfg = port_config.cfg_from_string("", base=port_config.AttrDict(cfg))
    return SpeechToImage(port_cfg, enc_sd, g_sd, joint=joint, device="cpu")


def _wavs(pipe, b: int = 3):
    n = pipe.p.max_samples
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(7)
    wavs = np.stack([0.4 * np.sin(2 * np.pi * 220.0 * (i + 1) * t) for i in range(b)])
    wavs = (wavs + 0.05 * rng.standard_normal(wavs.shape)).astype(np.float32)
    lens = np.array([n, n // 2, 100], np.int32)[:b]  # full, ragged, < one window
    for i, m in enumerate(lens):
        wavs[i, m:] = 0.0
    return wavs, lens


def _z(seed: int, b: int, z_dim: int) -> np.ndarray:
    # exactly the draw inside s2i_tpu/pipeline.py's jitted _generate
    return np.asarray(jax.random.normal(jax.random.key(seed), (b, z_dim), jnp.float32))


@pytest.fixture(scope="module")
def frozen():
    """cfg + JAX states with a separately trained (frozen) encoder."""
    cfg = _cfg(False)
    return (cfg, *_states(cfg, False))


@pytest.mark.parametrize("joint", [False, True], ids=["frozen-encoder", "joint"])
def test_wav_to_image_matches_jax(joint, request):
    if joint:
        cfg = _cfg(True)
        enc_state, gan_state = _states(cfg, True)
    else:
        cfg, enc_state, gan_state = request.getfixturevalue("frozen")
    jpipe = JaxPipe(cfg, enc_state, gan_state)
    pipe = _port_pipe(cfg, enc_state, gan_state)
    wavs, lens = _wavs(pipe)
    z = _z(5, len(wavs), pipe.z_dim)

    want = jpipe.generate(wavs, lens, seed=5)
    got = pipe.generate(wavs, lens, z=z)
    assert got.shape == want.shape == (3, 256, 256, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    if not joint:
        want8 = jpipe.generate(wavs, lens, seed=5, output_dtype="uint8")
        got8 = pipe.generate(wavs, lens, z=z, output_dtype="uint8")
        assert got8.dtype == want8.dtype == np.uint8
        diff = np.abs(got8.astype(np.int16) - want8.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
        # the stage range check, on both sides alike
        for stage in (3, -4):
            with pytest.raises(ValueError, match="out of range"):
                jpipe.generate(wavs, lens, stage=stage)
            with pytest.raises(ValueError, match="out of range"):
                pipe.generate(wavs, lens, stage=stage)
        small = pipe.generate(wavs, lens, z=z, stage=-3)
        assert small.shape == (3, 64, 64, 3)


def test_seeded_noise_and_generate_files(tmp_path, frozen):
    from PIL import Image

    from s2i_tpu_torch.audio.wavio import write_wav

    pipe = _port_pipe(*frozen)
    wavs, lens = _wavs(pipe, b=2)
    a = pipe.generate(wavs, lens, seed=3)
    np.testing.assert_array_equal(a, pipe.generate(wavs, lens, seed=3))
    assert not np.array_equal(a, pipe.generate(wavs, lens, seed=4))

    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"{i}.wav"))
        write_wav(paths[-1], wavs[i, : lens[i]], 16000)
    outs = [str(tmp_path / f"{i}.png") for i in range(2)]
    pipe.generate_files(paths, outs, seed=3)
    # the PCM16 round trip moves the input by < 2^-15: compare loosely
    pngs = np.stack([np.asarray(Image.open(o)) for o in outs])
    ref = pipe.generate(wavs, lens, seed=3, output_dtype="uint8")
    assert pngs.shape == ref.shape == (2, 256, 256, 3)
    assert np.abs(pngs.astype(np.int16) - ref.astype(np.int16)).max() <= 2


def test_entry_point_needs_matching_state(frozen):
    cfg, enc_state, gan_state = frozen
    with pytest.raises(ValueError, match="encoder_vars"):
        bridge.states_from_gan(gan_state.g_params, gan_state.g_stats)
    pipe = _port_pipe(cfg, enc_state, gan_state)
    sd = pipe.g.state_dict()
    sd.pop("img_net3.img.0.weight")
    with pytest.raises(RuntimeError, match="img_net3"):
        SpeechToImage(pipe.cfg, pipe.encoder.state_dict(), sd, device="cpu")
