"""The port's trainer loop, checkpoints, sampling and serving from
checkpoints (s2i_tpu_torch/train/loop.py, utils/, cli.py, pipeline.py), on
the CPU at tiny widths: BRANCH_NUM 1, GF/DF 4, batch 8, batches of the
128-example synthetic corpus (the trainers take the first 6 of each
epoch's 16, to keep the runs short); joint mode adds N_MELS 8, MAX_FRAMES
32 and a small encoder. They are the port's counterparts of
tests/test_loop.py: resumes are held bitwise equal to uninterrupted runs.

Two tests hold the port against the JAX package at the same tiny width
(2 stages), from the same weights through ``bridge.gnet_trees``, with the
tolerance of tests/test_torch_pipeline.py (5e-5 absolute): ``bn_recalc``
fed the draws that ``make_bn_recalc_fn`` makes, and ``sample`` fed the z of
``_per_example_normal`` (``make_sample_fn`` jitted: one compile of the tiny
G takes half the time of its op-by-op eager run). No JAX train step is
compiled here."""

import itertools
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2i_tpu import config as jax_config
from s2i_tpu.train import gan as jax_gan
from s2i_tpu_torch import bridge, cli, config
from s2i_tpu_torch.data import synthetic_wavs
from s2i_tpu_torch.models.layers import BatchNorm
from s2i_tpu_torch.pipeline import SpeechToImage
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.train.encoder import encoder_train_step, init_encoder_state
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils import CheckpointManager
from s2i_tpu_torch.utils.checkpoint import to_host

ATOL = 5e-5
B = 8
STEPS_PER_EPOCH = 6  # of the synthetic corpus's 16 batches an epoch
TINY = [
    "DATASET_NAME=synthetic", "TREE.BRANCH_NUM=1", "GAN.GF_DIM=4", "GAN.DF_DIM=4", "GAN.Z_DIM=8",
    "GAN.EMBEDDING_DIM=16", "GAN.R_NUM=1", "TEXT.DIMENSION=32", f"TRAIN.BATCH_SIZE={B}",
    "TRAIN.MAX_EPOCH=1", "TRAIN.SNAPSHOT_INTERVAL=8", "DTYPE.COMPUTE=float32",
]
AUDIO = ["AUDIO.N_MELS=8", "AUDIO.MAX_FRAMES=32", "ENCODER.CONV_CHANNELS=[8, 16]", "ENCODER.RNN_HIDDEN=16",
         "ENCODER.N_CLASSES=8", "ENCODER.BATCH_SIZE=16"]
JOINT = ["TRAIN.JOINT_FT=true", "TRAIN.COEFF.DISTILL=1.0", *AUDIO]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors gain nothing from torch's intra-op threads: one thread
    takes the same time here and half the CPU, which the test run's
    parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_of(*over):
    return config.apply_overrides(config.default_cfg(), TINY + list(over))


def short_epochs(cfg):
    """The synthetic batch stream, STEPS_PER_EPOCH batches an epoch."""
    full = cli.gan_batch_factory(cfg)
    return lambda epoch: itertools.islice(full(epoch), STEPS_PER_EPOCH)


def trainer(cfg, out, factory=None, **kw) -> GanTrainer:
    kw.setdefault("image_every", 10**6)
    return GanTrainer(cfg, str(out), factory or short_epochs(cfg), device="cpu", **kw)


def flat(sd, prefix: str = "") -> dict:
    """A nested state dict as {path: leaf}."""
    if isinstance(sd, dict):
        return {k: v for key, val in sd.items() for k, v in flat(val, f"{prefix}/{key}").items()}
    if isinstance(sd, (list, tuple)):
        return {k: v for i, val in enumerate(sd) for k, v in flat(val, f"{prefix}/{i}").items()}
    return {prefix: sd}


def assert_bitwise_equal(got: dict, want: dict) -> None:
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if torch.is_tensor(w):
            assert torch.equal(got[k], w), k
        else:
            assert got[k] == w, k


def train_and_close(t: GanTrainer, **kw) -> dict:
    try:
        t.train(**kw)
        return to_host(t.state.state_dict())
    finally:
        t.close()


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The uninterrupted frozen run: 2 epochs, logged every 4 steps, a grid
    every 6. Returns (run dir, final state dict)."""
    out = tmp_path_factory.mktemp("straight")
    cfg = cfg_of()
    return out, train_and_close(trainer(cfg, out, log_every=4, image_every=6), max_epoch=2)


class SigtermAfter:
    """A train step that sends this process SIGTERM as the trainer hands it
    its ``n``-th batch: the trainer finishes that step, then stops. (The
    batch factory runs ahead in the trainer's prefetch thread, so a signal
    sent from there would land some steps before its batch is trained.)"""

    def __init__(self, step, n: int):
        self.step, self.left = step, n

    def __call__(self, state, batch, **kw):
        self.left -= 1
        if self.left == 0:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.step(state, batch, **kw)


@pytest.mark.parametrize("stop", ["epoch_boundary", "mid_epoch", "sigterm"])
def test_resume_is_bitwise_equal_to_the_uninterrupted_run(tmp_path, straight, stop, monkeypatch):
    """A run stopped at an epoch's end, 2 steps into epoch 1 (max_steps, at
    a snapshot), or by SIGTERM after 9 batches, then resumed by a new trainer on its
    directory, ends bitwise where the uninterrupted run ends: params, BN
    statistics, Adam states, EMA, step. Epochs count in total: a finished
    1-epoch job does nothing more."""
    cfg = cfg_of()
    if stop == "sigterm":
        cfg.TRAIN.SNAPSHOT_INTERVAL = 10**9  # only the stop's own save may happen
        before = signal.getsignal(signal.SIGTERM)
        t = trainer(cfg, tmp_path)
        with monkeypatch.context() as m:
            m.setattr(gan, "train_step", SigtermAfter(gan.train_step, 9))
            t.train(max_epoch=50)  # 300 steps, were it not stopped
        assert t.state.step == 9 and t.ckpt.latest_step == 9
        assert signal.getsignal(signal.SIGTERM) is before  # the trainer's handler is gone
        t.close()
        cfg.TRAIN.SNAPSHOT_INTERVAL = 8
    else:
        kw = dict(max_epoch=1) if stop == "epoch_boundary" else dict(max_epoch=2, max_steps=8)
        train_and_close(trainer(cfg, tmp_path), **kw)
    want_step = {"epoch_boundary": STEPS_PER_EPOCH, "mid_epoch": 8, "sigterm": 9}[stop]
    progress = json.loads((tmp_path / "train_progress.json").read_text())
    assert progress == {"step": want_step, "epoch": want_step // STEPS_PER_EPOCH,
                        "step_in_epoch": want_step % STEPS_PER_EPOCH}
    t2 = trainer(cfg, tmp_path)
    assert t2.state.step == want_step  # restored, not initialized
    t2.train(max_epoch=1)
    assert t2.state.step == max(want_step, STEPS_PER_EPOCH)
    assert_bitwise_equal(train_and_close(t2, max_epoch=2), straight[1])


def test_run_dir_holds_scalars_grids_and_metadata(straight):
    out = straight[0]
    lines = (out / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [4, 8, 12]
    rec = json.loads(lines[-1])
    for key in ("step", "time", "g_loss", "d_loss", "kl", "images_per_sec"):
        assert key in rec
    assert sorted(os.listdir(out / "images")) == ["fake_0000006.png", "fake_0000012.png"]
    meta = json.loads((out / "run_meta.json").read_text())
    assert meta["device"] == "cpu" and meta["perf_levers"] is None and meta["params"]["encoder"] == 0


def test_net_g_warm_starts_the_whole_state(tmp_path, straight):
    cfg = cfg_of(f"TRAIN.NET_G={straight[0] / 'ckpt'}")
    t = trainer(cfg, tmp_path / "warm")
    assert t.state.step == 2 * STEPS_PER_EPOCH
    assert_bitwise_equal(to_host(t.state.state_dict()), straight[1])
    t.close()
    cfg.TRAIN.NET_G = str(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="NET_G"):
        trainer(cfg, tmp_path / "cold")


def test_debug_nans_guard(tmp_path):
    cfg = cfg_of("TRAIN.DEBUG_NANS=true", "TRAIN.GENERATOR_LR=1000000.0")
    t = trainer(cfg, tmp_path)
    with pytest.raises(FloatingPointError, match="non-finite"):
        t.train(max_epoch=6)  # the absurd lr drives a loss non-finite
    t.close()


def test_profile_dir_writes_a_trace(tmp_path):
    cfg = cfg_of(f"TRAIN.PROFILE_DIR={tmp_path / 'trace'}")
    t = trainer(cfg, tmp_path / "run")
    t.train(max_epoch=2, max_steps=11)  # the trace covers steps 6-10
    t.close()
    (trace,) = os.listdir(tmp_path / "trace")
    assert trace.endswith(".json")
    events = json.loads((tmp_path / "trace" / trace).read_text())["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert ranges.count("gan.step") == 5 and "loop.data_wait" in ranges  # the program's host spans


def test_sample_to_dir_is_independent_of_the_batch_size(tmp_path, straight):
    """N PNGs, the same bytes at batch 3 and batch 5 (z follows the global
    index, not the place in a padded batch); EMA with the raw-trajectory BN
    statistics warns."""
    cfg = cfg_of()
    t = trainer(cfg, straight[0])
    emb = np.random.default_rng(0).normal(size=(5, 32)).astype(np.float32)
    for bs in (3, 5):
        with pytest.warns(UserWarning, match="EMA_BN_RECALC"):
            t.sample_to_dir(emb, str(tmp_path / f"b{bs}"), batch_size=bs)
    t.close()
    names = sorted(os.listdir(tmp_path / "b3"))
    assert names == [f"{i:06d}.png" for i in range(5)] == sorted(os.listdir(tmp_path / "b5"))
    for n in names:
        assert (tmp_path / "b3" / n).read_bytes() == (tmp_path / "b5" / n).read_bytes(), n


def test_eval_state_recalcs_bn_under_the_ema_and_leaves_g_alone(tmp_path, straight):
    emb = np.random.default_rng(0).normal(size=(6, 32)).astype(np.float32)
    t = trainer(cfg_of("EVAL.EMA_BN_RECALC=3"), straight[0])
    g = t.state.models.g
    before = {k: v.clone() for k, v in g.state_dict().items()}
    es = t.eval_state(emb, seed=1)
    assert not es.training and es is not g
    for k, v in g.state_dict().items():
        assert torch.equal(v, before[k]), k  # the trainer's G: untouched
    for name, p in es.named_parameters():
        assert torch.equal(p, t.state.ema[name]), name
    stats = [k for k in before if "running" in k]
    assert stats and all(not torch.equal(es.state_dict()[k], before[k]) for k in stats)
    t.sample_to_dir(emb, str(tmp_path / "samples"), batch_size=4)  # no warning with recalc
    assert len(os.listdir(tmp_path / "samples")) == 6
    t.close()
    t = trainer(cfg_of(), straight[0])  # recalc off: the EMA with G's running statistics
    es = t.eval_state(emb)
    assert all(torch.equal(es.state_dict()[k], before[k]) for k in stats)
    t.close()


@pytest.fixture(scope="module")
def encoder_runs(tmp_path_factory):
    """Encoder pretraining of the joint cfg's encoder geometry: 2 epochs
    straight, and 1 + 1 epochs resumed in one directory (then a third,
    finished call). Returns (resumed run dir, progress after each call, the
    straight and the resumed final checkpoints)."""
    root = tmp_path_factory.mktemp("encoder")
    cfg = cfg_of(*AUDIO, "ENCODER.LOG_EVERY=0", "ENCODER.SNAPSHOT_INTERVAL=0")
    cli.run_encoder_pretrain(cfg, epochs=2, device="cpu", run_dir=str(root / "straight"))
    run = root / "resumed"
    progress = []
    for epochs in (1, 2, 2):
        cli.run_encoder_pretrain(cfg, epochs=epochs, device="cpu", run_dir=str(run))
        progress.append(json.loads((run / "train_progress.json").read_text()))
    raw = lambda d: CheckpointManager(str(d / "ckpt")).restore_latest_raw()[0]  # noqa: E731
    return run, progress, raw(root / "straight"), raw(run)


def test_encoder_pretrain_resume_counts_total_epochs(encoder_runs):
    _, progress, straight_sd, resumed_sd = encoder_runs
    spe = progress[0]["step"]  # 128 examples at batch 16
    assert progress == [{"epoch": 1, "step": spe}, {"epoch": 2, "step": 2 * spe}, {"epoch": 2, "step": 2 * spe}]
    assert spe == 8
    assert_bitwise_equal(resumed_sd, straight_sd)


def test_net_e_grafts_the_pretrained_encoder_and_rejects_drift(tmp_path, encoder_runs):
    run, _, _, enc_sd = encoder_runs
    cfg = cfg_of(*JOINT, f"TRAIN.NET_E={run / 'ckpt'}")
    t = trainer(cfg, tmp_path / "joint")
    got = t.state.models.encoder.state_dict()
    assert set(enc_sd["model"]) - set(got) == {"cls.weight", "cls.bias"}  # the class head stays out
    for k, v in got.items():
        assert torch.equal(v, enc_sd["model"][k]), k
    assert all(not st for st in t.state.g_opt.state.values())  # G's optimizer starts fresh
    t.close()
    bad = cfg_of(*JOINT, "ENCODER.RNN_HIDDEN=8", f"TRAIN.NET_E={run / 'ckpt'}")
    with pytest.raises(ValueError, match="NET_E.*rnn"):
        trainer(bad, tmp_path / "drift")


def _wavs(cfg, n: int = 3):
    p = cli.frontend_params_from_cfg(cfg.AUDIO)
    return synthetic_wavs(np.arange(n), p.max_samples, seed=2, min_samples=p.max_samples // 2)


def test_from_checkpoints_serves_what_the_trainers_trained(tmp_path, straight):
    """Frozen: the encoder pretraining's checkpoint beside the GAN run's;
    joint: the GAN checkpoint alone, with its finetuned encoder. Each serves
    bitwise what a pipeline built from the in-memory states serves: G's EMA
    weights with its running statistics."""
    cfg = cfg_of(*AUDIO)
    est = init_encoder_state(cfg, device="cpu")
    rng = np.random.default_rng(1)
    encoder_train_step(est, {"feats": rng.standard_normal((4, 32, 8)).astype(np.float32),
                             "feat_mask": np.ones((4, 32), bool),
                             "teacher": rng.standard_normal((4, 32)).astype(np.float32),
                             "class_id": np.arange(4)})
    CheckpointManager(str(tmp_path / "enc")).save(est.step, est)
    wav, lens = _wavs(cfg)
    pipe = SpeechToImage.from_checkpoints(cfg, str(tmp_path / "enc"), str(straight[0] / "ckpt"), device="cpu")
    sd = straight[1]
    want = SpeechToImage(cfg, est.model.state_dict(), {**sd["g"], **sd["ema"]}, device="cpu")
    np.testing.assert_array_equal(pipe.generate(wav, lens, seed=3), want.generate(wav, lens, seed=3))
    with pytest.raises(ValueError, match="encoder_ckpt"):
        SpeechToImage.from_checkpoints(cfg, None, str(straight[0] / "ckpt"), device="cpu")

    cfg = cfg_of(*JOINT)
    t = trainer(cfg, tmp_path / "joint")
    t.train(max_steps=2)
    t.close()
    pipe = SpeechToImage.from_checkpoints(cfg, None, str(tmp_path / "joint" / "ckpt"), device="cpu")
    g_sd = {**t.state.models.g.state_dict(), **t.state.ema}
    want = SpeechToImage(cfg, t.state.models.encoder.state_dict(), g_sd, joint=True, device="cpu")
    np.testing.assert_array_equal(pipe.generate(wav, lens, seed=3), want.generate(wav, lens, seed=3))


def test_checkpoint_retention_atomic_write_and_force(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step is None and mgr.restore_latest_raw() is None
    for step in (1, 2, 3):
        assert mgr.save(step, {"x": torch.full((2,), float(step))})
    assert mgr.steps() == [2, 3] and sorted(os.listdir(tmp_path)) == ["2.pt", "3.pt"]
    assert not mgr.save(3, {"x": torch.zeros(2)})  # not newer: kept as it is
    assert mgr.save(3, {"x": torch.zeros(2)}, force=True)
    (tmp_path / "9.pt.tmp").write_bytes(b"torn")  # an interrupted write is never the latest
    raw, step = mgr.restore_latest_raw()
    assert step == 3 and torch.equal(raw["x"], torch.zeros(2))


def test_checkpoint_restores_into_a_fresh_state_and_checks_its_layout(tmp_path):
    """A checkpoint holds host tensors only and loads into a fresh state;
    a state of another kind (frozen vs joint) or another optimizer layout
    is refused."""
    cfg = cfg_of()
    st = gan.init_state(cfg, device="cpu")
    gan.train_step(st, next(iter(cli.synthetic_gan_batches(cfg)(0))))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(st.step, st)
    raw, _ = mgr.restore_latest_raw()
    assert all(v.device.type == "cpu" for v in flat(raw).values() if torch.is_tensor(v))
    fresh = gan.init_state(cfg_of("SEED=7"), device="cpu")
    assert mgr.restore_latest(fresh) == (fresh, 1)
    assert_bitwise_equal(to_host(fresh.state_dict()), to_host(st.state_dict()))
    with pytest.raises(ValueError, match="joint"):
        gan.init_state(cfg_of(*JOINT), device="cpu").load_state_dict(raw)
    raw["g_opt_names"] = raw["g_opt_names"][::-1]
    with pytest.raises(ValueError, match="order"):
        fresh.load_state_dict(raw)


# --- against the JAX package -------------------------------------------------

@pytest.fixture(scope="module")
def jax_pair():
    """A 2-stage port state whose BN statistics and EMA differ from the
    init, the JAX models, and the same state as a JAX GanTrainState."""
    over = [o for o in TINY if not o.startswith("TREE.")] + ["TREE.BRANCH_NUM=2"]
    cfg = config.apply_overrides(config.default_cfg(), over)
    cfg_j = jax_config.apply_overrides(jax_config.default_cfg(), over)
    st = gan.init_state(cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in st.models.g.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
        for v in st.ema.values():
            v.add_(0.05 * torch.randn(v.shape, generator=gen))
    g = st.models.g
    g_params, g_stats = bridge.gnet_trees(g.state_dict())
    ema = bridge.gnet_trees({**g.state_dict(), **st.ema})[0]
    js = jax_gan.GanTrainState(step=jnp.zeros((), jnp.int32), g_params=g_params, g_stats=g_stats, g_opt=None,
                               d_params=(), d_stats=(), d_opt=(), ema_g=ema)
    return cfg_j, st, jax_gan.build_models(cfg_j), js


def test_bn_recalc_matches_jax(jax_pair):
    cfg_j, st, models, js = jax_pair
    batches, z_dim = 2, int(cfg_j.GAN.Z_DIM)
    pool = np.random.default_rng(4).normal(size=(20, 32)).astype(np.float32)
    rng = jax.random.key(3)
    idx, z = [], []
    for r in jax.random.split(rng, batches):  # make_bn_recalc_fn's draws
        r_idx, r_z = jax.random.split(r)
        idx.append(np.asarray(jax.random.randint(r_idx, (B,), 0, pool.shape[0])))
        z.append(np.asarray(jax.random.normal(r_z, (B, z_dim), jnp.float32)))
    want_stats = jax_gan.make_bn_recalc_fn(cfg_j, models, batches=batches, batch_size=B)(js, jnp.asarray(pool), rng)
    want = bridge.gnet_state_dict(js.ema_g, {"g": want_stats})
    before = {k: v.clone() for k, v in st.models.g.state_dict().items()}
    got = gan.bn_recalc(st, pool, batches, B, idx=np.stack(idx), z=np.stack(z))
    stats = [k for k in want if "running" in k]
    assert stats and sorted(stats) == sorted(got)
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=ATOL, err_msg=k)
        assert not np.allclose(want[k], before[k].numpy())  # the recalc moved every statistic
        assert torch.equal(st.models.g.state_dict()[k], before[k])  # on a copy of G


def test_sample_matches_jax(jax_pair):
    cfg_j, st, models, js = jax_pair
    emb = np.random.default_rng(6).normal(size=(3, 32)).astype(np.float32)
    key = jax.random.key(9)
    want = jax.jit(jax_gan.make_sample_fn(cfg_j, models))(js, jnp.asarray(emb), key)
    z = np.array(jax_gan._per_example_normal(key, jnp.arange(3), (int(cfg_j.GAN.Z_DIM),)))
    got = gan.sample(gan.sampling_generator(st), emb, z=z)
    assert len(got) == len(want) == 2
    for g_img, w_img in zip(got, want):
        np.testing.assert_allclose(g_img.permute(0, 2, 3, 1).numpy(), np.asarray(w_img), rtol=0, atol=ATOL)
    # without z: each example's noise follows its global index
    a = gan.sample(gan.sampling_generator(st), emb, seed=1)[-1]
    b = gan.sample(gan.sampling_generator(st), emb[1:], seed=1, offset=1)[-1]
    torch.testing.assert_close(a[1:], b, rtol=0, atol=1e-6)
