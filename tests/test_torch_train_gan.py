"""The port's GAN training (s2i_tpu_torch/train/gan.py, train/losses.py,
data/synthetic.py, cli.run_gan_training) against the JAX package's
``gan.make_train_step``, on the CPU at tiny widths: 3 steps of the 2-stage
GAN with roll wrong pairs, and 1 joint step (1 stage) with class-aware
ones; the 256 px D and the 3-stage G are held at module level in
tests/test_torch_models.py, and the full-width 3-stage step card vs CPU by
chip_smoke.py: every JAX step compiled here weighs on the test suite's
clock.

Both sides start from the port's seeded init, carried to Flax trees by the
inverse bridge (``bridge.gnet_trees`` / ``dnet_trees`` / ``encoder_trees``),
and get the same batches and the same noise: z and the CA eps drawn by JAX's
``_per_example_normal`` for the step, as the JAX step draws them, and
injected into the port's step. The JAX layout levers stay at the cfg's
defaults ("auto": S2D and D_TRUNK_BATCH on at batch 4), which the port
computes in the plain layout.

The JAX step runs in float64 (``jax.enable_x64``, ``DTYPE.COMPUTE``
float64; the joint step's speech encoder in float32, since its GRU's carry
is float32) and holds the port's float32 step. The JAX package's own
float32 step is not a fit referee at these widths: on some batches its
gradients are further from its float64 step than the tolerances below
allow the port's float32 step to be. Tolerances, for the port's float32 sums:
- metrics: rtol 1e-4, atol 1e-5;
- params, BN running statistics and the EMA after a step: atol 3e-5,
  rtol 1e-4, as tests/test_torch_train_encoder.py;
- Adam moments: 2e-4 of the tensor's largest magnitude (4e-4 for the
  second moment, which squares the gradient: G's init fc feeds a BN over 4
  examples) plus 1e-5 of the largest over the model (a BN bias's gradient
  sums a whole batch of gradients that BN made mean-free, so it is 0 up to
  rounding);
- where a first moment is 0 within that tolerance, Adam's normalized step
  m/(sqrt(v) + eps) may take either sign, so that element of the params (and
  the EMA) may differ by up to 2·lr; the moments pin its gradient.
Over 3 free-running steps the states drift apart by more than that, since
those elements feed the next step. So the metrics are compared on the
free-running trajectories, and the states per step from a common start:
before each step the JAX state is made from the port's (params, statistics,
Adam moments and count, EMA).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from s2i_tpu import config as jax_config
from s2i_tpu.data import SyntheticGanDataset as JaxGanDataset
from s2i_tpu.train import gan as jax_gan
from s2i_tpu_torch import bridge, cli, config
from s2i_tpu_torch.data import SyntheticGanDataset, synthetic_wavs
from s2i_tpu_torch.train import gan, loop

B = 4
MET_RTOL, MET_ATOL = 1e-4, 1e-5
STATE_ATOL, STATE_RTOL = 3e-5, 1e-4
MOMENT_REL, MOMENT_ABS = 2e-4, 1e-5
LR = 2e-4  # TRAIN.GENERATOR_LR and DISCRIMINATOR_LR of the default cfg
TINY = [
    "GAN.GF_DIM=4", "GAN.DF_DIM=4", "GAN.Z_DIM=8", "GAN.EMBEDDING_DIM=16", "GAN.R_NUM=1",
    "TEXT.DIMENSION=32", f"TRAIN.BATCH_SIZE={B}", "TRAIN.COEFF.COLOR_LOSS=50.0",
    "DTYPE.COMPUTE=float32",
]
JOINT = [
    "TRAIN.JOINT_FT=true", "TRAIN.COEFF.DISTILL=1.0", "AUDIO.N_MELS=8", "AUDIO.MAX_FRAMES=32",
    "ENCODER.CONV_CHANNELS=[8, 16]", "ENCODER.RNN_HIDDEN=16",
]


def cfgs(*overrides):
    over = TINY + list(overrides)
    return (config.apply_overrides(config.default_cfg(), over),
            jax_config.apply_overrides(jax_config.default_cfg(), over + ["DTYPE.COMPUTE=float64"]))


def dataset(cfg, cls=SyntheticGanDataset):
    return cls(num_classes=3, examples_per_class=3, branch_num=int(cfg.TREE.BRANCH_NUM),
               emb_dim=int(cfg.TEXT.DIMENSION), image_dtype="uint8", ship_scales="top")


def jax_noise(step: int, cfg):
    """The JAX step's own z and CA eps for ``step`` (base key 0)."""
    rz, rc = jax.random.split(jax.random.fold_in(jax.random.key(0), step))
    idx = jnp.arange(B)
    return (np.array(jax_gan._per_example_normal(rz, idx, (int(cfg.GAN.Z_DIM),))),
            np.array(jax_gan._per_example_normal(rc, idx, (int(cfg.GAN.EMBEDDING_DIM),))))


def _moments(mod, opt):
    """{name: (exp_avg, exp_avg_sq)} of ``mod``'s parameters (zeros before
    the first step)."""
    out = {}
    for name, p in mod.named_parameters():
        s = opt.state.get(p, {})
        out[name] = tuple(s.get(k, torch.zeros_like(p)).detach().clone() for k in ("exp_avg", "exp_avg_sq"))
    return out


def _with(mod, values: dict) -> dict:
    sd = {k: v.detach().clone() for k, v in mod.state_dict().items()}
    sd.update(values)
    return sd


def jax_state(st: gan.GanTrainState, cfg_j) -> jax_gan.GanTrainState:
    """The JAX train state holding the port state's params, statistics,
    Adam moments and count, and EMA."""
    def J(tree):  # float64, but the encoder ("enc") stays float32: see run_both
        return {k: jax.tree.map(lambda x, k=k: jnp.asarray(x, jnp.float32 if k == "enc" else jnp.float64), v)
                for k, v in tree.items()}

    g, enc = st.models.g, st.models.encoder

    def g_tree(values, with_enc):
        ca_g, stats = bridge.gnet_trees(_with(g, values.get("g", {})))
        if enc is None:
            return ca_g, stats
        ev = bridge.encoder_trees(_with(enc, values.get("enc", {})))
        return ({**ca_g, "enc": ev["params"]} if with_enc else ca_g), {**stats, "enc": ev["batch_stats"]}

    def adam(mods_opt, conv):
        mu = {k: {n: m[0] for n, m in _moments(mod, opt).items()} for k, (mod, opt) in mods_opt.items()}
        nu = {k: {n: m[1] for n, m in _moments(mod, opt).items()} for k, (mod, opt) in mods_opt.items()}
        return (optax.ScaleByAdamState(jnp.asarray(st.step, jnp.int32), J(conv(mu)), J(conv(nu))),
                optax.EmptyState())

    g_params, g_stats = g_tree({}, True)
    g_mods = {"g": (g, st.g_opt)} | ({"enc": (enc, st.g_opt)} if enc is not None else {})
    d_trees = [bridge.dnet_trees(d.state_dict()) for d in st.models.ds]
    return jax_gan.GanTrainState(
        step=jnp.asarray(st.step, jnp.int32),
        g_params=J(g_params), g_stats=J(g_stats),
        g_opt=adam(g_mods, lambda v: g_tree(v, True)[0]),
        d_params=tuple(J(p) for p, _ in d_trees), d_stats=tuple(J(s) for _, s in d_trees),
        d_opt=tuple(adam({"d": (d, o)}, lambda v, d=d: bridge.dnet_trees(_with(d, v["d"]))[0])
                    for d, o in zip(st.models.ds, st.d_opts)),
        ema_g=J(bridge.gnet_trees(_with(g, st.ema))[0]) if st.ema else {},
    )


def port_snapshot(st: gan.GanTrainState) -> dict:
    """Every state tensor of the port as numpy, keyed by "<part>/<name>"."""
    out = {}
    parts = [("g", st.models.g, st.g_opt), ("enc", st.models.encoder, st.g_opt)]
    parts += [(f"d{i}", d, o) for i, (d, o) in enumerate(zip(st.models.ds, st.d_opts))]
    for part, mod, opt in parts:
        if mod is None:
            continue
        out.update({f"{part}/{k}": v.numpy().copy() for k, v in mod.state_dict().items()})
        for name, (m, v) in _moments(mod, opt).items():
            out[f"{part}/mu/{name}"], out[f"{part}/nu/{name}"] = m.numpy(), v.numpy()
    out.update({f"ema/{k}": v.numpy().copy() for k, v in st.ema.items()})
    return out


def jax_snapshot(js, joint: bool) -> dict:
    """The same keys from a JAX state, through the forward bridge."""
    out = {}
    adam = js.g_opt[0]
    g_sd = lambda p: bridge.gnet_state_dict({"ca": p["ca"], "g": p["g"]}, js.g_stats)  # noqa: E731
    out.update({f"g/{k}": v for k, v in g_sd(js.g_params).items()})
    for m, tree in (("mu", adam.mu), ("nu", adam.nu)):
        out.update({f"g/{m}/{k}": v for k, v in g_sd(tree).items() if "running" not in k})
    if joint:
        e_sd = lambda p: bridge.encoder_state_dict({"params": p["enc"], "batch_stats": js.g_stats["enc"]})  # noqa: E731
        out.update({f"enc/{k}": v for k, v in e_sd(js.g_params).items()})
        for m, tree in (("mu", adam.mu), ("nu", adam.nu)):
            out.update({f"enc/{m}/{k}": v for k, v in e_sd(tree).items() if "running" not in k})
    for i, (p, s, o) in enumerate(zip(js.d_params, js.d_stats, js.d_opt)):
        out.update({f"d{i}/{k}": v for k, v in bridge.dnet_state_dict(p, s).items()})
        for m, tree in (("mu", o[0].mu), ("nu", o[0].nu)):
            out.update({f"d{i}/{m}/{k}": v for k, v in bridge.dnet_state_dict(tree, s).items() if "running" not in k})
    if js.ema_g:
        out.update({f"ema/{k}": v for k, v in g_sd(js.ema_g).items() if "running" not in k})
    return out


def assert_states_close(got: dict, want: dict, what: str) -> None:
    """Moments within MOMENT_REL of their tensor's largest magnitude plus
    MOMENT_ABS of the largest over the model; params, statistics and EMA
    within STATE_ATOL/RTOL, except where the first moment is 0 within that
    tolerance: there Adam's normalized step may take either sign and the
    element may differ by up to 2·LR."""
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:10]
    scale = {}
    for k, w in want.items():
        part = k.split("/")[0] + ("/mu" if "/mu/" in k else "/nu" if "/nu/" in k else "")
        scale[part] = max(scale.get(part, 0.0), float(np.abs(w).max()))
    for k, w in want.items():
        part, name = k.split("/")[0], k.split("/")[-1]
        if "/mu/" in k or "/nu/" in k:
            kind = "mu" if "/mu/" in k else "nu"
            rel = MOMENT_REL if kind == "mu" else 2 * MOMENT_REL  # v squares the gradient
            tol = rel * np.abs(w).max() + MOMENT_ABS * scale[f"{part}/{kind}"]
            err = np.abs(got[k] - w).max()
            assert err <= tol, f"{what} {k}: {err} > {tol}"
            continue
        mu_key = f"{'g' if part == 'ema' else part}/mu/{name}"
        err = np.abs(got[k] - w)
        tol = STATE_ATOL + STATE_RTOL * np.abs(w)
        if mu_key in got:
            mu = got[mu_key]
            ill = np.abs(mu) <= MOMENT_REL * np.abs(mu).max() + MOMENT_ABS * scale[f"{mu_key.split('/')[0]}/mu"]
            tol = np.where(ill, tol + 2 * LR, tol)
        assert (err <= tol).all(), f"{what} {k}: {err.max()} at {np.unravel_index((err - tol).argmax(), err.shape)}"


def jax_batch(b: dict) -> dict:
    """A port batch for the float64 JAX step (uint8 images stay uint8)."""
    f64 = lambda x: x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x  # noqa: E731
    return {k: (tuple(jnp.asarray(f64(x)) for x in v) if k == "images" else jnp.asarray(f64(np.asarray(v))))
            for k, v in b.items()}


def run_both(cfg, cfg_j, batches, joint=False) -> list[dict]:
    """Per step: both sides' metrics on the free-running trajectories, and
    the port's state after the step beside the JAX step's from the port's
    state before it."""
    st = gan.init_state(cfg, device="cpu")
    noise = [jax_noise(i, cfg) for i in range(len(batches))]
    out = []
    with jax.enable_x64(True):
        models = jax_gan.build_models(cfg_j, joint=joint)
        if joint:  # the JAX encoder's GRU carries a float32 state: keep it float32
            models = models._replace(encoder=models.encoder.clone(dtype=jnp.float32))
        step_fn = jax.jit(jax_gan.make_train_step(cfg_j, models))
        js_free = jax_state(st, cfg_j)
        for b, (z, eps) in zip(batches, noise):
            jb = jax_batch(b)
            js_sync, _ = step_fn(jax_state(st, cfg_j), jb, jax.random.key(0))
            js_free, jm = step_fn(js_free, jb, jax.random.key(0))
            tm = gan.train_step(st, b, z, eps)
            grads = {n: p.grad for mod in (st.models.g, st.models.encoder, *st.models.ds) if mod is not None
                     for n, p in mod.named_parameters()}
            out.append(dict(jax_mets={k: float(v) for k, v in jm.items()},
                            port_mets={k: float(v) for k, v in tm.items()},
                            port=port_snapshot(st), jax=jax_snapshot(js_sync, joint),
                            zero_grads=[n for n, g in grads.items() if g is None or not g.abs().max() > 0]))
    return out


@pytest.fixture(scope="module")
def frozen_roll():
    """2 branches, roll wrong pairs, EMA warmup 1: steps 0 | 1, 2 on either
    side of the switch."""
    cfg, cfg_j = cfgs("TREE.BRANCH_NUM=2", "TRAIN.EMA_WARMUP=1")
    ds = dataset(cfg)
    return run_both(cfg, cfg_j, [ds.batch((np.array([0, 3, 6, 1]) + i) % ds.n) for i in range(3)])


@pytest.fixture(scope="module")
def joint_class_aware():
    """1 branch, the speech encoder in G's optimizer group, distillation,
    class-aware wrong pairs (two examples share a class)."""
    cfg, cfg_j = cfgs("TREE.BRANCH_NUM=1", "TRAIN.WRONG_PAIR=class_aware", *JOINT)
    raw = dataset(cfg).batch(np.array([0, 4, 8, 2]))
    assert len(set(raw["class_id"])) < B
    p = cli.frontend_params_from_cfg(cfg.AUDIO)
    # distinct pitches per class: a random encoder maps alike wavs to alike
    # embeddings, which leaves G's gradients along them at rounding level
    wav, lens = synthetic_wavs(raw["class_id"] * 3, p.max_samples, seed=1, min_samples=2000)
    batch = cli.featurize({**raw, "wav": wav, "wav_len": lens, "teacher": raw["embedding"]}, p, "cpu")
    batch = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in batch.items()}
    return run_both(cfg, cfg_j, [batch], joint=True)


def _assert_metrics(rec, step):
    assert rec["port_mets"].keys() == rec["jax_mets"].keys()
    for k, v in rec["jax_mets"].items():
        np.testing.assert_allclose(rec["port_mets"][k], v, rtol=MET_RTOL, atol=MET_ATOL, err_msg=f"step {step} {k}")


@pytest.mark.parametrize("n_steps", [1, 3])
def test_gan_steps_match_jax(frozen_roll, n_steps):
    for i, rec in enumerate(frozen_roll[:n_steps]):
        _assert_metrics(rec, i)
        assert_states_close(rec["port"], rec["jax"], f"step {i}")
        assert not rec["zero_grads"], rec["zero_grads"]
    assert {"d_loss", "d1_loss", "d1_real_acc", "d1_fake_acc", "g_adv", "kl", "color", "g_loss"} <= \
        frozen_roll[0]["port_mets"].keys()


def test_ema_tracks_params_until_warmup_then_averages(frozen_roll):
    first, last = frozen_roll[0]["port"], frozen_roll[-1]["port"]
    for k in (k for k in first if k.startswith("ema/")):
        np.testing.assert_array_equal(first[k], first["g/" + k[4:]])  # decay 0 at step 0
    moved = [k for k in last if k.startswith("ema/") and not np.array_equal(last[k], last["g/" + k[4:]])]
    assert moved  # decay 0.999 from step 1 on


def test_joint_class_aware_step_matches_jax(joint_class_aware):
    (rec,) = joint_class_aware
    _assert_metrics(rec, 0)
    assert "distill_mse" in rec["port_mets"]
    assert any(k.startswith("enc/mu/rnn.") for k in rec["port"])
    assert_states_close(rec["port"], rec["jax"], "joint")
    assert not rec["zero_grads"], rec["zero_grads"]


def test_wrong_pair_sources_match_jax():
    for cls in ([0, 0, 1, 1, 2, 0], [3, 3, 3, 3], [1, 2], [5]):
        got = gan.wrong_pair_sources(torch.tensor(cls))
        want = jax_gan.wrong_pair_sources(jnp.asarray(cls))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_uint8_top_scale_pyramid_matches_jax():
    cfg, _ = cfgs("TREE.BRANCH_NUM=3")
    b = dataset(cfg).batch(np.arange(3))
    assert b["images"][0].dtype == np.uint8 and len(b["images"]) == 1
    got = gan.expand_image_pyramid(gan.normalize_images(b["images"], torch.device("cpu")), 3)
    want = jax_gan.expand_image_pyramid(jax_gan.normalize_images(tuple(map(jnp.asarray, b["images"]))), 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="scales"):
        gan.expand_image_pyramid(got[:2], 3)


def test_synthetic_gan_dataset_matches_jax():
    cfg, _ = cfgs("TREE.BRANCH_NUM=2")
    for kw in (dict(image_dtype="uint8", ship_scales="top"), dict()):
        got = SyntheticGanDataset(num_classes=2, examples_per_class=2, branch_num=2, emb_dim=32, **kw)
        want = JaxGanDataset(num_classes=2, examples_per_class=2, branch_num=2, emb_dim=32, **kw)
        rng = np.random.default_rng(4)
        for idx in (rng.integers(0, got.n, size=3) for _ in range(2)):
            a, b = got.batch(idx), want.batch(idx)
            assert a.keys() == b.keys()
            for x, y in zip(a["images"], b["images"]):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(a["embedding"], b["embedding"])
            np.testing.assert_array_equal(a["class_id"], b["class_id"])


def test_g_phase_leaves_the_discriminators_alone():
    """The G phase runs the Ds in train mode, but their running statistics
    stay those of the D phase, and no gradient reaches their parameters."""
    cfg, _ = cfgs("TREE.BRANCH_NUM=2")
    st = gan.init_state(cfg, device="cpu")
    batch = gan.prepare_batch(st, dataset(cfg).batch(np.arange(B)))
    fwd = gan.g_forward(st, batch, *gan.step_noise(st, B))
    gan.d_phase(st, batch, fwd)
    before = [{k: v.clone() for k, v in d.state_dict().items()} for d in st.models.ds]
    grads = [[p.grad.clone() for p in d.parameters()] for d in st.models.ds]
    gan.g_phase(st, batch, fwd)
    for d, sd, gs in zip(st.models.ds, before, grads):
        for k, v in d.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
        for p, g in zip(d.parameters(), gs):
            torch.testing.assert_close(p.grad, g, rtol=0, atol=0)
    assert all(p.requires_grad for d in st.models.ds for p in d.parameters())


def test_init_is_seeded_and_noise_follows_the_step():
    cfg, _ = cfgs("TREE.BRANCH_NUM=1")
    torch.manual_seed(1)
    a = gan.init_state(cfg, device="cpu")
    torch.manual_seed(2)
    b = gan.init_state(cfg, device="cpu")
    for k, v in a.models.g.state_dict().items():
        torch.testing.assert_close(v, b.models.g.state_dict()[k], rtol=0, atol=0)
    w = a.models.ds[0].img_code_s16[2].weight.flatten(1)  # [out, in·16]: orthonormal rows
    torch.testing.assert_close(w @ w.T, torch.eye(w.shape[0]), atol=1e-5, rtol=0)
    z0, _ = gan.step_noise(a, B)
    a.step = 1
    z1, _ = gan.step_noise(a, B)
    assert not torch.equal(z0, z1) and torch.equal(z1, gan.step_noise(a, B)[0])


def test_optimizer_choices():
    cfg, _ = cfgs("TREE.BRANCH_NUM=1", "TRAIN.OPTIMIZER=sgd")
    assert isinstance(gan.init_state(cfg, device="cpu").g_opt, torch.optim.SGD)
    cfg, _ = cfgs("TREE.BRANCH_NUM=1")
    assert type(gan.init_state(cfg, device="cpu").g_opt) is torch.optim.Adam  # MOMENT_DTYPE float32
    cfg, _ = cfgs("TREE.BRANCH_NUM=1", "TRAIN.MOMENT_DTYPE=bfloat16")
    opt = gan.init_state(cfg, device="cpu").g_opt
    assert isinstance(opt, gan.CastMomentAdam) and opt.moment_dtype == torch.bfloat16
    cfg, _ = cfgs("TREE.BRANCH_NUM=1", "TRAIN.MOMENT_DTYPE=float16")
    with pytest.raises(ValueError, match="MOMENT_DTYPE='float16'"):
        gan.init_state(cfg, device="cpu")


@pytest.mark.parametrize("mode", ["frozen", "joint"])
def test_run_gan_training_logs_scalars(tmp_path, monkeypatch, mode):
    cfg, _ = cfgs("TREE.BRANCH_NUM=1", "DATASET_NAME=synthetic", *(JOINT if mode == "joint" else ()))
    calls = []
    featurize = loop.featurize  # the trainer featurizes each joint batch as it takes it
    monkeypatch.setattr(loop, "featurize", lambda *a: calls.append(1) or featurize(*a))
    mets = cli.run_gan_training(cfg, steps=2, device="cpu", run_dir=str(tmp_path), log_every=1)
    assert len(calls) == (2 if mode == "joint" else 0)  # one wav batch featurized per step
    lines = [json.loads(line) for line in (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    assert lines[-1]["images_per_sec"] > 0 and lines[-1]["g_loss"] == mets["g_loss"]
    assert ("distill_mse" in mets) == (mode == "joint")
    assert all(np.isfinite(v) for v in mets.values())


def test_gan_batch_factory_prefers_the_callers_batches():
    cfg, _ = cfgs("TREE.BRANCH_NUM=1", "DATASET_NAME=synthetic")
    mine = dataset(cfg).batch(np.array([3, 2, 1, 0]))
    got = list(cli.gan_batch_factory(cfg, lambda epoch: [mine])(0))
    assert len(got) == 1 and got[0] is mine
    synth = list(cli.gan_batch_factory(cfg)(0))
    assert len(synth) == cli._synthetic_gan(cfg).n // B


def test_train_step_marks_its_parts_in_order():
    cfg, _ = cfgs("TREE.BRANCH_NUM=1")
    st = gan.init_state(cfg, device="cpu")
    parts = []
    mets = gan.train_step(st, dataset(cfg).batch(np.arange(B)), mark=parts.append)
    assert parts == ["g_forward", "d_phase", "g_phase"]
    assert st.step == 1 and np.isfinite(mets["g_loss"].item())


def test_gan_entry_points_need_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points rightly run on it")
    cfg, _ = cfgs("TREE.BRANCH_NUM=1", "DATASET_NAME=synthetic")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gan.init_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_gan_training(cfg, steps=1, run_dir=str(tmp_path))
    cfg.DATASET_NAME, cfg.DATA_DIR = "birds", str(tmp_path / "no_data")
    with pytest.raises(FileNotFoundError, match="filenames.pickle"):  # the StackGAN loader, on a missing tree
        cli.gan_batch_factory(cfg)
