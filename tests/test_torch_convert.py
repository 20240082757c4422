"""The Orbax → torch converter (tools_jax2torch/orbax_to_torch.py) on the
CPU at tiny widths (2 stages, GF/DF 4, a small encoder): JAX train states
(``s2i_tpu``'s ``EncoderTrainState`` / ``GanTrainState`` with optax Adam
states) whose weights ``bridge.encoder_trees`` / ``gnet_trees`` /
``dnet_trees`` build from seeded port modules (BN statistics and the EMA
moved off their init, so that each is seen), saved by the JAX package's
Orbax ``CheckpointManager`` beside its ``config.yml``, are converted into
port checkpoints. Those must hold every weight bitwise, serve through
``SpeechToImage.from_checkpoints`` bitwise as the source modules do, and
warm-start a trainer. The Adam states hold seeded non-zero moments at step
``STEP`` (float32, and ``TRAIN.MOMENT_DTYPE=bfloat16``'s two masked states):
the port's ``exp_avg`` / ``exp_avg_sq`` / ``step`` must be the bridged moments
bitwise, and one port Adam step from them must give the parameters of one
eager optax update on the same gradients. No JAX step is compiled."""

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
from s2i_tpu.train.gan import _adam as jax_gan_optimizer
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
MIN_SIZE = 512  # TRAIN.MOMENT_DTYPE_MIN_SIZE: at these widths 14 G, 9 D and 4 encoder leaves are this large
ATOL_STEP = 1e-6  # parameters after one port Adam step against one optax update, float32


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


def seeded_adam(opt_state, seed: int):
    """``opt_state`` (optax, possibly masked) with every Adam state's count
    at STEP and its moments seeded non-zero in their own types (``nu``
    positive), drawn in numpy: no JAX op is compiled."""
    rng = np.random.default_rng(seed)
    draw = lambda x, f: (f(rng.standard_normal(x.shape)) * 0.1).astype(x.dtype)  # noqa: E731
    if isinstance(opt_state, optax.ScaleByAdamState):
        return opt_state._replace(count=np.int32(STEP), mu=jax.tree.map(lambda x: draw(x, lambda a: a), opt_state.mu),
                                  nu=jax.tree.map(lambda x: draw(x, np.abs), opt_state.nu))
    if isinstance(opt_state, optax.MaskedState):
        return opt_state._replace(inner_state=seeded_adam(opt_state.inner_state, seed))
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        return tuple(seeded_adam(s, seed + i) for i, s in enumerate(opt_state))
    return opt_state


def jax_encoder_run(run: str, cfg, jax_cfg) -> tuple[dict, EncoderTrainState]:
    """A JAX encoder pretraining run from the port's seeded encoder, with
    seeded Adam moments; returns the encoder's state dict and the state."""
    src = init_encoder_state(cfg, device="cpu").model
    sd = moved(src, torch.Generator().manual_seed(1))
    trees = bridge.encoder_trees(sd)
    state = EncoderTrainState(step=np.int32(STEP), params=trees["params"], batch_stats=trees["batch_stats"],
                              opt=seeded_adam(optax.adam(1e-3).init(trees["params"]), 4))
    save_jax_run(run, state, STEP, jax_cfg)
    return sd, state


def jax_gan_run(run: str, cfg, jax_cfg) -> tuple[dict, GanTrainState]:
    """A JAX GAN run (joint when the cfg says so) from the port's seeded
    state, its EMA apart from the raw weights, the JAX package's optimizers
    (``TRAIN.MOMENT_DTYPE``'s) with seeded moments; returns the source's
    state dicts as numpy (g, ds, enc or None, ema) and the JAX state."""
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
    g_tx, d_tx = (jax_gan_optimizer(jax_cfg, float(lr)) for lr in (cfg.TRAIN.GENERATOR_LR, cfg.TRAIN.DISCRIMINATOR_LR))
    state = GanTrainState(
        step=np.int32(STEP), g_params=g_params, g_stats=g_stats, g_opt=seeded_adam(g_tx.init(g_params), 10),
        d_params=tuple(p for p, _ in d_trees), d_stats=tuple(s for _, s in d_trees),
        d_opt=tuple(seeded_adam(d_tx.init(p), 20 + i) for i, (p, _) in enumerate(d_trees)), ema_g=ema_g)
    save_jax_run(run, state, STEP, jax_cfg)
    return src, state


def assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k


def moments(opt: optax.OptState) -> dict:
    """{"mu", "nu"} trees of an optax state, the masked halves merged."""
    states = [s for s in jax.tree.leaves(opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
              if isinstance(s, optax.ScaleByAdamState)]
    leaf = lambda *xs: next(x for x in xs if not isinstance(x, optax.MaskedNode))  # noqa: E731
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    return {k: jax.tree.map(leaf, *(getattr(s, k) for s in states), is_leaf=masked) for k in ("mu", "nu")}


def gan_named(tree: dict, g_stats: dict, joint: bool) -> dict:
    """A tree of G's optimizer group → the port's ``g_opt_names`` names."""
    out = {f"g.{k}": v for k, v in bridge.gnet_state_dict({"ca": tree["ca"], "g": tree["g"]}, g_stats).items()}
    if joint:
        out.update({f"enc.{k}": v for k, v in
                    bridge.encoder_state_dict({"params": tree["enc"], "batch_stats": g_stats["enc"]}).items()})
    return out


def opt_groups(jax_state, models) -> list:
    """(optax state, port parameter names in optimizer order, tree → named
    arrays) for G's optimizer and each D's."""
    joint = "enc" in jax_state.g_params
    groups = [(jax_state.g_opt, gan.g_opt_names(models), lambda t: gan_named(t, jax_state.g_stats, joint))]
    for opt, d, stats in zip(jax_state.d_opt, models.ds, jax_state.d_stats):
        groups.append((opt, [n for n, _ in d.named_parameters()], lambda t, s=stats: bridge.dnet_state_dict(t, s)))
    return groups


def padded(tree, params):
    """``tree`` (parameters, gradients or an optax state over ``params``)
    with each array raveled and zero-padded to the largest size of its
    moment-dtype class (``MIN_SIZE`` and over, or under), 0-d counts as they
    are. Adam works element by element and the JAX package masks by size, so
    an eager optax update of the padded trees gives the same values at the
    same places while compiling each op for two shapes, not for every
    leaf's (~5 s a run fewer)."""
    sizes = [np.size(p) for p in jax.tree.leaves(params)]
    length = {big: max((n for n in sizes if (n >= MIN_SIZE) == big), default=0) for big in (False, True)}

    def pad(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return x
        out = np.zeros(length[x.size >= MIN_SIZE], x.dtype)
        out[: x.size] = x.ravel()
        return out

    return jax.tree.map(pad, tree)


def assert_moments_carried(opt_sd: dict, jax_opt, names: list[str], named, big: int | None) -> None:
    """The port optimizer state_dict's per-parameter Adam state is the
    bridged optax moments bitwise, in bfloat16 for leaves of at least
    ``big`` elements (else float32), at step STEP."""
    want = {k: named(v) for k, v in moments(jax_opt).items()}
    assert sorted(opt_sd["state"]) == list(range(len(names)))
    for i, name in enumerate(names):
        st = opt_sd["state"][i]
        assert float(st["step"]) == STEP, name
        for key, k in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            t = st[key]
            cast = big is not None and t.numel() >= big
            assert t.dtype == (torch.bfloat16 if cast else torch.float32), (name, key)
            assert torch.equal(t.float(), torch.from_numpy(want[k][name])), (name, key)


def wavs(cfg):
    n = frontend_params_from_cfg(cfg.AUDIO).max_samples
    rng = np.random.default_rng(3)
    return (0.1 * rng.standard_normal((3, n))).astype(np.float32), np.array([n, 2000, 900])


@pytest.mark.parametrize("mode", ["frozen", "joint"])
def test_converted_checkpoints_serve_and_warm_start_as_their_source(tmp_path, mode, capsys):
    joint = mode == "joint"
    cfg, jax_cfg = cfgs(f"TRAIN.JOINT_FT={str(joint).lower()}")
    src, jax_state = jax_gan_run(str(tmp_path / "jax_gan"), cfg, jax_cfg)
    orbax_to_torch.main([str(tmp_path / "jax_gan"), str(tmp_path / "port_gan")])
    assert orbax_to_torch.EXACT_NOTE in capsys.readouterr().out
    raw, step = CheckpointManager(str(tmp_path / "port_gan" / "ckpt")).restore_latest_raw()
    assert step == STEP and raw["step"] == STEP
    assert_same(raw["g"], src["g"])
    for got, want in zip(raw["ds"], src["ds"]):
        assert_same(got, want)
    assert_same(raw["ema"], src["ema"])
    # Adam's moments and steps, bridged as the weights
    opt_sds = [raw["g_opt"], *raw["d_opts"]]
    for opt_sd, (jax_opt, names, named) in zip(opt_sds, opt_groups(jax_state, gan.init_state(cfg, "cpu").models)):
        assert_moments_carried(opt_sd, jax_opt, names, named, None)
    enc_ckpt = None
    if joint:
        assert_same(raw["enc"], src["enc"])
        enc_sd = src["enc"]
    else:
        assert raw["enc"] is None
        enc_sd, jax_enc = jax_encoder_run(str(tmp_path / "jax_enc"), cfg, jax_cfg)
        orbax_to_torch.main([str(tmp_path / "jax_enc" / "ckpt"), str(tmp_path / "port_enc"),
                             "--cfg", str(tmp_path / "jax_enc" / "config.yml")])
        assert orbax_to_torch.EXACT_NOTE in capsys.readouterr().out
        enc_raw, _ = CheckpointManager(str(tmp_path / "port_enc" / "ckpt")).restore_latest_raw()
        assert enc_raw["step"] == STEP
        assert_same(enc_raw["model"], enc_sd)
        names = [n for n, _ in init_encoder_state(cfg, device="cpu").model.named_parameters()]
        assert_moments_carried(enc_raw["opt"], jax_enc.opt, names, lambda t: bridge.encoder_state_dict(
            {"params": t, "batch_stats": jax_enc.batch_stats}), None)
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
    with pytest.raises(ValueError, match="g_opt: the checkpoint has an Adam state; the config's optimizer is SGD"):
        orbax_to_torch.main([str(tmp_path / "jax"), str(tmp_path / "port"), "--set", "TRAIN.OPTIMIZER=sgd"])


@pytest.mark.parametrize("mode, moment_dtype", [("frozen", "float32"), ("joint", "bfloat16")])
def test_converted_adam_state_steps_as_optax(tmp_path, mode, moment_dtype, capsys):
    """The converted moments of every optimizer, bitwise (bfloat16 kept for
    the large leaves), and one port Adam step of each optimizer (G's group:
    CA, G and in joint mode the encoder, every permutation the bridge makes;
    each D's) from the converted checkpoint against one eager optax update of
    the JAX package's optimizer on the same seeded gradients: the resume is
    exact."""
    cfg, jax_cfg = cfgs(f"TRAIN.JOINT_FT={str(mode == 'joint').lower()}", f"TRAIN.MOMENT_DTYPE={moment_dtype}",
                        f"TRAIN.MOMENT_DTYPE_MIN_SIZE={MIN_SIZE}")
    _, jax_state = jax_gan_run(str(tmp_path / "jax"), cfg, jax_cfg)
    orbax_to_torch.main([str(tmp_path / "jax"), str(tmp_path / "port")])
    assert orbax_to_torch.EXACT_NOTE in capsys.readouterr().out
    raw, _ = CheckpointManager(str(tmp_path / "port" / "ckpt")).restore_latest_raw()
    state = gan.init_state(cfg, device="cpu")
    state.load_state_dict(raw)
    big = MIN_SIZE if moment_dtype == "bfloat16" else None
    assert isinstance(state.g_opt, gan.CastMomentAdam) == (big is not None)
    opts = [state.g_opt, *state.d_opts]
    jax_params = [jax_state.g_params, *jax_state.d_params]
    txs = [jax_gan_optimizer(jax_cfg, float(cfg.TRAIN.GENERATOR_LR))]
    txs += [jax_gan_optimizer(jax_cfg, float(cfg.TRAIN.DISCRIMINATOR_LR))] * len(state.d_opts)
    n_cast = 0
    rng = np.random.default_rng(9)
    for opt, params, tx, (jax_opt, names, named) in zip(opts, jax_params, txs, opt_groups(jax_state, state.models)):
        assert_moments_carried(opt.state_dict(), jax_opt, names, named, big)
        n_cast += sum(p.numel() >= MIN_SIZE for p in opt.param_groups[0]["params"])
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        port_grads = named(grads)
        port_params = opt.param_groups[0]["params"]
        for name, p in zip(names, port_params):
            p.grad = torch.from_numpy(port_grads[name])
        opt.step()
        flat = lambda tree: padded(tree, params)  # noqa: E731
        new = optax.apply_updates(flat(params), tx.update(flat(grads), flat(jax_opt), flat(params))[0])
        want = named(jax.tree.map(lambda x, p: np.asarray(x)[: p.size].reshape(p.shape), new, params))
        for name, p in zip(names, port_params):
            np.testing.assert_allclose(p.detach().numpy(), want[name], atol=ATOL_STEP, rtol=0, err_msg=name)
    assert n_cast > 0  # some leaves' moments are bfloat16 under that moment dtype


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
