"""The port's bfloat16 compute (``DTYPE.COMPUTE=bfloat16``, the default of
every shipped cfg but debug_tiny) and bfloat16 Adam moments
(``TRAIN.MOMENT_DTYPE=bfloat16``) against the JAX package, on the CPU at
tiny widths, with the Flax weights carried over by s2i_tpu_torch/bridge.py
and inputs from a numpy seed.

The JAX modules run eagerly (no ``jax.jit``), with
``capture_intermediates=True``:
- the dtype audit: at the counterpart points (conv and dense outputs, BN
  outputs, images, logits, GRU outputs, pooled heads) the port's output
  types are the JAX package's;
- the values: ``max|port_bf16 - jax_bf16|`` is below a fixed tolerance, and
  that tolerance is below ``max|jax_bf16 - jax_fp32|`` on the same inputs,
  so a port that computed in float32 would fail. The ratio measured when
  the bounds were set is written beside each bound.
The two packages round at the same points but not in the same order (XLA
and ATen take other bfloat16 conv and matmul paths on the CPU), hence a
tolerance and not equality.

The bfloat16-moment Adam is held against ``s2i_tpu.train.gan._adam`` run
eagerly with optax; the guard of tests/test_train_gan.py (first-step
parameter deltas within bfloat16-moment rounding of float32 Adam's, a
short run finite) is ported without JAX; and bf16 encoder and joint steps
resume bitwise from a checkpoint."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from s2i_tpu import config as jax_config
from s2i_tpu.models.ca_net import CANet as JaxCANet
from s2i_tpu.models.discriminator import build_discriminators
from s2i_tpu.models.encoder import SpeechEncoder as JaxEncoder
from s2i_tpu.models.generator import GNet as JaxGNet
from s2i_tpu.train.gan import _adam as jax_adam
from s2i_tpu_torch import bridge, cli, config
from s2i_tpu_torch.models import encoder as port_encoder
from s2i_tpu_torch.models.ca_net import CANet
from s2i_tpu_torch.models.discriminator import DNet
from s2i_tpu_torch.models.encoder import BiGRU, SpeechEncoder
from s2i_tpu_torch.models.generator import GNet, ToRGB
from s2i_tpu_torch.models.layers import BatchNorm, Conv1d, Conv2d
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.utils import CheckpointManager
from tests._flax_random import random_variables

BF16, F32 = torch.bfloat16, torch.float32
GF, DF, Z, EMB, TEXT, B = 4, 4, 8, 16, 32, 4
G_BRANCH = 2  # 64 and 128 px: the init stage and one next stage




# Each case's tolerance on max|port_bf16 - jax_bf16| (absolute); beside it
# max|port_bf16 - jax_bf16| / max|jax_bf16 - jax_fp32| as measured when it
# was set. A conv whose float32 sums run in another order rounds an element
# to the neighbouring bfloat16 now and then, and later layers carry that
# further: over batches 2-16 the G and D ratios moved between 0 and 0.7.
TOL = {
    "ca": 5e-3,  # ratio 0 (bitwise; spread 1.06e-2)
    "g-transpose": 5e-3,  # ratio 0.018 (2.4e-4 of 1.33e-2)
    "g-naive": 5e-3,  # ratio 0.082 (1.0e-3 of 1.26e-2)
    "d64": 1.2e-3,  # ratio 0 (bitwise; spread 2.55e-3)
    "d128": 1.2e-3,  # ratio 0 (bitwise; spread 3.84e-3)
    "d256": 1.2e-3,  # ratio 0 (bitwise; spread 1.85e-3)
    "encoder-eval": 1e-4,  # ratio 4.7e-5 (1.2e-7 of 2.55e-3)
    "encoder-train": 1e-4,  # ratio 1.1e-5 (1.2e-7 of 1.04e-2)
}
LR = 2e-4
TINY_GAN = ["DATASET_NAME=synthetic", "TREE.BRANCH_NUM=2", "GAN.GF_DIM=4", "GAN.DF_DIM=4", "GAN.Z_DIM=8",
            "GAN.EMBEDDING_DIM=16", "GAN.R_NUM=1", "TEXT.DIMENSION=32", "TRAIN.BATCH_SIZE=4"]
AUDIO = ["AUDIO.N_MELS=8", "AUDIO.MAX_FRAMES=32", "ENCODER.CONV_CHANNELS=[8, 16]", "ENCODER.RNN_HIDDEN=16",
         "ENCODER.N_CLASSES=8", "ENCODER.BATCH_SIZE=16"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jdt(x) -> str:
    return {jnp.bfloat16: "bfloat16", jnp.float32: "float32"}[jnp.dtype(x.dtype).type]


def _tdt(x) -> str:
    return {BF16: "bfloat16", F32: "float32"}[x.dtype]


# Flax module names → the audit's counterpart points. The GRU's input
# projection (``input_proj``, bfloat16) has no module of its own in the
# port: the audit holds what the recurrence is given instead, float32 on
# both sides ("xw").
_JAX_POINTS = (
    (re.compile(r"(Conv|UpConv3x3)_\d+|conv\d+|(un)?cond_logit"), "conv"),
    (re.compile(r"BatchNorm_\d+|bn\d+"), "bn"),
    (re.compile(r"Dense_\d+"), "dense"),
    (re.compile(r"to_rgb\d+"), "image"),
    (re.compile(r"BiGRU_0"), "gru"),
    (re.compile(r"head|cls"), "head"),
)


def jax_audit(intermediates) -> dict[str, set]:
    """{point: the set of output types} over every Flax submodule output."""
    seen: dict[str, set] = {}

    def walk(tree, name):
        for k, v in tree.items():
            if k == "__call__":
                point = next((p for rx, p in _JAX_POINTS if rx.fullmatch(name)), None)
                if point:
                    seen.setdefault(point, set()).update(_jdt(x) for x in jax.tree.leaves(v))
            else:
                walk(v, k)

    walk(intermediates, "")
    return seen


def port_audit(module: torch.nn.Module, run):
    """(run's result, {point: the set of output types}) with forward hooks
    on the port's counterpart modules, and the types of the recurrence's
    input projection (what ``gru_scan`` is given) as the point "xw"."""
    seen: dict[str, set] = {}

    def point(name, m):
        if isinstance(m, (Conv1d, Conv2d)):
            return "conv"
        if isinstance(m, BatchNorm):
            return "bn"
        if isinstance(m, torch.nn.Linear):
            return "head" if name.split(".")[-1] in ("head", "cls") else "dense"
        return {ToRGB: "image", BiGRU: "gru"}.get(type(m))

    def hook(p):
        return lambda m, args, out: seen.setdefault(p, set()).update(
            _tdt(x) for x in (out if isinstance(out, tuple) else (out,)) if torch.is_tensor(x))

    handles = [m.register_forward_hook(hook(p)) for name, m in module.named_modules()
               if (p := point(name, m))]
    scan = port_encoder.gru_scan

    def scan_audit(xw, *args):
        seen.setdefault("xw", set()).add(_tdt(xw))
        return scan(xw, *args)

    port_encoder.gru_scan = scan_audit
    try:
        out = run()
    finally:
        port_encoder.gru_scan = scan
        for h in handles:
            h.remove()
    return out, seen


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(jnp.asarray(x, jnp.float32))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.permute(0, 2, 3, 1) if torch.is_tensor(x) else x


def _load(module, sd, train: bool):
    module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=True)
    return module.train(train)


def _apply(jm, variables, *args, train: bool | None = None, **kw):
    """Eager Flax apply capturing every submodule's output: (out, intermediates)."""
    if train is not None:
        kw["train"] = train
    mutable = ["intermediates", "batch_stats"] if train else ["intermediates"]
    out, new = jm.apply(variables, *args, capture_intermediates=True, mutable=mutable, **kw)
    return out, new["intermediates"]


def case_ca(rng):
    emb = rng.standard_normal((B, TEXT)).astype(np.float32)
    eps = rng.standard_normal((B, EMB)).astype(np.float32)
    params = random_variables(JaxCANet(c_dim=EMB).init, emb, seed=2, train=False)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        (c, mu, logvar), inter = _apply(JaxCANet(EMB, dt), params, emb, eps=eps)
        want[dt] = [c, mu, logvar]
    tca = CANet(TEXT, EMB, BF16)
    tca.load_state_dict({"fc.weight": torch.from_numpy(np.asarray(params["params"]["Dense_0"]["kernel"]).T.copy()),
                         "fc.bias": torch.from_numpy(np.asarray(params["params"]["Dense_0"]["bias"]))})
    got, seen = port_audit(tca, lambda: list(tca.sample(torch.from_numpy(emb), torch.from_numpy(eps))))
    seen["out"] = {_tdt(x) for x in got}
    return got, want, seen, {**jax_audit(inter), "out": {_jdt(x) for x in want[jnp.bfloat16]}}


def _case_g(rng, mode):
    z = rng.standard_normal((B, Z)).astype(np.float32)
    c = rng.standard_normal((B, EMB)).astype(np.float32)
    emb = np.zeros((B, TEXT), np.float32)
    ca_params = random_variables(JaxCANet(c_dim=EMB).init, emb, seed=2, train=False)["params"]
    variables = random_variables(JaxGNet(GF, G_BRANCH, 1, up_mode=mode).init, z, c, seed=3)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        want[dt], inter = _apply(JaxGNet(GF, G_BRANCH, 1, dtype=dt, up_mode=mode), variables, z, c, train=False)
    audit = jax_audit(inter)
    sd = bridge.gnet_state_dict({"ca": ca_params, "g": variables["params"]}, {"g": variables["batch_stats"]})
    tg = _load(GNet(GF, Z, EMB, TEXT, G_BRANCH, 1, BF16, mode), sd, train=False)
    got, seen = port_audit(tg, lambda: tg(torch.from_numpy(z), torch.from_numpy(c)))
    seen["out"], audit["out"] = {_tdt(x) for x in got}, {_jdt(x) for x in want[jnp.bfloat16]}
    return [_nhwc(x) for x in got], want, seen, audit


def _case_d(rng, scale):
    branch = {64: 1, 128: 2, 256: 3}[scale]
    real = rng.uniform(-1, 1, (B, scale, scale, 3)).astype(np.float32)
    c = rng.standard_normal((B, EMB)).astype(np.float32)
    variables = random_variables(build_discriminators(branch, DF, EMB)[-1].init, real, c, seed=scale)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        want[dt], inter = _apply(build_discriminators(branch, DF, EMB, dtype=dt)[-1], variables, real, c, train=False)
    td = _load(DNet(scale, DF, EMB, dtype=BF16), bridge.dnet_state_dict(variables["params"],
                                                                        variables["batch_stats"]), train=False)
    got, seen = port_audit(td, lambda: list(td(_nchw(real), torch.from_numpy(c))))
    seen["out"] = {_tdt(x) for x in got}
    return got, want, seen, {**jax_audit(inter), "out": {_jdt(x) for x in want[jnp.bfloat16]}}


def _case_encoder(rng, train):
    arch = dict(emb_dim=TEXT, conv_channels=(8, 16), conv_kernel=5, conv_stride=2, rnn_hidden=8, n_classes=5)
    t, n_mels = 24, 8
    lens = np.array([t, 13, 0, 20, 7])  # ragged, one all-masked
    feats = rng.standard_normal((len(lens), t, n_mels)).astype(np.float32)
    mask = np.arange(t)[None, :] < lens[:, None]
    variables = random_variables(JaxEncoder(**arch).init, feats, mask, seed=1, train=False)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        out, inter = _apply(JaxEncoder(dtype=dt, **arch), variables, feats, mask, train=train)
        want[dt] = list(out)
    audit = jax_audit(inter)
    tm = _load(SpeechEncoder(n_mels=n_mels, dtype=BF16, **arch), bridge.encoder_state_dict(variables), train)
    got, seen = port_audit(tm, lambda: list(tm(torch.from_numpy(feats), torch.from_numpy(mask))))
    seen["out"], audit["out"] = {_tdt(x) for x in got}, {_jdt(x) for x in want[jnp.bfloat16]}
    assert seen.pop("xw") == {"float32"}  # the recurrence takes float32, as the JAX package's
    return got, want, seen, audit


CASES = {
    "ca": case_ca,
    "g-transpose": lambda rng: _case_g(rng, "transpose"),
    "g-naive": lambda rng: _case_g(rng, "naive"),
    "d64": lambda rng: _case_d(rng, 64),
    "d128": lambda rng: _case_d(rng, 128),
    "d256": lambda rng: _case_d(rng, 256),
    "encoder-eval": lambda rng: _case_encoder(rng, False),
    "encoder-train": lambda rng: _case_encoder(rng, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_matches_jax_at_its_cast_points(case):
    got, want, seen, audit = CASES[case](np.random.default_rng(len(case)))
    assert seen == audit, f"output types at the counterpart points: port {seen}, JAX {audit}"
    err = max(float(np.abs(_np(g) - _np(w)).max()) for g, w in zip(got, want[jnp.bfloat16]))
    spread = max(float(np.abs(_np(a) - _np(b)).max()) for a, b in zip(want[jnp.bfloat16], want[jnp.float32]))
    print(f"{case}: port vs JAX bf16 {err:.3g}, JAX bf16 vs fp32 {spread:.3g}, ratio {err / spread:.3g}")
    assert TOL[case] < spread, f"{case}: the tolerance {TOL[case]} does not tell bf16 from fp32 ({spread})"
    assert err <= TOL[case], f"{case}: {err} > {TOL[case]} (bf16 vs fp32 {spread})"


# a small tree: with TRAIN.MOMENT_DTYPE_MIN_SIZE 300 the conv and dense
# kernels take bfloat16 moments, the rest float32
ADAM_TREE = {"conv": (8, 3, 4, 4), "dense": (64, 32), "bias": (8,), "scale": (16,), "small_conv": (4, 2, 3, 3)}


def _adam_cfgs(moment_dtype: str):
    over = [f"TRAIN.MOMENT_DTYPE={moment_dtype}", "TRAIN.MOMENT_DTYPE_MIN_SIZE=300"]
    return (config.apply_overrides(config.default_cfg(), over),
            jax_config.apply_overrides(jax_config.default_cfg(), over))


def test_cast_moment_adam_matches_optax():
    """TRAIN.MOMENT_DTYPE=bfloat16: the port's Adam against the JAX
    package's ``_adam`` run eagerly with optax over 3 steps: bfloat16
    moments on exactly the leaves optax keeps in bfloat16, the same moment
    values, and parameters within float32 rounding (a few ulps of 0.1)."""
    rng = np.random.default_rng(0)
    init = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in ADAM_TREE.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in ADAM_TREE.items()} for _ in range(3)]
    cfg, jcfg = _adam_cfgs("bfloat16")
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = gan.make_optimizer(cfg, list(params.values()), LR)
    tx = jax_adam(jcfg, LR)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0, atol=3e-8, err_msg=k)
    mu = {k: v for part in state[:2] for k, v in part.inner_state.mu.items() if hasattr(v, "dtype")}
    nu = {k: v for part in state[:2] for k, v in part.inner_state.nu.items() if hasattr(v, "dtype")}
    want_bf16 = {k for k, v in mu.items() if v.dtype == jnp.bfloat16}
    assert want_bf16 == {"conv", "dense"}
    assert {k for k, p in params.items() if opt.state[p]["exp_avg"].dtype == BF16} == want_bf16
    assert {k for k, p in params.items() if opt.state[p]["exp_avg_sq"].dtype == BF16} == want_bf16
    for k in want_bf16:
        for got, ref in ((opt.state[params[k]]["exp_avg"], mu[k]), (opt.state[params[k]]["exp_avg_sq"], nu[k])):
            np.testing.assert_array_equal(_np(got), _np(ref), err_msg=k)


def test_float32_moments_are_torch_adam_bitwise():
    cfg, _ = _adam_cfgs("float32")
    rng = np.random.default_rng(1)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in ADAM_TREE.items()}
    runs = []
    for make in (lambda ps: gan.make_optimizer(cfg, ps, LR),
                 lambda ps: torch.optim.Adam(ps, lr=LR, betas=(0.5, 0.999), eps=1e-8)):
        ps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in init.values()]
        opt = make(ps)
        assert type(opt) is torch.optim.Adam
        for step in range(3):
            for p in ps:
                p.grad = torch.from_numpy(np.random.default_rng(step).standard_normal(p.shape).astype(np.float32))
            opt.step()
        runs.append(ps)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_moment_dtype_bf16_trains_and_tracks_fp32():
    """The guard of tests/test_train_gan.py on the port: the first step's
    parameter deltas with bfloat16 moments lie within 1e-5 of float32
    Adam's (bfloat16 rounding of an lr-sized update), the large leaves'
    moments are bfloat16, and 5 steps stay finite."""
    first = {}
    for mdt in ("float32", "bfloat16"):
        cfg = config.apply_overrides(config.default_cfg(), TINY_GAN + [
            f"TRAIN.MOMENT_DTYPE={mdt}", "TRAIN.MOMENT_DTYPE_MIN_SIZE=1024"])
        st = gan.init_state(cfg, device="cpu")
        batches = cli.synthetic_gan_batches(cfg)(0)
        for i in range(5):
            mets = gan.train_step(st, next(iter(batches)))
            if i == 0:
                first[mdt] = {k: v.clone() for k, v in st.models.g.named_parameters()}
        assert all(np.isfinite(float(v)) for v in mets.values()), (mdt, mets)
        if mdt == "bfloat16":
            assert any(s["exp_avg"].dtype == BF16 for o in st.d_opts for s in o.state.values())
    for name, a in first["float32"].items():
        np.testing.assert_allclose(a.detach().numpy(), first["bfloat16"][name].detach().numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


def _final_checkpoint(run_dir):
    return CheckpointManager(str(run_dir / "ckpt")).restore_latest_raw()[0]


def _assert_bitwise(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_bitwise(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bitwise(g, w, f"{path}/{i}")
    elif torch.is_tensor(want):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, path


def test_bf16_joint_and_encoder_runs_resume_bitwise(tmp_path):
    """A bfloat16 joint GAN run with bfloat16 moments (3 steps) and a
    bfloat16 encoder pretraining run (2 epochs), each straight and stopped +
    resumed from its checkpoint: finite metrics, and the final checkpoints
    (parameters, statistics, Adam's bfloat16 and float32 moments, EMA,
    step) bitwise equal."""
    cfg = config.apply_overrides(config.default_cfg(), TINY_GAN + AUDIO + [
        "TREE.BRANCH_NUM=1", "TRAIN.JOINT_FT=true", "TRAIN.COEFF.DISTILL=1.0", "TRAIN.MOMENT_DTYPE=bfloat16",
        "TRAIN.MOMENT_DTYPE_MIN_SIZE=1024"])
    assert cfg.DTYPE.COMPUTE == "bfloat16"
    mets = cli.run_gan_training(cfg, steps=3, device="cpu", run_dir=str(tmp_path / "gan"), log_every=1)
    assert all(np.isfinite(float(v)) for v in mets.values()), mets
    for steps in (2, 3):
        cli.run_gan_training(cfg, steps=steps, device="cpu", run_dir=str(tmp_path / "gan_resumed"))
    got, want = _final_checkpoint(tmp_path / "gan_resumed"), _final_checkpoint(tmp_path / "gan")
    assert any(v.dtype == BF16 for st in want["g_opt"]["state"].values() for v in st.values())
    _assert_bitwise(got, want)

    enc_cfg = config.apply_overrides(config.default_cfg(), TINY_GAN + AUDIO + [
        "ENCODER.LOG_EVERY=1", "ENCODER.SNAPSHOT_INTERVAL=0"])
    mets = cli.run_encoder_pretrain(enc_cfg, epochs=2, device="cpu", run_dir=str(tmp_path / "enc"))
    assert all(np.isfinite(float(v)) for v in mets.values()), mets
    for epochs in (1, 2):
        cli.run_encoder_pretrain(enc_cfg, epochs=epochs, device="cpu", run_dir=str(tmp_path / "enc_resumed"))
    _assert_bitwise(_final_checkpoint(tmp_path / "enc_resumed"), _final_checkpoint(tmp_path / "enc"))
