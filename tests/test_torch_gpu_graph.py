"""The GAN step replayed from CUDA graphs on the card (``train.gan.StepGraphs``)
against the same step run eagerly, frozen and joint (the encoder's K2
forward and K3 backward inside the graphs). Every test is marked ``gpu``
and skips without a card; the file imports nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_graph.py

Graphed and eager steps are held bitwise equal: a replay runs the kernels
that the eager step issues, with the same arguments, and cuDNN is held to
its deterministic algorithms here (restored afterwards), so no library
picks another algorithm between the two."""

import numpy as np
import pytest
import torch

from s2i_tpu_torch import config
from s2i_tpu_torch.ops import gru_kernel
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.utils import checkpoint

pytestmark = pytest.mark.gpu

B = 4
TINY = ["TREE.BRANCH_NUM=2", "GAN.GF_DIM=4", "GAN.DF_DIM=4", "GAN.Z_DIM=8", "GAN.EMBEDDING_DIM=16", "GAN.R_NUM=1",
        "TEXT.DIMENSION=32", "TRAIN.COEFF.COLOR_LOSS=50.0", "TRAIN.EMA_WARMUP=3"]
JOINT = ["TRAIN.JOINT_FT=true", "TRAIN.COEFF.DISTILL=1.0", "AUDIO.N_MELS=8", "AUDIO.MAX_FRAMES=32",
         "ENCODER.CONV_CHANNELS=[8, 16]", "ENCODER.RNN_HIDDEN=16"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _cfg(mode: str):
    return config.apply_overrides(config.default_cfg(), TINY + (JOINT if mode == "joint" else []))


def _batches(cfg, n: int, b: int = B, seed: int = 0) -> list[dict]:
    """``n`` host batches of ``b`` rows, every one with other values."""
    rng = np.random.default_rng(seed)
    size = 64 * 2 ** (int(cfg.TREE.BRANCH_NUM) - 1)
    out = []
    for _ in range(n):
        batch = {"images": (rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),),
                 "class_id": rng.integers(0, 5, b)}
        if cfg.TRAIN.JOINT_FT:
            t = int(cfg.AUDIO.MAX_FRAMES)
            lens = rng.integers(t // 2, t + 1, b)
            batch.update(feats=rng.standard_normal((b, t, int(cfg.AUDIO.N_MELS))).astype(np.float32),
                         feat_mask=np.arange(t)[None, :] < lens[:, None],
                         teacher=rng.standard_normal((b, int(cfg.TEXT.DIMENSION))).astype(np.float32))
        else:
            batch["embedding"] = rng.standard_normal((b, int(cfg.TEXT.DIMENSION))).astype(np.float32)
        out.append(batch)
    return out


def _step(state, batch, eager: bool = False):
    """(metrics as floats, the kind of step): ``eager`` forgets the graphs
    first, so the step cannot replay."""
    if eager:
        state.graphs.drop()
    before = dict(gan.train_step.graph_steps)
    mets = gan.train_step(state, batch)
    (kind,) = [k for k, v in gan.train_step.graph_steps.items() if v != before[k]]
    return {k: v.item() for k, v in mets.items()}, kind


def _tensors(state) -> dict:
    """Every parameter and buffer, the EMA copy and every optimizer state tensor."""
    m = state.models
    out = {}
    for prefix, mod in [("g", m.g), *((f"d{i}", d) for i, d in enumerate(m.ds)), ("enc", m.encoder)]:
        if mod is not None:
            out.update({f"{prefix}.{k}": v for k, v in mod.state_dict().items()})
    out.update({f"ema.{k}": v for k, v in state.ema.items()})
    for name, opt in [("g_opt", state.g_opt), *((f"d_opt{i}", o) for i, o in enumerate(state.d_opts))]:
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in st.items()})
    return out


def _assert_bitwise(got, want) -> None:
    assert got.keys() == want.keys()
    differ = [k for k in want if not torch.equal(got[k].cpu(), want[k].cpu())]
    assert not differ, differ[:10]


@pytest.mark.parametrize("mode", ["frozen", "joint"])
def test_graphed_steps_equal_eager_steps(card, mode):
    """Seven steps from one seeded state, graphed and eager: the same losses
    each step and, after them, bitwise the same parameters, EMA copy (its
    warm-up ends at step 3, inside the replays), BN running statistics and
    Adam moments and counts. Steps 0 and 1 run eager, step 2 is captured,
    the rest replay; the eager state never captures."""
    cfg = _cfg(mode)
    graphed, eager = gan.init_state(cfg, "cuda"), gan.init_state(cfg, "cuda")
    assert gan.all_capturable([graphed.g_opt, *graphed.d_opts])
    kinds = []
    for batch in _batches(cfg, 7):
        got, kind = _step(graphed, batch)
        want, eager_kind = _step(eager, batch, eager=True)
        assert got == want and eager_kind == "eager"
        kinds.append(kind)
    assert kinds == ["eager", "eager", "capture", "replay", "replay", "replay", "replay"]
    assert set(graphed.graphs.captured.ema) == {0.0, graphed.sc.ema_decay}
    _assert_bitwise(_tensors(graphed), _tensors(eager))


def test_a_new_shape_runs_eager_then_is_captured(card):
    """Half batches after a captured run of full ones: the full batches'
    graphs are dropped, then two eager steps, a capture, replays; full
    batches again go the same way."""
    cfg = _cfg("frozen")
    state = gan.init_state(cfg, "cuda")
    full, half = _batches(cfg, 7), _batches(cfg, 4, B // 2, 1)
    kinds = [_step(state, b)[1] for b in full[:3]]
    first = state.graphs.captured
    kinds += [_step(state, b)[1] for b in half]
    assert state.graphs.captured is not first
    kinds += [_step(state, b)[1] for b in full[3:]]
    assert kinds == ["eager", "eager", "capture"] + ["eager", "eager", "capture", "replay"] * 2


@pytest.mark.parametrize("mode", ["frozen", "joint"])
def test_loading_a_state_after_capture_drops_the_graphs(card, mode):
    """A captured state loads another state's checkpoint (its tensors copied
    to the host, as a saved one is: an optimizer loading a state_dict in
    memory would share its tensors): its next steps run eager, capture anew
    and match the eager steps of a state that loaded the same checkpoint,
    bitwise; loading an optimizer alone drops the graphs too."""
    cfg = _cfg(mode)
    batches = _batches(cfg, 9)
    graphed, eager, source = (gan.init_state(cfg, "cuda") for _ in range(3))
    for b in batches[:4]:
        _step(graphed, b)
        _step(source, b, eager=True)
    _step(source, batches[4], eager=True)  # the checkpoint is a step further on
    assert graphed.graphs.captured
    sd = checkpoint.to_host(source.state_dict())
    graphed.load_state_dict(sd)
    eager.load_state_dict(sd)
    assert not graphed.graphs.captured and graphed.step == eager.step == 5
    kinds = []
    for b in batches[5:]:
        got, kind = _step(graphed, b)
        assert got == _step(eager, b, eager=True)[0]
        kinds.append(kind)
    assert kinds == ["eager", "eager", "capture", "replay"]
    _assert_bitwise(_tensors(graphed), _tensors(eager))
    graphed.d_opts[0].load_state_dict(graphed.d_opts[0].state_dict())
    assert not graphed.graphs.captured and not graphed.graphs.seen


def test_held_metrics_keep_their_step(card):
    """The metrics a replayed step returned keep that step's values while
    later steps replay."""
    cfg = _cfg("frozen")
    state = gan.init_state(cfg, "cuda")
    batches = _batches(cfg, 6)
    for b in batches[:3]:
        _step(state, b)
    held = gan.train_step(state, batches[3])
    values = {k: v.item() for k, v in held.items()}
    later = [_step(state, b) for b in batches[4:]]
    assert [kind for _, kind in later] == ["replay", "replay"]
    assert {k: v.item() for k, v in held.items()} == values
    assert later[0][0]["g_loss"] != values["g_loss"]


def test_replays_count_the_gru_kernels_launches(card):
    """Each joint step, eager, captured or replayed, advances K2's and K3's
    launch counters by the launches it ran: one each per GRU layer."""
    cfg = _cfg("joint")
    state = gan.init_state(cfg, "cuda")
    layers = int(cfg.ENCODER.RNN_LAYERS)
    counters = (gru_kernel.gru_scan, gru_kernel.gru_scan_bwd)
    kinds, deltas = [], []
    for b in _batches(cfg, 5):
        before = [c.launches for c in counters]
        kinds.append(_step(state, b)[1])
        deltas.append([c.launches - n for c, n in zip(counters, before)])
    assert kinds == ["eager", "eager", "capture", "replay", "replay"]
    assert deltas == [[layers, layers]] * 5
