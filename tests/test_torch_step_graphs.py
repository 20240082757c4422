"""What the GAN step's CUDA graphs (``train.gan.StepGraphs``) change on the
CPU, where every step runs eager: the up-convolution's constant tap matrix,
the graphs' static inputs and noise, the optimizers, the step's own record
of how it ran, when a signature is captured, and the registry of counted
kernel wrappers whose counters a replay advances. The graphs themselves run
in ``tests/test_torch_gpu_graph.py`` on a card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from s2i_tpu_torch import config
from s2i_tpu_torch.models import layers
from s2i_tpu_torch.ops import counted, gru_kernel, mel_kernel
from s2i_tpu_torch.pipeline import build_generator
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.utils.logging import clear_spans, span_records

B = 4
TINY = ["TREE.BRANCH_NUM=1", "GAN.GF_DIM=4", "GAN.DF_DIM=4", "GAN.Z_DIM=8", "GAN.EMBEDDING_DIM=16", "GAN.R_NUM=1",
        "TEXT.DIMENSION=32", "DTYPE.COMPUTE=float32"]


def _batch(seed: int, b: int = B) -> dict:
    rng = np.random.default_rng(seed)
    return {"images": (rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8),),
            "embedding": rng.standard_normal((b, 32)).astype(np.float32), "class_id": np.arange(b)}


def test_up_convolution_keeps_its_taps_on_its_device_and_off_the_state_dict():
    """The phase form's tap matrix is a buffer that moves with the module:
    the output is bitwise the sums of the taps formed from a host copy, and
    G's state_dict keys are its parameters and BN statistics only."""
    torch.manual_seed(0)
    up = layers.UpConv3x3(6, 8, torch.bfloat16, "transpose")
    x = torch.randn(2, 6, 5, 7)
    m = up.weight.new_tensor(layers._PHASE_M4)
    kt = torch.einsum("rp,sq,oipq->oirs", m, m, up.weight)
    want = F.conv_transpose2d(x.to(torch.bfloat16), kt.flip(2, 3).transpose(0, 1).to(torch.bfloat16),
                              stride=2, padding=1)
    assert torch.equal(up(x), want)
    assert up.phase_m4.dtype == torch.float32 and "phase_m4" not in up.state_dict()
    cfg = config.apply_overrides(config.default_cfg(), TINY[:-1] + ["TREE.BRANCH_NUM=2"])  # bfloat16, transpose
    g = build_generator(cfg)
    assert any(n.endswith("phase_m4") for n, _ in g.named_buffers())
    stats = {n for n, _ in g.named_buffers() if n.rsplit(".", 1)[-1] in ("running_mean", "running_var")}
    assert set(g.state_dict()) == {n for n, _ in g.named_parameters()} | stats


def test_static_inputs_refill_with_each_steps_noise():
    """The static inputs that a captured step reads, refilled step by step,
    hold the batch's tensors and ``step_noise`` of each step, bitwise."""
    cfg = config.apply_overrides(config.default_cfg(), TINY)
    state = gan.init_state(cfg, device="cpu")
    static = gan.StaticInputs(*gan.step_inputs(state, _batch(0)))
    for step in range(1, 5):
        state.step = step
        batch = _batch(step)
        static.fill(*gan.step_inputs(state, batch))
        z, eps = gan.step_noise(state, B)
        assert torch.equal(static.z, z) and torch.equal(static.eps, eps)
        assert torch.equal(static.inputs["images"][0], torch.from_numpy(batch["images"][0]))
        assert torch.equal(static.inputs["embedding"], torch.from_numpy(batch["embedding"]))


def test_cpu_optimizers_are_not_capturable():
    cfg = config.apply_overrides(config.default_cfg(), TINY)
    state = gan.init_state(cfg, device="cpu")
    opts = [state.g_opt, *state.d_opts]
    assert all(type(o) is torch.optim.Adam for o in opts)
    assert not any(g["capturable"] for o in opts for g in o.param_groups)
    assert not gan.all_capturable(opts)
    gan.train_step(state, _batch(0))
    sd = state.g_opt.state_dict()
    assert not sd["param_groups"][0]["capturable"] and sd["state"][0]["step"].device.type == "cpu"


def test_cpu_steps_run_eager_and_say_so():
    cfg = config.apply_overrides(config.default_cfg(), TINY)
    state = gan.init_state(cfg, device="cpu")
    before = dict(gan.train_step.graph_steps)
    clear_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for i in range(3):
                gan.train_step(state, _batch(i))
        roots = [r for r in span_records()[0] if r.name == "gan.step"]
    finally:
        clear_spans()
    assert sorted(r.attrs["step"] for r in roots) == [0, 1, 2] and {r.attrs["graph"] for r in roots} == {"eager"}
    after = gan.train_step.graph_steps
    assert {k: after[k] - before[k] for k in after} == {"eager": 3, "capture": 0, "replay": 0}
    assert not state.graphs.captured and not state.graphs.seen


def test_a_signature_is_captured_after_two_eager_steps():
    """The choice by signature: two eager steps, then a capture; another
    shape or another cuDNN switch is another signature, whose step starts
    its own count and forgets the last one's; dropping forgets."""
    graphs = gan.StepGraphs()
    full, half = gan.step_signature(_batch(0)), gan.step_signature(_batch(0, B // 2))
    assert full != half and full == gan.step_signature(_batch(1))
    assert full != gan.step_signature({**_batch(0), "class_id": None})
    kinds = []
    for sig in (full, full, half, full, full):
        kinds.append(graphs.mode(sig))
        graphs.saw(sig)
    assert kinds == ["eager", "eager", "eager", "eager", "eager"] and graphs.mode(full) == "capture"
    assert graphs.mode(half) == "eager"
    flag = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = not flag
        assert gan.step_signature(_batch(0)) != full
    finally:
        torch.backends.cudnn.deterministic = flag
    graphs.drop()
    assert graphs.mode(full) == "eager"


@pytest.mark.parametrize("field", ["load_state_dict", "use_axis"])
def test_replacing_the_states_tensors_forgets_the_graphs(field):
    cfg = config.apply_overrides(config.default_cfg(), TINY)
    state = gan.init_state(cfg, device="cpu")
    sig = gan.step_signature(_batch(0))
    for _ in range(2):
        state.graphs.saw(sig)
    assert state.graphs.mode(sig) == "capture"
    if field == "load_state_dict":
        state.load_state_dict(state.state_dict())
    else:
        gan.use_axis(state, None)
    assert state.graphs.mode(sig) == "eager"
    for _ in range(2):
        state.graphs.saw(sig)
    state.g_opt.load_state_dict(state.g_opt.state_dict())  # an optimizer alone replaces its moments
    assert state.graphs.mode(sig) == "eager"


def test_every_kernel_wrapper_with_a_launch_counter_is_registered():
    """A captured step advances the counters of the registry's wrappers
    (``ops.counted.WRAPPERS``): every wrapper that counts its launches is
    there, once, with its counter."""
    wrappers = [mel_kernel.logmel, mel_kernel.logmel_frames, gru_kernel.gru_scan, gru_kernel.gru_scan_bwd]
    assert sorted(counted.WRAPPERS, key=id) == sorted(wrappers, key=id)
    assert all(isinstance(fn.launches, int) for fn in counted.WRAPPERS)
    modules = [mel_kernel, gru_kernel]
    with_counter = [v for mod in modules for v in vars(mod).values() if callable(v) and hasattr(v, "launches")]
    assert sorted(with_counter, key=id) == sorted(wrappers, key=id)
