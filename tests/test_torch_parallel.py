"""Data parallelism of the port (s2i_tpu_torch/parallel/) on the CPU over
gloo: one module-scoped spawn of 2 ranks (tests/_torch_parallel_worker.py,
which imports torch and the port only, one torch and one BLAS thread each)
runs every case over the data axis at tiny widths (GF/DF 4, Z 8, global
batch 8) and writes its results to a temporary directory; this process
computes the one-process port step on the same global batch meanwhile, and
the tests read both. Every wait on a rank has a timeout, and so does every
collective of the ranks (60 s), so a hung collective fails the module
instead of the run's clock.

Tolerances (float32):
- BN running statistics, metrics and the updated parameters: 1e-5 of
  max(1, their scale);
- gradients: the median tensor within 1e-5 of its scale (reduction-order
  noise), every tensor within FLIP_TOL. A float32 rounding difference
  can change the sign of a LeakyReLU input of a D and so move a G gradient
  by a discrete step: at these widths the 2-rank 2-stage step reads up to
  3.3e-3 of the scale of ``g.img_net2.img.0.weight``'s gradient, and the
  one-process step itself moves as far when its embeddings are scaled by
  1 + 2^-20 (in some processes: such a flip hangs on the last bit);
- the GAN steps use SGD, as tests/test_parallel.py does, so that a
  parameter's change is its gradient times the learning rate (Adam's first
  step is about lr·sign(g), which turns rounding into ±lr);
- the trainer runs (4 steps) compound that: TRAINER_TOL.
Parameters and buffers are bitwise equal across the ranks, sharded
sampling is bitwise the one-process ``sample``, and a stopped and resumed
2-rank run is bitwise the straight one."""

import os
import shutil
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2i_tpu.train import gan as jax_gan
from s2i_tpu_torch import cli, entrypoints, native, parallel
from s2i_tpu_torch.data.stackgan import GanEpochIterator, SpeechEpochIterator, StackGanSplit
from s2i_tpu_torch.eval import InceptionFeatures
from s2i_tpu_torch.models.layers import BatchNorm
from s2i_tpu_torch.train import encoder as encoder_train
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils.checkpoint import to_host
from tests import _torch_parallel_worker as w
from tools_torch.make_fixture_dataset import make_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
JOIN_TIMEOUT_S = 120  # both ranks take ~9 s alone; the test run's other workers share the cores
TOL = 1e-5
FLIP_TOL = 1e-2
TRAINER_TOL = 5e-2
STEP_CASES = (*w.CASES, "encoder")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(out: str) -> list[subprocess.Popen]:
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        with open(os.path.join(out, f"log.{r}.txt"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-m", "tests._torch_parallel_worker", out], cwd=ROOT,
                                          env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


def join(procs: list[subprocess.Popen], out: str) -> None:
    """Wait for every rank until the deadline; kill them all past it or when
    one fails, and raise with their logs."""
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        logs = "\n".join(open(os.path.join(out, f"log.{r}.txt")).read()[-3000:] for r in range(WORLD))
        raise AssertionError(f"ranks exited {[p.returncode for p in procs]}:\n{logs}")


def one_process_references(out: str) -> dict:
    """The one-process port on every case's global batch."""
    refs = {}
    for name in w.CASES:
        cfg = w.cfg_of(*w.CASES[name])
        st = gan.init_state(cfg, "cpu")
        refs[name] = w.gan_record(st, gan.train_step(st, w.gan_batch(cfg)))
    cfg = w.cfg_of(*w.AUDIO)
    st = encoder_train.init_encoder_state(cfg, "cpu")
    refs["encoder"] = w.encoder_record(st, encoder_train.encoder_train_step(st, w.encoder_batch(cfg)))
    x, ct = w.bn_inputs()
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, 6))
    x.requires_grad_(True)
    y = bn(x)
    (y * ct).sum().backward()
    refs["bn"] = {"y": y.detach(), "dx": x.grad, "running_mean": bn.running_mean, "running_var": bn.running_var}
    g, emb = w.sample_inputs()
    refs["sample"] = {"images": gan.sample(g, emb, seed=11)}
    ex = InceptionFeatures(None, device="cpu", **w.INCEPTION)
    refs["inception"] = dict(zip(("pool", "logits"), ex.extract(w.inception_images(), batch_size=4)))
    refs["trainer_straight"] = run_trainer(os.path.join(out, "one_process"), w.TRAINER_STEPS)
    refs["wrong_pair_sources"] = np.asarray(jax_gan.wrong_pair_sources(jnp.asarray(w.WRONG_PAIR_CLASSES)))
    return refs


def run_trainer(d: str, steps: int) -> dict:
    cfg = w.trainer_cfg()
    t = GanTrainer(cfg, d, w.short_epochs(cfg), device="cpu", image_every=0, log_every=0)
    try:
        t.train(max_steps=steps)
        return to_host(t.state.state_dict())
    finally:
        t.close()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' results by case, the one-process references): the ranks
    run while this process computes the references."""
    out = str(tmp_path_factory.mktemp("ranks"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    procs = spawn_ranks(out)
    try:
        refs = one_process_references(out)
    finally:
        join(procs, out)
        torch.set_num_threads(threads)
    ranks = {}
    for name in os.listdir(out):
        if name.endswith(".pt"):
            case, rank, _ = name.rsplit(".", 2)
            ranks.setdefault(case, {})[int(rank)] = torch.load(os.path.join(out, name), weights_only=False)
    return SimpleNamespace(out=out, ranks=ranks, refs=refs)


def scale_err(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """max |got - want| over max(|want|'s largest magnitude, floor)."""
    return ((got.float() - want.float()).abs().max() / max(want.abs().max().item(), floor, 1e-30)).item()


def flat_state(sd, prefix: str = "") -> dict:
    if isinstance(sd, dict):
        return {k: v for key, val in sd.items() for k, v in flat_state(val, f"{prefix}/{key}").items()}
    if isinstance(sd, (list, tuple)):
        return {k: v for i, val in enumerate(sd) for k, v in flat_state(val, f"{prefix}/{i}").items()}
    return {prefix: sd}


def assert_bitwise(a, b) -> None:
    fa, fb = flat_state(a), flat_state(b)
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        assert (torch.equal(v, fb[k]) if torch.is_tensor(v) else v == fb[k]), k


@pytest.mark.parametrize("case", STEP_CASES)
def test_step_matches_one_process(run, case):
    """A step on 2 ranks, each on 4 rows of the global batch of 8, against
    the one-process port step on the 8 rows."""
    got, want = run.ranks[case][0], run.refs[case]
    for k, v in want["mets"].items():
        assert abs(float(got["mets"][k]) - float(v)) <= TOL * max(abs(float(v)), 1.0), k
    for k, v in want["buffers"].items():
        assert scale_err(got["buffers"][k], v, 1.0) <= TOL, k
    errs = {k: scale_err(got["grads"][k], v) for k, v in want["grads"].items() if v is not None}
    assert {k for k, v in got["grads"].items() if v is None} == {k for k, v in want["grads"].items() if v is None}
    assert float(np.median(list(errs.values()))) <= TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert max(errs.values()) <= FLIP_TOL, max(errs, key=errs.get)
    for k, v in want["params"].items():
        assert scale_err(got["params"][k], v, 1.0) <= TOL, k


@pytest.mark.parametrize("case", (*STEP_CASES, "trainer"))
def test_ranks_hold_the_same_state(run, case):
    """Parameters, gradients and buffers (the trainer: its whole state)
    bitwise equal on both ranks."""
    r0, r1 = run.ranks[case][0], run.ranks[case][1]
    assert_bitwise(r0, r1)


def test_synced_batchnorm_is_one_batchnorm_on_the_whole_batch(run):
    """Forward, the gradient with respect to each rank's input and the
    running statistics of the synced BN against one BN on the concatenated
    batch."""
    r, want = run.ranks["bn"], run.refs["bn"]
    for k in ("y", "dx"):
        got = torch.cat([r[0][k], r[1][k]])
        assert scale_err(got, want[k]) <= TOL, k
    for k in ("running_mean", "running_var"):
        assert torch.equal(r[0][k], r[1][k])
        assert scale_err(r[0][k], want[k], 1.0) <= TOL, k


def test_global_wrong_pair_sources_match_jax(run):
    """The rows each rank's wrong pairs take their conditions from, put
    together, are the global roll and JAX's ``wrong_pair_sources`` of the
    global class ids (called eagerly)."""
    got = {m: torch.cat([run.ranks["wrong_pair"][r][m] for r in range(WORLD)]).numpy()
           for m in ("roll", "class_aware")}
    np.testing.assert_array_equal(got["roll"], np.roll(np.arange(w.B), 1))
    np.testing.assert_array_equal(got["class_aware"], run.refs["wrong_pair_sources"])
    assert (got["class_aware"][4:] < 4).any()  # a pick that crosses the ranks' border


def test_sharded_sampling_is_the_one_process_sample(run):
    """6 embeddings padded to 8, 4 rows a rank: every stage's images bitwise
    those of ``gan.sample`` on the 6 in one process, on both ranks."""
    want = run.refs["sample"]["images"]
    for r in range(WORLD):
        got = run.ranks["sample"][r]["images"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_sharded_inception_features_match_one_process(run):
    """5 images in batches of 3 (rounded up to 4 over 2 ranks, the tail
    padded) against one process in batches of 4, float32."""
    for r in range(WORLD):
        for k in ("pool", "logits"):
            got, want = run.ranks["inception"][r][k], run.refs["inception"][k]
            assert got.shape == want.shape == (5, 2048 if k == "pool" else w.INCEPTION["num_classes"])
            assert np.abs(got - want).max() <= TOL * np.abs(want).max(), k


def test_two_rank_trainer_resumes_bitwise(run):
    """2 steps, a stop and a resume by new trainers to 4 steps: bitwise the
    straight 4-step 2-rank run; rank 0 alone wrote the logs, grids and
    checkpoints, and every rank's grid sampled the global batch's first
    embeddings, gathered from the ranks' rows."""
    res = run.ranks["trainer"][0]
    assert_bitwise(res["resumed"], res["straight"])
    first = next(iter(w.short_epochs(w.trainer_cfg())(0)))["embedding"][:8]
    for r in range(WORLD):
        np.testing.assert_array_equal(run.ranks["trainer"][r]["viz_emb"].numpy(), first)
    assert res["straight"]["step"] == w.TRAINER_STEPS
    with open(os.path.join(run.out, "straight", "scalars.jsonl")) as f:
        assert [int(line.split('"step": ')[1].split(",")[0]) for line in f] == list(range(1, w.TRAINER_STEPS + 1))
    assert os.listdir(os.path.join(run.out, "straight", "images")) == [f"fake_{w.TRAINER_STEPS:07d}.png"]
    assert sorted(os.listdir(os.path.join(run.out, "resumable", "ckpt"))) == [f"{w.TRAINER_STEPS // 2}.pt"]


def test_a_sigterm_on_one_rank_stops_every_rank(run):
    """Rank 1 alone gets SIGTERM during the first step: both ranks stop
    after that step, and rank 0 checkpoints it."""
    assert [run.ranks["trainer"][r]["sigterm_step"] for r in range(WORLD)] == [1, 1]
    assert os.listdir(os.path.join(run.out, "sigterm", "ckpt")) == ["1.pt"]


def trainer_errs(got: dict, want: dict) -> dict:
    fg, fw = flat_state(got), flat_state(want)
    assert fg.keys() == fw.keys()
    return {k: scale_err(fg[k], v, 1e-3) for k, v in fw.items() if torch.is_tensor(v) and v.is_floating_point()}


def test_two_rank_trainer_matches_one_process(run):
    errs = trainer_errs(run.ranks["trainer"][0]["straight"], run.refs["trainer_straight"])
    assert max(errs.values()) <= TRAINER_TOL, max(errs, key=errs.get)


def test_two_rank_checkpoint_resumes_in_one_process(run):
    """The 2-rank run's checkpoint at step 2 resumed by a one-process trainer
    to step 4: within TRAINER_TOL of the 2-rank run's step 4."""
    d = os.path.join(run.out, "resumed_alone")
    shutil.copytree(os.path.join(run.out, "resumable"), d)
    got = run_trainer(d, w.TRAINER_STEPS)
    assert got["step"] == w.TRAINER_STEPS
    errs = trainer_errs(got, run.ranks["trainer"][0]["straight"])
    assert max(errs.values()) <= TRAINER_TOL, max(errs, key=errs.get)


@pytest.mark.parametrize("what, words", [
    ("indivisible", "not divisible"),
    ("num_devices", "--nproc_per_node 4"),
    ("batch", "does not split over 2 ranks"),
])
def test_the_axis_refuses(run, what, words):
    """An indivisible global batch, MESH.NUM_DEVICES against the world size
    (naming the world size to launch with), a global batch size that the
    world size does not divide."""
    msg = run.ranks["refusals"][0][what]
    assert msg is not None and words in msg, msg


def test_launch_refusals(monkeypatch):
    """No process group without torchrun's variables; --gpu, or a command
    that runs in one process, under a launch of 2 ranks; a launch without
    torch.distributed; MESH.NUM_DEVICES above 1 without a launch."""
    for k in parallel.mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert parallel.maybe_initialize_distributed("cpu") is False
    assert parallel.make_mesh_if_configured(w.cfg_of()) is None
    with pytest.raises(ValueError, match="--nproc_per_node 2"):
        parallel.make_mesh_if_configured(w.cfg_of("MESH.NUM_DEVICES=2"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="--gpu names one card"):
        entrypoints.train_gan(["--gpu", "0", "--set", "DATASET_NAME=synthetic"])
    with pytest.raises(ValueError, match="runs in one process"):
        entrypoints.port_gan(["--device", "cpu", "--netg", "x.pth", "--out", "y"])
    with pytest.raises(ValueError, match="runs in one process"):
        cli.run_embedding_extraction(w.cfg_of(), "ckpt", device="cpu")
    monkeypatch.setattr(torch.distributed, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="LOCAL_RANK, MASTER_ADDR, MASTER_PORT unset"):
        parallel.maybe_initialize_distributed("cpu")
    for k, v in {"LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        parallel.maybe_initialize_distributed("cpu")


def test_replicate_state_sends_host_tensors_over_the_host_group(monkeypatch):
    """NCCL moves no CPU tensor, and Adam keeps its step counts on the host:
    ``replicate_state`` broadcasts a card's tensors over the joined group
    and the host's over the gloo group. The card is stood for by the meta
    device, on which Adam steps too."""
    model = torch.nn.Linear(3, 2, device="meta")
    opt = torch.optim.Adam(model.parameters())
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    axis = object.__new__(parallel.DataAxis)
    axis.group, axis.host_group = "joined", "host"
    sent = []
    monkeypatch.setattr(torch.distributed, "broadcast", lambda t, src, group=None: sent.append((t.device.type, group)))
    parallel.replicate_state(SimpleNamespace(model=model, opt=opt), axis)
    # 2 parameters and their 2 moments each on the card, 2 step counts on the host
    assert sorted(sent) == [("cpu", "host")] * 2 + [("meta", "joined")] * 6


@pytest.mark.parametrize("loader", ["pil", "native"])
def test_row_sharded_loaders_give_the_rows_of_the_whole_batch(tmp_path, loader):
    """Each rank's GanEpochIterator (images, embeddings, wavs) and
    SpeechEpochIterator, loading only its rows, yields those rows of the
    whole batch: the PIL path makes the skipped rows' crop draws, the
    native loader seeds each image by its row in the whole batch."""
    if loader == "native" and not native.native_available():
        pytest.skip(f"the native loader does not build here: {native.unavailable_reason()}")
    make_fixture(str(tmp_path), classes=2, per_class=4, captions=3, emb_dim=32, image_size=96,
                 wav_samples=(1000, 6000))
    split = StackGanSplit(str(tmp_path), "train")
    kw = dict(base_size=32, seed=3, use_native=loader == "native", with_audio=True, max_samples=6000)
    whole = list(GanEpochIterator(split, 4, 2, **kw))
    speech = list(SpeechEpochIterator(split, 4, 16000, 6000, seed=2))
    for r in range(WORLD):
        rows = slice(2 * r, 2 * r + 2)
        part = list(GanEpochIterator(split, 4, 2, rows=rows, **kw))
        assert len(part) == len(whole) > 0
        for a, b in zip(part, whole):
            for k in ("embedding", "class_id", "wav", "wav_len", "teacher"):
                np.testing.assert_array_equal(a[k], b[k][rows])
            for x, y in zip(a["images"], b["images"]):
                np.testing.assert_array_equal(x, y[rows])
        for a, b in zip(SpeechEpochIterator(split, 4, 16000, 6000, seed=2, rows=rows), speech):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k][rows])
