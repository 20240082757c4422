"""The port's TensorBoard event files (s2i_tpu_torch/utils/logging.py) and its
tools for the card's machine (tools_torch/validate_data.py, inspect_ckpt.py,
synthesize_speech.py) on the CPU: the event file parses with TensorBoard's
own ``Event`` proto, every record's checksums match TensorBoard's
``masked_crc32c``, its tags, steps and float32 values are ``scalars.jsonl``'s
and its image decodes to the grid, without loading TensorFlow; the tools give
the JAX tools' reports (tools/validate_data.py) and WAV bytes
(tools/synthesize_speech.py), and inspect_ckpt counts a state's elements.
The slow-marked cross-check writes the same calls through the JAX package's
``tf.summary`` logger and reads both runs with TensorBoard's reader."""

import ast
import io
import json
import os
import pathlib
import pickle
import shutil
import struct
import sys

import numpy as np
import pytest
import threadpoolctl
import torch
from PIL import Image

from s2i_tpu_torch import config
from s2i_tpu_torch.audio.wavio import read_wav
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.utils import CheckpointManager, ScalarLogger
from s2i_tpu_torch.utils.logging import read_events
from tools import synthesize_speech as jax_synthesize_speech
from tools import validate_data as jax_validate_data
from tools_torch import inspect_ckpt, synthesize_speech, validate_data
from tools_torch.make_fixture_dataset import make_fixture

ROOT = pathlib.Path(__file__).resolve().parent.parent
GRID = np.random.default_rng(0).integers(0, 256, (20, 36, 3), dtype=np.uint8)
CALLS = [(1, {"g_loss": 1.5, "d_loss": 0.1, "images_per_sec": 123.456789}),
         (2, {"g_loss": float("nan"), "d_loss": float("inf"), "kl": 3e-41}),
         (30, {"g_loss": 1.25, "d_loss": -2.0, "kl": 1 / 3})]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixture")
    make_fixture(str(d), classes=2, per_class=3, captions=2, emb_dim=8, image_size=64, wav_samples=(500, 500),
                 seed=4)
    return str(d)


def write_run(run_dir: str, writer: bool = True) -> None:
    lg = ScalarLogger(run_dir, writer=writer, use_tensorboard=True)
    for step, scalars in CALLS:
        lg.log(step, scalars)
    lg.log_image(30, "samples", GRID)
    lg.close()


def test_event_files_parse_with_tensorboards_protos(tmp_path):
    before = {m for m in sys.modules if m.split(".")[0] == "tensorflow"}
    write_run(str(tmp_path / "run"))
    from tensorboard.compat.proto import event_pb2
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c

    (name,) = os.listdir(tmp_path / "run" / "tb")
    assert name.startswith("events.out.tfevents.")
    data = (tmp_path / "run" / "tb" / name).read_bytes()
    events, i = [], 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i: i + 8])
        assert struct.unpack("<I", data[i + 8: i + 12])[0] == masked_crc32c(data[i: i + 8])
        body = data[i + 12: i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n: i + 16 + n])[0] == masked_crc32c(body)
        events.append(event_pb2.Event.FromString(body))
        i += 16 + n
    assert i == len(data) and events[0].file_version == "brain.Event:2"
    got = [(e.step, v.tag, v.simple_value) for e in events[1:] for v in e.summary.value if v.HasField("simple_value")]
    jsonl = [json.loads(line) for line in open(tmp_path / "run" / "scalars.jsonl")]
    want = [(r["step"], k, np.float32(float(v))) for r in jsonl for k, v in r.items() if k not in ("step", "time")]
    assert [(s, t) for s, t, _ in got] == [(s, t) for s, t, _ in want]
    assert all(np.array_equal(np.float32(g), w, equal_nan=True) for (*_, g), (*_, w) in zip(got, want))
    (img,) = [(e.step, v) for e in events for v in e.summary.value if v.HasField("image")]
    assert img[0] == 30 and img[1].tag == "samples"
    assert (img[1].image.height, img[1].image.width, img[1].image.colorspace) == GRID.shape
    with Image.open(io.BytesIO(img[1].image.encoded_image_string)) as im:
        assert np.array_equal(np.asarray(im), GRID)
    # the port's own reader finds the same records
    recs = read_events(str(tmp_path / "run" / "tb" / name))
    assert [(r["step"], v["tag"]) for r in recs[1:] for v in r["values"]] == \
        [(e.step, v.tag) for e in events[1:] for v in e.summary.value]
    assert {m for m in sys.modules if m.split(".")[0] == "tensorflow"} == before  # no TensorFlow loaded

    write_run(str(tmp_path / "rank1"), writer=False)  # a rank other than 0
    assert not (tmp_path / "rank1").exists()
    torn = tmp_path / "torn"
    torn.write_bytes(data[:-1])
    with pytest.raises(ValueError, match="torn"):
        read_events(str(torn))
    flipped = bytearray(data)
    flipped[-6] ^= 1
    torn.write_bytes(bytes(flipped))
    with pytest.raises(ValueError, match="checksum"):
        read_events(str(torn))


def test_the_new_modules_import_no_tensorboard_grain_or_the_jax_package():
    sources = [ROOT / "s2i_tpu_torch" / "data" / "grain_pipeline.py", ROOT / "s2i_tpu_torch" / "utils" / "logging.py",
               *(ROOT / "tools_torch" / f"{t}.py" for t in ("validate_data", "inspect_ckpt", "synthesize_speech"))]
    forbidden = {"grain", "jax", "orbax", "tensorboard", "tensorflow", "google", "s2i_tpu"}
    for path in sources:
        roots = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        assert not roots & forbidden, (path.name, roots & forbidden)


def test_validate_data_gives_the_jax_tools_report(tmp_path, tree, capsys):
    broken = str(tmp_path / "broken")
    shutil.copytree(tree, broken)
    split = pickle.load(open(os.path.join(broken, "train", "filenames.pickle"), "rb"))
    os.remove(os.path.join(broken, "images", split[0] + ".jpg"))
    shutil.rmtree(os.path.join(broken, "audio", split[1]))
    for d, code in ((tree, 0), (broken, 1)):
        want = [jax_validate_data.check_split(d, s) for s in ("train", "test")]
        assert [validate_data.check_split(d, s) for s in ("train", "test")] == want
        assert validate_data.main(["--data_dir", d]) == code
        assert json.loads(capsys.readouterr().out) == want
    assert want[0]["problems"] == ["1 images missing", "1 wav trees missing (speech mode unavailable)"]
    assert validate_data.main(["--data_dir", str(tmp_path / "none")]) == 1  # a split that does not load


def test_synthesize_speech_writes_the_jax_tools_wavs(tmp_path, monkeypatch):
    table = {"a/x": ["a small bird with a red crown", "white belly"], "b/y": ["yellow wings"], "b/z": ["tiny"]}
    with open(tmp_path / "captions.json", "w") as f:
        json.dump(table, f)
    for d in ("jax", "port"):
        for split, names in (("train", ["a/x", "b/y"]), ("test", ["b/z"])):
            os.makedirs(tmp_path / d / split)
            with open(tmp_path / d / split / "filenames.pickle", "wb") as f:
                pickle.dump(names, f)
        os.makedirs(tmp_path / d / "audio" / "b" / "y")
        (tmp_path / d / "audio" / "b" / "y" / "0.wav").write_bytes(b"kept")  # an existing WAV is skipped
    argv = ["--data_dir", str(tmp_path / "jax"), "--captions", str(tmp_path / "captions.json"), "--tone"]
    monkeypatch.setattr(sys, "argv", ["synthesize_speech.py", *argv])
    jax_synthesize_speech.main()
    assert synthesize_speech.main(["--data_dir", str(tmp_path / "port"), *argv[2:]]) == 0
    wavs = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax" / "audio").rglob("*.wav"))
    assert len(wavs) == 4
    assert sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port" / "audio").rglob("*.wav")) == wavs
    for w in wavs:
        assert (tmp_path / "port" / w).read_bytes() == (tmp_path / "jax" / w).read_bytes()
    assert (tmp_path / "port" / "audio" / "b" / "y" / "0.wav").read_bytes() == b"kept"
    x, sr = read_wav(str(tmp_path / "port" / "audio" / "a" / "x" / "1.wav"))
    assert sr == 16000 and x.shape == (48000,) and 0 < np.abs(x).max() <= 1
    with pytest.raises(SystemExit):
        synthesize_speech.main(["--data_dir", str(tmp_path / "port")])  # neither --tone nor --cmd


def numel(obj) -> int:
    if torch.is_tensor(obj):
        return obj.numel()
    if isinstance(obj, dict):
        obj = list(obj.values())
    return sum(map(numel, obj)) if isinstance(obj, (list, tuple)) else 0


def test_inspect_ckpt_counts_every_tensor_of_the_state(tmp_path, capsys):
    cfg = config.apply_overrides(config.cfg_from_file("cfg/birds_3stages.yml"), [
        "TEXT.DIMENSION=8", "GAN.GF_DIM=4", "GAN.DF_DIM=4", "GAN.Z_DIM=4", "GAN.EMBEDDING_DIM=4", "GAN.R_NUM=1",
        "TREE.BRANCH_NUM=1"])
    state = gan.init_state(cfg, device="cpu")
    for opt in (state.g_opt, *state.d_opts):  # a step on zero gradients fills Adam's moments
        for group in opt.param_groups:
            for p in group["params"]:
                p.grad = torch.zeros_like(p)
        opt.step()
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(1, state)
    state.step = 3
    ckpt.save(3, state)
    sd = state.state_dict()
    want = {k: numel(v) for k, v in sd.items() if numel(v)}
    assert set(want) == {"g", "ds", "g_opt", "d_opts", "ema"}
    info = inspect_ckpt.inspect(str(tmp_path / "ckpt"))
    assert info == {"steps": [1, 3], "groups": want, "total": sum(want.values())}
    assert inspect_ckpt.main(["--ckpt", str(tmp_path / "ckpt")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "steps: [1, 3]" and out[-1].endswith(f"({sum(want.values())} elements)")
    assert inspect_ckpt.inspect(str(tmp_path / "empty")) == {"steps": [], "groups": {}, "total": 0}


@pytest.mark.slow
def test_event_files_read_as_the_jax_loggers_in_tensorboard(tmp_path):
    """The same calls through the JAX package's logger (``tf.summary``) and
    the port's, read back by TensorBoard's plugin event accumulator (which
    migrates both record forms to tensors): the same tags, steps and float32
    values, and images of the same pixels."""
    pytest.importorskip("tensorflow")
    from tensorboard.backend.event_processing import plugin_event_accumulator
    from tensorboard.util import tensor_util

    from s2i_tpu.utils.logging import ScalarLogger as JaxLogger

    jax_run = str(tmp_path / "jax")
    lg = JaxLogger(jax_run, use_tensorboard=True)
    for step, scalars in CALLS:
        lg.log(step, scalars)
    lg.log_image(30, "samples", GRID)
    lg.close()
    write_run(str(tmp_path / "port"))

    def read(run: str) -> dict:
        acc = plugin_event_accumulator.EventAccumulator(os.path.join(run, "tb"))
        acc.Reload()
        out = {}
        for tag in acc.Tags()["tensors"]:
            for ev in acc.Tensors(tag):
                val = tensor_util.make_ndarray(ev.tensor_proto)
                if val.dtype == object:  # an image: [width, height, png, ...]
                    with Image.open(io.BytesIO(val[2])) as im:
                        val = np.asarray(im)
                out[(tag, ev.step)] = val
        return out

    jax, port = read(jax_run), read(str(tmp_path / "port"))
    assert sorted(jax) == sorted(port) and len(port) == 10
    for key in jax:
        assert np.array_equal(np.asarray(port[key], np.float32) if port[key].dtype != np.uint8 else port[key],
                              np.asarray(jax[key], np.float32) if jax[key].dtype != np.uint8 else jax[key],
                              equal_nan=True), key
