"""AOT artifacts of the port (s2i_tpu_torch/export.py), the kernels as
torch.library custom ops (s2i_tpu_torch/ops), and the export, serve and
speech-to-image commands, on the CPU, as tests/test_export.py holds the JAX
package's artifacts.

The artifact comes from the export command, run on a joint GAN checkpoint
at a tiny width in bfloat16 (the shipped cfgs' compute type) with two GRU
layers, at batch sizes 2 and 4. Every comparison with the live pipeline is
bitwise: on the CPU the loaded program runs the same ATen ops and the same
plain versions of the kernels, in the same order, at the same padded batch.
No JAX here (the float32 JAX parity of an artifact is in
tests/test_torch_pipeline.py); one torch thread."""

import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from s2i_tpu_torch import config, entrypoints
from s2i_tpu_torch import export as s2i_export
from s2i_tpu_torch.audio.frontend import FrontendParams
from s2i_tpu_torch.audio.wavio import write_wav
from s2i_tpu_torch.ops import gru_kernel, mel_kernel
from s2i_tpu_torch.pipeline import SpeechToImage, build_encoder, build_generator
from s2i_tpu_torch.serving import Batcher, make_server
from s2i_tpu_torch.train import encoder as encoder_train
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.utils import CheckpointManager

ROOT = Path(__file__).resolve().parent.parent
RNN_LAYERS = 2
TINY = [
    "TREE.BRANCH_NUM=2", "GAN.GF_DIM=4", "GAN.Z_DIM=6", "GAN.EMBEDDING_DIM=6", "GAN.R_NUM=1", "TEXT.DIMENSION=12",
    "AUDIO.N_MELS=8", "AUDIO.MAX_FRAMES=16", "ENCODER.CONV_CHANNELS=[6, 8]", "ENCODER.RNN_HIDDEN=8",
    f"ENCODER.RNN_LAYERS={RNN_LAYERS}", "TRAIN.JOINT_FT=true", "DTYPE.COMPUTE=bfloat16",
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test run's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A joint GAN checkpoint of seeded weights (with an EMA that differs
    from them), the live pipeline it serves, and the artifact that the
    export command writes from it."""
    root = tmp_path_factory.mktemp("export")
    cfg = config.apply_overrides(config.default_cfg(), TINY)
    gen = torch.Generator().manual_seed(0)
    g, enc = build_generator(cfg), build_encoder(cfg, joint=True)
    gan.init_weights(g, [], gen)
    encoder_train.init_weights(enc, gen)
    ema = {k: v + 0.01 * torch.randn(v.shape, generator=gen) for k, v in g.named_parameters()}
    ckpt = str(root / "ckpt")
    CheckpointManager(ckpt).save(1, {"step": 1, "g": g.state_dict(), "ema": ema, "enc": enc.state_dict()})
    out = str(root / "artifact")
    meta = entrypoints.main(["export", "--device", "cpu", "--gan_ckpt", ckpt, "--out", out, "--batches", "4,2",
                             "--set", *TINY])
    live = SpeechToImage.from_checkpoints(cfg, None, ckpt, device="cpu")
    return {"root": root, "cfg": cfg, "ckpt": ckpt, "out": out, "meta": meta, "live": live,
            "loaded": s2i_export.load(out, device="cpu")}


def _wavs(p, b: int, same: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """b tones plus noise at the exported length (the live pipeline and the
    artifact then see the same padded input), ragged lengths, zero past them."""
    n = p.max_samples
    rng = np.random.default_rng(7)
    t = np.arange(n) / 16000.0
    wavs = np.stack([0.4 * np.sin(2 * np.pi * 220.0 * (1 if same else i + 1) * t) for i in range(b)])
    wavs = (wavs + 0.05 * rng.standard_normal((1 if same else b, n))).astype(np.float32)
    lens = np.array([n, n // 2, 3 * n // 4, 900] * b, np.int32)[:b]
    if same:
        lens[:] = n
    for i, m in enumerate(lens):
        wavs[i, m:] = 0.0
    return wavs, lens


def _pad(x: np.ndarray, rows: int) -> np.ndarray:
    return np.concatenate([x, np.zeros((rows - len(x), *x.shape[1:]), x.dtype)])


def test_ops_pass_opcheck():
    """Schema, fake (shapes and strides), autograd registration and AOT
    dispatch of each custom op, at tiny shapes, through its CPU
    registration; the GRU's forward with its registered backward."""
    p = FrontendParams(max_frames=6, n_mels=8)
    wav = torch.randn(2, 1500, generator=torch.Generator().manual_seed(0))
    torch.library.opcheck(torch.ops.s2i.logmel.default, (wav, 6, *mel_kernel.geometry(p)))
    rows = mel_kernel.frame_rows(wav, p, 6)
    torch.library.opcheck(torch.ops.s2i.logmel_frames.default, (rows, *mel_kernel.geometry(p)))
    gen = torch.Generator().manual_seed(1)
    d, t, b, h = 2, 4, 3, 4
    xw, w_h, b_h, h0 = (torch.randn(s, generator=gen, requires_grad=True)
                        for s in ((d, t, b, 3 * h), (d, h, 3 * h), (d, 3 * h), (d, b, h)))
    mask = (torch.arange(t)[:, None] < torch.tensor([t, 2, 0])[None]).float()
    torch.library.opcheck(torch.ops.s2i.gru_scan.default, (xw, w_h, b_h, mask, h0))
    ins = [x.detach() for x in (xw, w_h, b_h)] + [mask, h0.detach()]
    ys = gru_kernel.gru_scan_plain(*ins)
    torch.library.opcheck(torch.ops.s2i.gru_scan_bwd.default, (*ins, ys, torch.randn(ys.shape, generator=gen)))


def test_export_command_writes_one_dynamic_program_with_the_kernel_ops(run):
    meta = run["meta"]
    assert meta["batch_sizes"] == [2, 4] and meta["files"] == {"2": "program.pt2", "4": "program.pt2"}
    assert (meta["platforms"], meta["output_dtype"], meta["stage"], meta["image_size"]) == (["cpu"], "uint8", 1, 128)
    assert (meta["z_dim"], meta["max_samples"], meta["torch_version"]) == (6, run["live"].p.max_samples,
                                                                           torch.__version__)
    assert sorted(os.listdir(run["out"])) == ["meta.json", "program.pt2"]
    with open(os.path.join(run["out"], "meta.json")) as f:
        assert json.load(f) == meta
    assert run["loaded"].batch_sizes == [2, 4]  # one program, its batch dimension dynamic
    graph = run["loaded"].program.graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets.count("s2i.logmel.default") == 1
    assert targets.count("s2i.gru_scan.default") == RNN_LAYERS
    # no recurrence decomposed into ATen ops: the encoder's only nonlinearities are its convs' ReLUs
    rnn_ops = {str(n.target) for n in graph.nodes if n.op == "call_function"
               and any("rnn" in path for path, _ in (n.meta.get("nn_module_stack") or {}).values())}
    assert rnn_ops and not rnn_ops & {"aten.sigmoid.default", "aten.tanh.default", "aten.mm.default"}


def test_round_trip_equals_the_live_pipeline(run):
    """Exact fits at both exported sizes, a negative seed, and z given."""
    live, loaded = run["live"], run["loaded"]
    wavs, lens = _wavs(live.p, 4)
    for b, seed in ((2, 3), (2, -1), (4, 5)):
        got = loaded.generate(wavs[:b], lens[:b], seed=seed)
        assert got.dtype == np.uint8 and got.shape == (b, 128, 128, 3)
        np.testing.assert_array_equal(got, live.generate(wavs[:b], lens[:b], seed=seed, output_dtype="uint8"))
    z = np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32)
    np.testing.assert_array_equal(loaded.generate(wavs, lens, z=z),
                                  live.generate(wavs, lens, z=z, output_dtype="uint8"))
    dev = loaded.generate_async(wavs[:2], lens[:2], seed=3)
    assert isinstance(dev, torch.Tensor) and dev.device == loaded.device


def test_batch_padding(run):
    """B=3 pads to the b4 size: rows past the request are trimmed and the
    real rows are those of the live pipeline at the padded batch."""
    live, loaded = run["live"], run["loaded"]
    wavs, lens = _wavs(live.p, 3)
    got = loaded.generate(wavs, lens, seed=5)
    want = live.generate(_pad(wavs, 4), np.append(lens, live.p.max_samples), seed=5, output_dtype="uint8")
    assert got.shape == (3, 128, 128, 3)
    np.testing.assert_array_equal(got, want[:3])
    z = np.random.default_rng(3).standard_normal((3, 6)).astype(np.float32)
    want = live.generate(_pad(wavs, 4), np.append(lens, live.p.max_samples), z=_pad(z, 4), output_dtype="uint8")
    np.testing.assert_array_equal(loaded.generate(wavs, lens, z=z), want[:3])


def test_chunked_requests_draw_distinct_latents(run):
    """B=8 over the largest size, 4, runs two chunks; chunk 1's noise comes
    from the derived seed, so identical wavs in the two chunks give other
    images, and seed 8's chunk 0 is not seed 7's chunk 1."""
    live, loaded = run["live"], run["loaded"]
    one, lens = _wavs(live.p, 8, same=True)
    got = loaded.generate(one, lens, seed=7)
    assert got.shape[0] == 8
    assert not np.array_equal(got[0], got[4])
    seed1 = int(np.int32(np.uint32(7) + np.uint32(2654435761)))
    assert s2i_export.chunk_seed(7, 1) == seed1 and s2i_export.chunk_seed(-1, 0) == -1
    np.testing.assert_array_equal(got[:4], live.generate(one[:4], lens[:4], seed=7, output_dtype="uint8"))
    np.testing.assert_array_equal(got[4:], live.generate(one[4:], lens[4:], seed=seed1, output_dtype="uint8"))
    assert not np.array_equal(loaded.generate(one, lens, seed=8)[:4], got[4:])


def test_batcher_and_http_on_a_loaded_artifact(run):
    loaded = run["loaded"]
    assert (loaded.p.sample_rate, loaded.p.hop_length) == (run["live"].p.sample_rate, run["live"].p.hop_length)
    wavs, lens = _wavs(loaded.p, 2)
    batcher = Batcher(loaded, batch_size=2, wait_ms=1)
    try:
        job = batcher.submit(wavs[0])
        assert job.done.wait(timeout=60) and job.error is None
        assert job.result.dtype == np.uint8 and job.result.shape == (128, 128, 3)
    finally:
        batcher.close()
    srv = make_server(loaded, "127.0.0.1", 0, batch_size=2, job_timeout_s=60, device="cpu")
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True).start()
    try:
        buf = io.BytesIO()
        write_wav(buf, wavs[1, : lens[1]], loaded.p.sample_rate)
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/generate", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert (r.status, r.headers["Content-Type"]) == (200, "image/png")
            assert np.asarray(Image.open(io.BytesIO(r.read()))).shape == (128, 128, 3)
    finally:
        srv.shutdown()
        srv.server_close()


def _copy(run, name: str, **meta) -> str:
    """A copy of the artifact with ``meta`` written over its meta.json."""
    out = str(run["root"] / name)
    shutil.copytree(run["out"], out)
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump({**run["meta"], **meta}, f)
    return out


def test_refusals(run):
    loaded = run["loaded"]
    wavs, _ = _wavs(loaded.p, 1)
    with pytest.raises(ValueError, match="re-export for stage 0"):
        loaded.generate(wavs, stage=0)
    with pytest.raises(ValueError, match="re-export for float32"):
        loaded.generate(wavs, output_dtype="float32")
    with pytest.raises(ValueError, match=r"exported for \['cpu'\], asked to run on 'cuda'"):
        s2i_export.load(run["out"], device="cuda")
    card = _copy(run, "card", platforms=["cuda"])
    with pytest.raises(ValueError, match=r"exported for \['cuda'\], asked to run on 'cpu'"):
        s2i_export.load(card, device="cpu")
    if not torch.cuda.is_available():  # a CUDA artifact never drifts to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            s2i_export.load(card)
    old = _copy(run, "old", torch_version="0.0")
    Path(old, "program.pt2").write_bytes(b"not a program")
    with pytest.raises(RuntimeError, match=rf"torch 0\.0, into torch {re.escape(torch.__version__)}"):
        s2i_export.load(old, device="cpu")
    floats = _copy(run, "floats", output_dtype="float32")
    with pytest.raises(SystemExit):  # serving answers PNGs: a float artifact is refused
        entrypoints.main(["serve", "--device", "cpu", "--artifact", floats, "--port", "0", "--no_warmup"])


def test_loads_and_serves_without_the_model_code(run, tmp_path):
    """A fresh process with models, pipeline, train and data blocked loads
    the artifact and serves a batch equal to the live pipeline's."""
    wavs, lens = _wavs(run["live"].p, 2)
    np.save(tmp_path / "wavs.npy", wavs)
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "for m in ('models', 'pipeline', 'train', 'data'):\n"
        "    sys.modules['s2i_tpu_torch.' + m] = None\n"
        "from s2i_tpu_torch.export import load\n"
        f"loaded = load({run['out']!r}, device='cpu')\n"
        f"img = loaded.generate(np.load({str(tmp_path / 'wavs.npy')!r}), {lens.tolist()}, seed=3)\n"
        f"np.save({str(tmp_path / 'img.npy')!r}, img)\n"
        "print(sorted(m for m in sys.modules if m.startswith('s2i_tpu_torch') and sys.modules[m]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded_modules = eval(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded_modules if m.split(".")[1:2] in (["models"], ["pipeline"], ["train"], ["data"])]
    np.testing.assert_array_equal(np.load(tmp_path / "img.npy"),
                                  run["live"].generate(wavs, lens, seed=3, output_dtype="uint8"))


def test_serve_and_speech_to_image_commands(run, tmp_path):
    """serve builds (and warms up) a server over the artifact or the
    checkpoint without serving; speech-to-image writes one PNG per WAV,
    those of the live pipeline's generate_files. Without a card, each of
    the three commands raises unless told --device cpu."""
    for source in (["--artifact", run["out"]], ["--gan_ckpt", run["ckpt"], "--set", *TINY]):
        srv = entrypoints.build_server(["--device", "cpu", "--port", "0", "--batch", "2", *source])
        srv.server_close()
    wavs, lens = _wavs(run["live"].p, 2)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"utt{i}.wav"))
        write_wav(paths[-1], wavs[i, : lens[i]], 16000)
    outs = entrypoints.main(["speech-to-image", "--device", "cpu", "--gan_ckpt", run["ckpt"], "--wav", *paths,
                             "--out_dir", str(tmp_path / "png"), "--seed", "4", "--set", *TINY])
    assert outs == [str(tmp_path / "png" / f"utt{i}.png") for i in range(2)]
    want = [str(tmp_path / f"want{i}.png") for i in range(2)]
    run["live"].generate_files(paths, want, seed=4)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(np.asarray(Image.open(o)), np.asarray(Image.open(w)))
    if not torch.cuda.is_available():
        for argv in (["export", "--gan_ckpt", run["ckpt"], "--out", str(tmp_path / "x")],
                     ["serve", "--artifact", run["out"]],
                     ["speech-to-image", "--gan_ckpt", run["ckpt"], "--wav", *paths]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                entrypoints.main(argv)
