"""The port's CLI and entry points (s2i_tpu_torch/cli.py, entrypoints.py,
__main__.py) on the CPU (``--device cpu``) at tiny widths, on a fixture
tree from tools_torch/make_fixture_dataset.py (2 classes × 4 images, 3
captions, 96 px JPEGs, WAVs of 1 000 to 6 000 samples): the reference
workflow pretrain → extract → GAN train (frozen on the extracted
embeddings, and joint from the pretrained encoder) → sample, the pickle the
JAX package's ``StackGanSplit`` reads, a PNG per test file name, each run
dir's ``config.yml``, and a mid-epoch resume on loader batches bitwise equal
to the straight run. No JAX step is compiled."""

import json
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

from s2i_tpu.data.stackgan import StackGanSplit as JaxSplit
from s2i_tpu_torch import cli, config, entrypoints
from s2i_tpu_torch.audio.frontend import extract_features, frontend_params_from_cfg
from s2i_tpu_torch.data.stackgan import GanEpochIterator, StackGanSplit
from s2i_tpu_torch.pipeline import build_encoder
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils import CheckpointManager
from s2i_tpu_torch.utils.checkpoint import to_host
from tools_torch.make_fixture_dataset import make_fixture

CAPTIONS = 3
SMALL = ["AUDIO.N_MELS=8", "AUDIO.MAX_FRAMES=32", "ENCODER.CONV_CHANNELS=[8, 16]", "ENCODER.RNN_HIDDEN=16",
         "ENCODER.N_CLASSES=2", "ENCODER.BATCH_SIZE=4", "TEXT.DIMENSION=16", "GAN.GF_DIM=4", "GAN.DF_DIM=4",
         "GAN.Z_DIM=8", "GAN.EMBEDDING_DIM=8", "GAN.R_NUM=1", "TREE.BRANCH_NUM=1", "TRAIN.BATCH_SIZE=2",
         "EVAL.EMA_BN_RECALC=2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixture")
    make_fixture(str(d), classes=2, per_class=4, captions=CAPTIONS, emb_dim=16, image_size=96,
                 wav_samples=(1000, 6000), seed=2)
    return str(d)


def run(tmp_path, tree, *argv) -> object:
    return entrypoints.main([*argv, "--device", "cpu", "--data_dir", tree, "--output_dir", str(tmp_path)])


def run_dir(out, prefix: str) -> str:
    (name,) = [n for n in os.listdir(out) if n.startswith(prefix)]
    return os.path.join(out, name)


def test_reference_workflow_runs_through_the_cli(tmp_path, tree):
    out = tmp_path / "runs"
    run(out, tree, "pretrain-encoder", "--cfg", "cfg/pretrain_encoder_birds.yml", "--set", *SMALL,
        "ENCODER.EPOCHS=1", "ENCODER.LOG_EVERY=1")
    enc_run = run_dir(out, "birds_encoder_encoder_")
    assert len(open(os.path.join(enc_run, "scalars.jsonl")).read().splitlines()) == 6 * CAPTIONS // 4
    enc_cfg = config.cfg_from_file(os.path.join(enc_run, "config.yml"))
    assert enc_cfg.DATA_DIR == tree and enc_cfg.ENCODER.RNN_HIDDEN == 16  # the resolved config

    written = run(out, tree, "pretrain-encoder", "--cfg", "cfg/pretrain_encoder_birds.yml", "--set", *SMALL,
                  "--extract", os.path.join(enc_run, "ckpt"))
    for split, n in (("train", 6), ("test", 2)):
        assert written[split] == os.path.join(tree, split, "speech-embeddings.pickle")
        emb = JaxSplit(tree, split, embedding_file="speech-embeddings.pickle").embeddings
        assert emb.shape == (n, CAPTIONS, 16) and emb.dtype == np.float32 and np.isfinite(emb).all()
    # a row is the encoder's embedding of that caption's wav alone
    p = frontend_params_from_cfg(enc_cfg.AUDIO)
    model = build_encoder(enc_cfg)
    model.load_state_dict(CheckpointManager(os.path.join(enc_run, "ckpt")).restore_latest_raw()[0]["model"])
    split = StackGanSplit(tree, "test")
    wav = split.load_wav(1, 2, p.sample_rate)[: p.max_samples]
    with torch.no_grad():
        one = model.eval()(*extract_features(wav[None], p, [len(wav)], device="cpu"))[0][0].numpy()
    with open(written["test"], "rb") as f:
        np.testing.assert_allclose(pickle.load(f)[1, 2], one, rtol=0, atol=1e-5)

    run(out, tree, "train", "--cfg", "cfg/birds_3stages.yml", "--set", *SMALL, "TRAIN.MAX_EPOCH=1")
    gan_run = run_dir(out, "birds_3stages_train_")
    assert CheckpointManager(os.path.join(gan_run, "ckpt")).latest_step == 3  # 6 images, batch 2
    run(out, tree, "train", "--cfg", "cfg/birds_joint_ft.yml", "--set", *SMALL, "TRAIN.MAX_EPOCH=1",
        f"TRAIN.NET_E={os.path.join(enc_run, 'ckpt')}")
    assert CheckpointManager(os.path.join(run_dir(out, "birds_joint_train_"), "ckpt")).latest_step == 3

    samples = run(out, tree, "sample", "--cfg", "cfg/eval_birds.yml", "--set", *SMALL,
                  "EVAL.NUM_SAMPLES_PER_EMB=2", f"TRAIN.NET_G={os.path.join(gan_run, 'ckpt')}")
    names = sorted(f.replace("/", "_") + ".png" for f in split.filenames)
    assert sorted(os.listdir(os.path.join(samples, "0"))) == sorted(os.listdir(os.path.join(samples, "1"))) == names


def test_finetune_inception_writes_a_run_that_eval_loads(tmp_path, tree):
    run_d = run(tmp_path, tree, "finetune-inception", "--cfg", "cfg/birds_3stages.yml", "--set", "ENCODER.N_CLASSES=2",
                "--epochs", "1", "--batch", "3", "--image_size", "75", "--base_size", "64")
    assert os.path.basename(run_d).startswith("birds_3stages_inception_")
    assert config.cfg_from_file(os.path.join(run_d, "config.yml")).DATA_DIR == tree
    (line,) = open(os.path.join(run_d, "scalars.jsonl")).read().splitlines()
    assert {"ce", "acc"} <= set(json.loads(line)) and np.isfinite(json.loads(line)["ce"])
    ckpt = os.path.join(run_d, "ckpt")
    raw, step = CheckpointManager(ckpt).restore_latest_raw()
    assert step == raw["step"] == 2  # 6 train images, batch 3
    sd, n = cli.inception_weights(finetuned_ckpt=ckpt)
    assert n == 2 and sd.keys() == raw["model"].keys()
    assert all(torch.equal(sd[k], raw["model"][k]) for k in sd)
    with pytest.raises(ValueError, match="2 classes"):
        cli.inception_weights(finetuned_ckpt=ckpt, num_classes=1000)


def test_module_entry_and_the_card_requirement(tmp_path, tree, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["s2i_tpu_torch", "--help"])
    with pytest.raises(SystemExit) as e:
        runpy.run_module("s2i_tpu_torch", run_name="__main__")
    assert e.value.code == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entrypoints.main(["train", "--cfg", "cfg/birds_3stages.yml", "--data_dir", tree])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entrypoints.main(["--cfg", "cfg/eval_birds.yml", "--gpu", "0", "--output_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="--gpu"):
        entrypoints.main(["sample", "--device", "cpu", "--gpu", "1"])


def test_make_run_dir_writes_the_resolved_config(tmp_path):
    cfg = config.apply_overrides(config.cfg_from_file("cfg/birds_3stages.yml"),
                                 [f"OUTPUT_DIR={tmp_path}", "TRAIN.BATCH_SIZE=7"])
    d = cli.make_run_dir(cfg, "train")
    assert os.path.basename(d).startswith("birds_3stages_train_")
    assert config.cfg_from_file(os.path.join(d, "config.yml")) == cfg


def test_data_pipeline_selection(tree):
    cfg = config.apply_overrides(config.cfg_from_file("cfg/birds_3stages.yml"),
                                 [*SMALL, f"DATA_DIR={tree}", "TEXT.EMBEDDING_FILE=char-CNN-RNN-embeddings.pickle"])
    cfg.DATA.PIPELINE = "grain"  # trainer batches in Grain's order (tests/test_torch_grain.py)
    batches = list(cli.gan_batch_factory(cfg)(0))
    assert len(batches) == 3 and batches[0].keys() == {"images", "embedding", "class_id"}
    assert batches[0]["images"][0].shape == (2, 64, 64, 3) and batches[0]["embedding"].shape == (2, 16)
    cfg.TRAIN.JOINT_FT = True  # joint mode takes the epoch iterator whatever DATA.PIPELINE says, as in JAX
    joint = cli.gan_batch_factory(cfg)(0)
    assert isinstance(joint, GanEpochIterator) and joint.with_audio and joint.use_native is True
    cfg.TRAIN.JOINT_FT = False
    cfg.DATA.PIPELINE = "tf"
    with pytest.raises(ValueError, match="DATA.PIPELINE"):
        cli.gan_batch_factory(cfg)
    cfg.DATASET_NAME = "synthetic"  # the synthetic corpus ignores DATA.PIPELINE, as in JAX
    assert next(iter(cli.gan_batch_factory(cfg)(0)))["images"][0].shape == (2, 64, 64, 3)
    cfg.DATASET_NAME = "birds"
    cfg.DATA.PIPELINE = "pil"
    assert cli.gan_batch_factory(cfg)(0).use_native is False
    cfg.DATA.PIPELINE = "native"
    assert cli.gan_batch_factory(cfg)(0).use_native is True  # g++ and libjpeg are here


def flat(sd, prefix: str = "") -> dict:
    """A nested state dict as {path: leaf}."""
    if isinstance(sd, dict):
        return {k: v for key, val in sd.items() for k, v in flat(val, f"{prefix}/{key}").items()}
    if isinstance(sd, (list, tuple)):
        return {k: v for i, val in enumerate(sd) for k, v in flat(val, f"{prefix}/{i}").items()}
    return {prefix: sd}


def test_mid_epoch_resume_on_loader_batches_is_bitwise(tmp_path, tree):
    cfg = config.apply_overrides(config.cfg_from_file("cfg/birds_joint_ft.yml"),
                                 [*SMALL, f"DATA_DIR={tree}", "TRAIN.SNAPSHOT_INTERVAL=100"])
    factory = cli.gan_batch_factory(cfg)  # joint: images, embeddings and the same caption's wav

    def trained(out, **kw) -> dict:
        t = GanTrainer(cfg, str(out), factory, image_every=0, device="cpu")
        try:
            t.train(**kw)
            return to_host(t.state.state_dict())
        finally:
            t.close()

    want = trained(tmp_path / "straight", max_epoch=2)
    trained(tmp_path / "stopped", max_epoch=2, max_steps=4)  # epoch 1, one batch in
    got = trained(tmp_path / "stopped", max_epoch=2)
    assert got["step"] == want["step"] == 6
    fg, fw = flat(got), flat(want)
    assert fg.keys() == fw.keys()
    for k, v in fw.items():
        assert torch.equal(fg[k], v) if torch.is_tensor(v) else fg[k] == v, k
