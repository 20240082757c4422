"""Integration: the port's certification CLIs end to end on the CPU
(``--device cpu``), each in a subprocess, at the tiny sizes of the JAX
package's slow smokes (tests/test_encoder_quality_smoke.py,
test_joint_quality_smoke.py, test_eval_smoke.py, test_workflow_smoke.py):
each writes a well-formed record. Tiny sizes prove plumbing only; the
convergence runs on the card are under docs/certs/torch_*."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_GAN = ["TEXT.DIMENSION=32", "TREE.BRANCH_NUM=1", "GAN.GF_DIM=8", "GAN.DF_DIM=8", "GAN.Z_DIM=16",
            "GAN.EMBEDDING_DIM=16", "TRAIN.BATCH_SIZE=4", "TRAIN.EMA_WARMUP=0", "EVAL.EMA_BN_RECALC=2"]
TINY_ENCODER = ["ENCODER.BATCH_SIZE=4", "ENCODER.RNN_HIDDEN=16", "ENCODER.CONV_CHANNELS=[8,16]"]


def run(args: list[str], timeout: int) -> dict:
    """``python -m s2i_tpu_torch.scripts.<args>`` on the CPU → its last JSON line."""
    r = subprocess.run([sys.executable, "-m", *args, "--device", "cpu"], cwd=REPO,
                       env={**os.environ, "OMP_NUM_THREADS": "2"}, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-6000:]
    return json.loads([line for line in r.stdout.strip().splitlines() if line.startswith("{")][-1])


def summary_file(out) -> dict:
    with open(out / "summary.json") as f:
        return json.load(f)


def records(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.slow
def test_quality_cert_smoke(tmp_path):
    summary = run(["s2i_tpu_torch.scripts.quality_cert", "--out", str(tmp_path), "--classes", "4", "--per_class",
                   "3", "--captions", "2", "--steps", "2", "--eval_every", "1", "--inc_epochs", "1",
                   "--eval_batch", "4", "--eval_n", "8", "--ema_bn_recalc", "2", "--set", *TINY_GAN], 1200)
    recs = records(tmp_path / "results.jsonl")
    assert recs[0]["floor"] and [r["step"] for r in recs[1:]] == [0, 1, 2]
    assert summary["steps"] == 2 and summary_file(tmp_path)["curve"] == recs[1:]
    assert all(np.isfinite(r[k]) and r["n_fake"] == 8 for r in recs[1:] for k in ("fid", "raw_fid", "ema_stale_fid"))
    assert (tmp_path / "inception_finetuned.pt").exists() and (tmp_path / "grids" / "step_0000002_raw.png").exists()
    rec = run(["s2i_tpu_torch.scripts.posthoc_quality_eval", "--run", str(tmp_path), "--classes", "4",
               "--eval_batch", "4", "--eval_n", "8", "--ema_bn_recalc", "2", "--set", *TINY_GAN], 600)
    assert rec["step"] == 2 and all(np.isfinite(rec[f"{t}_fid"]) for t in ("raw", "ema_stale", "ema_recalc"))


@pytest.mark.slow
def test_encoder_quality_cert_smoke(tmp_path):
    summary = run(["s2i_tpu_torch.scripts.encoder_quality_cert", "--out", str(tmp_path), "--classes", "4",
                   "--per_class", "3", "--captions", "2", "--steps", "4", "--eval_every", "2", "--train_eval_n", "4",
                   "--set", "TEXT.DIMENSION=32", *TINY_ENCODER, "AUDIO.MAX_FRAMES=128"], 1200)
    assert summary["steps"] == 4
    recs = records(tmp_path / "results.jsonl")
    assert [r["step"] for r in recs] == [0, 2, 4]
    for r in recs:
        assert 0.0 <= r["test_r@1"] <= 1.0 and 0.0 <= r["test_map"] <= 1.0 and r["test_medr"] >= 1.0
        assert r["test_mse"] >= 0.0 and 0.0 <= r["proto_cls_acc"] <= 1.0
    assert "mse" in recs[-1] and "loss" in recs[-1]
    assert summary_file(tmp_path)["curve"] == recs


@pytest.mark.slow
def test_joint_quality_cert_smoke(tmp_path):
    summary = run(["s2i_tpu_torch.scripts.joint_quality_cert", "--out", str(tmp_path), "--classes", "4",
                   "--per_class", "3", "--captions", "2", "--pretrain_epochs", "1", "--steps", "2", "--eval_every",
                   "1", "--inc_epochs", "1", "--eval_batch", "4", "--eval_n", "8", "--train_eval_n", "4",
                   "--audio_frames", "64", "--set", *TINY_GAN, *TINY_ENCODER], 1800)
    assert summary["steps"] == 2
    recs = records(tmp_path / "results.jsonl")
    assert recs[0]["floor"] and [r["step"] for r in recs[1:]] == [0, 1, 2]
    for r in recs[1:]:
        assert all(np.isfinite(r[k]) for k in ("fid", "raw_fid", "speech_fid", "test_mse"))
        assert 0.0 <= r["test_r@1"] <= 1.0
    assert "distill_mse" in recs[-1]


@pytest.mark.slow
def test_eval_smoke_pipeline(tmp_path):
    rec = run(["s2i_tpu_torch.scripts.eval_smoke", "--out", str(tmp_path)], 2400)
    assert rec["inception"] == "finetuned" and rec["is_mean"] >= 1.0
    assert np.isfinite(rec["fid"]) and rec["fid"] >= 0 and rec["n_gen"] > 0


@pytest.mark.slow
def test_workflow_cert_smoke(tmp_path):
    summary = run(["s2i_tpu_torch.scripts.workflow_cert", "--out", str(tmp_path), "--classes", "4", "--per_class",
                   "10", "--captions", "2", "--encoder_epochs", "1", "--gan_epochs", "1", "--inc_epochs", "1",
                   "--samples_per_emb", "2", "--audio_frames", "64", "--emb_dim", "32",
                   "--set", *TINY_GAN, *TINY_ENCODER], 1800)
    assert [s["stage"] for s in summary["stages"]] == [
        "fixture", "encoder_pretrain", "embedding_extraction", "gan_train", "sampling", "finetune_inception",
        "eval_is_fid"]
    assert summary["metrics"]["is_mean"] >= 1.0 and summary["metrics"]["fid"] >= 0.0
    assert summary["metrics"]["inception"] == "finetuned"
    assert all(r["rc"] == 0 for r in records(tmp_path / "workflow.jsonl"))
