"""The port's quality-certification harness (s2i_tpu_torch/eval/cert.py,
s2i_tpu_torch/scripts/) against the JAX package's on the CPU.

The JAX cert functions compared here are numpy/scipy (no JAX program is
compiled), and InceptionV3 is stubbed: an extractor object whose
``.extract(images, batch)`` returns seeded pools [N, 64] and logits
[N, 16]. Tolerances: FID relative 1e-4 (full-rank covariances, N > 64: the
port takes tr((σ1σ2)^½) from eigendecompositions and an SVD where the JAX
package calls ``scipy.linalg.sqrtm``), IS 1e-6 relative, the real-image
loader and the classifier carried from a JAX pickle bitwise. The quality
cert's train-and-evaluate loop runs in process at tiny widths (GF/DF 4,
Z 8, one stage) with the classifier stubbed, and resumes."""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import threadpoolctl
import torch

from s2i_tpu.data.stackgan import StackGanSplit as JaxSplit
from s2i_tpu.eval import cert as jax_cert
from s2i_tpu.eval import gaussian_stats as jax_gaussian_stats
from s2i_tpu_torch import bridge, config
from s2i_tpu_torch.data.stackgan import StackGanSplit
from s2i_tpu_torch.eval import cert, gaussian_stats
from s2i_tpu_torch.models import inception
from s2i_tpu_torch.scripts import (encoder_quality_cert, eval_smoke, joint_quality_cert, posthoc_quality_eval,
                                   quality_cert, workflow_cert)
from s2i_tpu_torch.train import gan
from tools_torch import render_quality_grids
from tools_torch.make_fixture_dataset import make_fixture

TOL_FID = 1e-4
TOL_IS = 1e-6
TINY_GAN = ["TEXT.DIMENSION=16", "TREE.BRANCH_NUM=1", "GAN.GF_DIM=4", "GAN.DF_DIM=4", "GAN.Z_DIM=8",
            "GAN.EMBEDDING_DIM=8", "TRAIN.BATCH_SIZE=4", "TRAIN.EMA_WARMUP=0", "DTYPE.COMPUTE=float32",
            "DATA.PIPELINE=pil", "WORKERS=1"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread and one BLAS thread: the test run's parallel
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


class StubExtractor:
    """Stands in for InceptionFeatures: "images" are row indices into seeded
    pools and logits, or images whose pixels are hashed to features."""

    def __init__(self, n: int = 160, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.pools = rng.normal(size=(n, 64)).astype(np.float32)
        self.logits = (3.0 * rng.normal(size=(n, 16))).astype(np.float32)
        self.proj = rng.normal(size=(3, 64)).astype(np.float32)

    def extract(self, images, batch_size=64):
        images = np.asarray(images)
        if images.ndim == 1:
            return self.pools[images], self.logits[images]
        mean = images.reshape(len(images), -1, 3).mean(1)  # [N, 3]
        pool = np.tanh(mean @ self.proj + images.reshape(len(images), -1)[:, :64])
        return pool.astype(np.float32), (pool[:, :16] * 4.0).astype(np.float32)


def rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def test_floor_and_fid_is_match_the_jax_cert():
    ex = StubExtractor()
    real, fake = np.arange(0, 96), np.arange(64, 160)  # 96 rows each: full-rank 64² covariances
    got = cert.interpretability_floor(ex.pools[real], ex.logits[real], seed=3)
    want = jax_cert.interpretability_floor(ex.pools[real], ex.logits[real], seed=3)
    assert got.keys() == want.keys()
    assert rel(got["real_real_fid"], want["real_real_fid"]) <= TOL_FID, (got, want)
    for k in ("real_is_mean", "real_is_std"):
        assert rel(got[k], want[k]) <= TOL_IS, (k, got, want)
    fid, is_mean, is_std = cert.make_fid_is(ex, gaussian_stats(ex.pools[real]), 32)(fake)
    j_fid, j_mean, j_std = jax_cert.make_fid_is(ex, jax_gaussian_stats(ex.pools[real]), 32)(fake)
    assert fid > 1.0 and rel(fid, j_fid) <= TOL_FID, (fid, j_fid)
    assert rel(is_mean, j_mean) <= TOL_IS and rel(is_std, j_std) <= TOL_IS, (is_mean, is_std, j_mean, j_std)


def test_load_real_images_bitwise_the_jax_loader(tmp_path):
    make_fixture(str(tmp_path), classes=2, per_class=3, captions=2, emb_dim=8, image_size=40, wav_samples=(64, 64))
    got = cert.load_real_images([StackGanSplit(str(tmp_path), s) for s in ("train", "test")], 32)
    want = jax_cert.load_real_images([JaxSplit(str(tmp_path), s) for s in ("train", "test")], 32)
    assert got.shape == (6, 32, 32, 3) and got.dtype == np.float32
    assert np.array_equal(got, want)


def test_classifier_carried_from_a_jax_pickle_and_the_port_file(tmp_path):
    model = inception.InceptionV3(5)
    inception.init_weights(model, torch.Generator().manual_seed(0))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    variables = bridge.inception_trees(sd)
    pkl = tmp_path / "inception_finetuned.pkl"
    with open(pkl, "wb") as f:  # as scripts/quality_cert.py saves its classifier
        pickle.dump(jax.tree.map(lambda x: np.asarray(x), variables), f)
    got = cert.load_classifier(str(pkl))
    assert got.keys() == sd.keys()
    assert all(np.array_equal(got[k].numpy(), v) for k, v in sd.items())
    pt = cert.save_classifier(got, str(tmp_path))
    again = cert.load_classifier(pt)
    assert all(torch.equal(again[k], got[k]) for k in got)


def tiny_gan_state():
    cfg = config.cfg_from_file("cfg/birds_3stages.yml")
    config.apply_overrides(cfg, TINY_GAN)
    return gan.init_state(cfg, "cpu")


def test_sampling_generator_raw_or_ema():
    st = tiny_gan_state()
    with torch.no_grad():
        for name in st.ema:
            st.ema[name].add_(0.5)
    ema, raw = gan.sampling_generator(st, use_ema=True), gan.sampling_generator(st, use_ema=False)
    default = gan.sampling_generator(st)
    g = dict(st.models.g.named_parameters())
    for name, p in raw.named_parameters():
        assert torch.equal(p, g[name]), name
    for name, p in default.named_parameters():
        assert torch.equal(p, st.ema[name] if name in st.ema else g[name]), name
        assert torch.equal(p, dict(ema.named_parameters())[name])
    for m in (raw, default):
        assert not m.training
        assert all(torch.equal(b, dict(st.models.g.named_buffers())[n]) for n, b in m.named_buffers())
    assert any(not torch.equal(p, g[n]) for n, p in default.named_parameters())


# the keys of a point of scripts/quality_cert.py (with --ema_bn_recalc), and of a trained one
POINT_KEYS = {"step", "fid", "is_mean", "is_std", "raw_fid", "raw_is", "n_fake", "n_real", "eval_s",
              "ema_stale_fid", "ema_stale_is"}
TRAINED_KEYS = {"d_loss", "g_loss", "kl", "g_adv", "d0_loss", "d0_real_acc", "d0_fake_acc"}


def test_quality_cert_loop_records_and_resumes(tmp_path, monkeypatch, capsys):
    fixture = tmp_path / "fixture"
    make_fixture(str(fixture), classes=2, per_class=3, captions=2, emb_dim=16, image_size=64, wav_samples=(64, 64))
    monkeypatch.setattr(cert, "classifier", lambda out, pkl, fit: ({}, {"acc": 1.0}))
    monkeypatch.setattr(cert, "make_extractor", lambda sd, n, device: StubExtractor())
    out = tmp_path / "run"
    argv = ["--out", str(out), "--fixture", str(fixture), "--device", "cpu", "--classes", "2", "--eval_every", "1",
            "--eval_batch", "4", "--ema_bn_recalc", "2", "--set", *TINY_GAN]
    first = quality_cert.main(argv + ["--steps", "2"])
    with open(out / "results.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert lines[0]["floor"] is True and {"real_real_fid", "real_is_mean", "inception_eval_acc"} <= lines[0].keys()
    assert [r["step"] for r in lines[1:]] == [0, 1, 2] and first["curve"] == lines[1:]
    for r in lines[1:]:
        assert POINT_KEYS <= r.keys(), r.keys()
        assert all(np.isfinite(v) for v in r.values() if isinstance(v, float)), r
    assert TRAINED_KEYS <= lines[2].keys() and TRAINED_KEYS <= lines[3].keys()
    assert (out / "grids" / "step_0000002.png").exists() and (out / "grids" / "step_0000002_raw.png").exists()
    capsys.readouterr()

    second = quality_cert.main(argv + ["--steps", "3"])
    assert "resumed from step 2" in capsys.readouterr().out
    with open(out / "results.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert sum(1 for r in lines if r.get("floor")) == 1
    assert [r["step"] for r in lines[1:]] == [0, 1, 2, 3]
    with open(out / "summary.json") as f:
        assert json.load(f) == second
    assert second["curve"] == lines[1:] and second["steps"] == 3
    assert second["fid_first"] == lines[1]["fid"] and second["fid_best"] == min(r["fid"] for r in lines[1:])


@pytest.mark.parametrize("main, flag", [
    (quality_cert.main, "--out"), (encoder_quality_cert.main, "--out"), (joint_quality_cert.main, "--out"),
    (posthoc_quality_eval.main, "--run"), (eval_smoke.main, "--out"), (workflow_cert.main, "--out"),
    (render_quality_grids.main, "--run")])
def test_certs_need_a_card_or_the_cpu_flag(main, flag, tmp_path):
    """Without a card and without --device cpu a cert raises before it
    writes anything."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([flag, str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")
