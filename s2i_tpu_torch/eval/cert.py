"""Shared plumbing of the port's quality certifications, the counterpart of
``s2i_tpu/eval/cert.py`` (``s2i_tpu_torch/scripts/quality_cert.py``,
``encoder_quality_cert.py``, ``joint_quality_cert.py``,
``posthoc_quality_eval.py``).

Every cert follows one protocol (``docs/QUALITY.md``): build a
class-structured fixture from a seed (no external assets), fine-tune the
IS/FID classifier on the fixture's classes, then train a recipe config in
chunks and score every chunk boundary in a FIXED feature space with FIXED
sampling populations, so that the curve's trend is the training signal.

What a run writes under its ``--out`` and how it resumes:

- ``results.jsonl``: one preamble line with the interpretability floor
  (``{"floor": true, ...}``), then one line per eval point. A later call on
  the same ``--out`` reads it (:class:`Results`): the floor is written once,
  a point already scored is not scored again, and ``summary.json`` covers
  every point of the file, so that a run can span calls;
- ``inception_finetuned.pt``: the classifier (:func:`save_classifier`),
  which a resumed run and ``posthoc_quality_eval`` reuse, so that every
  point of a run lands in one feature space. ``--inception_pkl`` takes this
  file or a JAX run's ``inception_finetuned.pkl`` (:func:`load_classifier`).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Callable, Sequence

import numpy as np
import torch

from s2i_tpu_torch.audio.frontend import FrontendParams, extract_features
from s2i_tpu_torch.bridge import inception_state_dict
from s2i_tpu_torch.data.pipeline import Prefetcher
from s2i_tpu_torch.data.stackgan import GanEpochIterator, StackGanSplit
from s2i_tpu_torch.eval import InceptionFeatures, fid_from_stats, gaussian_stats, inception_score_from_probs
from s2i_tpu_torch.eval.finetune import init_inception_state, make_inception_train_step
from s2i_tpu_torch.eval.inception_score import softmax
from s2i_tpu_torch.eval.retrieval import retrieval_metrics
from s2i_tpu_torch.eval.weights import load_torch_inception
from s2i_tpu_torch.models.generator import GNet
from s2i_tpu_torch.train import gan

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLASSIFIER_FILE = "inception_finetuned.pt"


def build_fixture(out: str, classes: int, per_class: int, captions: int,
                  emb_dim: int, seed: int, test_per_class: int = 1) -> str:
    """``<out>/fixture``, written by ``tools_torch/make_fixture_dataset.py``
    with the JAX tool's defaults for the other flags (304 px images, 2 s
    WAVs), or reused when it exists (same arguments, same tree)."""
    fixture = os.path.join(out, "fixture")
    if os.path.exists(os.path.join(fixture, "train", "filenames.pickle")):
        print(f"fixture exists: {fixture}")
        return fixture
    from tools_torch.make_fixture_dataset import make_fixture

    make_fixture(fixture, classes, per_class, captions, emb_dim, seed=seed, test_per_class=test_per_class)
    return fixture


def load_real_images(splits: Sequence[StackGanSplit], size: int) -> np.ndarray:
    """All fixture images at the GAN's top scale, [-1,1] NHWC (the FID
    real set; center-crop-free resize — fixture images are square)."""
    from PIL import Image

    imgs = []
    for split in splits:
        for i in range(len(split)):
            im = Image.open(split.image_path(i)).convert("RGB")
            if im.size != (size, size):
                im = im.resize((size, size), Image.BILINEAR)
            imgs.append(np.asarray(im, np.float32) / 127.5 - 1.0)
    return np.stack(imgs)


def finetune_inception(cfg, split: StackGanSplit, n_classes: int, epochs: int, batch: int, base_size: int,
                       lr: float, device: str | torch.device = "cuda") -> tuple[dict, dict]:
    """Fine-tune the IS/FID classifier on the fixture classes at 299 px from
    the seeded init (``cfg.SEED``), ``epochs`` epochs of ``batch`` images
    loaded at ``base_size`` (``GanEpochIterator``, seed SEED + epoch) by a
    prefetch thread.
    A from-scratch InceptionV3's pool3 features are near-collapsed, so FID
    only discriminates once this classifier is trained; the certs record its
    last train accuracy as provenance. Returns (the state_dict on the CPU,
    the last step's ``{"ce", "acc"}`` as floats)."""
    state = init_inception_state(n_classes, int(cfg.SEED), lr, device=device)
    step = make_inception_train_step(299)
    mets: dict = {}
    for epoch in range(epochs):
        # images load and copy to the device in a thread, ahead of the step
        for b in Prefetcher(GanEpochIterator(split, batch, 1, base_size=base_size, seed=int(cfg.SEED) + epoch),
                            depth=2, device=device):
            mets = step(state, b["images"][0], b["class_id"] % n_classes)
        if epoch % 5 == 0 or epoch == epochs - 1:
            print(f"  inception epoch {epoch}: " + " ".join(f"{k}={float(v):.3f}" for k, v in mets.items()))
    return ({k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            {k: float(v) for k, v in mets.items()})


def save_classifier(state_dict: dict, out: str) -> str:
    """``<out>/inception_finetuned.pt``: the classifier's state_dict."""
    path = os.path.join(out, CLASSIFIER_FILE)
    torch.save(state_dict, path)
    return path


def load_classifier(path: str) -> dict[str, torch.Tensor]:
    """A classifier saved by a cert: the port's ``inception_finetuned.pt``
    (``torch.save`` of the state_dict) or a JAX run's
    ``inception_finetuned.pkl`` (a pickle of the Flax ``{"params",
    "batch_stats"}`` as numpy, read through ``bridge.inception_state_dict``:
    scores then land in that run's feature space)."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            variables = pickle.load(f)
        return load_torch_inception(inception_state_dict(variables))
    return load_torch_inception(torch.load(path, map_location="cpu", weights_only=True))


def classifier(out: str, inception_pkl: str, fit: Callable[[], tuple[dict, dict]]) -> tuple[dict, dict]:
    """The run's classifier and its provenance: ``inception_pkl`` when
    given, else the one an earlier call on ``out`` saved (a resumed run
    stays in its feature space), else ``fit()``'s. Saved as ``out``'s
    ``inception_finetuned.pt`` whatever its source."""
    own = os.path.join(out, CLASSIFIER_FILE)
    src = inception_pkl or (own if os.path.exists(own) else "")
    if src:
        print(f"classifier: reuse {src}")
        sd, mets = load_classifier(src), {"loaded": src}
    else:
        sd, mets = fit()
    if os.path.abspath(src) != os.path.abspath(own):
        save_classifier(sd, out)
    return sd, mets


def make_extractor(state_dict: dict, n_classes: int, device: str | torch.device) -> InceptionFeatures:
    """The certs' extractor: eval features of uint8-quantized pixels
    (pytorch-fid's protocol: the bytes a saved PNG would hold)."""
    return InceptionFeatures(state_dict, num_classes=n_classes, quantize_input=True, device=device)


def make_fid_is(ex, real_stats, eval_batch: int) -> Callable[[np.ndarray], tuple[float, float, float]]:
    """fake images → (fid, is_mean, is_std) in ``ex``'s feature space."""

    def fid_is_of(fake: np.ndarray) -> tuple[float, float, float]:
        pool, logits = ex.extract(fake, eval_batch)
        fid = fid_from_stats(*gaussian_stats(pool), *real_stats)
        is_mean, is_std = inception_score_from_probs(softmax(logits), splits=5)
        return float(fid), float(is_mean), float(is_std)

    return fid_is_of


def interpretability_floor(real_pool: np.ndarray, real_logits: np.ndarray, seed: int) -> dict:
    """Anchors for the fixture-FID/IS curve: the real-vs-real FID (random
    half vs half — the best any generator could score at this sample count)
    and the real set's own IS (the ceiling; IS is also bounded above by the
    class count)."""
    halves = np.random.default_rng(seed).permutation(real_pool.shape[0])
    floor_fid = fid_from_stats(*gaussian_stats(real_pool[halves[::2]]), *gaussian_stats(real_pool[halves[1::2]]))
    real_is_mean, real_is_std = inception_score_from_probs(softmax(real_logits), splits=5)
    return {
        "real_real_fid": round(float(floor_fid), 3),
        "real_is_mean": round(float(real_is_mean), 4),
        "real_is_std": round(float(real_is_std), 4),
    }


class Results:
    """A run's ``results.jsonl``: the floor preamble once, then one line
    per eval point, appended as it is scored; what earlier calls on the
    same directory wrote is read back first."""

    def __init__(self, out: str):
        self.path = os.path.join(out, "results.jsonl")
        self.floor: dict | None = None
        self.points: list[dict] = []
        if os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    if line.strip():
                        rec = json.loads(line)
                        if rec.get("floor"):
                            self.floor = self.floor or rec
                        else:
                            self.points.append(rec)

    def _append(self, rec: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def write_floor(self, floor: dict) -> None:
        """The preamble, unless an earlier call wrote it."""
        if self.floor is None:
            self.floor = {"floor": True, **floor}
            self._append(self.floor)

    def has(self, step: int) -> bool:
        return any(p["step"] == step for p in self.points)

    def add(self, rec: dict) -> None:
        self.points.append(rec)
        self._append(rec)

    def write_summary(self, out: str, summary: dict) -> dict:
        """``summary.json``: ``summary`` and the whole curve."""
        summary = {**summary, "curve": self.points}
        with open(os.path.join(out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        print(json.dumps({k: v for k, v in summary.items() if k != "curve"}))
        return summary


def train_metrics(mets: dict, digits: int = 4) -> dict:
    """A chunk's last training metrics as rounded floats (a record's tail)."""
    return {k: round(float(v), digits) for k, v in mets.items()}


def sample_images(g: GNet, embeddings: np.ndarray, batch: int, seed: int = 123) -> np.ndarray:
    """Top-scale images [N, S, S, 3] in [-1, 1] of eval-mode ``g`` (a
    :func:`gan.sampling_generator` copy) for every embedding, ``batch`` at a
    time; example i's noise is keyed by (``seed``, i) (``gan.sample``), so
    every eval point draws the same z."""
    outs = []
    for i in range(0, embeddings.shape[0], batch):
        top = gan.sample(g, embeddings[i:i + batch], seed=seed, offset=i)[-1]
        outs.append(top.permute(0, 2, 3, 1).float().cpu().numpy())
    return np.concatenate(outs)


def speech_features(items: Sequence[tuple[StackGanSplit, int, int]], p: FrontendParams, batch: int,
                    device: str | torch.device) -> tuple[np.ndarray, np.ndarray]:
    """Log-mel features and masks (on the host) of the WAVs of ``items``
    ((split, image, caption) triples), ``batch`` at a time on ``device`` (K1
    on the card). They do not depend on the encoder, so a cert computes them
    once and reruns only the encoder per eval point."""
    feats, masks = [], []
    for start in range(0, len(items), batch):
        chunk = items[start:start + batch]
        wavs = np.zeros((len(chunk), p.max_samples), np.float32)
        lens = np.zeros(len(chunk), np.int32)
        for j, (split, i, c) in enumerate(chunk):
            x = split.load_wav(i, c, p.sample_rate)[:p.max_samples]
            wavs[j, :len(x)] = x
            lens[j] = len(x)
        f, m = extract_features(wavs, p, wav_len=lens, device=device)
        feats.append(f.cpu().numpy())
        masks.append(m.cpu().numpy())
    return np.concatenate(feats), np.concatenate(masks)


def retrieval_populations(train: StackGanSplit, test: StackGanSplit, classes: int, train_eval_n: int, seed: int,
                          p: FrontendParams, batch: int, device: str | torch.device) -> dict[str, Any]:
    """The fixed populations of the encoder metrics: every test caption as
    a query against the test teachers; a seeded subset of ``train_eval_n``
    train images (a denser gallery); the train split's class prototypes in
    the teacher space (nearest-prototype accuracy grades cross-split class
    structure, not memorization). Features are computed here, once."""
    caps = test.captions_per_image
    emb_dim = test.embeddings.shape[-1]
    test_idx = np.arange(len(test))
    tr_idx = np.sort(np.random.default_rng(seed).permutation(len(train))[:train_eval_n])
    protos = np.stack([train.embeddings[train.class_id == k].mean((0, 1)) for k in range(classes)])
    return {
        "test": speech_features([(test, int(i), c) for i in test_idx for c in range(caps)], p, batch, device),
        "train": speech_features([(train, int(i), c) for i in tr_idx for c in range(caps)], p, batch, device),
        "test_teacher": test.embeddings[test_idx].reshape(-1, emb_dim).astype(np.float32),
        "test_ids": np.repeat(test_idx, caps),
        "test_cls": np.repeat(test.class_id[test_idx], caps),
        "train_teacher": train.embeddings[tr_idx].reshape(-1, emb_dim).astype(np.float32),
        "train_ids": np.repeat(tr_idx, caps),
        "protos": protos.astype(np.float32),
    }


def encoder_record(embed: Callable[[np.ndarray, np.ndarray], np.ndarray], pops: dict,
                   device: str | torch.device) -> dict:
    """The encoder's metrics over :func:`retrieval_populations`' sets with
    ``embed(feats, mask)`` → eval-mode embeddings: held-out distill MSE,
    test and train speech→teacher R@1 / mAP / medR (multi-positive, grouped
    by image), nearest-train-prototype class accuracy."""
    emb_t = embed(*pops["test"])
    emb_tr = embed(*pops["train"])
    ret_t = retrieval_metrics(emb_t, pops["test_teacher"], ks=(1, 5), query_ids=pops["test_ids"],
                              target_ids=pops["test_ids"], device=device)["q2t"]
    ret_tr = retrieval_metrics(emb_tr, pops["train_teacher"], ks=(1, 5), query_ids=pops["train_ids"],
                               target_ids=pops["train_ids"], device=device)["q2t"]
    unit = lambda x: x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-8)  # noqa: E731
    cls_acc = float(((unit(emb_t) @ unit(pops["protos"]).T).argmax(1) == pops["test_cls"]).mean())
    return {
        "test_mse": round(float(np.mean(np.square(emb_t - pops["test_teacher"]))), 5),
        "test_r@1": round(ret_t["r@1"], 4),
        "test_map": round(ret_t["map"], 4),
        "test_medr": ret_t["medr"],
        "train_r@1": round(ret_tr["r@1"], 4),
        "train_map": round(ret_tr["map"], 4),
        "train_medr": ret_tr["medr"],
        "proto_cls_acc": round(cls_acc, 4),
        "n_test_q": int(emb_t.shape[0]),
        "n_train_q": int(emb_tr.shape[0]),
    }
