"""Write a dataset tree in the StackGAN + speech layout from a seed, so that
every real-data path of the port (loaders, encoder pretraining from WAVs,
embedding extraction, GAN training, sampling) runs without the CUB or
Oxford assets. The port's jax-free copy of tools/make_fixture_dataset.py
and of the tone synthesizer of tools/synthesize_speech.py (the one copy:
tools_torch/synthesize_speech.py takes it from here):

    python tools_torch/make_fixture_dataset.py --out output/fixture \\
        --classes 8 --per_class 7 --captions 10 --image_size 500 \\
        --wav_samples 3000 164080
    python -m s2i_tpu_torch pretrain-encoder --cfg cfg/pretrain_encoder_birds.yml \\
        --data_dir output/fixture

The tree: ``<split>/{filenames,char-CNN-RNN-embeddings,class_info}.pickle``
(teacher embeddings: a class prototype plus noise per caption),
``images/<class>/<img>.jpg`` (gratings whose frequencies are the class),
``CUB_200_2011/{images,bounding_boxes}.txt`` (a box per image) and
``audio/<class>/<img>/<k>.wav`` (16-bit tone sequences keyed by the caption's
text, of lengths drawn from ``--wav_samples``). The last ``--test_per_class``
images of each class go to the test split. With ``--wav_samples`` at its
default of 2 s and no boxes read, the images, embeddings and WAVs are those
that the JAX package's tool writes for the same arguments.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from s2i_tpu_torch.audio.wavio import write_wav  # noqa: E402


def _stable_hash(text: str) -> int:
    return zlib.crc32(text.encode("utf-8"))  # hash() is salted per process


def tone_synthesize(text: str, sample_rate: int, n_samples: int) -> np.ndarray:
    """A deterministic text-dependent tone sequence of ``n_samples`` (a
    quarter-second tone per word, up to 12 words, plus a noise floor): a
    stand-in for a TTS caption."""
    rng = np.random.default_rng(_stable_hash(text))
    n = n_samples
    t = np.arange(n) / sample_rate
    out = np.zeros(n, np.float32)
    dur = min(sample_rate // 4, n)
    for word in text.split()[:12]:
        f = 200.0 + (_stable_hash(word) % 2000)
        start = int(rng.integers(0, max(1, n - sample_rate // 4)))
        seg = slice(start, start + dur)
        out[seg] += 0.2 * np.sin(2 * np.pi * f * t[: out[seg].shape[0]]).astype(np.float32)
    out += 0.01 * rng.standard_normal(n).astype(np.float32)
    return np.clip(out, -1, 1)


def make_fixture(
    out: str,
    classes: int = 8,
    per_class: int = 4,
    captions: int = 3,
    emb_dim: int = 1024,
    image_size: int = 304,
    sample_rate: int = 16000,
    test_per_class: int = 1,
    wav_samples: tuple[int, int] = (32000, 32000),
    seed: int = 0,
) -> dict[str, int]:
    """Write the tree under ``out``; returns the images per split."""
    from PIL import Image

    if per_class < test_per_class + 1:
        raise ValueError("per_class must exceed test_per_class: the rest of each class is the train split")
    lo, hi = wav_samples
    if not 0 < lo <= hi:
        raise ValueError(f"wav_samples must be 0 < min <= max, got {wav_samples}")
    rng = np.random.default_rng(seed)
    len_rng = np.random.default_rng(seed + 1)  # apart from rng: the images match the JAX tool's
    box_rng = np.random.default_rng(seed + 2)
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    emb_protos = rng.normal(size=(classes, emb_dim)).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 4, image_size), np.linspace(0, 4, image_size), indexing="ij")
    splits: dict[str, dict[str, list]] = {"train": {"names": [], "embs": [], "cls": []},
                                          "test": {"names": [], "embs": [], "cls": []}}
    boxes = []
    for k in range(classes):
        freq = rng.normal(size=(2, 3)) * 2.0
        for j in range(per_class):
            name = f"class_{k:03d}/img_{j:04d}"
            split = "test" if j >= per_class - test_per_class else "train"
            # class: the grating's frequencies; per image: phase, amplitude
            # and offset per channel, so a class is a manifold, not a point
            phase = rng.uniform(0, 2 * np.pi, size=3)
            amp = rng.uniform(70.0, 120.0, size=3)
            dc = rng.uniform(-25.0, 25.0, size=3)
            img = np.stack([127 + dc[c] + amp[c] * np.sin(freq[0, c] * yy + freq[1, c] * xx + phase[c])
                            for c in range(3)], -1)
            path = os.path.join(out, "images", name + ".jpg")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=92)
            emb = (emb_protos[k][None] + 0.1 * rng.normal(size=(captions, emb_dim))).astype(np.float32)
            splits[split]["names"].append(name)
            splits[split]["embs"].append(emb)
            splits[split]["cls"].append(k)
            w, h = box_rng.uniform(0.4, 0.9, size=2) * image_size
            x, y = box_rng.uniform(0, image_size - w), box_rng.uniform(0, image_size - h)
            boxes.append((name, x, y, w, h))
            wav_dir = os.path.join(out, "audio", name)
            os.makedirs(wav_dir, exist_ok=True)
            for c in range(captions):
                n = int(len_rng.integers(lo, hi + 1))
                write_wav(os.path.join(wav_dir, f"{c}.wav"),
                          tone_synthesize(f"class {k} caption {c} item {j}", sample_rate, n), sample_rate)
    cub = os.path.join(out, "CUB_200_2011")
    os.makedirs(cub, exist_ok=True)
    with open(os.path.join(cub, "images.txt"), "w") as f_img, \
            open(os.path.join(cub, "bounding_boxes.txt"), "w") as f_box:
        for i, (name, x, y, w, h) in enumerate(boxes, start=1):
            f_img.write(f"{i} {name}.jpg\n")
            f_box.write(f"{i} {x:.1f} {y:.1f} {w:.1f} {h:.1f}\n")
    counts = {}
    for split, d in splits.items():
        sd = os.path.join(out, split)
        os.makedirs(sd, exist_ok=True)
        with open(os.path.join(sd, "filenames.pickle"), "wb") as f:
            pickle.dump(d["names"], f)
        with open(os.path.join(sd, "char-CNN-RNN-embeddings.pickle"), "wb") as f:
            pickle.dump(np.stack(d["embs"]), f)
        with open(os.path.join(sd, "class_info.pickle"), "wb") as f:
            pickle.dump(d["cls"], f)
        counts[split] = len(d["names"])
    return counts


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--per_class", type=int, default=4)
    p.add_argument("--captions", type=int, default=3)
    p.add_argument("--emb_dim", type=int, default=1024)
    p.add_argument("--image_size", type=int, default=304)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--test_per_class", type=int, default=1, help="held-out images per class")
    p.add_argument("--wav_samples", type=int, nargs=2, default=(32000, 32000), metavar=("MIN", "MAX"),
                   help="each WAV's length in samples, drawn uniformly from [MIN, MAX]")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    try:
        counts = make_fixture(args.out, args.classes, args.per_class, args.captions, args.emb_dim,
                              args.image_size, args.sample_rate, args.test_per_class,
                              tuple(args.wav_samples), args.seed)
    except ValueError as e:
        p.error(str(e))
    for split, n in counts.items():
        print(f"{split}: {n} images x {args.captions} captions")
    print(f"fixture dataset at {args.out}")


if __name__ == "__main__":
    main()
