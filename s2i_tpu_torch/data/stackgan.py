"""CUB-200 / Oxford-102 loaders in the StackGAN on-disk layout, the port's
copy of ``s2i_tpu/data/stackgan.py``: the same files, the same transforms and
the same random draws in the same order, so a batch equals the JAX package's
bitwise for the same seed (``tests/test_torch_data.py``).

Expected tree (StackGAN distribution convention):

    data_dir/
      train/ | test/
        char-CNN-RNN-embeddings.pickle   # [N_img][cap][1024] teacher embs
        filenames.pickle                 # [N_img] relative ids
        class_info.pickle                # [N_img] class ids
        speech-embeddings.pickle         # (ours) extracted speech embeddings
      images/<id>.jpg                    # CUB: CUB_200_2011/images/... also ok
      CUB_200_2011/bounding_boxes.txt + images.txt   # optional bbox crop
      audio/<id>/<k>.wav                 # synthesized speech captions

Image protocol (StackGAN lineage): optional bbox crop with 1.5× margin (CUB),
resize to 76/64·imsize, random crop to imsize, random horizontal flip; the
multi-scale pyramid is produced by area-resizing the largest scale.

Everything here is host-side numpy/PIL (and the C++ JPEG loader of
``s2i_tpu_torch/native``); ``data/pipeline.py`` moves its batches to the
device. ``tools_torch/make_fixture_dataset.py`` writes such a tree from a
seed.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from s2i_tpu_torch import native
from s2i_tpu_torch.audio.wavio import read_wav, resample_linear


def _load_pickle(path: str):
    with open(path, "rb") as f:
        try:
            return pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            return pickle.load(f, encoding="latin1")  # py2-era StackGAN pickles


def load_bboxes(data_dir: str) -> dict[str, tuple[float, float, float, float]] | None:
    """CUB bounding boxes keyed by filename-id (without extension)."""
    bbox_path = os.path.join(data_dir, "CUB_200_2011", "bounding_boxes.txt")
    images_path = os.path.join(data_dir, "CUB_200_2011", "images.txt")
    if not (os.path.exists(bbox_path) and os.path.exists(images_path)):
        return None
    id_to_name = {}
    with open(images_path) as f:
        for line in f:
            i, name = line.split()
            id_to_name[i] = os.path.splitext(name)[0]
    out = {}
    with open(bbox_path) as f:
        for line in f:
            i, x, y, w, h = line.split()
            out[id_to_name[i]] = (float(x), float(y), float(w), float(h))
    return out


class StackGanSplit:
    """One split (train/test) of the StackGAN layout."""

    def __init__(
        self,
        data_dir: str,
        split: str = "train",
        embedding_file: str = "char-CNN-RNN-embeddings.pickle",
    ):
        self.data_dir = data_dir
        self.split_dir = os.path.join(data_dir, split)
        self.filenames: list[str] = list(
            _load_pickle(os.path.join(self.split_dir, "filenames.pickle"))
        )
        emb = _load_pickle(os.path.join(self.split_dir, embedding_file))
        self.embeddings = np.asarray(emb, dtype=np.float32)  # [N, cap, D]
        if self.embeddings.ndim == 2:
            self.embeddings = self.embeddings[:, None, :]
        cls_path = os.path.join(self.split_dir, "class_info.pickle")
        if os.path.exists(cls_path):
            self.class_id = np.asarray(_load_pickle(cls_path), dtype=np.int64)
        else:
            self.class_id = np.zeros(len(self.filenames), dtype=np.int64)
        self.bboxes = load_bboxes(data_dir)

    def __len__(self) -> int:
        return len(self.filenames)

    @property
    def captions_per_image(self) -> int:
        return self.embeddings.shape[1]

    def image_path(self, i: int) -> str:
        for sub in ("images", os.path.join("CUB_200_2011", "images"), "jpg"):
            for ext in (".jpg", ".jpeg", ".png"):
                p = os.path.join(self.data_dir, sub, self.filenames[i] + ext)
                if os.path.exists(p):
                    return p
        raise FileNotFoundError(
            f"no image for {self.filenames[i]!r} under {self.data_dir}"
        )

    def wav_path(self, i: int, cap: int) -> str:
        base = os.path.join(self.data_dir, "audio", self.filenames[i])
        for name in (f"{cap}.wav", f"{cap:d}.wav"):
            p = os.path.join(base, name)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no wav {cap} for {self.filenames[i]!r}")

    def load_image(
        self,
        i: int,
        imsize: int,
        rng: np.random.Generator | None = None,
        flip_and_crop: bool = True,
        dtype: str = "float32",
    ) -> np.ndarray:
        """[imsize, imsize, 3] with the StackGAN transform. ``float32`` →
        [-1,1]; ``uint8`` → raw [0,255] for device-side normalization
        (DATA.IMAGE_DTYPE: 4x fewer host→device bytes)."""
        bbox = None
        if self.bboxes is not None:
            bbox = self.bboxes.get(self.filenames[i])
        return pil_load_transform(
            self.image_path(i),
            imsize,
            rng=rng,
            bbox=bbox,
            flip_and_crop=flip_and_crop,
            dtype=dtype,
        )

    def load_wav(self, i: int, cap: int, sample_rate: int) -> np.ndarray:
        x, sr = read_wav(self.wav_path(i, cap))
        return resample_linear(x, sr, sample_rate)


def crop_draws(rng: np.random.Generator, imsize: int) -> tuple[int, int, bool]:
    """The random crop offsets and flip of one image's StackGAN transform,
    drawn from ``rng`` as :func:`pil_load_transform` draws them (they do not
    depend on the image, so a loader can make them for an image it skips)."""
    load_size = int(imsize * 76 / 64)
    ox = int(rng.integers(0, load_size - imsize + 1))
    oy = int(rng.integers(0, load_size - imsize + 1))
    return ox, oy, bool(rng.random() < 0.5)


def pil_load_transform(
    path: str,
    imsize: int,
    rng: np.random.Generator | None = None,
    bbox=None,
    flip_and_crop: bool = True,
    dtype: str = "float32",
) -> np.ndarray:
    """The StackGAN PIL load+transform (the path taken without the native
    C++ loader): optional 1.5×-margin bbox crop → resize to 76/64·imsize →
    random crop + horizontal flip (or center crop)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if bbox is not None:
        x, y, w, h = bbox
        cx, cy = x + w / 2.0, y + h / 2.0
        r = int(np.maximum(w, h) * 0.75)  # 1.5× margin half-width
        x1 = max(0, int(cx - r))
        y1 = max(0, int(cy - r))
        x2 = min(img.width, int(cx + r))
        y2 = min(img.height, int(cy + r))
        img = img.crop((x1, y1, x2, y2))
    load_size = int(imsize * 76 / 64)
    img = img.resize((load_size, load_size), Image.BILINEAR)
    if dtype == "uint8":
        arr = np.asarray(img, dtype=np.uint8)
    else:
        arr = np.asarray(img, dtype=np.float32) / 127.5 - 1.0
    if flip_and_crop and rng is not None:
        ox, oy, flip = crop_draws(rng, imsize)
        arr = arr[oy : oy + imsize, ox : ox + imsize]
        if flip:
            arr = arr[:, ::-1]
    else:
        off = (load_size - imsize) // 2
        arr = arr[off : off + imsize, off : off + imsize]
    return np.ascontiguousarray(arr)


def multiscale(img: np.ndarray, branch_num: int, base_size: int = 64) -> list[np.ndarray]:
    """Largest-scale image → list of [S,S,3] for S = base·2^i by area-pooling
    (top scale must be base·2^(branch_num-1)). uint8 input stays uint8
    (rounded pool average); float stays float32."""
    top = base_size * 2 ** (branch_num - 1)
    if img.shape[0] != top:
        raise ValueError(f"image of {img.shape[0]} px, the top scale is {top}")
    is_u8 = img.dtype == np.uint8
    out = []
    for i in range(branch_num):
        f = 2 ** (branch_num - 1 - i)
        if f == 1:
            out.append(img if is_u8 else img.astype(np.float32))
        else:
            h = img.shape[0] // f
            pooled = img.reshape(h, f, h, f, 3).mean(axis=(1, 3))
            out.append(
                (pooled + 0.5).clip(0, 255).astype(np.uint8)
                if is_u8
                else pooled.astype(np.float32)
            )
    return out


def wav_batch(split: StackGanSplit, items, batch_size: int, sample_rate: int, max_samples: int) -> dict:
    """The WAVs of ``items`` ((image, caption) pairs), read one after the
    other, cropped to ``max_samples`` and zero-padded into a [batch_size,
    max_samples] float32 buffer, with their lengths (0 for rows past the
    items)."""
    wavs = np.zeros((batch_size, max_samples), np.float32)
    lens = np.zeros(batch_size, np.int32)
    for j, (i, c) in enumerate(items):
        x = split.load_wav(i, c, sample_rate)
        m = min(len(x), max_samples)
        wavs[j, :m] = x[:m]
        lens[j] = m
    return {"wav": wavs, "wav_len": lens}


class SpeechEpochIterator:
    """Shuffled epoch batches for encoder pretraining: fixed-length raw wav
    buffers + per-utterance lengths + teacher embeddings + class ids. The
    log-mel frontend runs on the device downstream (K1 on the card).
    ``rows``: only those rows of each batch are loaded and yielded (a
    rank's share of a global batch; the order is the global one)."""

    def __init__(
        self,
        split: StackGanSplit,
        batch_size: int,
        sample_rate: int,
        max_samples: int,
        seed: int = 0,
        drop_last: bool = True,
        rows: slice | None = None,
    ):
        self.split = split
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.max_samples = max_samples
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.rows = rows or slice(None)

    def __iter__(self):
        n = len(self.split)
        caps = self.split.captions_per_image
        order = self.rng.permutation(n * caps)
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            idx = idx[self.rows]
            items = [divmod(int(flat), caps) for flat in idx]
            img_idx = idx // caps
            cap_idx = idx % caps
            yield {
                **wav_batch(self.split, items, len(idx), self.sample_rate, self.max_samples),
                "teacher": self.split.embeddings[img_idx, cap_idx].astype(
                    np.float32
                ),
                "class_id": self.split.class_id[img_idx],
            }


class GanEpochIterator:
    """Shuffled epoch batches for GAN training from a StackGanSplit.

    Each example picks one of the caption embeddings at random (reference
    TextDataset behavior). Yields the trainer's batch dict. ``rows``: only
    those rows of each batch are loaded and yielded (a rank's share of a
    global batch), equal to the same rows of the whole batch: the PIL path
    makes the crop and flip draws of the other rows without loading them,
    and the native loader seeds each image by its row in the whole batch.
    """

    def __init__(
        self,
        split: StackGanSplit,
        batch_size: int,
        branch_num: int,
        base_size: int = 64,
        seed: int = 0,
        drop_last: bool = True,
        use_native: bool | None = None,
        num_threads: int = 8,
        with_audio: bool = False,
        sample_rate: int = 16000,
        max_samples: int = 164240,
        image_dtype: str = "float32",
        ship_scales: str = "all",
        fast_decode: bool = False,
        rows: slice | None = None,
    ):
        self.split = split
        self.rows = rows or slice(None)
        self.batch_size = batch_size
        self.branch_num = branch_num
        self.base_size = base_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.num_threads = num_threads
        # "uint8" ships raw [0,255] pixels to the device and normalizes
        # there (DATA.IMAGE_DTYPE): 4x fewer host→device bytes per batch.
        self.image_dtype = image_dtype
        # "top" ships ONLY the largest scale (DATA.SHIP_SCALES); the train
        # step derives the smaller scales by the same 2× area-pool on
        # device (gan.expand_image_pyramid) — another ~25% less transfer.
        if ship_scales not in ("all", "top"):
            raise ValueError(f"unknown ship_scales {ship_scales!r}")
        self.ship_scales = ship_scales
        # Joint-finetune mode: also yield the raw wav of the
        # SAME sampled caption plus its teacher embedding.
        self.with_audio = with_audio
        self.sample_rate = sample_rate
        self.max_samples = max_samples
        if use_native is None:
            use_native = native.native_available()
        self.use_native = use_native
        # DCT-scaled decode (DATA.FAST_DECODE): opt-in host-throughput knob,
        # native path only — the PIL fallback stays full-resolution.
        self.fast_decode = fast_decode

    def _load_scales_native(self, idx: np.ndarray, batch_seed: int, first_row: int = 0):
        paths = [self.split.image_path(int(i)) for i in idx]
        if any(not p.lower().endswith((".jpg", ".jpeg")) for p in paths):
            return None  # mixed formats: take the PIL path
        top = self.base_size * 2 ** (self.branch_num - 1)
        bboxes = None
        if self.split.bboxes is not None:
            bboxes = np.zeros((len(idx), 4), np.float32)
            for j, i in enumerate(idx):
                bb = self.split.bboxes.get(self.split.filenames[int(i)])
                if bb is not None:
                    bboxes[j] = bb
        # ship_scales="top": branch_num=1 at top size — the loader skips the
        # host-side pyramid entirely; the device derives the small scales.
        n_branches = 1 if self.ship_scales == "top" else self.branch_num
        outs, failed = native.load_batch(
            paths,
            bboxes,
            top,
            n_branches,
            batch_seed,
            augment=True,
            first_row=first_row,
            num_threads=self.num_threads,
            dtype=self.image_dtype,
            fast_decode=self.fast_decode,
        )
        if failed:
            # backfill zeroed slots via PIL (corrupt/odd files)
            for j, i in enumerate(idx):
                if not np.any(outs[-1][j]):
                    im = self.split.load_image(
                        int(i), top, self.rng, dtype=self.image_dtype
                    )
                    if n_branches == 1:
                        outs[0][j] = im
                    else:
                        for b, s in enumerate(
                            multiscale(im, self.branch_num, self.base_size)
                        ):
                            outs[b][j] = s
        return outs

    def _load_scales_pil(self, idx: np.ndarray, keep: range | None = None):
        """The images of ``idx`` (only its rows in ``keep``; the others'
        crop and flip draws are made all the same)."""
        top = self.base_size * 2 ** (self.branch_num - 1)
        keep = range(len(idx)) if keep is None else keep
        imgs = []
        for j, i in enumerate(idx):
            if j in keep:
                imgs.append(self.split.load_image(int(i), top, self.rng, dtype=self.image_dtype))
            else:
                crop_draws(self.rng, top)
        imgs = np.stack(imgs)
        if self.ship_scales == "top":
            return [imgs]
        return [
            np.stack(x)
            for x in zip(
                *[multiscale(im, self.branch_num, self.base_size) for im in imgs]
            )
        ]

    def __iter__(self):
        n = len(self.split)
        order = self.rng.permutation(n)
        for bnum, start in enumerate(range(0, n, self.batch_size)):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            keep = range(len(idx))[self.rows]
            scales = None
            if self.use_native:
                scales = self._load_scales_native(idx[self.rows], self.seed * 100003 + bnum, keep.start)
            if scales is None:
                scales = self._load_scales_pil(idx, keep)
            cap = self.rng.integers(0, self.split.captions_per_image, len(idx))[self.rows]
            idx = idx[self.rows]
            emb = self.split.embeddings[idx, cap]
            out = {
                "images": tuple(scales),
                "embedding": emb.astype(np.float32),
                "class_id": self.split.class_id[idx],
            }
            if self.with_audio:
                items = [(int(i), int(c)) for i, c in zip(idx, cap)]
                out.update(wav_batch(self.split, items, len(idx), self.sample_rate, self.max_samples))
                out["teacher"] = out["embedding"]
            yield out
