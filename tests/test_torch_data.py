"""The port's data layer (s2i_tpu_torch/data/stackgan.py, native/,
data/pipeline.py, tools_torch/make_fixture_dataset.py) against the JAX
package's on the CPU: on one fixture tree (2 classes × 4 images, 3
captions, 96 px JPEGs with CUB bounding boxes, WAVs of 1 000 to 6 000
samples), the port's ``GanEpochIterator`` and ``SpeechEpochIterator``
batches must equal ``s2i_tpu.data.stackgan``'s bitwise for the same seed:
the PIL and the native (C++, built here with g++) paths, float32 and uint8
images, all scales or the top one, with and without audio. Both loaders are
host numpy; nothing of JAX runs."""

import pickle
import threading
import time

import numpy as np
import pytest
import torch

from s2i_tpu import native as jax_native
from s2i_tpu.data import stackgan as jax_stackgan
from s2i_tpu_torch import native
from s2i_tpu_torch.data import stackgan
from s2i_tpu_torch.data.pipeline import ParallelMap, Prefetcher, prefetch
from tools_torch.make_fixture_dataset import make_fixture, tone_synthesize

MAX_SAMPLES = 5360  # 32 frames of the default frontend


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixture")
    counts = make_fixture(str(d), classes=2, per_class=4, captions=3, emb_dim=16, image_size=96,
                          wav_samples=(1000, 6000), seed=1)
    assert counts == {"train": 6, "test": 2}
    return str(d)


def assert_batches_equal(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            gs, ws = (g[k], w[k]) if k == "images" else ((g[k],), (w[k],))
            assert len(gs) == len(ws)
            for a, b in zip(gs, ws):
                assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


def test_native_loader_builds_into_the_build_dir():
    lib = native.get_lib()
    assert lib is not None, native.unavailable_reason()
    assert native._target().parent == native.BUILD_DIR and native._target().exists()


@pytest.mark.parametrize("loader", ["native", "pil"])
@pytest.mark.parametrize("image_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("ship_scales", ["all", "top"])
def test_gan_batches_equal_the_jax_loaders(tree, loader, image_dtype, ship_scales):
    use_native = loader == "native"
    if use_native:
        assert jax_native.native_available() and native.native_available()
    kw = dict(batch_size=2, branch_num=2, seed=5, use_native=use_native, image_dtype=image_dtype,
              ship_scales=ship_scales, num_threads=2)
    got = list(stackgan.GanEpochIterator(stackgan.StackGanSplit(tree, "train"), **kw))
    want = list(jax_stackgan.GanEpochIterator(jax_stackgan.StackGanSplit(tree, "train"), **kw))
    assert_batches_equal(got, want)
    assert len(got) == 3 and got[0]["images"][-1].shape == (2, 128, 128, 3)


@pytest.mark.parametrize("loader", ["native", "pil"])
def test_gan_batches_with_audio_equal_the_jax_loaders(tree, loader):
    kw = dict(batch_size=3, branch_num=1, seed=2, use_native=loader == "native", with_audio=True,
              max_samples=MAX_SAMPLES, image_dtype="uint8", ship_scales="top")
    got = list(stackgan.GanEpochIterator(stackgan.StackGanSplit(tree, "train"), **kw))
    want = list(jax_stackgan.GanEpochIterator(jax_stackgan.StackGanSplit(tree, "train"), **kw))
    assert_batches_equal(got, want)
    b = got[0]
    assert b["wav"].shape == (3, MAX_SAMPLES) and np.array_equal(b["teacher"], b["embedding"])
    assert 1000 <= b["wav_len"].min() and b["wav_len"].max() <= MAX_SAMPLES


def test_speech_batches_equal_the_jax_loader(tree):
    got = list(stackgan.SpeechEpochIterator(stackgan.StackGanSplit(tree, "train"), 4, 16000, MAX_SAMPLES, seed=3))
    want = list(jax_stackgan.SpeechEpochIterator(jax_stackgan.StackGanSplit(tree, "train"), 4, 16000,
                                                 MAX_SAMPLES, seed=3))
    assert_batches_equal(got, want)
    assert len(got) == 18 // 4  # 6 images × 3 captions, the last partial batch dropped


def test_split_bboxes_and_multiscale_equal_the_jax_package(tree):
    ours, theirs = stackgan.StackGanSplit(tree, "test"), jax_stackgan.StackGanSplit(tree, "test")
    assert ours.filenames == theirs.filenames and ours.captions_per_image == 3
    assert np.array_equal(ours.embeddings, theirs.embeddings) and np.array_equal(ours.class_id, theirs.class_id)
    assert stackgan.load_bboxes(tree) == jax_stackgan.load_bboxes(tree) and len(ours.bboxes) == 8
    assert np.array_equal(ours.load_wav(1, 2, 8000), theirs.load_wav(1, 2, 8000))  # resampled
    rng = np.random.default_rng(0)
    for img in (rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),
                rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)):
        for got, want in zip(stackgan.multiscale(img, 3), jax_stackgan.multiscale(img, 3)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="top scale"):
        stackgan.multiscale(img, 2)


def test_latin1_pickles_of_python2_load(tmp_path):
    path = tmp_path / "py2.pickle"
    # a Python 2 str holding a byte above 127 does not decode as ASCII
    path.write_bytes(b"\x80\x02]q\x00U\x04caf\xe9q\x01a.")
    assert stackgan._load_pickle(str(path)) == jax_stackgan._load_pickle(str(path)) == ["caf\xe9"]


def test_native_pipeline_takes_pil_when_the_library_is_missing(tree, monkeypatch):
    split = stackgan.StackGanSplit(tree, "train")
    monkeypatch.setattr(native, "get_lib", lambda: None)
    it = stackgan.GanEpochIterator(split, 2, 1, seed=0)
    assert it.use_native is False
    want = stackgan.GanEpochIterator(split, 2, 1, seed=0, use_native=False)
    assert_batches_equal(list(it), list(want))


def test_fixture_tones_match_the_jax_tool():
    from tools.synthesize_speech import tone_synthesize as jax_tone

    for text in ("class 0 caption 1 item 2", "a small bird with a red head"):
        assert np.array_equal(tone_synthesize(text, 16000, 32000), jax_tone(text, 16000, seconds=2.0))
    assert tone_synthesize("short", 16000, 3000).shape == (3000,)  # shorter than one tone


def test_prefetch_on_the_cpu_yields_the_same_batches_as_tensors(tree):
    split = stackgan.StackGanSplit(tree, "train")
    make = lambda: stackgan.GanEpochIterator(split, 2, 2, seed=4, with_audio=True,  # noqa: E731
                                             max_samples=MAX_SAMPLES, ship_scales="all")
    want = list(make())
    got = list(prefetch(make(), depth=2, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g["images"], tuple) and all(torch.is_tensor(t) for t in g["images"])
        for a, b in zip(g["images"], w["images"]):
            assert np.array_equal(a.numpy(), b)
        for k in ("embedding", "class_id", "wav", "wav_len", "teacher"):
            assert torch.is_tensor(g[k]) and np.array_equal(g[k].numpy(), w[k]), k


def test_prefetch_early_break_reaps_the_thread_and_errors_reach_the_consumer():
    def endless():
        i = 0
        while True:
            yield {"x": np.full(3, i)}
            i += 1

    pf = Prefetcher(endless(), depth=2, device="cpu")
    for item in pf:
        assert torch.equal(item["x"], torch.zeros(3, dtype=torch.int64))
        break
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()

    def failing():
        yield {"x": np.ones(2)}
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for item in prefetch(failing(), depth=2, device="cpu"):
            got.append(item)
    assert len(got) == 1


def test_prefetch_stress_keeps_order_under_fast_thread_switches():
    """Many producers and consumers at once with a short switch interval:
    every stream arrives complete and in order."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        results = {}

        def consume(k: int) -> None:
            results[k] = [int(b["i"]) for b in prefetch(({"i": np.int64(i)} for i in range(200)), 3, "cpu")]

        threads = [threading.Thread(target=consume, args=(k,)) for k in range(8)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads) and time.time() - t0 < 30
        assert all(results[k] == list(range(200)) for k in range(8))
    finally:
        sys.setswitchinterval(interval)


def test_parallel_map_keeps_order():
    pm = ParallelMap(lambda x: x * x, workers=4)
    try:
        assert pm(range(20)) == [x * x for x in range(20)]
    finally:
        pm.close()


def test_split_reads_a_two_dimensional_embedding_pickle(tree):
    """One embedding per image (a [N, D] pickle) is read as one caption."""
    flat = stackgan.StackGanSplit(tree, "train").embeddings[:, 0]
    with open(f"{tree}/train/flat.pickle", "wb") as f:
        pickle.dump(flat, f)
    got = stackgan.StackGanSplit(tree, "train", embedding_file="flat.pickle")
    assert got.embeddings.shape == (6, 1, 16) and np.array_equal(got.embeddings[:, 0], flat)
