"""``DATA.PIPELINE: grain`` in the port (s2i_tpu_torch/data/grain_pipeline.py)
against Grain and the JAX package on the CPU, on one fixture tree
(tools_torch/make_fixture_dataset.py: 2 classes × 4 images, 3 captions, 96
px JPEGs): the port's copy of Grain's C++ ``index_shuffle`` equals Grain's
compiled module on whole permutations and samples; the batches equal
``s2i_tpu.data.grain_pipeline.grain_batch_factory``'s bitwise over two
epochs for every ``SHIP_SCALES`` × ``IMAGE_DTYPE``, with 0 or 2 worker
processes; a 2-rank data axis's rows are the one-process batch's rows; and a
trainer on grain batches resumes mid-epoch bitwise as the straight run and
writes TensorBoard event files that hold its ``scalars.jsonl`` and its
sample grids. This is the one test file that
imports Grain; nothing of JAX is compiled."""

import copy
import io
import json
import os

import numpy as np
import pytest
import threadpoolctl
import torch
from grain._src.python.experimental.index_shuffle.python import index_shuffle_module
from PIL import Image

from s2i_tpu.data.grain_pipeline import grain_batch_factory as jax_grain_batch_factory
from s2i_tpu_torch import cli, config
from s2i_tpu_torch.data import grain_pipeline
from s2i_tpu_torch.data.stackgan import GanEpochIterator
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils.checkpoint import to_host
from s2i_tpu_torch.utils.logging import read_events
from tools_torch.make_fixture_dataset import make_fixture

SEEDS = (0, 5, 2**32 - 1)
SMALL = ["TEXT.DIMENSION=16", "GAN.GF_DIM=4", "GAN.DF_DIM=4", "GAN.Z_DIM=8", "GAN.EMBEDDING_DIM=8", "GAN.R_NUM=1",
         "TREE.BRANCH_NUM=2", "TREE.BASE_SIZE=16", "TRAIN.BATCH_SIZE=2", "EVAL.EMA_BN_RECALC=1",
         "TEXT.EMBEDDING_FILE=char-CNN-RNN-embeddings.pickle", "DTYPE.COMPUTE=float32", "DATA.PIPELINE=grain"]


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
    make_fixture(str(d), classes=2, per_class=4, captions=3, emb_dim=16, image_size=96, wav_samples=(1000, 1000),
                 seed=3)
    return str(d)


def grain_cfg(tree: str, *overrides: str) -> config.AttrDict:
    return config.apply_overrides(config.cfg_from_file("cfg/birds_3stages.yml"),
                                  [*SMALL, f"DATA_DIR={tree}", *overrides])


@pytest.mark.parametrize("max_index", [0, 1, 2, 3, 7, 55, 1000, 8854])
def test_index_shuffle_is_grains_permutation(max_index):
    for seed in SEEDS:
        want = [index_shuffle_module.index_shuffle(i, max_index, seed, 4) for i in range(max_index + 1)]
        got = grain_pipeline.index_shuffle(np.arange(max_index + 1), max_index, seed)
        assert got.dtype == np.int64 and got.tolist() == want, seed
    assert grain_pipeline.index_shuffle(max_index, max_index, seed) == want[-1]  # an int in, an int out


def test_index_shuffle_samples_past_the_table():
    max_index = 2**20 + 3  # a 22-bit block: the cipher walked a value at a time
    idx = np.random.default_rng(0).integers(0, max_index + 1, 300)
    for seed in SEEDS:
        want = [index_shuffle_module.index_shuffle(int(i), max_index, seed, 4) for i in idx]
        assert grain_pipeline.index_shuffle(idx, max_index, seed).tolist() == want
    with pytest.raises(ValueError, match="rounds"):
        grain_pipeline.index_shuffle(0, 7, 0, rounds=3)


def assert_batches_equal(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"images", "embedding", "class_id"}
        assert len(g["images"]) == len(w["images"])
        for a, b in [*zip(g["images"], w["images"]), (g["embedding"], w["embedding"]),
                     (g["class_id"], w["class_id"])]:
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("image_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("ship_scales", ["all", "top"])
def test_batches_equal_the_jax_grain_pipeline(tree, image_dtype, ship_scales):
    cfg = grain_cfg(tree, f"DATA.IMAGE_DTYPE={image_dtype}", f"DATA.SHIP_SCALES={ship_scales}", "SEED=7")
    port, jax = grain_pipeline.grain_batch_factory(cfg), jax_grain_batch_factory(cfg)
    for epoch in range(2):
        got = list(port(epoch))
        assert_batches_equal(got, list(jax(epoch)))
        assert len(got) == 3 and got[0]["images"][-1].shape == (2, 32, 32, 3)
        assert len(got[0]["images"]) == (1 if ship_scales == "top" else 2)


def test_workers_and_ranks_give_the_one_process_rows(tree):
    cfg = grain_cfg(tree, "SEED=11", "DATA.IMAGE_DTYPE=uint8")
    one = grain_pipeline.grain_batch_factory(cfg)
    want = [list(one(epoch)) for epoch in range(2)]
    cfg.DATA.GRAIN_WORKERS = 2
    workers = grain_pipeline.grain_batch_factory(cfg)
    for epoch in range(2):
        assert_batches_equal(list(workers(epoch)), want[epoch])

    class Rank:  # a 2-rank data axis as the factory sees it
        def __init__(self, rank: int):
            self.rank = rank

        def rows(self, n: int) -> slice:
            return slice(self.rank * n // 2, (self.rank + 1) * n // 2)

    cfg.DATA.GRAIN_WORKERS = 0
    for rank in range(2):
        rows = Rank(rank).rows(2)
        got = list(grain_pipeline.grain_batch_factory(cfg, Rank(rank))(1))
        assert_batches_equal(got, [{"images": tuple(s[rows] for s in b["images"]),
                                    "embedding": b["embedding"][rows], "class_id": b["class_id"][rows]}
                                   for b in want[1]])


def test_trainer_on_grain_batches_resumes_and_writes_event_files(tmp_path, tree):
    cfg = grain_cfg(tree, "TRAIN.TENSORBOARD=True", "DATA.GRAIN_WORKERS=2", "TREE.BRANCH_NUM=1", "TREE.BASE_SIZE=64")
    factory = cli.gan_batch_factory(cfg)
    first = next(iter(factory(0)))
    serial = config.apply_overrides(copy.deepcopy(cfg), ["DATA.GRAIN_WORKERS=0"])  # Grain's own workers start slowly
    assert_batches_equal([first], [next(iter(jax_grain_batch_factory(serial)(0)))])
    joint = config.apply_overrides(copy.deepcopy(cfg), ["TRAIN.JOINT_FT=True"])
    assert isinstance(cli.gan_batch_factory(joint)(0), GanEpochIterator)  # as the JAX package's joint mode

    def trained(out, max_steps: int, **kw) -> dict:
        t = GanTrainer(cfg, str(out), factory, device="cpu", **kw)
        try:
            t.train(max_steps=max_steps)
            return to_host(t.state.state_dict())
        finally:
            t.close()

    run = tmp_path / "run"
    trained(run, 2, log_every=1, image_every=2)  # stops in epoch 0, two of its three batches in
    got = trained(run, 4, log_every=1, image_every=2)  # resumes: epoch 0's third batch, then epoch 1's first
    assert got["step"] == 4 and json.load(open(run / "train_progress.json"))["epoch"] == 1
    want = trained(tmp_path / "straight", 4, log_every=0, image_every=0)
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))  # the stream realigned

    jsonl = [json.loads(line) for line in open(run / "scalars.jsonl")]
    recs = []
    for name in sorted(os.listdir(run / "tb")):  # one file per trainer, as the JAX writer makes
        file_recs = read_events(str(run / "tb" / name))
        assert file_recs[0]["file_version"] == "brain.Event:2"
        recs += file_recs[1:]
    scalars = [(r["step"], v["tag"], v["simple_value"]) for r in recs for v in r["values"] if "image" not in v]
    assert scalars == [(rec["step"], k, float(np.float32(v))) for rec in jsonl for k, v in rec.items()
                       if k not in ("step", "time")]
    assert [r["step"] for r in jsonl] == [1, 2, 3, 4]
    images = [(r["step"], v["tag"], v["image"]) for r in recs for v in r["values"] if "image" in v]
    assert [(s, tag) for s, tag, _ in images] == [(2, "samples"), (4, "samples")]
    for step, _, img in images:
        grid = np.asarray(Image.open(run / "images" / f"fake_{step:07d}.png"))
        with Image.open(io.BytesIO(img["png"])) as im:
            assert np.array_equal(np.asarray(im), grid)
        assert (img["height"], img["width"], img["colorspace"]) == grid.shape


def flat(sd) -> list:
    """The tensors of a nested state dict, in order."""
    if torch.is_tensor(sd):
        return [sd]
    if isinstance(sd, dict):
        sd = list(sd.values())
    return [t for v in sd for t in flat(v)] if isinstance(sd, (list, tuple)) else []
