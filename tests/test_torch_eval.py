"""The port's evaluation layer (s2i_tpu_torch/models/inception.py,
s2i_tpu_torch/eval/, the ``eval`` command) against the JAX package's on the
CPU, on the same numpy inputs made from a seed.

The weights are the port's seeded init with every BN scale, bias, mean and
variance randomized (at statistics of 0 and 1 eval-mode BN is nearly an
identity, which would hide a wrong ``eps`` or a swapped mean and variance),
carried to Flax by ``bridge.inception_trees``: the JAX ``InceptionV3.init``
is never run. Three small JAX programs are compiled (the whole network's
eval forward at 75 px, 2-4 s; each train-mode block, ~0.4 s, where an
op-by-op eager run of a block compiles each of its ops and takes longer);
the resize and the metrics run eagerly. Tolerances, each relative to the reference's largest magnitude
unless said otherwise: the whole network 1e-5 (float32 sums over ~95
layers in another order), the blocks 1e-5, the resize 1e-6 absolute, the
metrics 1e-9 (float64 on both sides) and FID 1e-7 (another square-root
algorithm, ``eval/fid.py``)."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch
from PIL import Image

from s2i_tpu.eval import fid as jax_fid
from s2i_tpu.eval.inception_score import inception_score_from_probs as jax_is_from_probs
from s2i_tpu.eval import retrieval as jax_retrieval
from s2i_tpu.eval.features import preprocess as jax_preprocess
from s2i_tpu.eval.weights import load_torch_inception as jax_load_torch_inception
from s2i_tpu.models import inception as jax_inception
from s2i_tpu_torch import bridge, entrypoints
from s2i_tpu_torch.eval import InceptionFeatures, fid, retrieval
from s2i_tpu_torch.eval.features import preprocess
from s2i_tpu_torch.eval.inception_score import inception_score_from_probs, softmax
from s2i_tpu_torch.eval.finetune import init_inception_state, make_inception_train_step
from s2i_tpu_torch.eval.weights import load_torch_inception
from s2i_tpu_torch.models import inception
from s2i_tpu_torch.models.layers import BatchNorm

CLASSES = 7
TOL_NET = 1e-5
TOL_BLOCK = 1e-5
TOL_RESIZE = 1e-6
TOL_METRIC = 1e-9
TOL_FID = 1e-7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread and one BLAS thread (FID's 2048² decompositions):
    the test run's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def randomize_bn(module: torch.nn.Module, seed: int) -> None:
    """Every BN's scale, bias, running mean and running variance off its init."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=gen))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))
                m.running_mean.copy_(0.2 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))


@pytest.fixture(scope="module")
def net():
    """(the port's InceptionV3 in eval mode, its state_dict as numpy, the Flax variables)."""
    model = inception.InceptionV3(CLASSES)
    inception.init_weights(model, torch.Generator().manual_seed(0))
    randomize_bn(model, 1)
    model.eval()
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return model, sd, bridge.inception_trees(sd)


def close(got, want, tol: float, what: str = "") -> None:
    """max |got - want| within ``tol`` of want's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, (what, err, scale)


def images(n: int, h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (n, h, w, 3)).astype(np.float32)


def test_inception_matches_jax_in_eval_mode(net):
    model, _, variables = net
    x = images(2, 75, 75, seed=2)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = jax.jit(lambda v, x: jax_inception.InceptionV3(num_classes=CLASSES).apply(v, x, train=False))(
        variables, jnp.asarray(x))
    for k in ("pool3", "logits"):
        assert got[k].dtype == torch.float32
        close(got[k].numpy(), want[k], TOL_NET, k)


@pytest.mark.parametrize("block", ["basic_conv", "inception_a"])
def test_train_mode_blocks_match_jax(block):
    """One train-mode pass: BN on the batch's statistics, Flax's biased
    variance, the running statistics moved with momentum 0.9."""
    c_in = 5
    if block == "basic_conv":
        port = inception.BasicConv2d(c_in, 6, 3, padding=1)
        flax = jax_inception.BasicConv2d(6, (3, 3), padding=((1, 1), (1, 1)))
    else:
        port = inception.InceptionA(c_in, 4)
        flax = jax_inception.InceptionA(4)
    inception.init_weights(port, torch.Generator().manual_seed(3))
    randomize_bn(port, 4)
    variables = bridge.inception_trees({k: v.numpy() for k, v in port.state_dict().items()})
    x = np.random.default_rng(5).uniform(-1.5, 2.5, (3, 8, 8, c_in)).astype(np.float32)
    port.train()
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    want, new_vars = jax.jit(lambda v, x: flax.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    close(got, want, TOL_BLOCK, "output")
    stats = bridge.inception_trees({k: v.numpy() for k, v in port.state_dict().items()})["batch_stats"]
    got_s = {jax.tree_util.keystr(p): v for p, v in jax.tree.leaves_with_path(stats)}
    want_s = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree.leaves_with_path(new_vars["batch_stats"])}
    assert got_s.keys() == want_s.keys()
    for k in want_s:
        close(got_s[k], want_s[k], TOL_BLOCK, k)


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("shape,size", [((64, 64), 299), ((96, 96), 75), ((48, 80), 64)],
                         ids=["up", "down", "down-and-up"])
def test_preprocess_matches_jax(shape, size, quantize):
    x = images(2, *shape, seed=6)
    got = preprocess(torch.from_numpy(x), size, quantize_input=quantize).numpy()
    want = np.asarray(jax_preprocess(jnp.asarray(x), size, quantize_input=quantize))
    assert got.shape == want.shape == (2, size, size, 3)
    assert float(np.abs(got - want).max()) <= TOL_RESIZE


@pytest.mark.parametrize("case", ["full-rank", "same-set", "rank-deficient"])
def test_fid_matches_jax(case):
    """The rank-deficient cases hold fewer images than features, as the
    protocol's 2048-d covariances of fewer than 2049 images are; FID(X, X)
    of such a set must still be 0 to rounding."""
    rng = np.random.default_rng(7)
    n, dim = (200, 64) if case == "full-rank" else (20, 64)
    f1 = rng.standard_normal((n, dim)) * np.linspace(0.1, 3.0, dim)
    f2 = f1 if case == "same-set" else 1.3 * rng.standard_normal((n + 10, dim)) + 0.2
    s1, s2 = fid.gaussian_stats(f1), fid.gaussian_stats(f2)
    for got, want in zip(s1 + s2, jax_fid.gaussian_stats(f1) + jax_fid.gaussian_stats(f2)):
        np.testing.assert_array_equal(got, want)
    got, want = fid.fid_from_stats(*s1, *s2), jax_fid.fid_from_stats(*s1, *s2)
    assert abs(got - want) <= TOL_FID * (np.trace(s1[1]) + np.trace(s2[1])), (got, want)
    if case == "same-set":
        assert abs(got) <= 1e-9 * np.trace(s1[1])


def test_inception_score_matches_jax():
    logits = 3.0 * np.random.default_rng(8).standard_normal((50, CLASSES)).astype(np.float32)
    probs = softmax(logits)
    want_probs = np.exp(logits - logits.max(1, keepdims=True))
    np.testing.assert_array_equal(probs, want_probs / want_probs.sum(1, keepdims=True))
    for splits in (1, 10, 60):
        got = inception_score_from_probs(probs, splits)
        want = jax_is_from_probs(probs, splits)
        np.testing.assert_allclose(got, want, rtol=TOL_METRIC)
    uniform = inception_score_from_probs(np.full((20, CLASSES), 1.0 / CLASSES), 4)
    np.testing.assert_allclose(uniform, (1.0, 0.0), atol=1e-12)


@pytest.mark.parametrize("grouped", [False, True], ids=["paired", "grouped"])
def test_retrieval_matches_jax(grouped):
    rng = np.random.default_rng(9)
    if grouped:
        t = rng.standard_normal((6, 16)).astype(np.float32)
        tid = np.arange(6)
        qid = np.repeat(np.arange(6), 3)
        q = (t[qid] + 0.8 * rng.standard_normal((18, 16))).astype(np.float32)
        kw = {"query_ids": qid, "target_ids": tid}
    else:
        t = rng.standard_normal((12, 16)).astype(np.float32)
        q = (t + 0.8 * rng.standard_normal((12, 16))).astype(np.float32)
        kw = {}
    got = retrieval.retrieval_metrics(q, t, ks=(1, 5), device="cpu", **kw)
    want = jax_retrieval.retrieval_metrics(q, t, ks=(1, 5), **kw)
    assert got.keys() == want.keys() == {"q2t", "t2q"}
    for d in got:
        assert got[d].keys() == want[d].keys() == {"r@1", "r@5", "medr", "mrr", "map"}
        for k in got[d]:
            assert got[d][k] == pytest.approx(want[d][k], rel=TOL_METRIC, abs=TOL_METRIC), (d, k)


@pytest.mark.parametrize("bad", ["paired-counts", "one-id-set", "no-positive"])
def test_retrieval_errors_match_jax(bad):
    q, t = np.ones((3, 4), np.float32), np.ones((4, 4), np.float32)
    kw = {"paired-counts": {}, "one-id-set": {"query_ids": np.arange(3)},
          "no-positive": {"query_ids": np.array([0, 1, 9]), "target_ids": np.arange(4)}}[bad]
    with pytest.raises(ValueError) as want:
        jax_retrieval.retrieval_metrics(q, t, **kw)
    with pytest.raises(ValueError) as got:
        retrieval.retrieval_metrics(q, t, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def torchvision_layout(sd: dict) -> dict:
    """``sd`` as a torchvision ``inception_v3`` state_dict has it: torch
    tensors, a ``num_batches_tracked`` beside each BN, and the auxiliary head."""
    out = {k: torch.from_numpy(v) for k, v in sd.items()}
    for k in sd:
        if k.endswith(".bn.running_var"):
            out[k.replace("running_var", "num_batches_tracked")] = torch.tensor(3)
    out["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    out["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    return out


def test_torchvision_weights_load_as_the_jax_mapper_loads_them(net):
    _, sd, variables = net
    tv = torchvision_layout(sd)
    got = load_torch_inception(tv)
    assert got.keys() == sd.keys()
    for k in sd:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), sd[k], err_msg=k)
    want = jax_load_torch_inception(tv)
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree.leaves_with_path(tree)}  # noqa: E731
    got_trees, want_trees = flat(bridge.inception_trees({k: v.numpy() for k, v in got.items()})), flat(want)
    assert got_trees.keys() == want_trees.keys()
    for k in want_trees:
        np.testing.assert_array_equal(got_trees[k], want_trees[k], err_msg=k)
    back = flat(bridge.inception_trees(bridge.inception_state_dict(want)))
    assert back.keys() == want_trees.keys()
    for k in want_trees:
        np.testing.assert_array_equal(back[k], want_trees[k], err_msg=k)
    assert flat(variables).keys() == want_trees.keys()


@pytest.mark.parametrize("fault", ["missing", "unexpected", "misshapen"])
def test_torchvision_loader_is_strict(net, fault):
    tv = torchvision_layout(net[1])
    if fault == "missing":
        del tv["Mixed_6c.branch7x7_2.bn.running_var"]
    elif fault == "unexpected":
        tv["Mixed_6c.branch7x7_9.conv.weight"] = torch.zeros(1)
    else:
        tv["Conv2d_1a_3x3.conv.weight"] = torch.zeros(32, 3, 5, 5)
    with pytest.raises(RuntimeError):
        load_torch_inception(tv)


def test_finetune_step_learns():
    """The JAX test's task (tests/test_eval.py): two classes told apart by
    colour, 16 images at 32 px resized to 75, 6 steps at lr 1e-3."""
    rng = np.random.default_rng(0)
    n = 16
    labels = np.arange(n) % 2
    imgs = np.zeros((n, 32, 32, 3), np.float32)
    imgs[labels == 0, :, :, 0] = 0.8
    imgs[labels == 1, :, :, 2] = 0.8
    imgs += 0.05 * rng.standard_normal(imgs.shape).astype(np.float32)
    state = init_inception_state(2, seed=0, lr=1e-3, device="cpu")
    step = make_inception_train_step(image_size=75)
    stats0 = state.model.Mixed_5b.branch1x1.bn.running_mean.clone()
    for _ in range(6):
        mets = step(state, imgs, labels)
    assert state.step == 6 and np.isfinite(float(mets["ce"]))
    assert float(mets["acc"]) >= 0.75, float(mets["acc"])
    assert not torch.equal(stats0, state.model.Mixed_5b.branch1x1.bn.running_mean)


def test_extract_pipelined_equals_the_serial_loop_and_keeps_the_tail(net):
    _, sd, _ = net
    ex = InceptionFeatures({k: torch.from_numpy(v) for k, v in sd.items()}, num_classes=CLASSES, image_size=75,
                           device="cpu")
    x = images(10, 48, 48, seed=10)
    pool, logits = ex.extract(x, batch_size=4)  # 3 batches, the last padded by 2
    assert pool.shape == (10, 2048) and logits.shape == (10, CLASSES)
    serial_p, serial_l = [], []
    for i in range(0, 10, 4):
        b = np.zeros((4, 48, 48, 3), np.float32)
        b[: len(x[i:i + 4])] = x[i:i + 4]
        p, lg = ex.forward(torch.from_numpy(b))
        serial_p.append(p.numpy()[: len(x[i:i + 4])])
        serial_l.append(lg.numpy()[: len(x[i:i + 4])])
    np.testing.assert_array_equal(pool, np.concatenate(serial_p))
    np.testing.assert_array_equal(logits, np.concatenate(serial_l))
    # the tail's rows are its images' own (eval-mode BN: the padding is inert)
    tail_p, _ = ex.forward(torch.from_numpy(x[8:]))
    close(pool[8:], tail_p.numpy(), TOL_NET, "tail")


def test_eval_command_on_a_directory(tmp_path, capsys):
    d = tmp_path / "gen"
    d.mkdir()
    rng = np.random.default_rng(11)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(d / f"{i}.png")
    rec = entrypoints.main(["eval", "--gen_dir", str(d), "--real_dir", str(d), "--num_classes", str(CLASSES),
                            "--splits", "1", "--batch", "2", "--json", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == rec
    assert rec.keys() == {"is_mean", "is_std", "n_gen", "inception", "fid"}
    assert rec["n_gen"] == 2 and rec["inception"] == "random-weight" and rec["is_mean"] >= 1.0
    assert abs(rec["fid"]) <= 1e-3


def test_retrieval_command_matches_retrieval_metrics(tmp_path, capsys):
    rng = np.random.default_rng(12)
    teacher = rng.standard_normal((5, 3, 8)).astype(np.float32)  # [images, captions, D]
    speech = (teacher + 0.5 * rng.standard_normal(teacher.shape)).astype(np.float32)
    for name, arr in (("q.pickle", speech), ("t.pickle", teacher[:4])):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(arr, f)
    got = entrypoints.main(["eval", "--retrieval", str(tmp_path / "q.pickle"), str(tmp_path / "t.pickle"),
                            "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.split("\n", 1)[1]) == got  # after the group-count note
    ids_q, ids_t = np.repeat(np.arange(4), 3), np.repeat(np.arange(4), 3)
    want = jax_retrieval.retrieval_metrics(speech[:4].reshape(12, 8), teacher[:4].reshape(12, 8),
                                           query_ids=ids_q, target_ids=ids_t)
    for d in want:
        for k in want[d]:
            assert got[d][k] == pytest.approx(want[d][k], rel=TOL_METRIC, abs=TOL_METRIC), (d, k)
