"""The port's checkpoint interchange with the reference project
(s2i_tpu_torch/port/, the port-torch-gan and export-torch-gan commands) on
the CPU at tiny widths, against the JAX package's porters
(s2i_tpu/port/stackgan_torch.py, audio_encoder_torch.py) and the torch
reference topologies (tests/_torch_stackgan.py, and the speech encoder of
tests/test_port_encoder.py):

- reading: ``netG.pth`` / ``netD*.pth`` with BN statistics off their init,
  saved under ``module.`` or inside ``{'state_dict': ...}``, give key for key
  and bitwise what the JAX porter gives through the bridge, the same
  ``meta``, and the reference G's and D's eval-mode outputs;
- writing: the exporters give bitwise what the JAX exporters give, and the
  reference modules load it strictly;
- naming drift raises and names the keys;
- the speech encoder's structural port, three topologies, bitwise the JAX
  porter's through the bridge and the reference's embedding;
- the commands on ``--device cpu``: a ported pair samples, warm-starts and
  serves; an export gives back the checkpoint's tensors.

Nothing here compiles a JAX function: the JAX porters are numpy code."""

import os

import numpy as np
import pytest
import threadpoolctl
import torch

import s2i_tpu.port as jax_port
from s2i_tpu_torch import bridge, config, entrypoints
from s2i_tpu_torch.audio.frontend import extract_features, frontend_params_from_cfg
from s2i_tpu_torch.models.discriminator import DNet
from s2i_tpu_torch.models.encoder import SpeechEncoder
from s2i_tpu_torch.models.generator import GNet
from s2i_tpu_torch.pipeline import SpeechToImage
from s2i_tpu_torch.port import (export_dnet, export_gnet, load_torch_state_dict, port_dnet, port_dnet_scale,
                                port_encoder, port_gnet)
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.train.encoder import init_encoder_state
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils import CheckpointManager
from tests import _torch_stackgan as ts
from tests.test_port_encoder import _randomized, _TorchSpeechEncoder

GF, TDIM, CDIM, ZDIM, RNUM, B = 8, 32, 16, 12, 2, 4  # tests/test_port.py's widths
ATOL = 3e-5  # eval-mode images and logits against the torch reference, as tests/test_port.py
ATOL_ENC = 1e-5  # the encoder's embedding against the torch reference
TINY_AUDIO = ["AUDIO.N_MELS=8", "AUDIO.MAX_FRAMES=32", "ENCODER.CONV_CHANNELS=[8, 16]", "ENCODER.RNN_HIDDEN=16",
              "ENCODER.N_CLASSES=8", "DTYPE.COMPUTE=float32"]
D_CLASSES = {64: ts.D_NET64, 128: ts.D_NET128, 256: ts.D_NET256}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread and one BLAS thread: the test run's parallel workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def warm_bn(model: torch.nn.Module, *inputs) -> torch.nn.Module:
    """Two train-mode forwards move every BN's running statistics (and
    ``num_batches_tracked``) off their init; returns the model in eval mode."""
    model.train()
    with torch.no_grad():
        for _ in range(2):
            model(*inputs)
    return model.eval()


def reference_g(branch: int, seed: int = 0, r_num: int = RNUM) -> ts.G_NET:
    torch.manual_seed(seed)
    return warm_bn(ts.G_NET(GF, TDIM, CDIM, ZDIM, branch_num=branch, r_num=r_num),
                   torch.randn(B, ZDIM), torch.randn(B, CDIM))


def reference_d(scale: int, seed: int = 0) -> torch.nn.Module:
    torch.manual_seed(seed + scale)
    return warm_bn(D_CLASSES[scale](ndf=8, nef=CDIM), torch.randn(B, 3, scale, scale), torch.randn(B, CDIM))


def assert_bitwise(got: dict, want: dict) -> None:
    assert list(got) == list(want) or sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], torch.as_tensor(np.asarray(v))), k


def g_images(model, z: np.ndarray, mu: torch.Tensor) -> list[np.ndarray]:
    with torch.no_grad():
        return [im.numpy() for im in model(torch.from_numpy(z), mu)]


@pytest.mark.parametrize("branch", [1, 2, 3])
def test_port_gnet_equals_the_jax_porter_and_the_reference_g(tmp_path, branch):
    g = reference_g(branch, seed=branch)
    sd = g.state_dict()
    assert any(k.endswith("num_batches_tracked") for k in sd)
    paths = {"module": tmp_path / "netG_dp.pth", "container": tmp_path / "netG_container.pth"}
    torch.save({f"module.{k}": v for k, v in sd.items()}, paths["module"])
    torch.save({"state_dict": sd, "epoch": 3}, paths["container"])
    jax_p, jax_s, jax_meta = jax_port.port_gnet(jax_port.load_torch_state_dict(str(paths["module"])))
    want = bridge.gnet_state_dict(jax_p, jax_s)
    for path in paths.values():
        got, meta = port_gnet(load_torch_state_dict(path))
        assert meta == jax_meta == {"gf_dim": GF, "z_dim": ZDIM, "c_dim": CDIM, "t_dim": TDIM,
                                    "branch_num": branch, "r_num": RNUM if branch > 1 else None}
        assert_bitwise(got, want)

    ported = GNet(gf_dim=GF, z_dim=ZDIM, c_dim=CDIM, t_dim=TDIM, branch_num=branch, num_res=RNUM)
    ported.load_state_dict(got)
    ported.eval()
    rng = np.random.default_rng(branch)
    emb = torch.from_numpy(rng.standard_normal((B, TDIM)).astype(np.float32))
    z = rng.standard_normal((B, ZDIM)).astype(np.float32)
    with torch.no_grad():
        mu_ref, logvar_ref = g.ca_net.encode(emb)
        mu, logvar = ported.ca_net(emb)
    np.testing.assert_allclose(mu.numpy(), mu_ref.numpy(), atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(), logvar_ref.numpy(), atol=ATOL)
    want_imgs = g_images(g, z, mu_ref)
    got_imgs = g_images(ported, z, mu_ref)
    assert len(got_imgs) == len(want_imgs) == branch
    for i, (a, b) in enumerate(zip(got_imgs, want_imgs)):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"stage {i}")


@pytest.mark.parametrize("scale", [64, 128, 256])
def test_port_dnet_equals_the_jax_porter_and_the_reference_d(tmp_path, scale):
    d = reference_d(scale)
    path = tmp_path / f"netD{scale}.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in d.state_dict().items()}}, path)
    sd = load_torch_state_dict(path)
    assert port_dnet_scale(sd) == scale
    got, meta = port_dnet(sd)
    jax_p, jax_s, jax_meta = jax_port.port_dnet(jax_port.load_torch_state_dict(str(path)))
    assert meta == jax_meta == {"scale": scale, "df_dim": 8, "ef_dim": CDIM}
    assert_bitwise(got, bridge.dnet_state_dict(jax_p, jax_s))

    ported = DNet(scale, 8, CDIM)
    ported.load_state_dict(got)
    ported.eval()
    gen = torch.Generator().manual_seed(scale)
    x, c = torch.randn(B, 3, scale, scale, generator=gen), torch.randn(B, CDIM, generator=gen)
    with torch.no_grad():
        for a, b in zip(ported(x, c), d(x, c)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_exporters_equal_the_jax_exporters_and_load_strictly():
    """Port state_dicts (seeded modules, BN statistics moved) → reference
    files: bitwise what ``s2i_tpu.port.export_gnet/export_dnet`` write from
    the same weights, strictly loadable by G_NET / D_NET*, and read back by
    the port's porter unchanged."""
    cfg = config.apply_overrides(config.default_cfg(), [
        f"GAN.GF_DIM={GF}", f"GAN.Z_DIM={ZDIM}", f"GAN.EMBEDDING_DIM={CDIM}", f"TEXT.DIMENSION={TDIM}",
        "GAN.DF_DIM=8", "TREE.BRANCH_NUM=3", "DTYPE.COMPUTE=float32"])
    m = gan.init_state(cfg, device="cpu").models
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, buf in (b for mod in (m.g, *m.ds) for b in mod.named_buffers()):
            buf.add_(0.1 * torch.rand(buf.shape, generator=gen))
    g_sd = m.g.state_dict()
    got = export_gnet(g_sd)
    assert not any(k.endswith("num_batches_tracked") or k.startswith("module.") for k in got)
    assert_bitwise(got, jax_port.export_gnet(*bridge.gnet_trees(g_sd)))
    ts.G_NET(GF, TDIM, CDIM, ZDIM, branch_num=3, r_num=RNUM).load_state_dict(got, strict=True)
    assert_bitwise(port_gnet(got)[0], g_sd)
    for scale, d in zip((64, 128, 256), m.ds):
        got = export_dnet(d.state_dict())
        assert_bitwise(got, jax_port.export_dnet(*bridge.dnet_trees(d.state_dict())))
        D_CLASSES[scale](ndf=8, nef=CDIM).load_state_dict(got, strict=True)
        assert_bitwise(port_dnet(got)[0], d.state_dict())


def test_naming_drift_raises_and_names_the_keys():
    sd = dict(reference_g(2).state_dict())
    renamed = dict(sd)
    renamed["img_net2.image.0.weight"] = renamed.pop("img_net2.img.0.weight")
    with pytest.raises(ValueError, match=r"missing keys 1 \['img_net2.img.0.weight'\].*"
                                         r"unrecognized keys .*\['img_net2.image.0.weight'\]"):
        port_gnet(renamed)
    with pytest.raises(ValueError, match=r"unrecognized keys .*h_net1.someday.weight"):
        port_gnet({**sd, "h_net1.someday.weight": sd["img_net1.img.0.weight"]})
    with pytest.raises(ValueError, match=r"missing keys 1 \['ca_net.fc.bias'\]"):
        port_gnet({k: v for k, v in sd.items() if k != "ca_net.fc.bias"})
    with pytest.raises(ValueError, match="missing 'ca_net.fc.weight'"):  # a key the dims come from
        port_gnet({k: v for k, v in sd.items() if k != "ca_net.fc.weight"})
    with pytest.raises(ValueError, match=r"shape mismatches \['h_net2.jointConv.1.bias"):
        port_gnet({**sd, "h_net2.jointConv.1.bias": torch.zeros(3)})
    d_sd = dict(reference_d(64).state_dict())
    with pytest.raises(ValueError, match=r"netD64: .*missing keys 1 \['uncond_logits.outlogits.0.bias'\]"):
        port_dnet({k: v for k, v in d_sd.items() if k != "uncond_logits.outlogits.0.bias"})
    with pytest.raises(ValueError, match="unrecognized keys"):
        export_gnet({**m_state(), "extra.weight": torch.zeros(1)})


def m_state() -> dict:
    return GNet(gf_dim=2, z_dim=4, c_dim=4, t_dim=8, branch_num=1).state_dict()


ENCODERS = {
    "bigru": (dict(bidirectional=True), 37, None, False),
    "unidirectional_two_layers": (dict(bidirectional=False, layers=2, hidden=10), 24, None, False),
    "cls_head_dataparallel": (dict(emb_dim=20, n_classes=7), 40, 20, True),
}


@pytest.mark.parametrize("topology", list(ENCODERS))
def test_port_encoder_equals_the_jax_porter_and_the_reference_encoder(topology):
    kwargs, t_len, emb_dim, prefixed = ENCODERS[topology]
    tm = _randomized(_TorchSpeechEncoder(**kwargs))
    sd = tm.state_dict()
    if prefixed:
        sd = {f"module.{k}": v for k, v in sd.items()}
    got, meta = port_encoder(sd, emb_dim=emb_dim)
    jax_tree, jax_meta = jax_port.port_encoder(sd, emb_dim=emb_dim)
    assert meta == {**jax_meta, "n_mels": 8}
    assert_bitwise(got, bridge.encoder_state_dict(jax_tree))
    enc = SpeechEncoder(**meta)
    enc.load_state_dict(got)
    enc.eval()
    x = np.random.default_rng(1).standard_normal((4, t_len, 8)).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x))
        out = enc(torch.from_numpy(x), torch.ones(4, t_len, dtype=torch.bool))
    want, out = (want, out) if isinstance(want, tuple) else ((want,), (out,))
    assert len(out) == len(want) == (2 if meta["n_classes"] else 1)
    for a, b in zip(out, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL_ENC)


def _drifted_encoders() -> dict:
    sd = dict(_randomized(_TorchSpeechEncoder()).state_dict())
    return {
        "attention.in_proj_weight": {**sd, "attention.in_proj_weight": torch.zeros(6, 4, 2, 2)},
        "bias": {**sd, "convs.0.bias": torch.zeros(16)},
        "emb_dim": _randomized(_TorchSpeechEncoder(emb_dim=20, n_classes=7)).state_dict(),
        "GRU": {k: v for k, v in sd.items() if "_l0" not in k},
    }


@pytest.mark.parametrize("fault", ["attention.in_proj_weight", "bias", "emb_dim", "GRU"])
def test_port_encoder_fails_loudly_as_the_jax_porter(fault):
    sd = _drifted_encoders()[fault]
    with pytest.raises(ValueError, match=fault):
        jax_port.port_encoder(sd)
    with pytest.raises(ValueError, match=fault):
        port_encoder(sd)


def save_references(tmp_path, branch: int = 2) -> tuple[ts.G_NET, dict]:
    """netG (DataParallel names, num_batches_tracked) and the per-scale netDs
    (one inside a container) of seeded reference modules; returns G and the
    paths."""
    g = reference_g(branch, seed=7)
    paths = {"netG": str(tmp_path / "netG.pth")}
    torch.save({f"module.{k}": v for k, v in g.state_dict().items()}, paths["netG"])
    for i, scale in enumerate((64, 128, 256)[:branch]):
        paths[f"netD{scale}"] = str(tmp_path / f"netD{scale}.pth")
        sd = reference_d(scale, seed=7).state_dict()
        torch.save({"state_dict": sd} if i else sd, paths[f"netD{scale}"])
    return g, paths


def test_port_torch_gan_command_samples_warm_starts_and_serves(tmp_path):
    g, paths = save_references(tmp_path)
    out = str(tmp_path / "ported")
    over = ["DATASET_NAME=synthetic", "TRAIN.EMA_G=0.999", *TINY_AUDIO]
    entrypoints.main(["port-torch-gan", "--device", "cpu", "--netg", paths["netG"],
                      "--netd", paths["netD128"], paths["netD64"], "--out", out, "--set", *over])
    cfg = config.cfg_from_file(os.path.join(out, "ported_config.yml"))
    assert (cfg.GAN.GF_DIM, cfg.GAN.Z_DIM, cfg.GAN.EMBEDDING_DIM, cfg.TEXT.DIMENSION, cfg.TREE.BRANCH_NUM,
            cfg.GAN.R_NUM, cfg.GAN.DF_DIM, cfg.TRAIN.JOINT_FT) == (GF, ZDIM, CDIM, TDIM, 2, RNUM, 8, False)

    # the step-0 checkpoint restores into the state of that cfg, every tensor the files'
    state, step = CheckpointManager(out).restore_latest(gan.init_state(cfg, device="cpu"))
    assert step == 0 == state.step
    g_sd = port_gnet(load_torch_state_dict(paths["netG"]))[0]
    assert_bitwise(state.models.g.state_dict(), g_sd)
    for scale, d in zip((64, 128), state.models.ds):
        assert_bitwise(d.state_dict(), port_dnet(load_torch_state_dict(paths[f"netD{scale}"]))[0])
    assert_bitwise(state.ema, {k: g_sd[k] for k, _ in state.models.g.named_parameters()})

    # TRAIN.NET_G warm-starts a trainer from it; `sample` draws PNGs from it
    cfg.TRAIN.NET_G = out
    warm = GanTrainer(cfg, str(tmp_path / "warm"), lambda epoch: iter(()), device="cpu")
    try:
        assert warm.state.step == 0
        assert_bitwise(warm.state.models.g.state_dict(), g_sd)
    finally:
        warm.close()
    with pytest.warns(UserWarning, match="EMA_BN_RECALC"):
        samples = entrypoints.main(["sample", "--device", "cpu", "--cfg", os.path.join(out, "ported_config.yml"),
                                    "--output_dir", str(tmp_path / "out"), "--set", f"TRAIN.NET_G={out}"])
    pngs = sorted(os.listdir(samples))
    assert len(pngs) == 128 and pngs[0].endswith(".png")

    # served with a frozen encoder: the images of the source G_NET on the same z and μ
    enc_ckpt = str(tmp_path / "enc")
    CheckpointManager(enc_ckpt).save(0, init_encoder_state(cfg, device="cpu"))
    pipe = SpeechToImage.from_checkpoints(cfg, enc_ckpt, out, device="cpu")
    p = frontend_params_from_cfg(cfg.AUDIO)
    rng = np.random.default_rng(3)
    wavs = (0.1 * rng.standard_normal((3, p.max_samples))).astype(np.float32)
    lens = np.array([p.max_samples, 2000, 900])
    z = rng.standard_normal((3, ZDIM)).astype(np.float32)
    with torch.no_grad():
        feats, mask = extract_features(wavs, p, wav_len=lens, device="cpu")
        mu = g.ca_net.encode(pipe.encoder(feats, mask)[0])[0]
    want = g_images(g, z, mu)[-1].transpose(0, 2, 3, 1)
    np.testing.assert_allclose(pipe.generate(wavs, lens, z=z), want, atol=ATOL)


def test_port_torch_gan_refuses_mismatched_discriminators(tmp_path):
    _, paths = save_references(tmp_path, branch=3)
    cases = {"duplicate netD for scale 64": [paths["netD64"], paths["netD64"]],
             "netD256 has no slot at BRANCH_NUM=2": [paths["netD256"]]}
    g2 = str(tmp_path / "netG2.pth")
    torch.save(reference_g(2).state_dict(), g2)
    for msg, netds in cases.items():
        with pytest.raises(ValueError, match=msg):
            entrypoints.main(["port-torch-gan", "--device", "cpu", "--netg", g2, "--netd", *netds,
                              "--out", str(tmp_path / "x")])
    other = str(tmp_path / "netD64_ef.pth")
    torch.save(ts.D_NET64(ndf=8, nef=CDIM + 2).state_dict(), other)
    with pytest.raises(ValueError, match="condition dim 18 != netG's 16"):
        entrypoints.main(["port-torch-gan", "--device", "cpu", "--netg", g2, "--netd", other,
                          "--out", str(tmp_path / "x")])


@pytest.mark.parametrize("mode, raw", [("frozen", False), ("frozen", True), ("joint", False), ("joint", True),
                                       ("no_ema", False)])
def test_export_torch_gan_command_gives_back_the_checkpoint(tmp_path, mode, raw):
    over = [f"GAN.GF_DIM={GF}", f"GAN.Z_DIM={ZDIM}", f"GAN.EMBEDDING_DIM={CDIM}", f"TEXT.DIMENSION={TDIM}",
            "GAN.DF_DIM=8", "TREE.BRANCH_NUM=2", f"TRAIN.JOINT_FT={str(mode == 'joint').lower()}",
            f"TRAIN.EMA_G={0.0 if mode == 'no_ema' else 0.999}", *TINY_AUDIO]
    cfg = config.apply_overrides(config.default_cfg(), over)
    state = gan.init_state(cfg, device="cpu")
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for t in [*state.ema.values(), *(b for mod in (state.models.g, *state.models.ds) for b in mod.buffers())]:
            t.add_(0.1 * torch.rand(t.shape, generator=gen))
    state.step = 3
    CheckpointManager(str(tmp_path / "ckpt")).save(3, state)
    out = str(tmp_path / "torch")
    written = entrypoints.main(["export-torch-gan", "--device", "cpu", "--ckpt", str(tmp_path / "ckpt"),
                                "--out", out] + (["--raw"] if raw else []))
    assert sorted(written) == ["netD128.pth", "netD64.pth", "netG.pth"]
    g_want = state.models.g.state_dict()
    if not raw and state.ema:
        g_want.update(state.ema)
    netg = torch.load(written["netG.pth"], weights_only=True)
    assert_bitwise(netg, g_want)
    ts.G_NET(GF, TDIM, CDIM, ZDIM, branch_num=2, r_num=RNUM).load_state_dict(netg, strict=True)
    for scale, d in zip((64, 128), state.models.ds):
        netd = torch.load(written[f"netD{scale}.pth"], weights_only=True)
        assert_bitwise(netd, d.state_dict())
        D_CLASSES[scale](ndf=8, nef=CDIM).load_state_dict(netd, strict=True)
