"""One rank of tests/test_torch_parallel.py: joins the gloo process group
that torchrun's variables describe, runs every case over the data axis at
tiny widths on the CPU and writes what each case gives to
``<out>/<case>.<rank>.pt`` (``<case>.error.<rank>.txt`` when a case
raises). It imports torch and the port only.

    RANK=0 WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=... \\
        python -m tests._torch_parallel_worker OUT
"""

from __future__ import annotations

import itertools
import os
import shutil
import signal
import sys
import traceback

import numpy as np
import torch

from s2i_tpu_torch import cli, config, parallel
from s2i_tpu_torch.audio.frontend import featurize, frontend_params_from_cfg
from s2i_tpu_torch.eval import InceptionFeatures
from s2i_tpu_torch.models.layers import BatchNorm, set_batchnorm_axis
from s2i_tpu_torch.train import encoder as encoder_train
from s2i_tpu_torch.train import gan
from s2i_tpu_torch.train.loop import GanTrainer
from s2i_tpu_torch.utils.checkpoint import to_host

B = 8  # the global batch of every case
STEPS_PER_EPOCH = 3  # the trainer runs' epochs, of the synthetic corpus's 16 batches
TRAINER_STEPS = 4
TINY = [
    "DATASET_NAME=synthetic", "GAN.GF_DIM=4", "GAN.DF_DIM=4", "GAN.Z_DIM=8", "GAN.EMBEDDING_DIM=16",
    "GAN.R_NUM=1", "TEXT.DIMENSION=32", f"TRAIN.BATCH_SIZE={B}", "TRAIN.MAX_EPOCH=2",
    "TRAIN.SNAPSHOT_INTERVAL=100", "DTYPE.COMPUTE=float32", "TRAIN.OPTIMIZER=sgd",
]
AUDIO = ["AUDIO.N_MELS=8", "AUDIO.MAX_FRAMES=32", "ENCODER.CONV_CHANNELS=[8, 16]", "ENCODER.RNN_HIDDEN=16",
         "ENCODER.N_CLASSES=8", f"ENCODER.BATCH_SIZE={B}"]
CASES = {
    "gan_roll": ["TREE.BRANCH_NUM=2", "TRAIN.WRONG_PAIR=roll"],
    "gan_class_aware": ["TREE.BRANCH_NUM=2", "TRAIN.WRONG_PAIR=class_aware"],
    "joint": ["TREE.BRANCH_NUM=1", "TRAIN.WRONG_PAIR=class_aware", "TRAIN.JOINT_FT=true",
              "TRAIN.COEFF.DISTILL=1.0", *AUDIO],
}
INCEPTION = {"num_classes": 10, "image_size": 75}
SAMPLES = 6  # embeddings sampled, padded to a multiple of the world size


_FACTORIES: dict = {}


def cfg_of(*over):
    return config.apply_overrides(config.default_cfg(), TINY + list(over))


def gan_batches(cfg):
    """The synthetic corpus's global batches (``cli.synthetic_gan_batches``),
    made once for each kind of corpus."""
    key = (int(cfg.TREE.BRANCH_NUM), bool(cfg.TRAIN.JOINT_FT))
    if key not in _FACTORIES:
        _FACTORIES[key] = cli.synthetic_gan_batches(cfg)
    return _FACTORIES[key]


def gan_batch(cfg) -> dict:
    """The first global batch of the synthetic corpus (featurized in joint mode)."""
    raw = next(iter(gan_batches(cfg)(0)))
    return featurize(raw, frontend_params_from_cfg(cfg.AUDIO), "cpu") if cfg.TRAIN.JOINT_FT else raw


def encoder_batch(cfg) -> dict:
    return next(iter(cli.speech_host_batches(cfg)(0)))


def bn_inputs() -> tuple[torch.Tensor, torch.Tensor]:
    """(x [B, 6, 3, 3], the cotangent of the BN's output)."""
    rng = np.random.default_rng(3)
    x = rng.normal(1.5, 2.0, (B, 6, 3, 3)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))


def gan_record(st: gan.GanTrainState, mets: dict) -> dict:
    """The step's metrics and, by module, every parameter, gradient and buffer."""
    rec = {"mets": {k: v.clone() for k, v in mets.items()}, "params": {}, "grads": {}, "buffers": {}}
    mods = {"g": st.models.g, **{f"d{i}": d for i, d in enumerate(st.models.ds)}}
    if st.models.encoder is not None:
        mods["enc"] = st.models.encoder
    for part, mod in mods.items():
        for name, p in mod.named_parameters():
            rec["params"][f"{part}.{name}"] = p.detach().clone()
            rec["grads"][f"{part}.{name}"] = None if p.grad is None else p.grad.clone()
        for name, b in mod.named_buffers():
            rec["buffers"][f"{part}.{name}"] = b.clone()
    return rec


def encoder_record(st: encoder_train.EncoderTrainState, mets: dict) -> dict:
    m = st.model
    return {"mets": {k: v.clone() for k, v in mets.items()},
            "params": {n: p.detach().clone() for n, p in m.named_parameters()},
            "grads": {n: p.grad.clone() for n, p in m.named_parameters()},
            "buffers": {n: b.clone() for n, b in m.named_buffers()}}


def short_epochs(cfg):
    full = gan_batches(cfg)
    return lambda epoch: itertools.islice(full(epoch), STEPS_PER_EPOCH)


def trainer_cfg():
    return cfg_of("TREE.BRANCH_NUM=1", "TRAIN.WRONG_PAIR=class_aware")


def sample_inputs():
    """(the sampling G of the seeded 2-stage init, SAMPLES embeddings)."""
    g = gan.sampling_generator(gan.init_state(cfg_of("TREE.BRANCH_NUM=2"), "cpu"))
    return g, np.random.default_rng(5).normal(size=(SAMPLES, 32)).astype(np.float32)


def inception_images() -> np.ndarray:
    return np.random.default_rng(4).uniform(-1, 1, (5, 64, 64, 3)).astype(np.float32)


def run_gan(axis, name: str) -> dict:
    cfg = cfg_of(*CASES[name])
    st = gan.init_state(cfg, "cpu")
    step = parallel.make_parallel_train_step(st, axis)
    return gan_record(st, step(gan_batch(cfg)))


def run_encoder(axis) -> dict:
    cfg = cfg_of(*AUDIO)
    st = encoder_train.init_encoder_state(cfg, "cpu")
    return encoder_record(st, parallel.make_parallel_encoder_step(st, axis)(encoder_batch(cfg)))


WRONG_PAIR_CLASSES = (3, 3, 1, 1, 1, 1, 1, 1)  # a run of one class across the ranks' border


def run_wrong_pair(axis) -> dict:
    """The global rows each of this rank's wrong pairs takes its condition
    from, by mode: the conditions are the rows' global indices."""
    rows = axis.rows(B)
    cond = torch.arange(B, dtype=torch.float32)[rows, None]
    cls = torch.tensor(WRONG_PAIR_CLASSES)[rows]
    return {mode: gan.wrong_conditions(cond, cls, mode, axis)[:, 0].long() for mode in ("roll", "class_aware")}


def run_bn(axis) -> dict:
    x, ct = bn_inputs()
    rows = axis.rows(B)
    bn = set_batchnorm_axis(BatchNorm(6), axis)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, 6))
    xr = x[rows].clone().requires_grad_(True)
    y = bn(xr)
    (y * ct[rows]).sum().backward()
    return {"y": y.detach(), "dx": xr.grad, "running_mean": bn.running_mean, "running_var": bn.running_var}


def run_sample(axis) -> dict:
    g, emb = sample_inputs()
    m = -(-SAMPLES // axis.size) * axis.size
    padded = np.concatenate([emb, np.zeros((m - SAMPLES, emb.shape[1]), emb.dtype)])
    imgs = parallel.make_parallel_sample_fn(g, axis)(padded, seed=11)
    return {"images": [im[:SAMPLES] for im in imgs]}


def run_inception(axis) -> dict:
    ex = InceptionFeatures(None, device="cpu", mesh=axis, **INCEPTION)
    pool, logits = ex.extract(inception_images(), batch_size=3)  # rounded up to 4: 2 batches, the second padded
    return {"pool": pool, "logits": logits}


def run_trainer(axis, out: str) -> dict:
    """4 steps straight, and 2 steps + a resume by a new trainer to 4; the
    stopped run's directory is copied at step 2 (``resumable``) for a
    resume in one process. Then a run in which rank 1 alone gets SIGTERM
    during its first step: both ranks stop after it."""
    cfg = trainer_cfg()
    dirs = {k: os.path.join(out, k) for k in ("straight", "stopped", "resumable", "sigterm")}
    viz = {}  # run dir → the embeddings its grid sampled

    def run(d, steps):
        t = GanTrainer(cfg, d, cli.gan_batch_factory(cfg, short_epochs(cfg), axis), device="cpu",
                       image_every=TRAINER_STEPS, log_every=1, mesh=axis)
        try:
            t.train(max_steps=steps)
            viz[d] = t._viz_emb
            return to_host(t.state.state_dict())
        finally:
            t.close()

    straight = run(dirs["straight"], TRAINER_STEPS)
    run(dirs["stopped"], TRAINER_STEPS // 2)
    if axis.rank == 0:
        shutil.copytree(dirs["stopped"], dirs["resumable"])
    axis.barrier()
    resumed = run(dirs["stopped"], TRAINER_STEPS)
    step = gan.train_step

    def step_then_sigterm(*args, **kwargs):
        mets = step(*args, **kwargs)
        if axis.rank == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return mets

    gan.train_step = step_then_sigterm
    try:
        sigterm = run(dirs["sigterm"], TRAINER_STEPS)
    finally:
        gan.train_step = step
    return {"straight": straight, "resumed": resumed, "sigterm_step": sigterm["step"],
            "viz_emb": torch.as_tensor(viz[dirs["straight"]])}


def refusals(axis) -> dict:
    """The messages of what the axis refuses."""
    out = {}
    for what, fn in {
        "indivisible": lambda: parallel.shard_batch({"x": np.zeros((B - 1, 2))}, axis),
        "num_devices": lambda: parallel.make_mesh_if_configured(cfg_of("MESH.NUM_DEVICES=4")),
        "batch": lambda: parallel.make_mesh_if_configured(cfg_of(), B - 1),
    }.items():
        try:
            fn()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    return out


def main(out: str) -> None:
    torch.set_num_threads(1)
    if not parallel.maybe_initialize_distributed("cpu", timeout_s=60):
        raise RuntimeError("no torchrun environment")
    try:
        axis = parallel.make_mesh_if_configured(cfg_of())
        cases = {name: (lambda n=name: run_gan(axis, n)) for name in CASES}
        cases.update(encoder=lambda: run_encoder(axis), bn=lambda: run_bn(axis),
                     wrong_pair=lambda: run_wrong_pair(axis), sample=lambda: run_sample(axis),
                     inception=lambda: run_inception(axis), trainer=lambda: run_trainer(axis, out),
                     refusals=lambda: refusals(axis))
        for name, fn in cases.items():
            try:
                torch.save(fn(), os.path.join(out, f"{name}.{axis.rank}.pt"))
            except Exception:  # noqa: BLE001 — written for the test to show, then raised: the rank exits
                with open(os.path.join(out, f"{name}.error.{axis.rank}.txt"), "w") as f:
                    f.write(traceback.format_exc())
                raise
    finally:
        parallel.destroy()


if __name__ == "__main__":
    main(sys.argv[1])
