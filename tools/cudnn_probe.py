"""Where the card's first GAN step differs from the CPU's: cuDNN's
convolution algorithms, the BN variance formula, or the step itself (two
float32 runs on the CPU that differ only in their convolution code).

    python3 tools/cudnn_probe.py [--cfg cfg/birds_3stages.yml] [--batch 4]
                                 [--settings card,card_no_cudnn,...]

Runs the first step of ``chip_smoke.py``'s check (the cfg at full width,
seeded weights, batch and noise) on the CPU as the reference, then once per
setting, each in a fresh process (PyTorch caches a convolution's cuDNN plan
per shape for the life of the process). A setting picks the device, cuDNN's
switches, oneDNN on the CPU, and the train-mode BN variance: Flax's
``E[x²] - E[x]²`` (the port's) or two-pass ``E[(x - E[x])²]`` (the same
statistic with another rounding; the reference then uses it too). For each
setting it prints the gradients' error against the reference (per network,
median and worst tensors), the losses' and BN statistics' worst error, the
step time at batch 24, the flags as PyTorch reads them back, and the step's
longest device kernels (torch.profiler), whose names say which algorithm
cuDNN ran. The full kernel lists go to
``<--out-dir>/cudnn_probe_b<batch>_<setting>.txt``. With ``--kinks`` it
also lists the LeakyReLU inputs whose sign differs from the reference's
(the slope there is 1 in one run and 0.2 in the other).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from s2i_tpu_torch import cli  # noqa: E402
from s2i_tpu_torch.models.layers import BatchNorm  # noqa: E402
from s2i_tpu_torch.train import gan  # noqa: E402

# setting → (device, cuDNN switches on top of resolve_device's TF32 off,
#            oneDNN enabled, BN variance)
SETTINGS = {
    "card": ("cuda", {}, True, "fast"),
    "card_deterministic": ("cuda", {"deterministic": True}, True, "fast"),
    "card_benchmark": ("cuda", {"benchmark": True}, True, "fast"),
    "card_no_cudnn": ("cuda", {"enabled": False}, True, "fast"),
    "card_two_pass": ("cuda", {}, True, "two_pass"),
    "card_two_pass_no_cudnn": ("cuda", {"enabled": False}, True, "two_pass"),
    "cpu_no_onednn": ("cpu", {}, False, "fast"),
    "cpu_two_pass_no_onednn": ("cpu", {}, False, "two_pass"),
}
TIMED_STEPS = 5


def use_two_pass_variance() -> None:
    """Train-mode BN with the variance in two passes, for this process."""
    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = [0, *range(2, x.ndim)]
            mean = x.mean(dims)
            var = (x - mean.view(shape)).square().mean(dims)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)

    BatchNorm.forward = forward


KINKS: list = []  # (module, input) of every LeakyReLU call, in call order


@contextlib.contextmanager
def kinks_recorded():
    """Keep the input of every LeakyReLU call inside the block in KINKS."""
    forward = torch.nn.LeakyReLU.forward

    def logged(self, x):
        KINKS.append((self, x.detach().cpu()))
        return forward(self, x)

    torch.nn.LeakyReLU.forward = logged
    try:
        yield
    finally:
        torch.nn.LeakyReLU.forward = forward


def kink_record(st: gan.GanTrainState) -> list[tuple[str, torch.Tensor, torch.Tensor]]:
    """(module name, sign mask, |input| / input std) per LeakyReLU call."""
    names = {id(m): f"{part}.{n}" for part, mod in smoke.step_modules(st).items()
             for n, m in mod.named_modules()}
    return [(names.get(id(m), "?"), x > 0, x.abs() / x.std()) for m, x in KINKS]


def kink_flips(got: list, want: list) -> list[tuple[int, str, int, int, float]]:
    """(call, module, flipped elements, elements, largest |input| / std of
    a flipped one) for each LeakyReLU call whose input signs differ."""
    out = []
    for i, ((name, mg, _), (_, mw, aw)) in enumerate(zip(got, want)):
        flips = mg != mw
        if flips.any():
            out.append((i, name, int(flips.sum()), flips.numel(), aw[flips].max().item()))
    return out


def flags() -> dict:
    b = torch.backends
    out = {"cudnn.enabled": b.cudnn.enabled, "cudnn.benchmark": b.cudnn.benchmark,
           "cudnn.deterministic": b.cudnn.deterministic, "cudnn.allow_tf32": b.cudnn.allow_tf32,
           "matmul.allow_tf32": b.cuda.matmul.allow_tf32, "mkldnn.enabled": b.mkldnn.enabled}
    for name, obj in (("cudnn.conv.fp32_precision", getattr(b.cudnn, "conv", None)),
                      ("matmul.fp32_precision", b.cuda.matmul)):
        if obj is not None and hasattr(obj, "fp32_precision"):
            out[name] = obj.fp32_precision
    return out


def kernel_table(prof) -> list[tuple[str, int, float]]:
    """(kernel name, calls, device ms) of every device event, largest first."""
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, e.count, getattr(e, "device_time_total", 0.0) / 1e3))
    return sorted(rows, key=lambda r: -r[2])


def reference(cfg_path: str, batch: int, bn: str, kinks: bool, out: str) -> None:
    """The CPU's first step with oneDNN, saved to ``out``."""
    if bn == "two_pass":
        use_two_pass_variance()
    cfg, raw, z, eps = smoke.first_step_inputs(cfg_path, batch)
    with kinks_recorded() if kinks else contextlib.nullcontext():
        st, rec = smoke.first_step(cfg, raw, z, eps, "cpu")
    if kinks:
        rec["kinks"] = kink_record(st)
    torch.save(rec, out)


def run_setting(name: str, cfg_path: str, batch: int, ref_path: str, kinks: bool, out_dir: str) -> None:
    dev, cudnn, onednn, bn = SETTINGS[name]
    torch.backends.cudnn.enabled = cudnn.get("enabled", True)
    torch.backends.cudnn.benchmark = cudnn.get("benchmark", False)
    torch.backends.cudnn.deterministic = cudnn.get("deterministic", False)
    torch.backends.mkldnn.enabled = onednn
    if bn == "two_pass":
        use_two_pass_variance()
    ref = torch.load(ref_path)
    cfg, raw, z, eps = smoke.first_step_inputs(cfg_path, batch)
    kernels, step_ms = [], None
    recording = kinks_recorded() if kinks else contextlib.nullcontext()
    if dev == "cuda":
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof, recording:
            st, rec = smoke.first_step(cfg, raw, z, eps, dev)
            torch.cuda.synchronize()
        kernels = kernel_table(prof)
        # the step time at batch GAN_BATCH, from the seeded init
        cfg24 = smoke.gan_cfg(cfg_path, smoke.GAN_BATCH)
        st24 = gan.init_state(cfg24, device="cuda")
        stream = itertools.cycle(list(cli.synthetic_gan_batches(cfg24)(1))[:4])
        times = []
        for i in range(2 + TIMED_STEPS):
            t0 = time.perf_counter()
            gan.train_step(st24, next(stream))
            torch.cuda.synchronize()
            if i >= 2:
                times.append(1e3 * (time.perf_counter() - t0))
        step_ms = {"median": float(np.median(times)), "min": min(times), "max": max(times)}
    else:
        with recording:
            st, rec = smoke.first_step(cfg, raw, z, eps, dev)
    e = smoke.step_errors(rec, ref)
    if kinks:
        flips = kink_flips(kink_record(st), ref["kinks"])
        print(f"[b{batch} {name}] LeakyReLU inputs of another sign than the reference's: "
              f"{sum(f[2] for f in flips)} elements in {len(flips)} of {len(ref['kinks'])} calls", flush=True)
        for call, mod, n, total, far in flips:
            print(f"[b{batch} {name}]   call {call:3d} {mod}: {n} of {total}, the farthest from 0 at "
                  f"{far:.3g} of the input's std", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"cudnn_probe_b{batch}_{name}.txt"), "w") as f:
        for k, n, ms in kernels:
            f.write(f"{ms:10.3f} ms {n:5d}x {k}\n")
    print(json.dumps({
        "batch": batch, "setting": name, "bn": bn, "flags": flags(), "net": e["net"],
        "median_tensor": float(np.median(list(e["tensor"].values()))),
        "worst_tensors": sorted(e["tensor"].items(), key=lambda kv: -kv[1])[:6], "zero_grads": e["zero"],
        "worst_loss": max(e["loss"].values()), "worst_stat": max(e["stats"].values()),
        "step_ms_batch24": step_ms,
    }), flush=True)
    for k, n, ms in kernels[:12]:
        print(f"[b{batch} {name}] {ms:9.3f} ms {n:4d}x {k[:160]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default="cfg/birds_3stages.yml")
    ap.add_argument("--batch", type=int, default=smoke.CHECK_BATCH)
    ap.add_argument("--settings", default=",".join(SETTINGS))
    ap.add_argument("--kinks", action="store_true", help="also compare the signs of every LeakyReLU input")
    ap.add_argument("--out-dir", default="output/cudnn_probe", help="where the kernel lists go")
    ap.add_argument("--setting", choices=list(SETTINGS))
    ap.add_argument("--ref")
    args = ap.parse_args()
    if args.setting:
        run_setting(args.setting, args.cfg, args.batch, args.ref, args.kinks, args.out_dir)
        return
    if not torch.cuda.is_available():
        raise SystemExit("cudnn_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    names = args.settings.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        refs = {}
        for bn in sorted({SETTINGS[n][3] for n in names}):
            # the reference: the CPU with oneDNN, in its own process (the BN
            # patch lasts for the life of a process)
            refs[bn] = os.path.join(tmp, f"ref_{bn}.pt")
            t0 = time.time()
            code = (f"from tools import cudnn_probe as p; "
                    f"p.reference({args.cfg!r}, {args.batch}, {bn!r}, {args.kinks}, {refs[bn]!r})")
            subprocess.run([sys.executable, "-c", code], check=True, timeout=1800, cwd=ROOT)
            print(f"CPU reference (BN variance {bn}) at batch {args.batch} in {time.time() - t0:.1f} s", flush=True)
        for name in names:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--cfg", args.cfg, "--batch",
                            str(args.batch), "--setting", name, "--ref", refs[SETTINGS[name][3]],
                            "--out-dir", os.path.abspath(args.out_dir)]
                           + ["--kinks"] * args.kinks, check=True, timeout=1800, cwd=ROOT)


if __name__ == "__main__":
    main()
