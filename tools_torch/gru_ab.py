"""Same-call A/B of the GRU kernels on one card: the port's K2/K3
(``s2i_tpu_torch/ops/gru_kernel.py``, both directions of a layer in one
launch) against the one-direction version of ``gru_fwd.cu``/``gru_bwd.cu``
that came before them (one launch per direction; its C interface is the one
of commit e0cfc07: ``s2i_gru_fwd_max_batch``, a 12-argument
``s2i_gru_fwd``, a 3-int ``s2i_gru_bwd_workspace``), and against
``torch.nn.GRU(bidirectional=True)``. Run from the repo root on a card:

    python3 tools_torch/gru_ab.py --old-csrc DIR [--batches 8,24,64]

DIR holds the earlier ``gru_fwd.cu`` and ``gru_bwd.cu`` (``git archive
e0cfc07 s2i_tpu_torch/csrc``); they are built with the port's nvcc flags
into a temporary directory. Every case runs the versions in turns (earlier,
current, current, earlier) on the same seeded inputs at T=128, H=512, D=2,
and checks that they agree; each time is a CUDA-event mean over 20 calls.
The earlier version is timed on its kernels alone: the flips of the
reverse direction's inputs that its caller made are left out. Prints one
line per case and a JSON line of every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from s2i_tpu_torch.device import resolve_device  # noqa: E402
from s2i_tpu_torch.ops import build, gru_kernel  # noqa: E402

T, H, C_IN = 128, 512, 256


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_old(csrc: Path, out: Path) -> dict[str, ctypes.CDLL]:
    nvcc = build._nvcc()
    procs = {n: subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", str(out / f"lib{n}_old.so"), str(csrc / f"{n}.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n in ("gru_fwd", "gru_bwd")}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for the earlier {n}.cu:\n{log}")
        libs[n] = ctypes.CDLL(str(out / f"lib{n}_old.so"))
    f, b = libs["gru_fwd"], libs["gru_bwd"]
    f.s2i_gru_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    f.s2i_gru_fwd_max_batch.argtypes = [ctypes.c_int, ctypes.c_int]
    b.s2i_gru_bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    b.s2i_gru_bwd_workspace.argtypes = [ctypes.c_int] * 3
    b.s2i_gru_bwd_workspace.restype = ctypes.c_long
    return libs


def old_fwd(lib, xw, w_h, b_h, mask, h0, ys):
    """One direction through the earlier K2: [T, B, ...] in, ys [T, B, H] filled."""
    t, b, _ = xw.shape
    units = -(-H // torch.cuda.get_device_properties(0).multi_processor_count)
    if lib.s2i_gru_fwd_max_batch(H, units) < b:
        raise ValueError("the earlier K2 takes this batch only in row chunks")
    barrier = torch.zeros(2, dtype=torch.int32, device="cuda")
    err = lib.s2i_gru_fwd(xw.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), mask.data_ptr(), h0.data_ptr(),
                          ys.data_ptr(), barrier.data_ptr(), t, b, H, units, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier gru_fwd: error {err}")


def old_bwd(lib, xw, w_h, b_h, mask, h0, ys, dys, out):
    t, b, _ = xw.shape
    workspace = torch.empty(lib.s2i_gru_bwd_workspace(t, b, H), device="cuda")
    barrier = torch.empty(b, dtype=torch.int32, device="cuda")
    err = lib.s2i_gru_bwd(*(x.data_ptr() for x in (xw, w_h, b_h, mask, h0, ys, dys, *out, workspace, barrier)),
                          t, b, H, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier gru_bwd: error {err}")


def inputs(b: int, seed: int = 0) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s, scale=1.0: scale * torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    lens = torch.randint(1, T + 1, (b,), generator=gen, device="cuda")
    lens[0], lens[-1] = T, 0
    g = dict(xw=rnd(2, T, b, 3 * H), w_h=rnd(2, H, 3 * H, scale=H ** -0.5), b_h=rnd(2, 3 * H, scale=0.1),
             mask=(torch.arange(T, device="cuda")[:, None] < lens[None, :]).float(), h0=rnd(2, b, H, scale=0.5))
    g["dys"] = rnd(2, T, b, H)
    return g


def one_direction(g: dict, d: int) -> dict:
    """Direction d as the earlier caller gave it: [T, B, ...], flipped in time for d = 1."""
    f = (lambda x: x.flip(0).contiguous()) if d else (lambda x: x.contiguous())  # noqa: E731
    return dict(xw=f(g["xw"][d]), w_h=g["w_h"][d].contiguous(), b_h=g["b_h"][d].contiguous(), mask=f(g["mask"]),
                h0=g["h0"][d].contiguous())


def case(libs, b: int) -> dict:
    g = inputs(b)
    args = {k: g[k] for k in ("xw", "w_h", "b_h", "mask", "h0")}
    dirs = [one_direction(g, d) for d in (0, 1)]
    ys_old = [torch.empty(T, b, H, device="cuda") for _ in dirs]
    run_old_fwd = lambda: [old_fwd(libs["gru_fwd"], **a, ys=y) for a, y in zip(dirs, ys_old)]  # noqa: E731
    run_new_fwd = lambda: gru_kernel.gru_scan(**args)  # noqa: E731
    ys = run_new_fwd()
    run_old_fwd()
    torch.cuda.synchronize()
    fwd_err = max((ys[0] - ys_old[0]).abs().max().item(), (ys[1] - ys_old[1].flip(0)).abs().max().item())

    dys_old = [g["dys"][0].contiguous(), g["dys"][1].flip(0).contiguous()]
    ys_dirs = [ys[0].contiguous(), ys[1].flip(0).contiguous()]
    outs_old = [[torch.empty_like(a[k]) for k in ("xw", "w_h", "b_h", "h0")] for a in dirs]
    run_old_bwd = lambda: [old_bwd(libs["gru_bwd"], **a, ys=y, dys=dy, out=o)  # noqa: E731
                           for a, y, dy, o in zip(dirs, ys_dirs, dys_old, outs_old)]
    run_new_bwd = lambda: gru_kernel.gru_scan_bwd(**args, ys=ys, dys=g["dys"])  # noqa: E731
    new = run_new_bwd()
    run_old_bwd()
    torch.cuda.synchronize()
    bwd_err = 0.0
    for i, name in enumerate(("dxw", "dw_h", "db_h", "dh0")):
        want = torch.stack([outs_old[0][i], outs_old[1][i].flip(0) if name == "dxw" else outs_old[1][i]])
        bwd_err = max(bwd_err, (new[i] - want).abs().max().item() / max(1.0, want.abs().max().item()))

    rec = {"B": b, "fwd_err_vs_earlier": fwd_err, "bwd_relerr_vs_earlier": bwd_err}
    for kind, old, cur in (("fwd", run_old_fwd, run_new_fwd), ("bwd", run_old_bwd, run_new_bwd)):
        times = [time_ms(old), time_ms(cur), time_ms(cur), time_ms(old)]
        rec[f"{kind}_earlier_ms"] = [times[0], times[3]]
        rec[f"{kind}_ms"] = [times[1], times[2]]
        rec[f"{kind}_plan"] = list(gru_kernel._plan(kind, 2, b, H, 0)[1])

    parts = []
    for _ in range(5):
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        gru_kernel.gru_scan_bwd(**args, ys=ys, dys=g["dys"], events=evs)
        torch.cuda.synchronize()
        parts.append([evs[i].elapsed_time(evs[i + 1]) for i in range(3)])
    rec["bwd_parts_ms"] = sorted(parts)[2]  # gate SGEMM, chain, dW_h + db_h: the run of median gate time

    ref = torch.nn.GRU(C_IN, H, bidirectional=True).cuda()
    x = torch.randn(T, b, C_IN, device="cuda")
    with torch.no_grad():
        rec["cudnn_bidirectional_fwd_ms"] = time_ms(lambda: ref(x))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", type=Path, required=True)
    ap.add_argument("--batches", default="8,24,64")
    args = ap.parse_args()
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[gru_ab] {smi}", flush=True)
    batches = [int(v) for v in args.batches.split(",")]
    build.build_all(["gru_fwd", "gru_bwd"])
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_old(args.old_csrc, Path(tmp))
        recs = []
        for b in batches:
            rec = case(libs, b)
            recs.append(rec)
            print("[gru_ab] " + " ".join(f"{k}={v}" for k, v in rec.items()), flush=True)
    print(json.dumps({"card": smi, "T": T, "H": H, "D": 2, "cases": recs}))


if __name__ == "__main__":
    main()
