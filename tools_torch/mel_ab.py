"""Same-call A/B of the log-mel kernels on one card: the port's K1 and K4
(``s2i_tpu_torch/ops/mel_kernel.py``, whose FFT branch takes the birds
geometry) against the dense windowed-DFT kernels that came before them
(``mel_fused.cu`` and ``mel_framed.cu`` of commit 6a4e413, C interface
``s2i_mel_fused`` / ``s2i_mel_framed``, fed by the same cos/sin/mel tables
as today's DFT branch). Run from the repo root on a card:

    python3 tools_torch/mel_ab.py --old-csrc DIR

DIR holds the earlier sources (``git archive 6a4e413 s2i_tpu_torch/csrc``);
they are built with the port's nvcc flags into a temporary directory. Cases
at the birds geometry (win 400, hop 160, n_fft 512, 40 mels): K1 on B = 8,
24 and 64 full-length seeded wavs (1024 frames each), K4 on the frame rows
of the A/B wav (8 × 64 000, 3 184 rows) and of the B = 8 wavs (8 192 rows).
Each case checks that the versions agree within 1e-4 and times them in
turns (earlier, current, current, earlier), each a CUDA-event mean of 20
calls queued behind a device sleep (a call is shorter than its host
overhead). Prints one line per case and a JSON line of every number.
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

from s2i_tpu_torch.audio.frontend import FrontendParams  # noqa: E402
from s2i_tpu_torch.device import resolve_device  # noqa: E402
from s2i_tpu_torch.ops import build, mel_kernel  # noqa: E402

TOL = 1e-4
ARGS = {  # the earlier entry points' arguments
    "mel_fused": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
    "mel_framed": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
}


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # the host queues every call before the first starts
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
             for n in ARGS}
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the earlier {n}.cu:\n{log}")
        libs[n] = ctypes.CDLL(str(out / f"lib{n}_old.so"))
        getattr(libs[n], f"s2i_{n}").argtypes = ARGS[n]
    return libs


def old_fused(lib, wav: torch.Tensor, p: FrontendParams, n_frames: int) -> torch.Tensor:
    cos, sin, mel_t = mel_kernel._tables(p, wav.device)
    out = torch.empty(wav.shape[0], n_frames, p.n_mels, device=wav.device)
    err = lib.s2i_mel_fused(wav.data_ptr(), wav.shape[0], wav.shape[1], cos.data_ptr(), sin.data_ptr(),
                            mel_t.data_ptr(), out.data_ptr(), n_frames, p.hop_length, cos.shape[0], p.n_bins,
                            p.n_mels, p.log_offset, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier mel_fused: error {err}")
    return out


def old_framed(lib, rows: torch.Tensor, p: FrontendParams) -> torch.Tensor:
    cos, sin, mel_t = mel_kernel._tables(p, rows.device)
    out = torch.empty(rows.shape[0], p.n_mels, device=rows.device)
    err = lib.s2i_mel_framed(rows.data_ptr(), rows.shape[0], rows.shape[1], cos.data_ptr(), sin.data_ptr(),
                             mel_t.data_ptr(), out.data_ptr(), cos.shape[0], p.n_bins, p.n_mels, p.log_offset,
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier mel_framed: error {err}")
    return out


def compare(name: str, old, new) -> dict:
    err = (old() - new()).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"{name}: the versions disagree by {err} > {TOL}")
    times = [time_ms(old), time_ms(new), time_ms(new), time_ms(old)]
    return {"case": name, "max_abs_err": err, "earlier_ms": [times[0], times[3]], "ms": [times[1], times[2]],
            "branch": mel_kernel.logmel.branch if name.startswith("K1") else mel_kernel.logmel_frames.branch}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", type=Path, required=True)
    args = ap.parse_args()
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[mel_ab] {smi}", flush=True)
    p = FrontendParams()
    build.build_all(list(ARGS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    wav = 0.1 * torch.randn(64, p.max_samples, generator=gen, device="cuda")
    ab = torch.randn(8, 64000, generator=gen, device="cuda")  # scripts/perf_cert.py::cert_mel's shape
    recs = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_old(args.old_csrc, Path(tmp))
        for b in (8, 24, 64):
            x = wav[:b].contiguous()
            recs.append(compare(f"K1 B={b}", lambda: old_fused(libs["mel_fused"], x, p, p.max_frames),
                                lambda: mel_kernel.logmel(x, p, p.max_frames)))
            print("[mel_ab] " + json.dumps(recs[-1]), flush=True)
        for name, w in (("K4 A/B 8x64000", ab), ("K4 birds serve B=8", wav[:8])):
            rows = mel_kernel.frame_rows(w, p, mel_kernel.num_frames(w.shape[1], p))
            recs.append(compare(f"{name} rows={rows.shape[0]}", lambda: old_framed(libs["mel_framed"], rows, p),
                                lambda: mel_kernel.logmel_frames(rows, p)))
            print("[mel_ab] " + json.dumps(recs[-1]), flush=True)
    print(json.dumps({"card": smi, "cases": recs}))


if __name__ == "__main__":
    main()
