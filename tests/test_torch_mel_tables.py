"""The constants that the log-mel kernels' FFT branch reads
(``ops/mel_kernel.py::fft_constants`` / ``fft_table``), held on the CPU in
numpy: the kernels themselves run only on a card (tests/test_torch_gpu.py).

The models here follow csrc/mel_common.cuh step by step, in float64 as the
kernels compute: window at t = 0..win-1, pack z[n] = x[2n] + i x[2n+1], an
n_fft/2-point complex FFT (np.fft.fft, or the kernels' mixed-radix Stockham
schedule with the table's twiddles), the split step with the table's
(A_k, B_k), the power, the sparse mel runs. Tolerances: 1e-9 of the largest
power (float64 rounding only), 1e-12·n_fft on the Stockham FFT against
np.fft.fft, and 1e-4 absolute on log-mel against the float32 plain version
(its own DFT rounding). One test runs the same model in complex64 to pin why
the kernels compute in float64."""

import numpy as np
import pytest
import torch

from s2i_tpu_torch.audio import filters
from s2i_tpu_torch.audio.frontend import FrontendParams, center_pad, preemphasize
from s2i_tpu_torch.ops import mel_kernel

GEOMETRIES = {
    "birds": dict(),  # win 400, hop 160, n_fft 512
    "hop33": dict(win_length=250, hop_length=33, n_fft=256),
    "short-window": dict(win_length=100, hop_length=50, n_fft=512),
}


def _rows(p: FrontendParams, n: int = 6, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, p.win_length))


def _split_power(z_fft: np.ndarray, split: np.ndarray) -> np.ndarray:
    """|A_k Z[k] + B_k conj(Z[M-k])|² for k = 0..M, Z along the last axis,
    from the table's A_k, k <= M/2: A_{M-k} = conj(A_k), B_k = 1 - A_k."""
    m = z_fft.shape[-1]
    k = np.arange(m + 1)
    a = np.concatenate([split, np.conj(split[::-1][1:])])
    assert a.shape == (m + 1,)
    x = a * z_fft[..., k % m] + (1 - a) * np.conj(z_fft[..., (m - k) % m])
    return np.abs(x) ** 2


def _packed(p: FrontendParams, frames: np.ndarray) -> np.ndarray:
    """z[n] = (w x)[2n] + i (w x)[2n+1], the windowed frame zero-padded to n_fft."""
    c = mel_kernel.fft_constants(p)
    x = np.zeros((frames.shape[0], p.n_fft))
    x[:, : p.win_length] = frames * c["window"]
    return x[:, 0::2] + 1j * x[:, 1::2]


@pytest.mark.parametrize("kw", GEOMETRIES.values(), ids=GEOMETRIES.keys())
def test_fft_formulation_matches_the_windowed_dft(kw):
    """Window placement, packing and the split factors: the kernels' real
    FFT gives the power of the windowed DFT tables (float64)."""
    p = FrontendParams(**kw)
    frames = _rows(p)
    got = _split_power(np.fft.fft(_packed(p, frames)), mel_kernel.fft_constants(p)["split"])
    cos, sin = filters.windowed_dft_matrices(p.win_length, p.n_fft)
    want = (frames @ cos) ** 2 + (frames @ sin) ** 2
    assert got.shape == want.shape == (len(frames), p.n_bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * want.max())
    # and the float32 tables the plain version multiplies by, to their rounding
    want32 = (frames @ p.dft_cos.astype(np.float64)) ** 2 + (frames @ p.dft_sin.astype(np.float64)) ** 2
    np.testing.assert_allclose(got, want32, rtol=0, atol=1e-6 * want.max())


def _stockham(z: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """mel_common.cuh's ``fft``: stage s of radix R after stages whose radices
    multiply to ns; butterfly j reads in[j + r·M/R], twiddles the r-th value
    by the stage's table at [(r-1)·ns + j mod ns] (tw: the stages' tables
    after the first, end to end), and writes its R-point DFT to
    out[(j - j mod ns)·R + j mod ns + r·ns]."""
    lead, m = z.shape[:-1], z.shape[-1]
    ns = 1
    for radix in mel_kernel.fft_radices(m):
        # v[..., r, q, k] = in[j + r·M/R], j = q·ns + k
        v = z.reshape(*lead, radix, m // (radix * ns), ns)
        if ns > 1:
            table = tw[: (radix - 1) * ns].reshape(radix - 1, 1, ns)
            v = v * np.concatenate([np.ones((1, 1, ns), table.dtype), table])
            tw = tw[(radix - 1) * ns:]
        v = np.fft.fft(v, axis=-3)  # the R-point DFT in registers
        # out[q·ns·R + r·ns + k] = v[..., r, q, k]
        z, ns = np.swapaxes(v, -3, -2).reshape(*lead, m), ns * radix
    assert tw.size == 0  # every twiddle used
    return z


@pytest.mark.parametrize("n_fft", mel_kernel.FFT_SIZES)
def test_stockham_schedule_with_the_table_twiddles_is_the_fft(n_fft):
    p = FrontendParams(win_length=n_fft // 2, hop_length=n_fft // 4, n_fft=n_fft)
    tw = mel_kernel.fft_constants(p)["tw"]
    z = np.random.default_rng(n_fft).standard_normal((2, n_fft // 2, 2)) @ np.array([1, 1j])
    np.testing.assert_allclose(_stockham(z, tw), np.fft.fft(z), rtol=0, atol=1e-12 * n_fft)


def _unpack(table: np.ndarray, p: FrontendParams) -> dict:
    """Read the packed byte table as the kernels do (header byte offsets)."""
    n, off_split, off_tw, off_window, off_mel_w, off_mel_idx = (int(v) for v in table[:24].view(np.int32))
    m = p.n_fft // 2
    region = lambda off, dtype, count: table[off:off + count * np.dtype(dtype).itemsize].view(dtype)  # noqa: E731
    idx = region(off_mel_idx, np.int32, 3 * p.n_mels).reshape(p.n_mels, 3)
    nnz = int((idx[:, 1] - idx[:, 0]).sum())
    return {
        "n": n, "offsets": (off_split, off_tw, off_window, off_mel_w, off_mel_idx),
        "split": region(off_split, np.complex128, m // 2 + 1),
        "tw": region(off_tw, np.complex128, (off_window - off_tw) // 16),
        "window": region(off_window, np.float64, -(-p.win_length // 2) * 2),
        "mel_w": region(off_mel_w, np.float32, nnz), "mel_idx": idx,
    }


@pytest.mark.parametrize("kw", GEOMETRIES.values(), ids=GEOMETRIES.keys())
def test_packed_table_holds_the_constants(kw):
    p = FrontendParams(**kw)
    table, c = mel_kernel.fft_table(p), mel_kernel.fft_constants(p)
    t = _unpack(table, p)
    assert table.dtype == np.uint8 and t["n"] == table.size and table.size % 16 == 0
    assert all(o % 16 == 0 for o in t["offsets"])
    assert t["offsets"][0] >= 24 and list(t["offsets"]) == sorted(t["offsets"])  # past the header, in order
    assert t["offsets"][-1] + 12 * p.n_mels <= table.size
    np.testing.assert_array_equal(t["split"], c["split"])
    np.testing.assert_array_equal(t["tw"], c["tw"])
    np.testing.assert_array_equal(t["window"][: p.win_length], c["window"])
    assert not t["window"][p.win_length:].any()  # zero past an odd window
    lo, hi, start = t["mel_idx"].T
    np.testing.assert_array_equal(lo, c["mel_lo"])
    np.testing.assert_array_equal(hi, c["mel_hi"])
    np.testing.assert_array_equal(start, np.concatenate([[0], np.cumsum(hi - lo)[:-1]]))
    for m in range(p.n_mels):
        np.testing.assert_array_equal(t["mel_w"][start[m]:start[m] + hi[m] - lo[m]], p.mel_fb[m, lo[m]:hi[m]])


@pytest.mark.parametrize(
    "kw",
    [*GEOMETRIES.values(), dict(win_length=250, hop_length=33, n_fft=256, n_mels=80, htk_mel=True)],
    ids=[*GEOMETRIES.keys(), "htk-empty-filters"],
)
def test_logmel_from_the_packed_table_matches_the_plain_version(kw):
    """The whole FFT branch read from the packed table, in float64 as the
    kernels compute it: window, pack, Stockham FFT, split, power, sparse mel
    runs, log, against logmel_framed_plain on the same frames."""
    p = FrontendParams(**kw)
    frames = np.random.default_rng(1).standard_normal((7, p.n_fft)).astype(np.float32)
    frames[3] = 0.0  # an all-zero row: every filter gives log(offset)
    t = _unpack(mel_kernel.fft_table(p), p)
    x = np.zeros((len(frames), p.n_fft))
    x[:, : p.win_length] = frames[:, : p.win_length] * t["window"][: p.win_length]
    power = _split_power(_stockham(x[:, 0::2] + 1j * x[:, 1::2], t["tw"]), t["split"])
    mel = np.stack([power[:, lo:hi] @ t["mel_w"][s:s + hi - lo] for lo, hi, s in t["mel_idx"]], axis=1)
    got = np.log(mel + p.log_offset)
    want = mel_kernel.logmel_framed_plain(torch.from_numpy(frames), p).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[3], np.full(p.n_mels, np.log(p.log_offset)))


@pytest.mark.parametrize(
    "kw,empty",
    [(dict(n_fft=512), False), (dict(n_fft=512, htk_mel=True), False),
     (dict(win_length=250, n_fft=256), False), (dict(win_length=250, n_fft=256, htk_mel=True), False),
     (dict(win_length=250, n_fft=256, n_mels=80, htk_mel=True, mel_norm="none"), True)],
    ids=["slaney-512", "htk-512", "slaney-256", "htk-256", "htk-256-80-mels"],
)
def test_mel_runs_cover_exactly_the_nonzeros(kw, empty):
    p = FrontendParams(**kw)
    lo, hi = mel_kernel.mel_runs(p.mel_fb)
    bins = np.arange(p.n_bins)[None, :]
    np.testing.assert_array_equal((bins >= lo[:, None]) & (bins < hi[:, None]), p.mel_fb != 0)
    assert (lo == hi).any() == empty  # HTK at n_fft 256 with 80 mels has empty filters


def test_branch_is_chosen_by_n_fft_only():
    for n_fft in (128, 256, 512, 1024, 2048):
        assert mel_kernel.kernel_branch(FrontendParams(win_length=100, hop_length=7, n_fft=n_fft)) == "fft"
    for n_fft in (400, 870, 4096):
        assert mel_kernel.kernel_branch(FrontendParams(win_length=100, n_fft=n_fft)) == "dft"
    # a CPU tensor takes the plain version and launches nothing
    p = FrontendParams()
    before = mel_kernel.logmel.launches, mel_kernel.logmel_frames.launches
    mel_kernel.logmel(torch.zeros(1, 1000), p, 2)
    mel_kernel.logmel_frames(torch.zeros(2, p.n_fft), p)
    assert (mel_kernel.logmel.launches, mel_kernel.logmel_frames.launches) == before


def _tones(n_samples: int, lens, seed: int) -> np.ndarray:
    """chip_smoke.py's tone_batch: tones plus a noise floor, zero past each
    utterance's length."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    wavs = np.zeros((len(lens), n_samples), np.float32)
    for i, n in enumerate(lens):
        x = 0.3 * np.sin(2 * np.pi * 180.0 * (i + 1) * t * (1 + 0.5 * t)) + 0.02 * rng.standard_normal(n_samples)
        wavs[i, :n] = x[:n]
    return wavs


def test_fft_formulation_needs_float64_at_the_hop40_geometry():
    """Why the kernels' window, FFT and split run in float64: on
    chip_smoke.py's hop-40 input (center pad, pre-emphasis 0.97, ragged),
    the FFT formulation computed in complex64 lands further from the float64
    arithmetic than the float32 plain version, and in float64 ten times
    closer. The split step cancels: a weak bin k is the difference of Z[k]
    and Z[M-k], whose rounding follows the strong mirrored bin, and the
    pre-emphasized frames have weak low bins mirroring boosted high ones.
    Both models keep the kernels' float32 power rows and mel sums."""
    p = FrontendParams(hop_length=40, center=True, preemphasis=0.97, max_frames=4096)
    wav = _tones(64000, [64000, 30011, 5000, 401, 64000, 12345, 777, 50000], 2)
    x = center_pad(preemphasize(torch.from_numpy(wav), p.preemphasis), p)
    n = mel_kernel.num_frames(x.shape[1], p)
    frames = x.unfold(-1, p.win_length, p.hop_length)[:, :n].reshape(-1, p.win_length).numpy()
    cos, sin = filters.windowed_dft_matrices(p.win_length, p.n_fft)
    f64 = frames.astype(np.float64)
    want = np.log(((f64 @ cos) ** 2 + (f64 @ sin) ** 2) @ p.mel_fb.astype(np.float64).T + p.log_offset)
    plain_err = np.abs(mel_kernel.logmel_plain(x, p, n).reshape(-1, p.n_mels).numpy() - want).max()
    c = mel_kernel.fft_constants(p)
    errs = {}
    for real, cplx in ((np.float32, np.complex64), (np.float64, np.complex128)):
        xw = np.zeros((len(frames), p.n_fft), real)
        xw[:, : p.win_length] = frames.astype(real) * c["window"].astype(real)
        z = _stockham((xw[:, 0::2] + 1j * xw[:, 1::2]).astype(cplx), c["tw"].astype(cplx))
        assert z.dtype == cplx
        power = _split_power(z, c["split"].astype(cplx)).astype(np.float32)
        errs[real] = np.abs(np.log((power @ p.mel_fb.T).astype(np.float64) + p.log_offset) - want).max()
    assert errs[np.float32] > plain_err > 10 * errs[np.float64], (errs, plain_err)
