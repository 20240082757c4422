"""The tiny-width cells and the ``tiny_cell`` fixture that the benchmark's
own tests share. They run on the CPU, where the program's plain versions
stand in for its kernels; nothing here is a measurement."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def tiny(cell, dtype: str = "float32", batch: int = 4):
    """``cell`` cut to tiny widths for a CPU test (never a measurement)."""
    c = cell.config["cfg"]
    c["GAN"].update(GF_DIM=4, DF_DIM=4, Z_DIM=8, EMBEDDING_DIM=8)
    c["TEXT"]["DIMENSION"] = 16
    c["TREE"]["BRANCH_NUM"] = 2
    c["AUDIO"].update(N_MELS=8, MAX_FRAMES=32)
    c["ENCODER"].update(CONV_CHANNELS=[4, 8, 8], RNN_HIDDEN=8, N_CLASSES=5)
    c["DTYPE"]["COMPUTE"] = dtype
    cell.traffic.update(batch=batch, pool_batches=3)
    if "wav_samples" in cell.traffic:
        cell.traffic["wav_samples"] = [1000, 6000]
    cell.seed, cell.seconds = 2**31 + 12345, 0.5
    return cell


@pytest.fixture
def tiny_cell():
    import torch

    from harness import spec

    torch.set_num_threads(1)
    return lambda name, dtype="float32": tiny(spec.cell(name), dtype)
