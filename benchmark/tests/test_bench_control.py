"""The control (the reference computed in the next lower precision, put in
the program's place) comes out not correct under each cell's limits. The
readings that set the limits come from ``calibrate.py`` on the card at the
cells' own sizes; this holds the same comparison at tiny widths."""

from __future__ import annotations

from bench_tiny import tiny_cell  # noqa: F401  (the fixture)

import pytest
import torch

TRAINING = ["birds3-gan-b24", "joint-train-b24", "birds3-encoder-b64"]


@pytest.mark.parametrize("name", TRAINING)
def test_training_control_is_not_correct(tiny_cell, name):
    from harness import compare, spec

    cell = tiny_cell(name)
    task = spec.task(cell.traffic["task"]).Task(cell, torch.device("cpu"))
    task.setup()
    task.release()
    ref, ctl = task.reference(), task.reference(control=True)
    numbers = {k: v for k, (v, _) in compare.training_numbers(ctl, ref).items()}
    correct, checks = compare.judge(numbers, cell.limits)
    assert not correct, checks
