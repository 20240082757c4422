"""The frozen reference against the program's plain CPU paths, in float32 at
tiny widths: the same seeded weights, inputs and noise give the same first
three training steps, from a state that the program's own ``init_state`` /
``init_encoder_state`` built."""

from __future__ import annotations

from bench_tiny import tiny_cell  # noqa: F401  (the fixture)

import pytest
import torch

TRAINING = ["birds3-gan-b24", "joint-train-b24", "birds3-encoder-b64"]


@pytest.mark.parametrize("name", TRAINING)
def test_training_steps_match_the_program(tiny_cell, monkeypatch, name):
    from harness.compare import training_numbers
    from harness import spec
    from s2i_tpu_torch.train import encoder, gan

    built = []
    for mod, fn in ((gan, "init_state"), (encoder, "init_encoder_state")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _orig=orig, _fn=fn, **k: built.append(_fn) or _orig(*a, **k))
    cell = tiny_cell(name)
    task = spec.task(cell.traffic["task"]).Task(cell, torch.device("cpu"))
    task.setup()
    assert built == ["init_encoder_state" if name == "birds3-encoder-b64" else "init_state"]
    task.release()
    got = training_numbers(task.prog, task.reference())
    for number, (value, where) in got.items():
        assert value < 1e-4, (number, value, where)
