"""A whole run of each cell on the CPU, the look for a card skipped: sound, it
comes out correct; with the timed path broken underneath, not correct."""

from __future__ import annotations

from bench_tiny import tiny_cell  # noqa: F401  (the fixture)

import json
import time

import pytest

CASES = [("birds3-gan-b24", None, True), ("birds3-gan-b24", "unchanged", False), ("birds3-gan-b24", "half", False),
         ("joint-train-b24", None, True), ("joint-train-b24", "unchanged", False), ("joint-train-b24", "half", False),
         ("birds3-encoder-b64", None, True), ("birds3-encoder-b64", "unchanged", False),
         ("birds3-encoder-b64", "half", False)]


@pytest.mark.parametrize("name,fault,correct", CASES)
def test_run_judges_the_timed_path(tiny_cell, capsys, name, fault, correct):
    from harness import runner

    cell = tiny_cell(name)
    cell.fault = fault
    assert runner.run(cell, time.perf_counter(), device="cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is correct, line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(cell.limits)
