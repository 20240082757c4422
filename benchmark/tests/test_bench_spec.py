"""``BENCHMARK.json`` and the files it names: names and units, every
configuration used, every per-layer metric beside the end-to-end metric it
moves, a file for every name, and nothing of JAX or the JAX package (the
reference: nothing of the program either) among the modules loaded."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_names_and_units():
    names = [m["name"] for m in METRICS] + [w["name"] for w in SPEC["workloads"]] + \
        [c["name"] for c in SPEC["configs"]] + [w["traffic"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert all(m["name"].endswith(".gan") or "_roofline" not in m["name"] or m["unit"] == "%" for m in METRICS)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_configuration_has_a_cell_and_every_cell_its_metrics():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        own_e2e = [m for m in SPEC["end_to_end"] if reports(m, w["name"])]
        assert len(own_e2e) >= 2
        own_layer = [m for m in SPEC["per_layer"] if reports(m, w["name"])]
        assert own_layer
        for m in own_layer:
            assert reports(e2e[m["moves"]], w["name"]), (m["name"], w["name"])


def test_every_name_has_its_file():
    for c in SPEC["configs"]:
        assert json.loads((BENCH.parent / c["file"]).read_text())["name"] == c["name"]
    for w in SPEC["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "tasks" / f"{traffic['task']}.py").exists()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert limits
    sys.path[:0] = [str(BENCH), str(BENCH.parent)]
    from harness import spec

    for m in SPEC["per_layer"]:
        assert hasattr(spec.metric_reader(m["name"]), "read")


def loaded_modules(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         cwd=BENCH.parent, capture_output=True, text=True, check=True, timeout=300)
    return {m.split(".", 1)[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


PATHS = f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]\n"


def test_the_harness_loads_no_jax():
    code = PATHS + "\n".join([
        "from harness import runner, spec",
        "import tasks.train_gan, tasks.train_encoder",
        "from s2i_tpu_torch.train import gan, encoder",
        "import s2i_tpu_torch.audio.frontend",
        "for m in spec.load_json(spec.CHECKOUT / 'BENCHMARK.json')['per_layer']: spec.metric_reader(m['name'])",
        "import roofline.k1_logmel, roofline.k2_gru_fwd, roofline.k3_gru_bwd, roofline.stackgan",
        "import reference.train, calibrate",
    ])
    top = loaded_modules(code)
    assert "s2i_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "s2i_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    code = PATHS + "import reference.audio, reference.models, reference.train, reference.precision\n" \
        "import roofline.k1_logmel, roofline.k2_gru_fwd, roofline.k3_gru_bwd, roofline.stackgan, harness.weights"
    top = loaded_modules(code)
    assert not top & {"jax", "jaxlib", "flax", "s2i_tpu", "s2i_tpu_torch"}


@pytest.mark.parametrize("name", ["jax.numpy", "s2i_tpu", "flax.linen"])
def test_forbidden_names_are_whole_top_level_names(name):
    sys.path[:0] = [str(BENCH), str(BENCH.parent)]
    from harness import runner

    saved = dict(sys.modules)
    try:
        sys.modules[name] = object()
        assert name in runner.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
    sys.modules["s2i_tpu_torch_x"] = object()
    try:
        assert "s2i_tpu_torch_x" not in runner.forbidden_modules()
    finally:
        del sys.modules["s2i_tpu_torch_x"]
