"""The cell's files, found by the names in ``BENCHMARK.json``:
``configs/<config>.json`` (the configuration as run), ``traffic/<traffic>.json``
(the mix's parameters, read by ``harness.feed`` and the task it names),
``limits/<workload>.json`` (the limit of each number compared),
``metrics/<metric>.py`` or ``metrics/<metric up to its first dot>.py`` (a
per-layer metric's reader) and ``tasks/<task>.py`` (the code that drives the
program's entry that the traffic names)."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the benchmark's folder
CHECKOUT = ROOT.parent


def use_checkout_caches() -> None:
    """Point every compile cache a run could fill at a fixed folder of the
    checkout (before torch is imported), and keep the process to one OpenMP
    thread. The port's nvcc builds already land in the checkout
    (``s2i_tpu_torch/_build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(ROOT / ".cache" / sub)
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):  # one process, few threads: steadier host timing
        os.environ.setdefault(var, "1")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    fault: str | None = None  # planted in the timed path by the harness's own tests only

    @property
    def cfg(self) -> dict:
        return self.config["cfg"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_json(CHECKOUT / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(CHECKOUT / conf["file"]),
        traffic=load_json(ROOT / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(ROOT / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(metric: str):
    """``metrics/<metric>.py``, else ``metrics/<metric's first part>.py``
    (one reader for ``k1_roofline.gan``, ``k1_roofline.encoder``, ...)."""
    for stem in (metric, metric.split(".", 1)[0]):
        path = ROOT / "metrics" / f"{stem}.py"
        if path.exists():
            return load_module(path, "bench_metric_" + stem.replace(".", "_").replace("-", "_"))
    raise FileNotFoundError(f"no reader for metric {metric!r} under metrics/")


def roofline(name: str):
    return importlib.import_module(f"roofline.{name}")


def task(name: str):
    return importlib.import_module(f"tasks.{name}")


def peaks() -> dict:
    return load_json(ROOT / "roofline" / "peaks.json")
