"""Readings that the limits in ``limits/<workload>.json`` are set from, at
the cell's own size, on a card:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... [--control-seeds 1,2,3]

For each seed, in one process: the program's numbers (a sound run), and
on the control seeds the control's (the reference in the next lower
precision put in the program's place, ``reference/precision.py``) and
each fault's that the cell can have ("half": half of the batch left out;
and "unchanged", which reads 1 by the change measure and needs no run).
One JSON line per reading; nothing is timed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
from harness import spec  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def training(cell, dev, seed, control: bool):
    from harness.compare import training_numbers

    task_mod = __import__(f"tasks.{cell.traffic['task']}", fromlist=["Task"])
    cell.seed = seed
    t = task_mod.Task(cell, dev)
    t.setup()
    t.release()
    ref = t.reference()
    emit(seed=seed, kind="program", **{k: v for k, (v, _) in training_numbers(t.prog, ref).items()},
         where={k: w for k, (_, w) in training_numbers(t.prog, ref).items()})
    if not control:
        return
    ctl = t.reference(control=True)
    emit(seed=seed, kind="control", **{k: v for k, (v, _) in training_numbers(ctl, ref).items()})
    h = task_mod.Task(cell, dev, fault="half")
    h.setup()
    h.release()
    emit(seed=seed, kind="half", **{k: v for k, (v, _) in training_numbers(h.prog, ref).items()})


def main() -> int:
    spec.use_checkout_caches()  # before torch is imported
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    from s2i_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    cell = spec.cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        training(cell, dev, seed, seed in controls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
