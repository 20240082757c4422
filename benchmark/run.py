"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (configuration, traffic mix, limits, metrics) is found by its
name in ``BENCHMARK.json``. The run needs a CUDA card (as many as the cell
asks for), makes its weights and inputs on the card from ``--seed``, warms
up, measures for ``--seconds``, checks what the timed path produced against
the plain reference in ``reference/`` and prints one JSON object as the
last line of standard output. ``--trace 1`` profiles the window and
reports the cell's per-layer metrics instead of its end-to-end ones.
Build and compile caches stay in fixed directories of the checkout.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
from harness import spec  # noqa: E402


def main() -> int:
    spec.use_checkout_caches()  # before torch is imported
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    cell = spec.cell(args.workload)
    cell.seed, cell.seconds, cell.trace = args.seed, args.seconds, bool(args.trace)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    from harness import runner

    return runner.run(cell, STARTED)


if __name__ == "__main__":
    sys.exit(main())
