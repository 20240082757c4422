"""The numbers that decide ``correct``, and their limits.

Training cells compare the program's first three steps with the
reference's, from the same seeded weights, inputs and noise:
  * ``loss1_gap``: the relative gap |p - r| / |r| of the first step's losses
    (before any update); ``loss_gap``: the largest over the three steps;
  * ``grad_gap``: the first gradient, as the optimizer got it (the program's
    worked out from Adam's first moment after one step, m₁ / (1 - β₁)),
    by the worst leaf: |‖g_p‖ - ‖g_r‖| / max(‖g_r‖, the median leaf's ‖g_r‖);
    ``grad_median_gap``: the median leaf's |‖g_p‖ - ‖g_r‖| / ‖g_r‖;
  * ``change_gap``: ‖W₃ - W₀‖ of each leaf after three steps (the EMA copy
    included), by the worst leaf, measured the same way;
    ``change_median_gap``: the median leaf's.
Leaves whose reference gradient is under a thousandth of the median leaf's
move under Adam by round-off alone and are left out of the leaf gaps.

A cell compares the numbers that its ``limits/<workload>.json`` names; the
others are readings for the calibration (``calibrate.py``).
"""

from __future__ import annotations

import math
import statistics

SMALL_GRAD = 1e-3


def included(ref_grad: dict[str, float]) -> set[str]:
    med = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v >= SMALL_GRAD * med}


def leaf_gap(prog: dict[str, float], ref: dict[str, float], keep: set[str]) -> tuple[float, str]:
    keys = [k for k in ref if k in keep]
    med = statistics.median(ref[k] for k in keys)
    worst = max(keys, key=lambda k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med, 1e-30), worst


def grad_leaf(name: str) -> str:
    """The leaf whose gradient decides whether ``name`` counts (the EMA copy
    of a G leaf follows that leaf)."""
    return "g." + name[4:] if name.startswith("ema.") else name


def training_numbers(prog: dict, ref: dict) -> dict[str, tuple[float, str]]:
    """``prog`` / ``ref``: {"losses": [{kind: value} per step], "grad": {leaf:
    norm}, "change": {leaf: norm}} → {number: (value, where)}. Besides the
    worst-leaf gaps: ``loss1_gap`` (the first step's losses, before any
    update), ``loss_gap`` (every step's), and the median leaf's gaps."""
    per_step = []
    for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"])):
        k = max(r, key=lambda k: abs(p[k] - r[k]) / max(abs(r[k]), 1e-30))
        per_step.append((abs(p[k] - r[k]) / max(abs(r[k]), 1e-30), f"step {i + 1} {k}"))
    keep = included(ref["grad"])
    change_keep = {k for k in ref["change"] if grad_leaf(k) in keep}
    return {"loss1_gap": per_step[0], "loss_gap": max(per_step),
            "grad_gap": leaf_gap(prog["grad"], ref["grad"], keep),
            "grad_median_gap": median_gap(prog["grad"], ref["grad"], keep),
            "change_gap": leaf_gap(prog["change"], ref["change"], change_keep),
            "change_median_gap": median_gap(prog["change"], ref["change"], change_keep)}


def median_gap(prog: dict[str, float], ref: dict[str, float], keep: set[str]) -> tuple[float, str]:
    """The median over the leaves of |‖p‖ - ‖r‖| / ‖r‖."""
    gaps = sorted(abs(prog[k] - ref[k]) / max(ref[k], 1e-30) for k in ref if k in keep)
    return statistics.median(gaps), f"{len(gaps)} leaves"


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, list[dict]]:
    """(correct, [{"name", "value", "limit"}]) over the numbers that the
    cell's limits name: every one finite and at most its limit."""
    checks = [{"name": k, "value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()]
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)
    return ok, checks
