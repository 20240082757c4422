"""The port's certification scripts, the counterparts of the JAX
package's ``scripts/``, each a module with ``main(argv=None)``:

    python -m s2i_tpu_torch.scripts.quality_cert --out output/quality --steps 1500
    python -m s2i_tpu_torch.scripts.encoder_quality_cert --out output/encoder_quality
    python -m s2i_tpu_torch.scripts.joint_quality_cert --out output/joint_quality --steps 1000
    python -m s2i_tpu_torch.scripts.posthoc_quality_eval --run output/quality
    python -m s2i_tpu_torch.scripts.eval_smoke --out output/eval_smoke
    python -m s2i_tpu_torch.scripts.workflow_cert --out output/workflow_cert

Each runs on the card unless given ``--device cpu`` and raises without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from s2i_tpu_torch.eval.cert import REPO


def device_argv(args: argparse.Namespace) -> list[str]:
    """The device flags of ``cli.add_device_flags`` to hand a stage's command."""
    if args.device == "cpu":
        return ["--device", "cpu"]
    return [] if args.gpu_id is None else ["--gpu", str(args.gpu_id)]


def run_stage(argv: list[str]) -> tuple[subprocess.CompletedProcess, float]:
    """``python <argv>`` from the repository's root, stdout and stderr
    together; returns the finished process and its wall seconds."""
    t0 = time.time()
    r = subprocess.run([sys.executable] + argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, env={**os.environ, "PYTHONPATH": os.pathsep.join(
                           filter(None, (REPO, os.environ.get("PYTHONPATH"))))})
    return r, round(time.time() - t0, 1)


def check_stage(r: subprocess.CompletedProcess, name: str) -> None:
    """A stage that exited non-zero ends the run non-zero, with its tail."""
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-6000:])
        raise SystemExit(f"stage {name} FAILED rc={r.returncode}: {' '.join(r.args[1:])}")
