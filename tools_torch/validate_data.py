"""Validate a DATA_DIR against the expected StackGAN + speech layout
(docs/DATA.md) with the port's loader: pickle shapes, image coverage, wav
coverage, split sanity. The port's copy of tools/validate_data.py, over
``s2i_tpu_torch.data.stackgan.StackGanSplit``: the same JSON report, field
for field, and the same exit codes (0: every split complete, 1: not).

    python tools_torch/validate_data.py --data_dir DATA_DIR
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from s2i_tpu_torch.data.stackgan import StackGanSplit  # noqa: E402


def check_split(data_dir: str, split: str) -> dict:
    """One split's report: ``ok`` (false when the split does not load or an
    image is missing), ``problems``, and the split's sizes."""
    rep = {"split": split, "ok": True, "problems": []}
    try:
        s = StackGanSplit(data_dir, split)
    except Exception as e:  # noqa: BLE001 — any load failure is a finding of the report
        return {"split": split, "ok": False, "problems": [f"load failed: {e}"]}
    rep["examples"] = len(s)
    rep["captions_per_image"] = s.captions_per_image
    rep["embedding_dim"] = int(s.embeddings.shape[-1])
    missing_img = missing_wav = 0
    for i in range(len(s)):
        try:
            s.image_path(i)
        except FileNotFoundError:
            missing_img += 1
        try:
            s.wav_path(i, 0)
        except FileNotFoundError:
            missing_wav += 1
    if missing_img:
        rep["ok"] = False
        rep["problems"].append(f"{missing_img} images missing")
    if missing_wav:
        rep["problems"].append(f"{missing_wav} wav trees missing (speech mode unavailable)")
    rep["has_bboxes"] = s.bboxes is not None
    rep["has_speech_embeddings"] = os.path.exists(os.path.join(data_dir, split, "speech-embeddings.pickle"))
    return rep


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True)
    args = p.parse_args(argv)
    report = [check_split(args.data_dir, sp) for sp in ("train", "test")]
    print(json.dumps(report, indent=2))
    return 0 if all(r["ok"] for r in report) else 1


if __name__ == "__main__":
    sys.exit(main())
