"""Offline speech-caption synthesis hook, the port's copy of
tools/synthesize_speech.py: the reference distributes TTS-synthesized wavs
for every CUB/Oxford text caption; the framework consumes wavs and does not
synthesize.

This tool materializes the expected ``DATA_DIR/audio/<image-id>/<k>.wav``
tree from caption text files, via either:

  --cmd 'some_tts --text {text} --out {out}'   # any local TTS binary
  --tone                                       # deterministic tone fixture
                                               # (dev/testing without TTS)

Caption sources: StackGAN text layout ``text_c10/<id>.txt`` (one caption per
line) or ``--captions captions.json`` mapping id → [caption, ...]. WAVs that
exist are skipped. ``--tone`` writes 3 s of ``make_fixture_dataset``'s tone
synthesizer per caption: the JAX tool's samples.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shlex
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from s2i_tpu_torch.audio.wavio import write_wav  # noqa: E402
from tools_torch.make_fixture_dataset import tone_synthesize  # noqa: E402

TONE_SECONDS = 3.0


def load_captions(data_dir: str, split: str, captions_json: str | None) -> list[tuple[str, list[str]]]:
    """(image id, captions) for every image of ``split``, from
    ``captions_json`` or ``text_c10/<id>.txt``."""
    with open(os.path.join(data_dir, split, "filenames.pickle"), "rb") as f:
        names = pickle.load(f)
    if captions_json:
        with open(captions_json) as f:
            table = json.load(f)
        return [(n, table[n]) for n in names]
    out = []
    for n in names:
        with open(os.path.join(data_dir, "text_c10", n + ".txt")) as f:
            out.append((n, [line.strip() for line in f if line.strip()]))
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--splits", nargs="*", default=["train", "test"])
    p.add_argument("--captions", default=None, help="optional captions.json")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--cmd", default=None, help="TTS command template with {text} and {out} placeholders")
    p.add_argument("--tone", action="store_true", help="tone-fixture synthesis")
    args = p.parse_args(argv)
    if not args.cmd and not args.tone:
        p.error("pass --cmd TEMPLATE or --tone")
    for split in args.splits:
        for name, captions in load_captions(args.data_dir, split, args.captions):
            out_dir = os.path.join(args.data_dir, "audio", name)
            os.makedirs(out_dir, exist_ok=True)
            for k, text in enumerate(captions):
                out_path = os.path.join(out_dir, f"{k}.wav")
                if os.path.exists(out_path):
                    continue
                if args.tone:
                    n = int(args.sample_rate * TONE_SECONDS)
                    write_wav(out_path, tone_synthesize(text, args.sample_rate, n), args.sample_rate)
                else:
                    subprocess.run(args.cmd.format(text=shlex.quote(text), out=out_path), shell=True, check=True)
        print(f"{split}: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
