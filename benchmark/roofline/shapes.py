"""Shapes the roofline and FLOP counts share: the frontend's framing and the
encoder's time steps, from the configuration alone."""

from __future__ import annotations

import math


def frame_geometry(cfg: dict) -> dict:
    a = cfg["AUDIO"]
    sr = int(a["SAMPLE_RATE"])
    return {"win": int(round(sr * float(a["WIN_MS"]) / 1000.0)), "hop": int(round(sr * float(a["HOP_MS"]) / 1000.0)),
            "n_fft": int(a["N_FFT"]), "n_mels": int(a["N_MELS"]), "max_frames": int(a["MAX_FRAMES"]),
            "sample_rate": sr, "fmin": float(a["FMIN"]), "fmax": float(a["FMAX"])}


def frames(n_samples: int, g: dict) -> int:
    """Frames the frontend computes for a batch of width ``n_samples``."""
    return min(max(0, 1 + (n_samples - g["win"]) // g["hop"]), g["max_frames"])


def valid_frames(length: int, g: dict) -> int:
    """Frames whose window fits in an utterance of ``length`` samples."""
    return min(max(0, (length - g["win"]) // g["hop"] + 1), g["max_frames"]) if length >= g["win"] else 0


def encoder_steps(cfg: dict) -> int:
    """The GRU's time steps: MAX_FRAMES through the strided convs ("SAME")."""
    t = int(cfg["AUDIO"]["MAX_FRAMES"])
    for _ in cfg["ENCODER"]["CONV_CHANNELS"]:
        t = math.ceil(t / int(cfg["ENCODER"]["CONV_STRIDE"]))
    return t


def valid_steps(length: int, cfg: dict) -> int:
    """The GRU steps an utterance of ``length`` samples keeps valid: its valid
    frames, then every stride's first-frame rule."""
    g = frame_geometry(cfg)
    v = valid_frames(length, g)
    for _ in cfg["ENCODER"]["CONV_CHANNELS"]:
        v = math.ceil(v / int(cfg["ENCODER"]["CONV_STRIDE"]))
    return min(v, encoder_steps(cfg))
