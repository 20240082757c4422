"""K2, ``s2i::gru_scan`` (``csrc/gru_fwd.cu``): the bidirectional GRU
recurrence of the encoder over D = 2 directions. Operations of the valid
(row, step) pairs only (a masked step carries h and needs no work): the
recurrent product h @ W_h (2 · H · 3H) and the gates (12 · H) per pair and
direction, at the float32 peak. Bytes: xw [D, T, B, 3H], W_h, b_h, the mask
[T, B] and h0 read once, ys [D, T, B, H] written once, float32."""

from __future__ import annotations

from roofline import shapes

PATTERNS = ("gru_fwd_kernel",)
PEAK = "fp32_flops"


def dims(cfg: dict, rec: dict):
    e = cfg["ENCODER"]
    d = 2 if e["BIDIRECTIONAL"] else 1
    h = int(e["RNN_HIDDEN"])
    t = shapes.encoder_steps(cfg)
    b = len(rec["gru"])
    valid = sum(shapes.valid_steps(int(n), cfg) for n in rec["gru"])
    return d, t, b, h, valid


def cost(cfg: dict, rec: dict):
    if not rec.get("gru"):
        return None
    d, t, b, h, valid = dims(cfg, rec)
    flops = d * (2.0 * valid * h * 3 * h + 12.0 * valid * h)
    nbytes = 4.0 * (d * t * b * 3 * h + d * h * 3 * h + d * 3 * h + t * b + d * b * h + d * t * b * h)
    return flops, nbytes
