"""K3, ``s2i::gru_scan_bwd`` (``csrc/gru_bwd.cu``: its gate SGEMM, the
reverse chain, dW_h and the bias sums): the GRU recurrence's gradient.
Operations of the valid (row, step) pairs only: three products of
2 · H · 3H (the gates recomputed, dh @ W_hᵀ, hᵀ dh) and 40 · H of gate
arithmetic per pair and direction, at the float32 peak. Bytes: xw, W_h,
b_h, the mask, h0, ys and dys read once; dxw, dW_h, db_h and dh0 written
once, float32."""

from __future__ import annotations

from roofline import k2_gru_fwd

PATTERNS = ("gru_bwd_chain_kernel", "namespace)::gemm_kernel", "sum_splits_kernel", "colsum_kernel")
PEAK = "fp32_flops"


def cost(cfg: dict, rec: dict):
    if not (rec.get("gru") and rec.get("gru_bwd")):
        return None
    d, t, b, h, valid = k2_gru_fwd.dims(cfg, rec)
    flops = d * (3 * 2.0 * valid * h * 3 * h + 40.0 * valid * h)
    ins = d * t * b * 3 * h + d * h * 3 * h + d * 3 * h + t * b + d * b * h + 2 * d * t * b * h
    outs = d * t * b * 3 * h + d * h * 3 * h + d * 3 * h + d * b * h
    return flops, 4.0 * (ins + outs)
