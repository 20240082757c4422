"""Speech↔image/text retrieval metrics, the counterpart of
``s2i_tpu/eval/retrieval.py``: the cosine-similarity matrix on the device,
then R@K / medR / MRR / mAP in both directions on the host.

A query can have several positives, every target that shares its group id
(the image id: ~10 captions an image). Pass ``query_ids``/``target_ids`` to
group; without ids the sets are strictly paired (positive = the diagonal).
"map" is mean Average Precision; "mrr" the reciprocal rank of the first
positive.
"""

from __future__ import annotations

import numpy as np
import torch

from s2i_tpu_torch.device import resolve_device


def _cosine_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[Q, D] × [T, D] → [Q, T] cosine similarities, on the inputs' device
    (norms floored at 1e-8, as the JAX package's ``_cosine_sim``)."""
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-8)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=1e-8)
    return a @ b.T


def _rank_metrics(
    sim: np.ndarray, pos: np.ndarray, ks: tuple[int, ...]
) -> dict:
    """sim [Q,T]; pos bool [Q,T] with ≥1 positive per row."""
    if not pos.any(axis=1).all():
        raise ValueError("every query needs at least one positive target")
    order = np.argsort(-sim, axis=1, kind="stable")
    hits = np.take_along_axis(pos, order, axis=1)  # positives in rank order
    first = hits.argmax(axis=1)  # 0-based rank of the best-ranked positive
    out = {f"r@{k}": float(np.mean(hits[:, :k].any(axis=1))) for k in ks}
    out["medr"] = float(np.median(first) + 1)
    out["mrr"] = float(np.mean(1.0 / (first + 1)))
    precision_at = np.cumsum(hits, axis=1) / np.arange(1, sim.shape[1] + 1)
    ap = (precision_at * hits).sum(axis=1) / hits.sum(axis=1)
    out["map"] = float(np.mean(ap))
    return out


def retrieval_metrics(
    query_emb: np.ndarray,
    target_emb: np.ndarray,
    ks: tuple[int, ...] = (1, 5, 10),
    query_ids: np.ndarray | None = None,
    target_ids: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """[Q,D]×[T,D] (+ optional group ids) → {'q2t': {...}, 't2q': {...}}.

    Without ids, Q must equal T and row i's positive is column i. With ids,
    target j is a positive for query i iff ``target_ids[j] == query_ids[i]``
    (e.g. ids = image index, repeated over each image's 10 captions). The
    similarities are computed in float32 on ``device``.
    """
    if query_ids is None and target_ids is None:
        if query_emb.shape[0] != target_emb.shape[0]:
            raise ValueError("paired mode needs equally many queries/targets")
        query_ids = target_ids = np.arange(query_emb.shape[0])
    elif query_ids is None or target_ids is None:
        raise ValueError("pass both query_ids and target_ids, or neither")
    query_ids = np.asarray(query_ids)
    target_ids = np.asarray(target_ids)
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(query_emb, np.float32), device=dev)
    t = torch.as_tensor(np.asarray(target_emb, np.float32), device=dev)
    sim = _cosine_sim(q, t).cpu().numpy()
    pos = query_ids[:, None] == target_ids[None, :]
    return {
        "q2t": _rank_metrics(sim, pos, ks),
        "t2q": _rank_metrics(sim.T, pos.T, ks),
    }
