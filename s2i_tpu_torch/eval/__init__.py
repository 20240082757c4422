"""Metrics of the port, the counterpart of ``s2i_tpu/eval``: Inception
feature and logit extraction on the device, the Inception Score (10-split
protocol), FID (on the host: the trace square root of the 2048² covariance
product as singular values, ``fid.py``) and speech↔image retrieval R@K /
mAP.

The protocol's fine-tuned Inception weights are a user's asset (none ship
and none are fetched); the plumbing runs with any weights, and seeded
random ones are its default: FID(X, X) = 0 and IS(uniform logits) = 1 hold
whatever the classifier.
"""

from s2i_tpu_torch.eval.features import InceptionFeatures
from s2i_tpu_torch.eval.fid import fid_from_stats, fid_score, gaussian_stats
from s2i_tpu_torch.eval.inception_score import inception_score, inception_score_from_probs
from s2i_tpu_torch.eval.retrieval import retrieval_metrics

__all__ = [
    "InceptionFeatures",
    "inception_score",
    "inception_score_from_probs",
    "fid_from_stats",
    "fid_score",
    "gaussian_stats",
    "retrieval_metrics",
]
