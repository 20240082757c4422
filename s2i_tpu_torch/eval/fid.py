"""Fréchet Inception Distance, the counterpart of ``s2i_tpu/eval/fid.py``:
pool3 features on the device, Gaussian statistics and the trace of the
covariance product's square root on the host.

    FID = |mu1 - mu2|² + tr(sigma1) + tr(sigma2) - 2 tr((sigma1 sigma2)^½)

The JAX package takes ``tr((sigma1 sigma2)^½)`` from ``scipy.linalg.sqrtm``
of the product, a complex Schur decomposition and a triangular square root
of a 2048² matrix. Here it is the sum of the singular values of
``sigma2^½ sigma1^½`` (those are the square roots of the eigenvalues of
``sigma1^½ sigma2 sigma1^½``, which are the product's), from a symmetric
eigendecomposition of each covariance and an SVD no larger than their
ranks: over ten times faster (chip_smoke.py's eval phase times both) and
more accurate where the protocol lives. With fewer images than the 2048
features the covariances are singular, and a square root of the product
turns every rounding-level eigenvalue into a sqrt(eps)-sized term, enough
to move FID(X, X) of 1024 images far past 1e-3; the singular values keep
it at rounding level. Held against the JAX package's ``fid_from_stats`` in
``tests/test_torch_eval.py``.
"""

from __future__ import annotations

import numpy as np

from s2i_tpu_torch.eval.features import InceptionFeatures


def gaussian_stats(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    features = np.asarray(features, dtype=np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _root_factor(sigma: np.ndarray) -> np.ndarray:
    """F [d, r] with F Fᵀ = sigma: its eigenvectors scaled by the square
    roots of their eigenvalues, those below the rounding level of the
    largest (``numpy.linalg.matrix_rank``'s tolerance) dropped."""
    w, v = np.linalg.eigh(sigma)
    keep = w > max(float(w.max()), 0.0) * len(w) * np.finfo(w.dtype).eps
    return v[:, keep] * np.sqrt(w[keep])


def trace_sqrt_product(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
    """tr((sigma1 sigma2)^½) of two covariances: the sum of the singular
    values of ``sigma2^½ sigma1^½``, which are those of the [r2, r1]
    product ``F2ᵀ F1`` of their root factors (``sigma^½ = V S Vᵀ`` and the
    outer ``V``s have orthonormal columns)."""
    f1, f2 = _root_factor(sigma1), _root_factor(sigma2)
    if not (f1.size and f2.size):
        return 0.0
    return float(np.linalg.svd(f2.T @ f1, compute_uv=False).sum())


def fid_from_stats(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray) -> float:
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * trace_sqrt_product(sigma1, sigma2))


def fid_score(
    images1: np.ndarray,
    images2: np.ndarray,
    extractor: InceptionFeatures,
    batch_size: int = 64,
) -> float:
    """FID between two image sets ([N,H,W,3] in [-1,1] each)."""
    f1, _ = extractor.extract(images1, batch_size)
    f2, _ = extractor.extract(images2, batch_size)
    return fid_from_stats(*gaussian_stats(f1), *gaussian_stats(f2))
