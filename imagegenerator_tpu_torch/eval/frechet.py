"""Fréchet distance between Gaussian fits of feature sets — the port's
own copy of ``imagegenerator_tpu/eval/frechet.py``.

Fit a Gaussian to a feature embedding of real and of generated samples
and report

    d^2 = |mu1 - mu2|^2 + tr(C1 + C2 - 2 sqrt(C1 C2)).

The moments and the distance are host float64 numpy: the card's job is
the feature extraction. With S1 = C1^(1/2) (PSD), C1 C2 has the spectrum
of the symmetric PSD matrix S1 C2 S1, so tr(sqrt(C1 C2)) =
sum(sqrt(eigvalsh(S1 C2 S1))): no complex arithmetic and no Schur
decomposition.
"""

from __future__ import annotations

import numpy as np

__all__ = ["FeatureMoments", "gaussian_stats", "frechet_distance"]


class FeatureMoments:
    """Streaming mean and covariance of feature batches: the count, the
    sum and the sum of outer products in float64, so a set embedded batch
    by batch never needs to be held whole. Sums add, so the moments of
    several ranks' shares add up to those of the whole set. ``stats()``
    is ``np.mean`` / ``np.cov(rowvar=False)`` (ddof=1)."""

    def __init__(self, dim: int):
        self.dim = int(dim)
        self.count = 0
        self.sum = np.zeros((self.dim,), np.float64)
        self.outer = np.zeros((self.dim, self.dim), np.float64)

    def update(self, feats) -> None:
        x = np.asarray(feats, np.float64)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected (batch, {self.dim}) features, got {x.shape}")
        self.count += x.shape[0]
        self.sum += x.sum(axis=0)
        self.outer += x.T @ x

    def stats(self):
        """-> (mu, cov) with ddof=1, as float64 numpy arrays."""
        if self.count < 2:
            raise ValueError(f"need >= 2 samples for a covariance, have {self.count}")
        n = float(self.count)
        mu = self.sum / n
        cov = (self.outer - n * np.outer(mu, mu)) / (n - 1.0)
        # exact symmetry (the accumulation is symmetric up to rounding)
        cov = 0.5 * (cov + cov.T)
        return mu, cov


def gaussian_stats(feats):
    """One-shot (mu, cov) of an (N, D) feature array, ddof=1."""
    m = FeatureMoments(np.asarray(feats).shape[1])
    m.update(feats)
    return m.stats()


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh(mat)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """Fréchet distance between N(mu1, cov1) and N(mu2, cov2).

    ``eps`` is added to both covariance diagonals when either is
    near-singular (smallest eigenvalue < eps), the usual regularisation
    for feature sets smaller than the feature dimension; eps=0 forbids
    the offset.
    """
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.asarray(cov1, np.float64), np.asarray(cov2, np.float64)
    if eps:
        lo = min(np.linalg.eigvalsh(cov1)[0], np.linalg.eigvalsh(cov2)[0])
        if lo < eps:
            off = np.eye(cov1.shape[0]) * eps
            cov1 = cov1 + off
            cov2 = cov2 + off
    s1 = _sqrtm_psd(cov1)
    inner = s1 @ cov2 @ s1
    w = np.linalg.eigvalsh(0.5 * (inner + inner.T))
    tr_sqrt = np.sqrt(np.clip(w, 0.0, None)).sum()
    diff = mu1 - mu2
    d2 = diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt
    # rounding can leave a tiny negative on identical inputs
    return float(max(d2, 0.0))
