"""Synthetic stand-ins for the paper's datasets, made from a seed.

``sift_like`` has SIFT1M's shape (d = 128, non-negative, clustered image
descriptors); its generator is the reference benchmarks' "sift-like" one,
so the same seed gives the same vectors in both packages.
"""

from __future__ import annotations

import numpy as np


def sift_like(n: int, d: int = 128, seed: int = 0) -> np.ndarray:
    """(n, d) f32: |center + 0.25 * noise| over 128 non-negative centers."""
    rng = np.random.default_rng(seed)
    centers = np.abs(rng.standard_normal((128, d))).astype(np.float32)
    a = rng.integers(0, 128, n)
    return np.abs(centers[a] + 0.25 * rng.standard_normal((n, d))
                  ).astype(np.float32)


def perturbed_queries(data: np.ndarray, nq: int, seed: int = 1) -> np.ndarray:
    """Queries are data points (paper §VI-A), slightly perturbed."""
    rng = np.random.default_rng(seed)
    sel = rng.choice(len(data), nq, replace=False)
    return (data[sel] + 0.05 * rng.standard_normal(
        (nq, data.shape[1]))).astype(np.float32)
