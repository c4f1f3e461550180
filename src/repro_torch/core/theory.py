"""Theoretical parameter machinery of DET-LSH (paper §II-C, §V).

Implements:
  * chi-square upper quantiles (Lemma 2),
  * the Lemma 3 coupling  eps^2 = chi2_{a1}(K) = c^2 * chi2_{a2}(K),
    L = -1/ln(a1),  beta = 2 - 2*a2^L,
  * the success-probability bound 1/2 - 1/e (Theorems 1-3).

Configuration-time host computations (scipy only); nothing here touches a
tensor.
"""

from __future__ import annotations

import dataclasses
import math

from scipy.stats import chi2 as _chi2

SUCCESS_PROBABILITY = 0.5 - 1.0 / math.e  # Theorems 1-3 lower bound.


def chi2_upper_quantile(alpha: float, k: int) -> float:
    """chi2_alpha(K): the value y with Pr[Y > y] = alpha for Y ~ chi2(K)."""
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0,1), got {alpha}")
    return float(_chi2.ppf(1.0 - alpha, k))


def chi2_sf(y: float, k: int) -> float:
    """Pr[Y > y] for Y ~ chi2(K)."""
    return float(_chi2.sf(y, k))


@dataclasses.dataclass(frozen=True)
class LSHParams:
    """Derived DET-LSH parameters (Lemma 3)."""

    K: int          # projected-space dimensionality
    L: int          # number of independent projected spaces / DE-Trees
    c: float        # approximation ratio
    alpha1: float   # per-space miss probability for near points
    alpha2: float   # per-space survival probability for far points
    epsilon: float  # projected-radius inflation: range query uses eps*r
    beta: float     # max false-positive fraction; stop at |S| >= beta*n + k

    @property
    def success_probability(self) -> float:
        return SUCCESS_PROBABILITY


def derive_params(K: int = 16, c: float = 1.5, L: int = 4,
                  beta_override: float | None = None) -> LSHParams:
    """Solve the Lemma 3 system given (K, c, L).

    L = -1/ln(alpha1)        =>  alpha1 = exp(-1/L)
    eps^2 = chi2_{alpha1}(K)
    chi2_{alpha2}(K) = eps^2 / c^2  =>  alpha2 = SF(eps^2/c^2; K)
    beta = 2 - 2*alpha2^L    (so that Markov gives Pr[E3] >= 1/2)

    ``beta_override`` reproduces the paper's experimental setting (beta=0.1)
    while keeping the theoretically coupled (eps, L).
    """
    if K < 1 or L < 1 or c <= 1.0:
        raise ValueError(f"need K>=1, L>=1, c>1; got K={K} L={L} c={c}")
    alpha1 = math.exp(-1.0 / L)
    eps2 = chi2_upper_quantile(alpha1, K)
    epsilon = math.sqrt(eps2)
    alpha2 = chi2_sf(eps2 / (c * c), K)
    beta = 2.0 - 2.0 * (alpha2 ** L)
    if beta_override is not None:
        beta = float(beta_override)
    return LSHParams(K=K, L=L, c=c, alpha1=alpha1, alpha2=alpha2,
                     epsilon=epsilon, beta=beta)
