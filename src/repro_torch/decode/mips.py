"""MIPS -> L2 reduction (Shrivastava-Li asymmetric augmentation).

Attention retrieval is maximum inner-product search: the positions worth
attending to are argmax q.k, over keys whose norms vary.  The DE-Forest
answers *Euclidean* range queries, so keys and queries are lifted into
R^(d+1) with

    k_hat = [k, sqrt(R^2 - ||k||^2)],      q_hat = [q, 0]

which gives ||q_hat - k_hat||^2 = ||q||^2 + R^2 - 2 q.k — a strictly
decreasing function of q.k for a fixed query, so augmented-L2 nearest ==
inner-product largest.

R is frozen at prefill (``mips_radius`` with a slack factor); keys upserted
later whose norm exceeds R get a clipped (0) augmentation coordinate, which
can only rank them closer than the exact reduction would (over-admission,
never a loss).  ``augment_keys`` reports the clip count so callers can
widen the slack when drift is real.
"""

from __future__ import annotations

import torch

DEFAULT_SLACK = 1e-6


def mips_radius(keys: torch.Tensor, *,
                slack: float = DEFAULT_SLACK) -> torch.Tensor:
    """Squared augmentation radius R^2 = max ||k||^2 * (1 + slack).

    keys (..., S, d) -> (...): the max runs over S, so each leading
    (batch, head) index freezes its own radius.
    """
    norms2 = (keys.to(torch.float32) ** 2).sum(-1)
    return norms2.amax(-1) * (1.0 + slack)


def augment_keys(keys: torch.Tensor, R2: torch.Tensor | float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """keys (..., S, d), R2 broadcastable to (...) -> (aug, n_clipped).

    aug (..., S, d+1) f32 with last coordinate sqrt(max(R^2 - ||k||^2, 0));
    n_clipped (int32 scalar) counts keys whose norm exceeded R.
    """
    kf = keys.to(torch.float32)
    norms2 = (kf ** 2).sum(-1)
    R2 = torch.as_tensor(R2, dtype=torch.float32, device=kf.device)
    if R2.ndim:
        R2 = R2[..., None]            # broadcast over the S axis
    gap = R2 - norms2
    extra = torch.sqrt(torch.clamp_min(gap, 0.0))
    n_clipped = (gap < 0.0).sum().to(torch.int32)
    return torch.cat([kf, extra[..., None]], -1), n_clipped


def augment_queries(q: torch.Tensor) -> torch.Tensor:
    """q (..., d) -> q_hat (..., d+1) with a zero augmentation coordinate."""
    qf = q.to(torch.float32)
    return torch.cat([qf, qf.new_zeros(qf.shape[:-1] + (1,))], -1)


def normalize_queries(q: torch.Tensor,
                      R2: torch.Tensor | float) -> torch.Tensor:
    """Rescale each query lane to the key-norm scale (||q_n|| = R).

    For a fixed lane, augmented-L2 order is a monotone function of q.k for
    any positive query scale, so rescaling never changes the ranking; it
    restores the LSH contrast that ||q|| >> R destroys (the common
    ||q||^2 + R^2 term swamps the spread of 2 q.k).  q (..., d or d+1);
    R2 broadcastable to the lane axes.
    """
    qf = q.to(torch.float32)
    norms = torch.sqrt((qf ** 2).sum(-1, keepdim=True))
    R = torch.sqrt(torch.as_tensor(R2, dtype=torch.float32, device=qf.device))
    if R.ndim:
        R = R.reshape(R.shape + (1,) * (qf.ndim - R.ndim))
    return qf * (R / torch.clamp_min(norms, 1e-12))
