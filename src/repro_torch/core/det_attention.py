"""Seed DET-LSH decode attention — the *oracle* for ``repro_torch.decode``.

The first cut of LSH-accelerated decode: per-(batch, kv-head) DE-Forests
built with the per-tree ``build_tree`` path and a per-head leaf-LB scan
(``retrieve_topm``).  The maintained implementation is
``repro_torch.decode``: ``KVCacheIndex.prefill`` builds through the fused
single-sort pipeline, each decode step is an upsert + one batched fused
``range_rerank_heads`` query.

What remains here:
  * ``build_kv_index`` / ``det_decode_attention`` — deprecation shims that
    still run the seed path, because it is the oracle (same forests as the
    fused build from the same inputs);
  * ``retrieve_topm`` — the seed per-head scan, oracle-only.
"""

from __future__ import annotations

import warnings
from typing import Any, NamedTuple, Optional

import torch

from repro_torch._device import to_device
from repro_torch.core import encoding as enc
from repro_torch.core import hashing
from repro_torch.core.detree import build_tree, leaf_bounds
from repro_torch.core.query import _topk_smallest
from repro_torch.core.theory import LSHParams, derive_params


class DETKVIndex(NamedTuple):
    A: torch.Tensor            # (dh+1, L*K) projections (augmented dim)
    point_ids: torch.Tensor    # (b, hk, L, n_pad)
    leaf_lo: torch.Tensor      # (b, hk, L, n_leaves, K)
    leaf_hi: torch.Tensor
    leaf_valid: torch.Tensor   # (b, hk, L, n_leaves)
    breakpoints: torch.Tensor  # (b, hk, L, K, Nr+1)
    radius: torch.Tensor       # (b, hk) augmentation R per head
    leaf_size: int
    S: int


def _augment_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """keys (S, dh) -> (S, dh+1) Shrivastava-Li augmentation + R, through
    ``repro_torch.decode.mips`` (the maintained reduction)."""
    from repro_torch.decode import mips
    R2 = mips.mips_radius(keys)
    aug, _ = mips.augment_keys(keys, R2)
    return aug, torch.sqrt(R2)


def build_kv_index(k_cache: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   params: LSHParams | None = None, Nr: int = 64,
                   leaf_size: int = 32, A: Any = None) -> DETKVIndex:
    """Index cache keys.  k_cache (b, S, hk, dh) -> per-(b,hk) DE-Forests,
    on k_cache's device.

    Deprecated oracle path; Nr, leaf_size and the derived K/L/c go through
    the same validation ``repro_torch.decode.KVSpec`` runs.  ``generator``
    draws A (None: a CPU generator seeded with 0); ``A``, when given, is
    used instead (the reference's matrix, for a like-for-like build).
    """
    warnings.warn("core.det_attention.build_kv_index is deprecated. use "
                  "repro_torch.decode.KVCacheIndex.prefill",
                  DeprecationWarning, stacklevel=2)
    b, S, hk, dh = k_cache.shape
    params = params or derive_params(K=4, c=1.5, L=4, beta_override=0.1)
    from repro_torch.decode.kv_index import KVSpec
    KVSpec(K=params.K, L=params.L, c=params.c, Nr=Nr, leaf_size=leaf_size)
    K, L = params.K, params.L
    dev = k_cache.device
    if A is None:
        A = hashing.sample_projections(
            generator or torch.Generator().manual_seed(0), dh + 1, K, L, dev)
    else:
        A = to_device(A, dev, torch.float32)

    heads = []
    for bi in range(b):
        for kv in range(hk):
            aug, R = _augment_keys(k_cache[bi, :, kv])
            proj = aug @ A                                    # (S, L*K)
            bp = enc.select_breakpoints(proj, Nr, method="full_sort")
            codes = enc.encode(proj, bp)
            proj_t = proj.reshape(S, L, K).permute(1, 0, 2)
            codes_t = codes.reshape(S, L, K).permute(1, 0, 2)
            bp_t = bp.reshape(L, K, Nr + 1)
            trees = [build_tree(proj_t[l], codes_t[l], bp_t[l], leaf_size)
                     for l in range(L)]
            heads.append({key: torch.stack([t[key] for t in trees])
                          for key in ("point_ids", "leaf_lo", "leaf_hi",
                                      "leaf_valid", "breakpoints")}
                         | {"radius": R})

    def stacked(key):
        x = torch.stack([hd[key] for hd in heads])
        return x.reshape((b, hk) + x.shape[1:])

    return DETKVIndex(A=A, point_ids=stacked("point_ids"),
                      leaf_lo=stacked("leaf_lo"), leaf_hi=stacked("leaf_hi"),
                      leaf_valid=stacked("leaf_valid"),
                      breakpoints=stacked("breakpoints"),
                      radius=stacked("radius"), leaf_size=leaf_size, S=S)


def retrieve_topm(index: DETKVIndex, q: torch.Tensor,
                  m_leaves: int) -> torch.Tensor:
    """q (b, hk, g, dh) -> candidate position ids (b, hk, g, m_leaves*ls).

    Ranks leaves by the LB distance of the augmented query in each tree and
    takes the best m_leaves/L per tree (the paper's leaf-granularity
    admission, ordered by LB; equal LBs in ascending leaf order)."""
    b, hk, g, dh = q.shape
    L = index.point_ids.shape[2]
    ls = index.leaf_size
    per_tree = max(1, m_leaves // L)
    qa = torch.cat([q.to(torch.float32),
                    q.new_zeros((b, hk, g, 1), dtype=torch.float32)], -1)
    qp = (qa @ index.A).reshape(b, hk, g, L, -1)              # (b,hk,g,L,K)
    out = torch.empty((b, hk, g, L * per_tree * ls), dtype=torch.int32,
                      device=q.device)
    for bi in range(b):
        for kv in range(hk):
            lb, _ = leaf_bounds(qp[bi, kv].permute(1, 0, 2),
                                index.leaf_lo[bi, kv], index.leaf_hi[bi, kv],
                                index.leaf_valid[bi, kv],
                                index.breakpoints[bi, kv])    # (L, g, nl)
            leaf_idx, _ = _topk_smallest(lb, per_tree)        # (L, g, per)
            gidx = (leaf_idx[..., None] * ls
                    + torch.arange(ls, device=q.device)).reshape(L, g, -1)
            pid = index.point_ids[bi, kv].to(torch.int64)     # (L, n_pad)
            ids = torch.gather(pid[:, None, :].expand(L, g, pid.shape[1]),
                               2, gidx)                       # (L, g, per*ls)
            out[bi, kv] = ids.permute(1, 0, 2).reshape(g, -1).to(torch.int32)
    return out


def det_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, index: DETKVIndex,
                         length: int, *, m_leaves: int = 16,
                         window: int = 64, sinks: int = 4) -> torch.Tensor:
    """Sparse decode attention over DET-LSH-retrieved positions.

    q (b, 1, h, dh); caches (b, S, hk, dh).  Exact softmax over the union
    of {retrieved candidates} + {last ``window`` positions} + {first
    ``sinks``}; positions at or past ``length`` and repeats are masked.
    """
    warnings.warn("core.det_attention.det_decode_attention is deprecated. "
                  "use repro_torch.decode.LSHDecoder / "
                  "sparse_decode_attention", DeprecationWarning, stacklevel=2)
    from repro_torch.decode.attention import attend, fixed_positions
    b, _, h, dh = q.shape
    S, hk = k_cache.shape[1], k_cache.shape[2]
    qh = q.reshape(b, hk, h // hk, dh)
    cand = retrieve_topm(index, qh, m_leaves)                 # (b, hk, g, mc)
    fixed = fixed_positions(length, window, sinks, q.device)
    fixed = fixed.expand(cand.shape[:3] + fixed.shape)
    ids = torch.clamp(torch.cat([cand, fixed], dim=-1), 0, S - 1)
    return attend(q, k_cache, v_cache, ids, ids < length)
