"""Sparse-attention assembly over retrieved KV positions.

``sparse_decode_attention`` is the read side of LSH decode: exact softmax
over the union of {retrieved candidate positions} ∪ {local window} ∪
{attention sinks}.  Retrieval decides *which* positions matter; this
module computes *exact* attention over them (no approximation inside the
softmax).

``LSHDecoder`` runs the decode step, tying its two halves together
against a ``KVCacheIndex``:

  write half:  upsert the step's new key into the delta;
  read half:   batched fused retrieval every ``refresh_every`` steps (the
               local window, required to be >= refresh_every, covers every
               key written since the last refresh, so a stale candidate
               table stays safe between refreshes).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.decode.kv_index import KVCacheIndex


def attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact softmax attention of each query head over its own cache rows.

    q (b, 1, h, dh); caches (b, S, hk, dh); ids (b, hk, g, m) in [0, S);
    valid (b, hk, g, m).  Query head ``kv * g + j`` reads kv head ``kv``.
    A repeated id counts once (its first occurrence under a stable sort,
    valid or not); scale 1/sqrt(dh) in f32.  Returns (b, 1, h, dh) in q's
    dtype."""
    b, _, h, dh = q.shape
    hk = k_cache.shape[2]
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32,
                                          device=dev))
    ids = ids.to(torch.int64)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    ki = torch.arange(hk, device=dev)[None, :, None, None]
    kg = k_cache[bi, ids, ki].to(torch.float32)               # (b,hk,g,m,dh)
    vg = v_cache[bi, ids, ki].to(torch.float32)
    qh = q.reshape(b, hk, h // hk, dh).to(torch.float32)
    s = torch.einsum("bkgd,bkgmd->bkgm", qh * scale, kg)
    order = torch.argsort(ids, dim=-1, stable=True)
    rs = torch.gather(ids, -1, order)
    first = torch.cat([torch.ones_like(rs[..., :1], dtype=torch.bool),
                       rs[..., 1:] != rs[..., :-1]], dim=-1)
    keep = torch.zeros_like(first).scatter(-1, order, first)
    s = torch.where(valid & keep, s, -float("inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgm,bkgmd->bkgd", p, vg)             # (b, hk, g, dh)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def fixed_positions(length: int, window: int, sinks: int,
                    device: torch.device) -> torch.Tensor:
    """The local window (length-1, length-2, ...) then the sinks (0, 1,
    ...), int32."""
    loc = length - 1 - torch.arange(window, device=device)
    return torch.cat([loc, torch.arange(sinks, device=device)]).to(
        torch.int32)


def sparse_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, positions: torch.Tensor,
                            length: int, *, window: int = 64,
                            sinks: int = 4) -> torch.Tensor:
    """Exact attention over {positions} ∪ {window} ∪ {sinks}.

    q (b, 1, h, dh); caches (b, S, hk, dh); positions (b, hk, g, m) int32
    cache positions (-1 = no candidate); length = attendable prefix.
    Duplicate positions across the three sources are masked (see
    :func:`attend`), so over distinct valid positions the softmax is the
    dense softmax restricted to them.
    """
    S = k_cache.shape[1]
    fixed = fixed_positions(length, window, sinks, q.device)
    fixed = fixed.expand(positions.shape[:3] + fixed.shape)
    ids = torch.cat([positions.to(torch.int32), fixed], dim=-1)
    # mask BEFORE clipping: -1 candidates must not alias position 0
    in_range = (ids >= 0) & (ids < length)
    return attend(q, k_cache, v_cache, torch.clamp(ids, 0, S - 1), in_range)


class LSHDecoder:
    """One decode step = upsert + (amortized) fused retrieval + sparse
    assembly, against a prefilled ``KVCacheIndex``.

    ``refresh_every=1`` retrieves every step; larger values reuse the last
    candidate table for R-1 steps, so retrieval cost amortizes to 1/R per
    token while the local window (``window >= refresh_every`` is enforced)
    keeps every not-yet-retrieved fresh key attendable.
    """

    def __init__(self, index: KVCacheIndex, *, window: int = 64,
                 sinks: int = 4, refresh_every: int = 1):
        if window < refresh_every:
            raise ValueError(
                f"window ({window}) must be >= refresh_every "
                f"({refresh_every}): keys written since the last refresh "
                f"are only attendable through the local window")
        self.index = index
        self.window = window
        self.sinks = sinks
        self.refresh_every = refresh_every
        self.n_refreshes = 0
        self._positions: Optional[torch.Tensor] = None   # (b, hk, g, m)
        self._since = refresh_every                      # refresh at t=0

    def step(self, q: torch.Tensor, k_cache: torch.Tensor,
             v_cache: torch.Tensor, k_new: Any, length: int) -> torch.Tensor:
        """q (b, 1, h, dh); caches (b, S, hk, dh) with the step's k/v
        already written at position length-1; k_new (b, hk, dh) is that
        key (upserted into the index's delta).  Returns (b, 1, h, dh)."""
        self.index.upsert(k_new)
        if self._positions is None or self._since >= self.refresh_every:
            res = self.index.retrieve(q)
            b, hk = self.index.b, self.index.hk
            g, m = res.ids.shape[1], res.ids.shape[2]
            self._positions = res.ids.reshape(b, hk, g, m)
            self._since = 0
            self.n_refreshes += 1
        self._since += 1
        return sparse_decode_attention(q, k_cache, v_cache, self._positions,
                                       length, window=self.window,
                                       sinks=self.sinks)
