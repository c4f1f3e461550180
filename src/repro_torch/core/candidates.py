"""Incremental candidate-set maintenance for the c^2-k-ANN rounds (Alg. 5).

The candidate set S of every lane is kept in incremental form, so a
round's cost scales with the round's candidate count m, not the buffer:

  * a packed 32-bit **seen-bitmap** (one bit per dataset point) answers
    "was this id already counted in S?" with one gather + bit test;
  * the round batch is deduped in-round with one m-sized stable sort and
    compacted with a cumsum;
  * surviving (first-seen) candidates are **appended at a cursor** into the
    fixed-size buffer.  No eviction is ever needed: Alg. 5 terminates as
    soon as the unique count reaches beta*n + k, and every round adds at
    most ``round_cap`` candidates, so with cap >= beta*n + k + round_cap the
    cursor never passes ``cap``.

The cursor *is* the unique count |S|, so the Alg. 5 line-7 test is a
compare.  The buffer is not kept distance-sorted between rounds; the final
top-k selection happens once per query.

Every array carries a leading lane axis: ids/dists (B, cap), seen
(B, words), count (B,) — the reference's ``jax.vmap`` written out.  Bitmap
words are int32 bit patterns of the reference's uint32 words (torch has no
uint32 arithmetic): a round's new bits are distinct and not yet set, so
``scatter_add_`` of them equals a bitwise or and never overflows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_INF = float("inf")


class CandidateState(NamedTuple):
    """Per-lane Alg. 5 candidate set S in incremental form."""

    ids: torch.Tensor     # (B, cap) int32 — appended unique ids; n = empty
    dists: torch.Tensor   # (B, cap) f32 — exact distances; +inf when empty
    seen: torch.Tensor    # (B, ceil(n/32)) int32 — membership bitmap
    count: torch.Tensor   # (B,) int32 — cursor == |S| (unique candidates)


def bitmap_words(n: int) -> int:
    return (n + 31) // 32


def init_state(n: int, cap: int, B: int,
               device: torch.device | str = "cpu") -> CandidateState:
    return CandidateState(
        ids=torch.full((B, cap), n, dtype=torch.int32, device=device),
        dists=torch.full((B, cap), _INF, dtype=torch.float32, device=device),
        seen=torch.zeros((B, bitmap_words(n)), dtype=torch.int32,
                         device=device),
        count=torch.zeros((B,), dtype=torch.int32, device=device))


def bitmap_test(seen: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """True where ``ids`` (B, m) (may hold the sentinel n) is already set in
    its lane's bitmap ``seen`` (B, words)."""
    safe = torch.clamp(ids.to(torch.int64), 0, n - 1)
    word = torch.gather(seen, 1, safe >> 5)
    return ((word >> (safe & 31).to(torch.int32)) & 1).to(torch.bool)


def merge_round(n: int, state: CandidateState, new_ids: torch.Tensor,
                new_d: torch.Tensor) -> CandidateState:
    """Fold one round's candidates into S.  new_ids/new_d: (B, m), id n =
    invalid.

    Cost: one stable m-sort per lane + O(m) scatters.  Appends past ``cap``
    are dropped (the reference's ``mode='drop'``), which the capacity
    invariant of the module docstring proves unreachable before termination;
    the count still advances for them, as in the reference.
    """
    B, cap = state.ids.shape
    dev = state.ids.device
    fresh = (new_ids < n) & ~bitmap_test(state.seen, new_ids, n)
    # In-round dedup: a stable sort by (masked) id puts duplicates adjacent
    # and invalid entries last; keep first occurrences only.
    ids_m = torch.where(fresh, new_ids, n)
    ids_s, order = torch.sort(ids_m, dim=1, stable=True)
    d_s = torch.gather(torch.where(fresh, new_d, _INF), 1, order)
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
    keep = first & (ids_s < n)

    # Append kept entries at the cursor (cumsum assigns dense slots); the
    # spare column ``cap`` takes every dropped write and is cut off after.
    pos = state.count[:, None].to(torch.int64) + torch.cumsum(keep, 1) - 1
    pos = torch.where(keep, pos, cap).clamp_max(cap)
    spare_i = torch.full((B, 1), n, dtype=torch.int32, device=dev)
    spare_d = torch.full((B, 1), _INF, dtype=torch.float32, device=dev)
    ids_out = torch.cat([state.ids, spare_i], 1).scatter_(1, pos, ids_s)
    d_out = torch.cat([state.dists, spare_d], 1).scatter_(1, pos, d_s)

    # Set bitmap bits.  Kept ids are unique, so bits within a shared word
    # never collide and scatter-add equals scatter-or.
    words = state.seen.shape[1]
    safe = torch.clamp(ids_s.to(torch.int64), 0, n - 1)
    word_idx = torch.where(keep, safe >> 5, words)
    b = safe & 31                     # 1 << b as an int32 bit pattern
    bits = torch.where(b == 31, -(1 << 31), torch.ones_like(b) << b)
    bits = bits.to(torch.int32)
    seen_out = torch.cat(
        [state.seen, torch.zeros((B, 1), dtype=torch.int32, device=dev)], 1)
    seen_out.scatter_add_(1, word_idx, torch.where(keep, bits, 0))

    count_out = state.count + keep.sum(1).to(torch.int32)
    return CandidateState(ids=ids_out[:, :cap], dists=d_out[:, :cap],
                          seen=seen_out[:, :words], count=count_out)


def canonicalize(n: int, ids: torch.Tensor, dists: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort a buffer ascending by (distance, id) along its last axis — the
    sort-based merge's output order.  Used for the equivalence tests."""
    order = torch.sort(ids, dim=-1, stable=True).indices
    d1 = torch.gather(dists, -1, order)
    order2 = torch.sort(d1, dim=-1, stable=True).indices
    return (torch.gather(torch.gather(ids, -1, order), -1, order2),
            torch.gather(d1, -1, order2))
