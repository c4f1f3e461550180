"""Compaction: merge sealed segments without rebuilding anything.

Every segment's per-tree arrays are already sorted by the bit-interleaved
iSAX key, and all segments share the same *inner* breakpoint edges (frozen
at the base build), so their key spaces are directly comparable.  Merging
two segments is therefore a stable **merge of sorted arrays** — positions
come from two ``searchsorted`` calls, O(n log n) comparisons and O(n)
moves, with no re-projection, no re-encoding, and no re-sort.  Tombstoned
rows are dropped before the merge, leaf summaries (lo/hi boxes) are
recomputed from the merged codes in one O(n) blockwise pass, and the outer
breakpoint edges of the merged forest are the union (min/max) of the
inputs' — which, as in ``segment.build_segment``, changes no code.

All data movement is vectorized over the L trees at once: survivor
extraction, the merge scatter, the padded assembly, and the leaf summaries
operate on stacked (L, m, ...) arrays (every tree holds the same survivor
set, so the per-tree survivor counts are equal and the stacked extraction
is a single boolean take + reshape).  Only the two ``searchsorted`` calls
per merge remain per-tree (numpy's searchsorted is 1-D) — O(m log m) each
over a tiny L, not the former per-tree Python assembly of every array.

Runs on the host (numpy), as in the reference package: compaction is the
background maintenance path, and the query path only ever sees the
swapped-in segment.  Device arrays are read with ``.cpu().numpy()``, the
merged forest goes back to the inputs' device.

Key order.  The segments' per-tree arrays are in the device sort order,
which sorts the biased int64 key ``(hi - 2^31) * 2^32 + lo``
(``detree.code_sort_orders``); the host merges on the uint64 key
``(hi << 32) | lo``.  Both order the pairs (hi, lo) of uint32 words
lexicographically, so the merge keeps each input's order.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from repro_torch._device import to_device
from repro_torch.core import FOREST_DTYPES
from repro_torch.core.detree import DEForest, key_bit_budget
from repro_torch.streaming.segment import Segment


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@functools.lru_cache(maxsize=None)
def _key_lut(K: int) -> np.ndarray:
    """(K, 256) uint64: the joined-word key contribution of code value v
    in dimension j — ``(hi << 32) | lo`` of ``detree.interleave_keys``,
    precomputed per 8-bit symbol so packing a run is one gather + OR per
    dimension instead of a per-bit shift sweep."""
    _, hi_bits, lo_bits = key_bit_budget(K)
    v = np.arange(256, dtype=np.uint64)
    lut = np.zeros((K, 256), np.uint64)
    # Positions >= 32 within a word overflow the device's uint32 shift and
    # are dropped there (e.g. K=9: lo positions reach 35); the host keys
    # must drop them identically or the merge order diverges from the
    # device sort order the segment arrays are actually in.
    for b in range(hi_bits):                       # hi word, shifted up 32
        bit = (v >> np.uint64(7 - b)) & np.uint64(1)
        for j in range(K):
            pos = hi_bits * K - 1 - (b * K + j)
            if pos < 32:
                lut[j] |= bit << np.uint64(32 + pos)
    for b in range(lo_bits):                       # lo word
        bit = (v >> np.uint64(7 - hi_bits - b)) & np.uint64(1)
        for j in range(K):
            pos = lo_bits * K - 1 - (b * K + j)
            if pos < 32:
                lut[j] |= bit << np.uint64(pos)
    return lut


def interleave_keys64(codes: np.ndarray, K: int) -> np.ndarray:
    """(..., m, K) region ids -> (..., m) uint64 interleaved sort keys
    (the two packed uint32 words of ``detree.interleave_keys`` joined —
    detree's exact order; asserted in tests/test_torch_streaming.py).
    Pure numpy: the compactor is the host maintenance path and must not
    round-trip keys through the device."""
    lut = _key_lut(K)
    c = np.asarray(codes, np.intp)
    out = lut[0][c[..., 0]]
    for j in range(1, K):
        out = out | lut[j][c[..., j]]
    return out


def stable_merge_positions(keys_a: np.ndarray,
                           keys_b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Output positions of two key-sorted runs in their stable merge
    (ties: all of A before B).  pos_a[i] = i + #{b < a_i}; pos_b[j] =
    j + #{a <= b_j}.  Disjoint and complete by construction."""
    pos_a = np.arange(len(keys_a)) + np.searchsorted(keys_b, keys_a, "left")
    pos_b = np.arange(len(keys_b)) + np.searchsorted(keys_a, keys_b, "right")
    return pos_a, pos_b


_RUN_FIELDS = ("keys", "gids", "proj", "codes")


def _merge_two(a: dict, b: dict) -> dict:
    """Merge two stacked per-tree runs of (L, m, ...) arrays in one scatter
    per field (positions per tree, assembly vectorized over trees)."""
    L, ma = a["keys"].shape
    mb = b["keys"].shape[1]
    pos_a = np.empty((L, ma), np.intp)
    pos_b = np.empty((L, mb), np.intp)
    for l in range(L):                      # searchsorted is 1-D only
        pos_a[l], pos_b[l] = stable_merge_positions(a["keys"][l],
                                                    b["keys"][l])
    rows = np.arange(L)[:, None]
    out = {}
    for name in _RUN_FIELDS:
        arr = np.empty((L, ma + mb) + a[name].shape[2:], a[name].dtype)
        arr[rows, pos_a] = a[name]
        arr[rows, pos_b] = b[name]
        out[name] = arr
    return out


def _tree_runs(seg: Segment, K: int) -> dict:
    """All L trees' surviving rows in sorted order, stacked (L, m, ...)
    (tombstones dropped).  Every tree keeps the same survivor set, so the
    per-tree counts are equal and one boolean take + reshape extracts all
    trees at once."""
    f = seg.forest
    pid = _host(f.point_ids)                           # (L, n_pad)
    valid = _host(f.valid)
    sel = valid.copy()
    sel[valid] = seg.live[pid[valid]]                  # (L, n_pad)
    L = pid.shape[0]
    m = int(sel[0].sum())
    rows = pid[sel].reshape(L, m)
    codes = _host(f.codes_sorted)[sel].reshape(L, m, K)
    return dict(keys=interleave_keys64(codes, K),
                gids=seg.gids[rows].astype(np.int64),
                proj=_host(f.proj_sorted)[sel].reshape(L, m, K),
                codes=codes)


def _leaf_summaries(codes_pad: np.ndarray, valid: np.ndarray,
                    leaf_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy mirror of detree.assemble_sorted_forest's blockwise lo/hi
    computation, for all L trees at once: codes_pad (L, n_pad, K),
    valid (n_pad,) -> lo/hi (L, n_leaves, K) int16, leaf_valid bool."""
    L, n_pad, K = codes_pad.shape
    n_leaves = n_pad // leaf_size
    blocks = codes_pad.reshape(L, n_leaves, leaf_size, K).astype(np.int32)
    bmask = valid.reshape(n_leaves, leaf_size)[None]
    big = np.iinfo(np.int32).max
    lo = np.where(bmask[..., None], blocks, big).min(axis=2)
    hi = np.where(bmask[..., None], blocks, -1).max(axis=2)
    leaf_valid = np.broadcast_to(bmask.any(axis=2), (L, n_leaves))
    lo = np.where(leaf_valid[..., None], lo, 0).astype(np.int16)
    hi = np.where(leaf_valid[..., None], hi, 0).astype(np.int16)
    return lo, hi, leaf_valid


def merge_segments(segments: List[Segment], *, leaf_size: int,
                   seg_id: int) -> Optional[Segment]:
    """Merge sealed segments into one, dropping tombstoned rows.

    Returns the merged Segment, or None when no row survives (the caller
    then just drops the inputs).  Correctness invariant: for every tree,
    the merged array is the stable key-sorted interleaving of the inputs'
    surviving rows — exactly what ``build_forest`` would produce for the
    surviving union encoded with the same (frozen-inner-edge) breakpoints,
    up to equal-key orderings, which the leaf bounds never depend on.
    """
    assert segments
    f0 = segments[0].forest
    L, K = f0.L, f0.K
    dev = segments[0].data.device
    bps = [_host(s.forest.breakpoints) for s in segments]
    for bp in bps[1:]:   # shared key space: inner edges must be identical
        np.testing.assert_allclose(bp[..., 1:-1], bps[0][..., 1:-1],
                                   rtol=0, atol=0)

    # Survivor rows in segment-list order define the merged local id space.
    datas = [_host(s.data)[s.live] for s in segments]
    gid_parts = [s.gids[s.live].astype(np.int64) for s in segments]
    data_m = (np.concatenate(datas) if datas else
              np.zeros((0, segments[0].data.shape[1]), np.float32))
    gids_m = np.concatenate(gid_parts) if gid_parts else np.zeros(0, np.int64)
    m = len(gids_m)
    if m == 0:
        return None
    order = np.argsort(gids_m, kind="stable")
    gids_sorted = gids_m[order]

    run = _tree_runs(segments[0], K)
    for seg in segments[1:]:
        run = _merge_two(run, _tree_runs(seg, K))
    assert run["gids"].shape == (L, m), (run["gids"].shape, m)

    n_leaves = -(-m // leaf_size)
    n_pad = n_leaves * leaf_size
    pad = n_pad - m
    valid = np.arange(n_pad) < m

    # gid -> merged local id, all trees at once (searchsorted broadcasts
    # over the stacked (L, m) lookup).
    local = order[np.searchsorted(gids_sorted, run["gids"])].astype(np.int32)
    pids = np.concatenate(
        [local, np.full((L, pad), m, np.int32)], axis=1)
    projs = np.concatenate(
        [run["proj"].astype(np.float32), np.zeros((L, pad, K), np.float32)],
        axis=1)
    codes_pad = np.concatenate(
        [run["codes"].astype(np.uint8), np.zeros((L, pad, K), np.uint8)],
        axis=1)
    leaf_lo, leaf_hi, leaf_valid = _leaf_summaries(codes_pad, valid,
                                                   leaf_size)

    bp_stack = np.stack(bps)                       # (S, L, K, Nr+1)
    bp_m = bps[0].copy()
    bp_m[..., 0] = bp_stack[..., 0].min(axis=0)    # widened union outer edges
    bp_m[..., -1] = bp_stack[..., -1].max(axis=0)

    arrays = dict(point_ids=pids, proj_sorted=projs, codes_sorted=codes_pad,
                  valid=np.tile(valid, (L, 1)), leaf_lo=leaf_lo,
                  leaf_hi=leaf_hi, leaf_valid=leaf_valid, breakpoints=bp_m)
    forest = DEForest(n=m, leaf_size=leaf_size,
                      **{k: to_device(np.ascontiguousarray(v), dev,
                                      FOREST_DTYPES[k])
                         for k, v in arrays.items()})

    live_rows = sum(int(s.n_live) for s in segments)
    clip = (sum(s.clip_fraction * max(s.n_live, 1) for s in segments)
            / max(live_rows, 1))
    return Segment(seg_id=seg_id, data=to_device(data_m, dev),
                   gids=gids_m.astype(np.int32), live=np.ones(m, bool),
                   forest=forest, clip_fraction=clip)
