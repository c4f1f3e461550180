"""KVCacheIndex: the KV cache as a MutableAnnIndex.

DET-LSH attention decode on the index stack:

  * **prefill** is a batched build: per (batch, kv-head) the augmented keys
    go through ``build_forest`` (frozen per-head breakpoints) and
    ``make_fused_plan``, exactly like ``DETLSH``;
  * **each decode step** is an upsert of the new key into a delta buffer
    (``streaming.BatchedMemtable``: H lockstep heads, one cursor) plus a
    batched fused query over {sealed forests + delta}: each radius round is
    ONE ``range_rerank_heads`` launch for all H forests, folded through
    ``inv_perm`` and ``core.query.fused_round_update`` with the (H, g)
    lanes flattened into H*g lanes of the fused engine's own update;
  * the MIPS -> L2 reduction (``decode.mips``) is the transform layer: keys
    are augmented once (radius frozen at prefill), queries zero-extended
    and rescaled per step.

Candidate ids ARE cache positions: sealed forests are built over keys in
cache-position order and delta slots carry their position as gid, so the
retrieval output feeds ``decode.attention`` directly.

Device rule: ``prefill`` runs on CUDA unless given ``device=``; every later
call follows the index's device.  The host buffers (tombstones, the delta,
the augmented keys) are numpy arrays changed in place; they reach the
device only as copies (``_device.to_device``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device, to_device
from repro_torch.api.request import (SearchRequest, SearchResult,
                                     SearchStats, _check_positive)
from repro_torch.api.spec import IndexSpec
from repro_torch.core import _host, hashing
from repro_torch.core.detree import build_forest
from repro_torch.core.query import (_topk_smallest, fused_round_update,
                                    fused_topk, make_fused_plan)
from repro_torch.core.theory import LSHParams, derive_params
from repro_torch.decode import mips
from repro_torch.kernels import ops
from repro_torch.kernels.range_rerank import row_pitch
from repro_torch.streaming.memtable import BatchedMemtable

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class KVSpec:
    """Build/search configuration for a ``KVCacheIndex``.

    Validation routes through ``IndexSpec`` (``index_spec()``), so the KV
    path fails with the same messages as every other index (Nr <= 256,
    positive leaf_size, known breakpoint method, ...); the decode-only
    knobs are checked here.
    """

    K: int = 4
    L: int = 4
    c: float = 1.5
    beta_override: Optional[float] = 0.1
    Nr: int = 64
    leaf_size: int = 32
    # full_sort is the seed ``det_attention`` breakpoint selection; at KV
    # scale (S ~ thousands per head) the full sort is cheap.
    breakpoint_method: str = "full_sort"
    build_impl: str = "auto"
    delta_capacity: int = 128     # decode steps between reseals
    m_top: int = 64               # retrieved positions per (kv-head, q-head)
    max_rounds: int = 8           # radius enlargements per retrieval
    radius_slack: float = 1e-6    # headroom on the frozen MIPS radius

    def __post_init__(self):
        self.index_spec()                      # shared eager validation
        _check_positive("m_top", self.m_top)
        _check_positive("max_rounds", self.max_rounds)
        if not self.radius_slack >= 0.0:
            raise ValueError(f"radius_slack must be >= 0, got "
                             f"{self.radius_slack!r} (it is headroom for "
                             f"post-prefill key-norm drift)")

    def index_spec(self) -> IndexSpec:
        """The equivalent ``IndexSpec`` (streaming kind: the KV index is a
        delta-buffered mutable index); constructing it IS the validation."""
        return IndexSpec(kind="streaming", K=self.K, L=self.L, c=self.c,
                         beta_override=self.beta_override, Nr=self.Nr,
                         leaf_size=self.leaf_size,
                         breakpoint_method=self.breakpoint_method,
                         build_impl=self.build_impl,
                         delta_capacity=self.delta_capacity)

    def derive_params(self) -> LSHParams:
        return derive_params(K=self.K, c=self.c, L=self.L,
                             beta_override=self.beta_override)


class HeadForest(NamedTuple):
    """H stacked per-(batch, kv-head) DE-Forests + their fused plans."""
    point_ids: torch.Tensor      # (H, L, n_pad) int32
    valid: torch.Tensor          # (H, L, n_pad) bool
    leaf_lo: torch.Tensor        # (H, L, nl, K) int16
    leaf_hi: torch.Tensor        # (H, L, nl, K) int16
    leaf_valid: torch.Tensor     # (H, L, nl) bool
    breakpoints: torch.Tensor    # (H, L, K, Nr+1) f32
    points_sorted: torch.Tensor  # (H, L, n_pad, d_aug) f32, rows padded
    inv_perm: torch.Tensor       # (H, L, n) int32


class KVRetrieval(NamedTuple):
    ids: torch.Tensor            # (H, g, m_top + C) int32 positions (-1 = none)
    dists: torch.Tensor          # (H, g, m_top + C) f32 augmented-L2 (+inf)
    rounds: torch.Tensor         # (H, g) int32
    n_candidates: torch.Tensor   # (H, g) int32 — |S| in the sealed forests


class _RoundParams(NamedTuple):
    c: float                     # fused_round_update only reads params.c


class RoundInputs(NamedTuple):
    """What every round of one retrieval shares."""
    q_aug: torch.Tensor          # (H, g, d_aug) augmented, key-scaled queries
    q_proj: torch.Tensor         # (H, L, g, K) their projections
    live_sorted: torch.Tensor    # (H, L, n_pad) tombstones in sorted order
    fold: torch.Tensor           # (H, L, g, n) int64 inv_perm, per lane


def _retrieve_impl(inp: RoundInputs, forest: HeadForest,
                   delta_vecs: torch.Tensor, delta_gids: torch.Tensor,
                   delta_mask: torch.Tensor, r_min: float, *, m_top: int,
                   max_rounds: int, leaf_size: int, eps: float, c: float,
                   beta: float) -> tuple[torch.Tensor, ...]:
    """Batched fused retrieval over {sealed forests + delta}.

    ``inp`` from :meth:`KVCacheIndex.round_inputs`; delta_vecs (H, C,
    d_aug); delta_gids (C,) positions; delta_mask (C,) live-and-assigned.
    One ``range_rerank_heads`` pass a round and one host sync a round, on
    "is any lane still running".
    """
    q_aug, fold = inp.q_aug, inp.fold
    H, L, g, n = fold.shape
    dev = q_aug.device
    thresh = torch.tensor(beta * n + m_top, dtype=torch.float32, device=dev)
    params = _RoundParams(c=c)

    rnd = 0
    rounds = torch.zeros((H * g,), dtype=torch.int32, device=dev)
    r = torch.full((H * g,), r_min, dtype=torch.float32, device=dev)
    done = torch.zeros((H * g,), dtype=torch.bool, device=dev)
    best = torch.full((H * g, n), _INF, dtype=torch.float32, device=dev)
    while rnd < max_rounds and bool((~done).any()):        # one sync a round
        r_eff = torch.where(done, -1.0, eps * r).reshape(H, g)
        dmat = ops.range_rerank_heads(
            q_aug, inp.q_proj, r_eff, forest.leaf_lo, forest.leaf_hi,
            forest.leaf_valid, forest.breakpoints, forest.points_sorted,
            forest.valid, inp.live_sorted,
            leaf_size=leaf_size)                        # (H, L, g, n_pad)
        by_id = torch.gather(dmat, 3, fold).amin(dim=1)         # (H, g, n)
        del dmat
        best, r, done, rounds = fused_round_update(
            best, by_id.reshape(H * g, n), r, done, rounds, rnd,
            params=params, k=m_top, thresh=thresh)
        rnd += 1

    ids_f, dists_f, count = fused_topk(best, m_top, n)
    ids_f = torch.where(torch.isfinite(dists_f), ids_f, -1)

    # Delta tier: exact augmented distances over the (tiny) buffer, in the
    # difference form.
    diff = delta_vecs[:, None, :, :] - q_aug[:, :, None, :]     # (H, g, C, d)
    dd = torch.sqrt(torch.clamp_min((diff * diff).sum(-1), 0.0))
    dd = torch.where(delta_mask[None, None, :], dd, _INF)
    did = torch.where(delta_mask, delta_gids.to(torch.int32), -1)
    did = did[None, None, :].expand(dd.shape)

    ids = torch.cat([ids_f.reshape(H, g, m_top), did], dim=-1)
    dists = torch.cat([dists_f.reshape(H, g, m_top), dd], dim=-1)
    return ids, dists, rounds.reshape(H, g), count.reshape(H, g)


class KVCacheIndex:
    """Per-(batch, kv-head) DE-Forests over a KV cache's augmented keys.

    Satisfies ``repro_torch.api.MutableAnnIndex``: ``upsert`` appends the
    next decode step's key(s), ``delete`` tombstones evicted positions,
    ``search`` answers the protocol surface (queries in decode layout
    (b, 1, h, dh), ids are cache positions).  ``retrieve`` is the
    decode-native entry returning the full (H, g, m) candidate tables the
    sparse-attention assembler consumes.
    """

    def __init__(self, spec: KVSpec, params: LSHParams, A: torch.Tensor,
                 b: int, hk: int, dh: int, R2: torch.Tensor,
                 forest: HeadForest, aug_keys: np.ndarray):
        self.spec = spec
        self.params = params
        self.A = A
        self.device = A.device
        self.b, self.hk, self.dh = b, hk, dh
        self.H = b * hk
        self.d_aug = dh + 1
        self.R2 = R2                                   # (H,) frozen radius^2
        self.forest = forest
        self.n_sealed = aug_keys.shape[1]
        self.next_pos = self.n_sealed
        self._aug = aug_keys                           # (H, n_sealed, d_aug)
        self._live = np.ones(self.n_sealed, bool)
        self.delta = BatchedMemtable(self.H, spec.delta_capacity, self.d_aug)
        self.clip_total = 0                            # upserts beyond R
        self.seals = 0
        self._r_min_cache: Optional[float] = None

    # ------------------------------------------------------------------
    # Build (prefill)
    # ------------------------------------------------------------------

    @classmethod
    def prefill(cls, k_cache: Any, generator: Optional[torch.Generator] = None,
                spec: Optional[KVSpec] = None, *, A: Any = None,
                device: Optional[Any] = None) -> "KVCacheIndex":
        """k_cache (b, S, hk, dh) -> index over all S prefix positions, on
        ``device`` (CUDA unless the caller asks otherwise).

        ``generator`` draws the (dh+1, L*K) projection matrix A (None means
        a CPU generator seeded with 0).  ``A``, when given, is used instead
        of a draw: that is how another package's matrix (the reference's,
        drawn with ``jax.random``) comes in, so both build the same forests.
        """
        dev = resolve_device(device)
        spec = spec or KVSpec()
        keys = to_device(k_cache, dev)
        b, S, hk, dh = keys.shape
        params = spec.derive_params()
        keys = keys.permute(0, 2, 1, 3).reshape(b * hk, S, dh)
        R2 = mips.mips_radius(keys, slack=spec.radius_slack)      # (H,)
        aug, _ = mips.augment_keys(keys, R2)                      # (H, S, d+1)
        if A is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            A = hashing.sample_projections(generator, dh + 1, spec.K, spec.L,
                                           dev)
        else:
            A = to_device(A, dev, torch.float32)
        proj = torch.matmul(aug, A)                               # (H, S, LK)
        forest = cls._build_heads(aug, proj, spec)
        return cls(spec, params, A, b, hk, dh, R2, forest, _host(aug))

    @staticmethod
    def _build_heads(aug: torch.Tensor, proj: torch.Tensor, spec: KVSpec,
                     breakpoints: Optional[np.ndarray] = None) -> HeadForest:
        """Stack per-head ``build_forest`` + ``make_fused_plan`` outputs.

        ``points_sorted`` is a view of the first d_aug columns of rows
        stored ``row_pitch(d_aug)`` floats apart (zeros beyond d_aug), so
        that the heads kernel stages them with 16-byte copies.

        ``breakpoints`` ((H, L*K, Nr+1), optional) is the reseal path:
        encode with the prefill quantization (outer edges pre-widened by
        the caller) instead of re-selecting per-head quantiles.
        """
        cols = {f: [] for f in HeadForest._fields}
        points = None
        for h in range(aug.shape[0]):
            f = build_forest(
                proj[h], spec.K, spec.L, Nr=spec.Nr,
                leaf_size=spec.leaf_size,
                breakpoint_method=spec.breakpoint_method,
                breakpoints=(None if breakpoints is None
                             else to_device(breakpoints[h], aug.device)),
                build_impl=spec.build_impl)
            plan = make_fused_plan(aug[h], f)
            for name in ("point_ids", "valid", "leaf_lo", "leaf_hi",
                         "leaf_valid", "breakpoints"):
                cols[name].append(getattr(f, name))
            if points is None:          # rows 16-byte aligned: d = 129 -> 132
                ps = plan.points_sorted
                points = ps.new_zeros((aug.shape[0], *ps.shape[:-1],
                                       row_pitch(ps.shape[-1])))
            points[h, ..., :aug.shape[-1]] = plan.points_sorted
            cols["inv_perm"].append(plan.inv_perm)
        del cols["points_sorted"]
        return HeadForest(points_sorted=points[..., :aug.shape[-1]],
                          **{k: torch.stack(v) for k, v in cols.items()})

    # ------------------------------------------------------------------
    # Mutation (the decode step's write half)
    # ------------------------------------------------------------------

    def upsert(self, vectors: Any, gids: Any = None) -> int:
        """Insert one decode step's keys ((b, hk, dh) or (b, 1, hk, dh));
        returns the assigned cache position.  ``gids`` must be None —
        positions are implicit (the KV cache is append-only)."""
        if gids is not None:
            raise ValueError("KVCacheIndex assigns positions itself; "
                             "gids must be None")
        vec = to_device(vectors, self.device)
        if vec.ndim == 4:                      # (b, 1, hk, dh) decode layout
            vec = vec[:, 0]
        if tuple(vec.shape) != (self.b, self.hk, self.dh):
            raise ValueError(f"expected one key per (batch, kv-head) "
                             f"({self.b}, {self.hk}, {self.dh}), got "
                             f"{tuple(vec.shape)}")
        rows = vec.reshape(self.H, 1, self.dh)
        aug, clipped = mips.augment_keys(rows, self.R2)     # frozen radius
        self.clip_total += int(clipped)
        pos = self.next_pos
        self.delta.add_step(pos, _host(aug[:, 0]))
        self._live = np.append(self._live, True)
        self.next_pos += 1
        if self.delta.full:
            self._seal()
        return pos

    def delete(self, gids: Any) -> int:
        """Tombstone cache positions (eviction); returns #newly dead."""
        removed = 0
        for pos in np.atleast_1d(np.asarray(gids, np.int64)):
            if not 0 <= pos < self.next_pos or not self._live[pos]:
                continue
            self._live[pos] = False
            if pos >= self.n_sealed:
                slot = int(np.where(self.delta.gids == pos)[0][0])
                self.delta.kill(slot)
            removed += 1
        return removed

    def maybe_compact(self) -> bool:
        """Seal a full delta (upsert already does; this is the protocol
        hook for callers that batch their mutations)."""
        if self.delta.full:
            self._seal()
            return True
        return False

    def _seal(self) -> None:
        """Rebuild the sealed forests over {old sealed + delta} with the
        prefill breakpoints (frozen quantization, outer edges widened to
        keep leaf boxes admissible for out-of-range new keys)."""
        cnt = self.delta.count
        if cnt == 0:
            return
        self._aug = np.concatenate([self._aug, self.delta.vecs[:, :cnt]],
                                   axis=1)
        aug = to_device(self._aug, self.device)        # (H, n_total, d_aug)
        proj = torch.matmul(aug, self.A)
        E = self.spec.Nr + 1
        bp = _host(self.forest.breakpoints).reshape(
            self.H, self.spec.L * self.spec.K, E).copy()
        bp[:, :, 0] = np.minimum(bp[:, :, 0], _host(proj.amin(dim=1)))
        bp[:, :, E - 1] = np.maximum(bp[:, :, E - 1], _host(proj.amax(dim=1)))
        self.forest = self._build_heads(aug, proj, self.spec, breakpoints=bp)
        self.n_sealed = self._aug.shape[1]
        self.delta.reset()
        self.seals += 1
        self._r_min_cache = None

    # ------------------------------------------------------------------
    # Retrieval (the decode step's read half)
    # ------------------------------------------------------------------

    def round_inputs(self, q: Any) -> RoundInputs:
        """The inputs every round of a retrieval for decode queries q
        (b, 1, h, dh) shares, built once a retrieval."""
        q = to_device(q, self.device)
        b, one, h, dh = q.shape
        if (b, dh) != (self.b, self.dh) or one != 1 or h % self.hk:
            raise ValueError(f"query shape {tuple(q.shape)} does not match "
                             f"cache (b={self.b}, hk={self.hk}, "
                             f"dh={self.dh})")
        g = h // self.hk
        f, H, n = self.forest, self.H, self.n_sealed
        L, K = f.breakpoints.shape[1], f.breakpoints.shape[2]
        q_aug = mips.augment_queries(q.reshape(H, g, dh))
        # Rescale lanes to the key-norm scale: order-preserving per lane
        # (retrieval ranks by q.k either way) and it restores the LSH
        # contrast that large-norm attention queries otherwise destroy.
        q_aug = mips.normalize_queries(q_aug, self.R2[:, None])
        q_proj = torch.matmul(q_aug, self.A).reshape(H, g, L, K).permute(
            0, 2, 1, 3).contiguous()
        live_pos = to_device(self._live[:n], self.device)
        live_sorted = (live_pos[torch.clamp(f.point_ids.to(torch.int64), 0,
                                            n - 1)] & f.valid)
        fold = f.inv_perm.to(torch.int64)[:, :, None, :].expand(H, L, g, n)
        return RoundInputs(q_aug, q_proj, live_sorted, fold)

    def retrieve(self, q: Any, r_min: Optional[float] = None) -> KVRetrieval:
        """q (b, 1, h, dh) decode queries -> per-(kv-head, q-head)
        candidate positions ranked by augmented L2 (monotone in q.k)."""
        inp = self.round_inputs(q)
        if r_min is None:
            r_min = self._estimate_r_min(inp.q_aug)
        delta_mask = (self.delta.live
                      & (np.arange(self.delta.capacity) < self.delta.count))
        dev = self.device
        ids, dists, rounds, count = _retrieve_impl(
            inp, self.forest, to_device(self.delta.vecs, dev),
            to_device(self.delta.gids, dev), to_device(delta_mask, dev),
            float(r_min), m_top=self.spec.m_top,
            max_rounds=self.spec.max_rounds, leaf_size=self.spec.leaf_size,
            eps=float(self.params.epsilon), c=float(self.params.c),
            beta=float(self.params.beta))
        return KVRetrieval(ids=ids, dists=dists, rounds=rounds,
                           n_candidates=count)

    def _estimate_r_min(self, q_aug: Any) -> float:
        """First-retrieval starting radius: the m_top-th augmented distance
        from a key subsample (paper §V-B1 heuristic), cached until the next
        seal.  Host numpy, exactly as the reference computes it."""
        if self._r_min_cache is None:
            qa = _host(q_aug)                             # (H, g, d)
            m = min(self.n_sealed, 512)
            sub = self._aug[:, :m]                        # (H, m, d)
            d2 = (((qa[:, :, None, :] - sub[:, None, :, :]) ** 2)
                  .sum(-1))                               # (H, g, m)
            kth = np.sqrt(np.partition(
                d2, min(self.spec.m_top, m - 1), axis=-1)
                [..., min(self.spec.m_top, m - 1)])
            r = float(np.median(kth))
            self._r_min_cache = max(r / (self.params.c ** 2), 1e-6)
        return self._r_min_cache

    # ------------------------------------------------------------------
    # AnnIndex protocol surface
    # ------------------------------------------------------------------

    @property
    def n_points(self) -> int:
        return int(self._live.sum())

    def search(self, queries: Any, request: Optional[SearchRequest] = None
               ) -> SearchResult:
        """Protocol search: queries (b, 1, h, dh) -> per-lane top-k cache
        positions, lanes flattened to (H*g, k).  Equal distances come in
        ascending slot order, as the reference's ``lax.top_k`` gives them."""
        req = request or SearchRequest()
        res = self.retrieve(queries, r_min=req.r_min)
        k = min(req.k, res.ids.shape[-1])
        sel, dists = _topk_smallest(res.dists, k)
        ids = torch.gather(res.ids, -1, sel)
        H, g = res.rounds.shape
        stats = SearchStats(
            engine="fused-kv", r_min=self._r_min_cache or float("nan"),
            r_min_cached=req.r_min is None, rounds=res.rounds.reshape(-1),
            n_candidates=res.n_candidates.reshape(-1), final_r=None)
        return SearchResult(ids=ids.reshape(H * g, k),
                            dists=dists.reshape(H * g, k), stats=stats,
                            raw=res)

    def r_min_for(self, k: int) -> float:
        """Starting-radius estimate from key-to-key augmented distances
        (protocol surface; ``retrieve`` refines from the live queries)."""
        if self._r_min_cache is None:
            sub = self._aug[:, : min(self.n_sealed, 256)]
            self._estimate_r_min(sub[:, : max(1, min(8, sub.shape[1]))])
        return self._r_min_cache

    def save(self, path: Any) -> None:
        raise NotImplementedError(
            "KV caches are ephemeral: rebuild with KVCacheIndex.prefill "
            "from the cache keys instead of snapshotting")

    def index_size_bytes(self) -> int:
        """Bytes the forest arrays hold, the stored points' row padding
        included, plus the delta buffer."""
        arrays = sum(a.untyped_storage().nbytes() for a in self.forest)
        return int(arrays) + int(self.delta.vecs.nbytes)

    @property
    def scan_fraction(self) -> float:
        """Retrieved candidates / attendable positions — the work model the
        decode benchmark reports."""
        m = self.spec.m_top + self.delta.capacity
        return m / max(1, self.next_pos)
