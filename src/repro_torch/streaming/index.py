"""StreamingDETLSH: the mutable, segmented DET-LSH index, in PyTorch.

Structure: a ``Manifest`` of sealed ``Segment``s plus one mutable
``Memtable`` delta.  Inserts append to the delta (answered exactly until
sealed); deletes tombstone wherever the point lives; sealing encodes the
delta with the base build's frozen breakpoints through the
``project_encode_pack`` kernel; compaction merges sealed segments on the
host and atomically swaps the result in.

Queries fan out over {segments + delta}: each sealed segment runs the
ordinary batched c^2-k-ANN (fused or vmap engine) over its own forest with
its tombstone mask, the delta is answered by exact brute force over its
<= capacity rows, and the per-source top-k lists — in *global* id space —
are combined through ``core/candidates.py`` (merge_round dedup +
canonicalize), the machinery the vmap engine's round loop uses.

Guarantee argument: each segment query is a standard DET-LSH query over
that segment's live points (T1 uses the segment's total row count
n_seg >= n_live, which only delays termination — a superset, safe), the
delta is exact, and the final k is the best-of-union — so recall over the
surviving union is bounded below by the paper's per-segment guarantee.

The state and its answers are the reference package's
(``repro.streaming``): a snapshot written by either package loads in the
other with the same ``state_digest`` and the same search answers.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device, to_device
from repro_torch.api import registry as engine_registry
from repro_torch.core import encoding as enc
from repro_torch.core import candidates as cand
from repro_torch.core import estimate_r_min, hashing
from repro_torch.core.query import QueryResult, _topk_smallest, \
    knn_query_batch
from repro_torch.core.theory import LSHParams, derive_params
from repro_torch.streaming.compactor import merge_segments
from repro_torch.streaming.manifest import Manifest
from repro_torch.streaming.memtable import Memtable
from repro_torch.streaming.segment import Segment, build_segment

_DELTA = "delta"     # locator tag for rows still in the memtable


def _locations(gids: np.ndarray, where: Any, positions: Any):
    """(gid, (where, position)) pairs for ``locator.update``, built from
    Python ints in one pass: a per-row loop over numpy scalars made the
    host side of a seal and of a compaction dominate their device work."""
    return zip(np.asarray(gids).tolist(),
               zip(itertools.repeat(where), list(positions)))


class _SegView(NamedTuple):
    """One segment's pinned query inputs.

    Pinning = holding references taken at pin time: a later ``mark_dead``
    replaces the segment's *caches* but never writes into the tensors an
    earlier pin captured.  ``live_host`` is a copy (the host bitmap does
    mutate in place) — it exists for ``PinnedView.survivors()``, the oracle
    input, not for the query path.
    """

    seg: Segment
    live_dev: Optional[torch.Tensor]         # (m,) bool, None = all live
    live_sorted_dev: Optional[torch.Tensor]  # (L, n_pad) bool, None = all
    gmap: torch.Tensor                       # (m+1,) int32 local -> global
    live_host: np.ndarray                    # (m,) bool copy at pin time


@dataclasses.dataclass(frozen=True)
class PinnedView:
    """An immutable epoch of a ``StreamingDETLSH``.

    Everything a query needs is captured by reference to tensors nothing
    writes into (sealed rows, device caches) or by copy (host bitmaps,
    delta rows), so any interleaving of upsert/delete/seal/compact after
    the pin leaves this view answering exactly as the index did at pin
    time; ``search(queries, request, view=...)`` runs the ordinary fan-out
    against it.
    """

    manifest_version: int
    memtable_version: int
    id_capacity: int                      # combine sentinel / bitmap width
    segs: tuple                           # of _SegView (n_live > 0 only)
    delta: Optional[tuple]                # (vecs, live, gmap) device tensors
    delta_n_live: int
    delta_capacity: int
    delta_host: Optional[tuple]           # (vecs, gids, live) host copies
    # per-view r_min cache (the index cache is keyed by *current* versions)
    _rmin: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @property
    def fingerprint(self) -> tuple:
        return (self.manifest_version, self.memtable_version)

    @property
    def n_live(self) -> int:
        return (sum(int(v.live_host.sum()) for v in self.segs)
                + self.delta_n_live)

    def survivors(self) -> tuple:
        """(vectors, gids) alive at pin time — the from-scratch-rebuild
        oracle input."""
        vecs = [v.seg.data.cpu().numpy()[v.live_host] for v in self.segs]
        gids = [v.seg.gids[v.live_host].astype(np.int64) for v in self.segs]
        if self.delta_host is not None:
            dv, dg, dl = self.delta_host
            vecs.append(dv[dl])
            gids.append(dg[dl])
        if not vecs:
            d = (self.segs[0].seg.data.shape[1] if self.segs
                 else (self.delta_host[0].shape[1] if self.delta_host
                       else 0))
            return np.zeros((0, d), np.float32), np.zeros(0, np.int64)
        return np.concatenate(vecs), np.concatenate(gids)


class StreamingDETLSH:
    """Mutable segmented DET-LSH index with upsert / delete / compaction.

    Satisfies ``repro_torch.api.MutableAnnIndex``: the typed ``search``
    surface plus ``upsert``/``delete``/``maybe_compact`` and snapshot
    ``save``.  Rows, forests and caches live on A's device; the memtable,
    gids, tombstone bitmaps and the locator live on the host.
    """

    def __init__(self, params: LSHParams, A: torch.Tensor,
                 bp_all: torch.Tensor, base: Optional[Segment], *, Nr: int,
                 leaf_size: int, delta_capacity: int = 512,
                 max_segments: int = 4, id_capacity: int = 1 << 20,
                 build_impl: str = "auto"):
        self.params = params
        self.A = A
        self.bp_all = bp_all              # (L*K, Nr+1) frozen breakpoints
        self.Nr = Nr
        self.leaf_size = leaf_size
        self.build_impl = build_impl      # seal-path builder
        self.max_segments = max_segments
        self.id_capacity = int(id_capacity)
        self.manifest = Manifest()
        self.locator: Dict[int, Tuple] = {}   # gid -> (_DELTA, slot) | (seg_id, row)
        self.next_gid = 0
        self._next_seg_id = 0
        d = A.shape[0]
        self.memtable = Memtable(delta_capacity, d)
        self._delta_cache: Optional[tuple] = None  # (version, device tensors)
        self.spec: Any = None             # IndexSpec when built via from_spec
        # ((manifest.version, memtable.version), {k: r_min}) — the per-k
        # radius-estimate cache, invalidated by structural mutation.
        self._rmin_cache: Tuple[Tuple[int, int], Dict[int, float]] = \
            ((-1, -1), {})
        # Seconds per stage of the base build and of the latest seal, each
        # stage ended by a device sync (empty for a loaded index).
        self.build_seconds: dict = {}
        self.last_seal_seconds: dict = {}
        if base is not None:
            self.manifest.add(base)
            self._next_seg_id = base.seg_id + 1
            self.locator.update(_locations(base.gids, base.seg_id,
                                           range(base.m)))
            self.next_gid = int(base.gids.max()) + 1 if base.m else 0

    @property
    def device(self) -> torch.device:
        return self.A.device

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    @classmethod
    def build(cls, data: Any, generator: Optional[torch.Generator] = None,
              params: Optional[LSHParams] = None, *,
              Nr: int = enc.DEFAULT_NR, leaf_size: int = 64,
              delta_capacity: int = 512, max_segments: int = 4,
              id_capacity: Optional[int] = None,
              breakpoint_method: str = "sample_sort",
              project_impl: str = "auto", encode_impl: str = "auto",
              build_impl: str = "auto",
              device: Optional[Any] = None) -> "StreamingDETLSH":
        """Static base build (Alg. 1 + 2) on ``device`` (CUDA unless the
        caller asks otherwise) that also freezes the breakpoints every
        later seal will encode with.  ``generator`` draws A and then the
        breakpoint sample, as ``DETLSH.build`` does; None means a CPU
        generator seeded with 0.  ``project_impl`` picks the base build's
        projection ('pallas': the ``lsh_project`` kernel), as in the
        reference; ``build_impl`` selects the builder of the base build and
        of every later seal."""
        dev = resolve_device(device)
        params = params or derive_params()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        seconds: dict = {}
        x = to_device(data, dev, torch.float32)
        n, d = x.shape
        t0 = time.perf_counter()
        A = hashing.sample_projections(generator, d, params.K, params.L, dev)
        proj = hashing.project(x, A, impl=project_impl)
        bp_all = enc.select_breakpoints(proj, Nr, method=breakpoint_method,
                                        generator=generator)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds["projection_breakpoints"] = time.perf_counter() - t0
        base = build_segment(x, np.arange(n, dtype=np.int64), A, params,
                             bp_all, Nr=Nr, leaf_size=leaf_size, seg_id=0,
                             proj=proj, encode_impl=encode_impl,
                             build_impl=build_impl, stage_seconds=seconds)
        if id_capacity is None:
            id_capacity = max(2 * n, n + 16 * delta_capacity, 1024)
        index = cls(params, A, bp_all, base, Nr=Nr, leaf_size=leaf_size,
                    delta_capacity=delta_capacity, max_segments=max_segments,
                    id_capacity=id_capacity, build_impl=build_impl)
        index.build_seconds = seconds
        return index

    @classmethod
    def from_spec(cls, data: Any, generator: Optional[torch.Generator],
                  spec: Any, *,
                  device: Optional[Any] = None) -> "StreamingDETLSH":
        """Build from one declarative ``repro_torch.api.IndexSpec``."""
        if spec.kind != "streaming":
            raise ValueError(f"StreamingDETLSH.from_spec needs "
                             f"kind='streaming', got {spec.kind!r} "
                             f"(use repro_torch.api.build)")
        idx = cls.build(data, generator, spec.derive_params(), Nr=spec.Nr,
                        leaf_size=spec.leaf_size,
                        delta_capacity=spec.delta_capacity,
                        max_segments=spec.max_segments,
                        id_capacity=spec.id_capacity,
                        breakpoint_method=spec.breakpoint_method,
                        project_impl=spec.project_impl,
                        encode_impl=spec.encode_impl,
                        build_impl=spec.build_impl, device=device)
        idx.spec = spec
        return idx

    # ------------------------------------------------------------------
    # Mutation
    # ------------------------------------------------------------------

    def upsert(self, vectors: Any, gids: Any = None) -> np.ndarray:
        """Insert (or overwrite) rows; returns their global ids (int32).

        Overwrite semantics: an existing gid is tombstoned wherever it
        lives and re-inserted into the delta.  Sealing triggers itself when
        the delta fills; compaction is the caller's trigger
        (``maybe_compact``).
        """
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.detach().cpu().numpy()
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        m = len(vecs)
        if gids is None:
            gids = np.arange(self.next_gid, self.next_gid + m, dtype=np.int64)
        else:
            gids = np.asarray(gids, np.int64).reshape(-1)
            assert len(gids) == m, (len(gids), m)
        if m == 0:
            return gids.astype(np.int32)
        # Validate before mutating any state so the caller can recover.
        self.next_gid = self.check_upsert(gids)

        # Last write wins within one call: keep only each gid's final row.
        _, last_rev = np.unique(gids[::-1], return_index=True)
        keep = np.sort(m - 1 - last_rev, kind="stable")
        ins_gids, ins_vecs = gids[keep], vecs[keep]
        for gid in ins_gids.tolist():              # overwrite semantics
            if gid in self.locator:
                self._tombstone(gid)
        # Bulk-copy into the delta in capacity-sized blocks, sealing at
        # each fill.
        pos = 0
        while pos < len(ins_gids):
            if self.memtable.full:
                self.seal()
            take = min(self.memtable.capacity - self.memtable.count,
                       len(ins_gids) - pos)
            slots = self.memtable.add_block(ins_gids[pos:pos + take],
                                            ins_vecs[pos:pos + take])
            self.locator.update(_locations(ins_gids[pos:pos + take], _DELTA,
                                           slots.tolist()))
            pos += take
        if self.memtable.full:
            self.seal()
        return gids.astype(np.int32)

    def check_upsert(self, gids: Any) -> int:
        """Validate an upsert's global ids *without mutating anything*;
        returns the post-insert ``next_gid``."""
        gids = np.asarray(gids, np.int64).reshape(-1)
        if len(gids) == 0:
            return self.next_gid
        if gids.min() < 0:
            raise ValueError(f"gids must be non-negative, got {gids.min()}")
        new_next = max(self.next_gid, int(gids.max()) + 1)
        if new_next > self.id_capacity:
            raise ValueError(
                f"gid space exhausted ({new_next} > id_capacity="
                f"{self.id_capacity}); call grow_id_capacity() (widens the "
                f"combine step's bitmap) or build a larger index")
        return new_next

    def delete(self, gids: Any) -> int:
        """Tombstone points by global id; returns how many existed."""
        return sum(self._tombstone(g)
                   for g in np.atleast_1d(gids).astype(np.int64).tolist())

    def _tombstone(self, gid: int) -> bool:
        loc = self.locator.pop(gid, None)
        if loc is None:
            return False
        where, pos = loc
        if where == _DELTA:
            self.memtable.kill(pos)
        else:
            self._segment(where).mark_dead(pos)
        return True

    def _segment(self, seg_id: int) -> Segment:
        for s in self.manifest.segments:
            if s.seg_id == seg_id:
                return s
        raise KeyError(seg_id)

    def seal(self) -> Optional[Segment]:
        """Freeze the delta into a sealed segment (frozen-breakpoint encode
        through ``project_encode_pack``).

        All ``capacity`` slots seal — already-dead slots become tombstoned
        rows (compaction drops them) — so every sealed-from-delta segment
        has identical shapes.  The seconds of each stage replace
        ``last_seal_seconds``.
        """
        mt = self.memtable
        if mt.count == 0:
            return None
        seconds: dict = {}
        t0 = time.perf_counter()
        seg = build_segment(mt.vecs, mt.gids, self.A, self.params,
                            self.bp_all, Nr=self.Nr,
                            leaf_size=self.leaf_size,
                            seg_id=self._next_seg_id, live=mt.live,
                            build_impl=self.build_impl,
                            stage_seconds=seconds)
        self._next_seg_id += 1
        self.manifest.add(seg)
        live_slots = np.flatnonzero(mt.live[: mt.count])
        self.locator.update(_locations(mt.gids[live_slots], seg.seg_id,
                                       live_slots.tolist()))
        mt.reset()
        seconds["total"] = time.perf_counter() - t0
        self.last_seal_seconds = seconds
        return seg

    flush = seal

    def compact(self) -> bool:
        """Merge all sealed segments into one, dropping tombstones (O(n)
        sorted-array merge on the host; see streaming/compactor.py)."""
        segs = self.manifest.segments
        if len(segs) <= 1 and not any(s.has_tombstones for s in segs):
            return False
        merged = merge_segments(segs, leaf_size=self.leaf_size,
                                seg_id=self._next_seg_id)
        self._next_seg_id += 1
        self.manifest.swap([s.seg_id for s in segs],
                           [merged] if merged is not None else [])
        if merged is not None:
            self.locator.update(_locations(merged.gids, merged.seg_id,
                                           range(merged.m)))
        return True

    def grow_id_capacity(self, new_capacity: int) -> None:
        """Enlarge the global id space (the combine step's bitmap width and
        invalid-id sentinel).  Existing gids are untouched."""
        if new_capacity < self.id_capacity:
            raise ValueError(f"cannot shrink id_capacity "
                             f"({new_capacity} < {self.id_capacity})")
        self.id_capacity = int(new_capacity)
        self._delta_cache = None          # gmap sentinel baked the old value

    def maybe_compact(self) -> bool:
        """The service's compaction trigger: compact when the fan-out width
        exceeds ``max_segments`` (the swap itself is atomic)."""
        if len(self.manifest.segments) > self.max_segments:
            return self.compact()
        return False

    def requantile(self, generator: Optional[torch.Generator] = None) -> None:
        """Full rebuild with fresh breakpoints over the surviving points —
        the escape hatch when ``clip_fraction()`` says the frozen
        quantization has drifted too far.  ``generator`` draws the
        breakpoint sample (None: the fixed-stride sample)."""
        vecs, gids = self._survivors()
        if len(gids) == 0:
            raise ValueError("cannot requantile an empty index")
        data = to_device(vecs, self.device, torch.float32)
        proj = hashing.project(data, self.A)
        self.bp_all = enc.select_breakpoints(proj, self.Nr,
                                             generator=generator)
        base = build_segment(data, gids, self.A, self.params, self.bp_all,
                             Nr=self.Nr, leaf_size=self.leaf_size,
                             seg_id=self._next_seg_id, proj=proj,
                             build_impl=self.build_impl)
        self._next_seg_id += 1
        self.manifest = Manifest()
        self.manifest.add(base)
        self.memtable.reset()
        self._delta_cache = None
        self.locator = dict(_locations(base.gids, base.seg_id,
                                       range(base.m)))

    def _survivors(self) -> tuple[np.ndarray, np.ndarray]:
        vecs = [s.data.cpu().numpy()[s.live] for s in self.manifest.segments]
        gids = [s.gids[s.live].astype(np.int64)
                for s in self.manifest.segments]
        mt = self.memtable
        if mt.n_live:
            vecs.append(mt.vecs[mt.live])
            gids.append(mt.gids[mt.live])
        if not vecs:
            return (np.zeros((0, self.A.shape[0]), np.float32),
                    np.zeros(0, np.int64))
        return np.concatenate(vecs), np.concatenate(gids)

    # ------------------------------------------------------------------
    # Query
    # ------------------------------------------------------------------

    def _delta_device(self) -> tuple:
        mt = self.memtable
        if self._delta_cache is None or self._delta_cache[0] != mt.version:
            gmap = np.where(mt.live, mt.gids,
                            self.id_capacity).astype(np.int32)
            # to_device copies: the memtable buffers mutate in place, and a
            # CPU tensor made with torch.from_numpy would alias them.
            dev = self.device
            self._delta_cache = (mt.version,
                                 (to_device(mt.vecs, dev),
                                  to_device(mt.live, dev),
                                  to_device(gmap, dev)))
        return self._delta_cache[1]

    def _current_view(self) -> PinnedView:
        """The view of the *current* structure — the ordinary query path
        (a plain ``search`` is a search on a just-pinned view, so epoch
        answers can never drift from live answers)."""
        mt = self.memtable
        return PinnedView(
            manifest_version=self.manifest.version,
            memtable_version=mt.version,
            id_capacity=self.id_capacity,
            segs=tuple(
                _SegView(seg, seg.live_dev(), seg.live_sorted_dev(),
                         seg.gid_map_dev(self.id_capacity), seg.live)
                for seg in self.manifest.segments if seg.n_live > 0),
            delta=self._delta_device() if mt.n_live > 0 else None,
            delta_n_live=mt.n_live, delta_capacity=mt.capacity,
            delta_host=None)

    def pin_state(self) -> PinnedView:
        """Pin the current epoch: an immutable view that keeps answering
        exactly as of now, across any later upsert/delete/seal/compact.

        Device tensors are pinned by reference (nothing writes into them —
        later deletes replace segment *caches*); host bitmaps and delta
        rows are pinned by copy, so the view's ``survivors()`` oracle stays
        frozen too."""
        cur = self._current_view()
        mt = self.memtable
        return dataclasses.replace(
            cur,
            segs=tuple(v._replace(live_host=v.live_host.copy())
                       for v in cur.segs),
            delta_host=((mt.vecs.copy(), mt.gids.copy(), mt.live.copy())
                        if mt.count > 0 else None))

    def _query_delta(self, view: PinnedView, queries: torch.Tensor, k: int,
                     n_active: Optional[int] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k over the delta rows (bounded, one stable shape).

        Direct (q - v)^2 differences, not the qq - 2qc + pp expansion: the
        direct form avoids the expansion's cancellation error (the delta is
        the 'exact' tier of the index — keep it exact).  Its intermediate
        is B * capacity * d * 4 bytes: 0.84 GB at B = 100, capacity =
        16,384, d = 128.  Pad lanes (>= n_active) admit nothing, matching
        the segment engines.  Equal distances come in ascending slot order,
        as the reference's ``lax.top_k(-dist, k)`` gives them."""
        vecs, live, gmap = view.delta
        diff = queries[:, None, :] - vecs[None, :, :]
        dist = torch.sqrt((diff * diff).sum(-1))
        del diff
        dist = torch.where(live[None, :], dist, float("inf"))
        if n_active is not None:
            lane_ok = torch.arange(queries.shape[0],
                                   device=queries.device) < int(n_active)
            dist = torch.where(lane_ok[:, None], dist, float("inf"))
        kk = min(k, view.delta_capacity)
        sel, d = _topk_smallest(dist, kk)
        # +inf slots (dead rows, masked pad lanes) must not leak their gid.
        ids = torch.where(torch.isfinite(d), gmap[sel], view.id_capacity)
        return ids.to(torch.int32), d

    def _combine(self, sources: List[Tuple[torch.Tensor, torch.Tensor]],
                 k: int, B: int, nid: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Fold per-source (global ids, exact dists) top-k lists into the
        overall top-k via the incremental candidate merge (one lane axis).
        ``nid`` is the view's pinned invalid-id sentinel / bitmap width."""
        cap = sum(int(ids.shape[1]) for ids, _ in sources)
        state = cand.init_state(nid, cap, B, self.device)
        for ids_s, d_s in sources:
            state = cand.merge_round(nid, state, ids_s.to(torch.int32), d_s)
        ids_c, d_c = cand.canonicalize(nid, state.ids, state.dists)
        if cap < k:
            ids_c = torch.nn.functional.pad(ids_c, (0, k - cap), value=nid)
            d_c = torch.nn.functional.pad(d_c, (0, k - cap),
                                          value=float("inf"))
        return ids_c[:, :k], d_c[:, :k]

    def _rmin_entries(self) -> Dict[int, float]:
        """The per-k radius cache for the *current* structure version —
        the single place the (manifest, memtable) cache key lives.
        Resets the cache when the tag is stale."""
        tag = (self.manifest.version, self.memtable.version)
        if self._rmin_cache[0] != tag:
            self._rmin_cache = (tag, {})
        return self._rmin_cache[1]

    def _rmin_hit(self, k: int) -> bool:
        """Whether ``r_min_for(k)`` would be a cache hit right now."""
        return k in self._rmin_entries()

    def r_min_for(self, k: int, queries: Any = None) -> float:
        """Cached per-(index, k) starting radius over the current structure.

        Estimated once per (index state, k) — on the first ``r_min=None``
        search, from that batch's queries (segment rows stand in as probes
        when no queries are given) — and keyed by (manifest, memtable)
        versions so structural mutations invalidate it.  A stale estimate
        only shifts the starting radius, never correctness."""
        cache = self._rmin_entries()
        if k not in cache:
            segs = [s for s in self.manifest.segments if s.n_live > 0]
            ref = segs[0].data if segs else self.memtable.vecs
            probes = (queries if queries is not None
                      else ref[: min(64, ref.shape[0])])
            cache[k] = estimate_r_min(ref, probes, k, self.params.c)
        return cache[k]

    def _fanout_query(self, queries: torch.Tensor, req: Any, r_min: float,
                      view: PinnedView) -> QueryResult:
        """Batched c^2-k-ANN over a view's live point set (fan-out +
        combine).  Returned ids are *global* ids; invalid slots carry the
        view's ``id_capacity`` and +inf."""
        B = queries.shape[0]
        k, n_active = req.k, req.n_active
        dev = queries.device
        spec = self.spec
        probe_default = spec.probe_depth if spec is not None else 0
        sources, rounds, n_cands, final_r = [], [], [], []
        probed, pcand = [], []
        for sv in view.segs:
            seg = sv.seg
            cfg = req.to_query_config(k=min(k, seg.m), r_min=r_min,
                                      default_probe_depth=probe_default)
            fused = engine_registry.resolve_engine(
                cfg.engine, mode=cfg.mode, batch=B) == "fused"
            res = knn_query_batch(
                seg.data, seg.forest, self.A, self.params, queries, cfg,
                plan=seg.plan() if fused else None, live=sv.live_dev,
                live_sorted=sv.live_sorted_dev, n_active=n_active)
            sources.append((sv.gmap[res.ids.to(torch.int64)], res.dists))
            rounds.append(res.rounds)
            n_cands.append(res.n_candidates)
            final_r.append(res.final_r)
            if res.probed_leaves is not None:
                probed.append(res.probed_leaves)
                pcand.append(res.probe_candidates)
        if view.delta is not None:
            sources.append(self._query_delta(view, queries, k, n_active))
            delta_cand = torch.full((B,), view.delta_n_live,
                                    dtype=torch.int32, device=dev)
            if n_active is not None:
                delta_cand = torch.where(
                    torch.arange(B, device=dev) < int(n_active), delta_cand,
                    0)
            n_cands.append(delta_cand)

        zero = torch.zeros((B,), dtype=torch.int32, device=dev)
        r0 = torch.full((B,), r_min, dtype=torch.float32, device=dev)
        if not sources:
            return QueryResult(
                ids=torch.full((B, k), view.id_capacity, dtype=torch.int32,
                               device=dev),
                dists=torch.full((B, k), float("inf"), dtype=torch.float32,
                                 device=dev),
                rounds=zero, n_candidates=zero, final_r=r0,
                probed_leaves=zero, probe_candidates=zero)

        ids, dists = self._combine(sources, k, B, view.id_capacity)
        return QueryResult(
            ids=ids, dists=dists,
            rounds=functools.reduce(torch.maximum, rounds, zero),
            n_candidates=functools.reduce(torch.add, n_cands, zero),
            final_r=functools.reduce(torch.maximum, final_r, r0),
            probed_leaves=functools.reduce(torch.add, probed, zero),
            probe_candidates=functools.reduce(torch.add, pcand, zero))

    def _view_rmin(self, view: PinnedView, k: int, probes: Any) -> float:
        """Per-(view, k) starting-radius estimate — cached *on the view*
        (the index cache is keyed by current versions, which a pinned
        epoch must not consult after a mutation)."""
        if k not in view._rmin:
            if view.segs:
                ref = view.segs[0].seg.data
            elif view.delta is not None:
                ref = view.delta[0]
            else:
                view._rmin[k] = 1.0                    # empty view
                return 1.0
            probes = probes if probes is not None and len(probes) \
                else ref[: min(64, ref.shape[0])]
            view._rmin[k] = estimate_r_min(ref, probes, k, self.params.c)
        return view._rmin[k]

    def search(self, queries: Any, request: Any = None, *,
               view: Optional[PinnedView] = None) -> Any:
        """Typed batched search over the live point set
        (``repro_torch.api.SearchRequest`` in, ``SearchResult`` out);
        queries move to the index's device.

        ``view`` pins the search to an epoch from ``pin_state()``: the
        answer is computed over the view's frozen structure regardless of
        any mutation since the pin.
        """
        from repro_torch.api.request import (SearchRequest, SearchResult,
                                             SearchStats)
        req = request or SearchRequest()
        if req.engine is None and self.spec is not None:
            req = dataclasses.replace(req, engine=self.spec.engine)
        queries = to_device(queries, self.device, torch.float32)
        r_min, cached = req.r_min, False
        current = (view is None
                   or view.fingerprint == (self.manifest.version,
                                           self.memtable.version))
        if r_min is None:
            # Zero-vector pad lanes must not skew the cached estimate
            # (n_active == 0 keeps the full batch: no real lanes to probe).
            probes = queries[: req.n_active] if req.n_active else queries
            if current:
                cached = self._rmin_hit(req.k)        # hit vs first estimate
                r_min = self.r_min_for(req.k, probes)
                if view is not None:
                    view._rmin.setdefault(req.k, r_min)
            else:
                cached = req.k in view._rmin
                r_min = self._view_rmin(view, req.k, probes)
        res = self._fanout_query(queries, req, float(r_min),
                                 view if view is not None
                                 else self._current_view())
        engine = engine_registry.resolve_engine(
            req.engine, mode=req.mode, batch=queries.shape[0])
        return SearchResult(
            ids=res.ids, dists=res.dists,
            stats=SearchStats(engine=engine, r_min=float(r_min),
                              r_min_cached=cached, rounds=res.rounds,
                              n_candidates=res.n_candidates,
                              final_r=res.final_r,
                              probed_leaves=res.probed_leaves,
                              probe_candidates=res.probe_candidates),
            raw=res)

    def save(self, path: Any) -> None:
        """Write a versioned snapshot directory (``repro_torch.api.load``):
        segments (rows, gids, tombstones, forests), memtable survivors,
        frozen breakpoints, and the manifest."""
        from repro_torch.api import persist
        persist.save_streaming(self, path)

    def warmup_query_caches(self) -> None:
        """Eagerly materialize per-segment device caches (fused plans,
        tombstone masks, gid maps) and the delta snapshot."""
        for seg in self.manifest.segments:
            seg.warm_caches(self.id_capacity)
        self._delta_device()

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def n_live(self) -> int:
        return self.manifest.n_live + self.memtable.n_live

    @property
    def n_points(self) -> int:
        """AnnIndex protocol: the live point count."""
        return self.n_live

    @property
    def n_total(self) -> int:
        return self.manifest.n_rows + self.memtable.count

    def clip_fraction(self) -> float:
        """Rows-weighted breakpoint-drift signal over sealed segments
        (coords of sealed inserts outside the frozen outer edges)."""
        total = sum(s.m for s in self.manifest.segments)
        if total == 0:
            return 0.0
        return sum(s.clip_fraction * s.m
                   for s in self.manifest.segments) / total

    def index_size_bytes(self) -> int:
        return (sum(s.forest.size_bytes() for s in self.manifest.segments)
                + self.A.numel() * 4)

    def state_digest(self) -> str:
        """sha256 fingerprint of the complete *logical* state: every array
        and counter that determines answers or future mutations (segments
        with their tombstone bitmaps and forests, memtable buffers, id
        allocation, frozen breakpoints).  Caches and version counters are
        excluded.  The bytes, their order and their dtypes are the
        reference's (``repro.streaming.StreamingDETLSH.state_digest``), so
        the two packages give one digest for one logical state."""
        h = hashlib.sha256()

        def put(a: Any, dtype: Any = None) -> None:
            x = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)
            if dtype is not None:
                x = x.astype(dtype)
            h.update(np.ascontiguousarray(x).tobytes())

        for v in (self.next_gid, self._next_seg_id, self.id_capacity,
                  self.Nr, self.leaf_size, self.memtable.count):
            h.update(int(v).to_bytes(8, "little", signed=True))
        put(self.A, np.float32)
        put(self.bp_all, np.float32)
        for seg in sorted(self.manifest.segments, key=lambda s: s.seg_id):
            h.update(int(seg.seg_id).to_bytes(8, "little", signed=True))
            h.update(np.float64(seg.clip_fraction).tobytes())
            put(seg.data, np.float32)
            put(seg.gids, np.int64)
            put(seg.live, np.uint8)
            for name in ("point_ids", "proj_sorted", "codes_sorted",
                         "valid", "leaf_lo", "leaf_hi", "leaf_valid",
                         "breakpoints"):
                put(getattr(seg.forest, name))
        mt = self.memtable
        put(mt.vecs, np.float32)
        put(mt.gids, np.int64)
        put(mt.live, np.uint8)
        return h.hexdigest()

    def stats(self) -> dict:
        return {
            "n_live": self.n_live, "n_total": self.n_total,
            "delta_rows": self.memtable.count,
            "delta_live": self.memtable.n_live,
            "clip_fraction": round(self.clip_fraction(), 6),
            "manifest": self.manifest.describe(),
        }
