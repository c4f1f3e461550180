"""DET-LSH query phase (paper §III-C: Alg. 3, 4, 5) — the fused engine.

The c^2-k-ANN query issues (r,c)-ANN rounds with radii r, c*r, c^2*r, ...
Each round performs a range query with projected radius eps*r in all L
DE-Trees, accumulates unique candidates into S with their exact
original-space distances, and terminates when

    (T1)  |S| >= beta*n + k                                   (Alg. 5 line 7)
    (T2)  at least k candidates satisfy ||o, q|| <= c * r     (Alg. 5 line 9)

returning the top-k of S by exact distance.

Two engines, registered in ``repro_torch.api.registry`` as the reference
registers its own:

  * ``vmap`` — the reference's per-query ``while_loop`` under ``jax.vmap``,
    with the lanes written out as a batch axis.  Each round fetches, per
    tree, the M leaves of least LB (the paper's priority queue of leaves
    becomes a top-M cut), admits those with LB <= eps*r (``mode='leaf'``)
    or the points within eps*r in projected space (``mode='strict'``, the
    unoptimized Alg. 3), reranks them exactly and merges them into the
    incremental candidate set of ``core.candidates``.  All lanes advance
    in one Python loop with one host sync a round; a lane whose loop
    condition is false keeps its state, exactly as the vmapped loop
    selects it.  ``bounds_impl``/``dist_impl='pallas'`` reach the
    ``leaf_bounds`` and ``l2_rerank`` kernels.
  * ``fused`` — see below.

The fused engine advances the whole batch through the radius rounds
together.  Each round is ONE ``range_rerank`` kernel launch (leaf LB +
radius admission + exact rerank over all L trees); the round folds into a
per-query dense best-distance table through ``inv_perm`` (a gather, not a
scatter), and |S| is the table's finite count.  Done lanes carry radius -1
and admit nothing.  The round loop is a Python ``while`` with one host
sync per round on "is any lane still running".
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.api import registry as engine_registry
from repro_torch.core import candidates as cand
from repro_torch.core.detree import DEForest, leaf_bounds
from repro_torch.core.theory import LSHParams

_INF = float("inf")


class QueryResult(NamedTuple):
    ids: torch.Tensor           # (B, k) int32 — point ids (n = invalid)
    dists: torch.Tensor         # (B, k) f32 — exact original-space distances
    rounds: torch.Tensor        # (B,) int32 — radius enlargements + 1
    n_candidates: torch.Tensor  # (B,) int32 — |S| (unique) at termination
    final_r: torch.Tensor       # (B,) f32
    probed_leaves: Optional[torch.Tensor] = None     # (B,) int32
    probe_candidates: Optional[torch.Tensor] = None  # (B,) int32


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    k: int = 50
    M: int = 8                 # leaves per tree per round (vmap engine)
    cap: int = 0               # candidate buffer (0 = auto: beta*n + k + round)
    r_min: float = 1.0
    max_rounds: int = 48
    mode: str = "leaf"         # 'leaf' (optimized, default) | 'strict'
    dist_impl: str = "auto"
    bounds_impl: str = "auto"
    engine: str = "auto"       # batch engine: 'auto' or a registered name
    probe_depth: int = 0       # near-miss leaves admitted per (tree, round)

    def __post_init__(self):
        from repro_torch.api.request import IMPLS, MODES, _check_choice, \
            _check_positive
        _check_positive("k", self.k)
        _check_positive("M", self.M)
        _check_positive("max_rounds", self.max_rounds)
        _check_positive("cap", self.cap, minimum=0)
        _check_positive("probe_depth", self.probe_depth, minimum=0)
        if not self.r_min > 0.0:
            raise ValueError(f"r_min must be positive, got {self.r_min!r}")
        _check_choice("mode", self.mode, MODES)
        _check_choice("dist_impl", self.dist_impl, IMPLS)
        _check_choice("bounds_impl", self.bounds_impl, IMPLS)
        engine_registry.validate_engine_name(self.engine)
        if self.probe_depth and self.mode == "strict":
            raise ValueError(
                "mode='strict' reproduces the unoptimized Alg. 3 per-point "
                "filter and admits no near-miss leaves; probe_depth must be "
                f"0 in strict mode (got {self.probe_depth})")


def _topk_smallest(vals: torch.Tensor, k: int) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """The k smallest of non-negative f32 ``vals`` along the last axis,
    ascending: (positions int64, values).

    Equal values come in ascending position order, the tie rule of the
    reference's ``lax.top_k(-vals, k)``; ``torch.topk`` promises no tie
    order.  So the selection runs on unique int64 keys: a value's f32 bit
    pattern (which orders like the value for non-negative floats, +inf
    included) above its position.  ``+ 0.0`` turns -0.0 into +0.0 first."""
    bits = (vals + 0.0).view(torch.int32).to(torch.int64)
    pos = torch.arange(vals.shape[-1], dtype=torch.int64, device=vals.device)
    key = torch.topk(bits * (1 << 32) + pos, k, dim=-1, largest=False,
                     sorted=True).values
    sel = key & 0xFFFFFFFF
    return sel, torch.gather(vals, -1, sel)


# ---------------------------------------------------------------------------
# Range query over the forest (one round, all L trees) — the vmap engine
# ---------------------------------------------------------------------------

def range_query_round(forest: DEForest, q_proj: torch.Tensor,
                      r_proj: torch.Tensor, M: int, *, mode: str = "leaf",
                      bounds_impl: str = "auto",
                      live: Optional[torch.Tensor] = None,
                      probe_depth: int = 0, with_stats: bool = False):
    """Range query with projected radius ``r_proj`` in all L trees.

    q_proj: (L, B, K) projected queries of B lanes and r_proj (B,) their
    radii.  ``live`` is an optional (n,) bool tombstone mask in point-id
    order (None = all live); dead points are rejected at admission, before
    the exact rerank.

    Per (tree, lane) the M leaves of least LB are fetched (ties to the
    lower leaf index, as ``lax.top_k`` breaks them); those with LB <= r_proj
    are admitted, and ``probe_depth > 0`` also admits the probe_depth
    fetched leaves of least LB above the radius.

    Returns (ids, ok): ids (B, L*M*leaf_size) int32 candidate point ids in
    tree-major order, ok the bool mask.  With ``with_stats=True`` also (B,)
    int32 counters (probed_leaves, probe_candidates) summed over trees.
    """
    ls, n = forest.leaf_size, forest.n
    M = min(M, forest.n_leaves)
    L, B, K = q_proj.shape
    lb, _ = leaf_bounds(q_proj, forest.leaf_lo, forest.leaf_hi,
                        forest.leaf_valid, forest.breakpoints,
                        impl=bounds_impl)                      # (L, B, nl)
    leaf_idx, lb_m = _topk_smallest(lb, M)                     # best-M by LB
    r = r_proj[None, :, None]
    leaf_ok = lb_m <= r                                        # LB <= eps*r
    if probe_depth > 0:
        outside = (~leaf_ok) & torch.isfinite(lb_m)
        rank = torch.cumsum(outside, dim=-1)                   # slack order
        probe_ok = outside & (rank <= probe_depth)
        admit = leaf_ok | probe_ok
    else:
        probe_ok = torch.zeros_like(leaf_ok)
        admit = leaf_ok
    offs = torch.arange(ls, dtype=torch.int64, device=q_proj.device)
    gidx = (leaf_idx[..., None] * ls + offs).reshape(L, B, M * ls)
    n_pad = forest.point_ids.shape[1]
    ids = torch.gather(forest.point_ids[:, None, :].expand(L, B, n_pad), 2,
                       gidx)                                   # (L, B, M*ls)
    ok = admit.repeat_interleave(ls, dim=-1) & (ids < n)
    if live is not None:
        ok = ok & live[torch.clamp(ids.to(torch.int64), 0, n - 1)]
    if mode == "strict":
        idx = gidx.reshape(L, B * M * ls, 1).expand(L, B * M * ls, K)
        pts = torch.gather(forest.proj_sorted, 1, idx).reshape(L, B, M * ls,
                                                               K)
        d = torch.sqrt(((pts - q_proj[:, :, None, :]) ** 2).sum(-1))
        ok = ok & (d <= r)
    probed = probe_ok.sum((0, 2)).to(torch.int32)
    pcand = (ok & probe_ok.repeat_interleave(ls, dim=-1)).sum((0, 2)).to(
        torch.int32)
    ids = ids.permute(1, 0, 2).reshape(B, L * M * ls)
    ok = ok.permute(1, 0, 2).reshape(B, L * M * ls)
    if with_stats:
        return ids, ok, probed, pcand
    return ids, ok


# ---------------------------------------------------------------------------
# Candidate set maintenance (unique ids, exact distances)
# ---------------------------------------------------------------------------

def _merge_candidates(n: int, buf_ids: torch.Tensor, buf_d: torch.Tensor,
                      new_ids: torch.Tensor, new_d: torch.Tensor) -> tuple[
                          torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based merge — the semantics-of-record oracle that
    ``core.candidates.merge_round`` is tested against.

    Merges new candidates into the fixed-size buffer (last axis), dedup by
    id; the buffer keeps the ``cap`` smallest-distance unique candidates.
    Returns (ids, dists, unique_count_in_buffer).  Invalid slots carry
    id = n and dist = +inf.
    """
    cap = buf_ids.shape[-1]
    ids = torch.cat([buf_ids, new_ids], -1)
    d = torch.cat([buf_d, new_d], -1)
    ids_s, order = torch.sort(ids, dim=-1, stable=True)        # sentinels last
    d_s = torch.gather(d, -1, order)
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[..., 1:] = ids_s[..., 1:] != ids_s[..., :-1]
    keep = first & (ids_s < n)
    d_s = torch.where(keep, d_s, _INF)
    ids_s = torch.where(keep, ids_s, n)
    sel, out_d = _topk_smallest(d_s, cap)            # retain the cap best
    out_ids = torch.gather(ids_s, -1, sel)
    return out_ids, out_d, (out_ids < n).sum(-1).to(torch.int32)


def exact_distances(data: torch.Tensor, q: torch.Tensor, ids: torch.Tensor,
                    ok: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Exact original-space distances for candidate ids (the paper's
    rerank): q (B, d), ids/ok (B, m) -> (B, m), +inf where not ok.

    'auto'/'xla' evaluate ``sqrt(sum((p - q)^2))``; 'pallas' runs the
    ``l2_rerank`` kernel on the gathered rows of a CUDA tensor (its plain
    version on a CPU one); 'pallas_interpret' that plain version anywhere.
    """
    n = data.shape[0]
    pts = data[torch.clamp(ids.to(torch.int64), 0, n - 1)]     # (B, m, d)
    if impl in ("pallas", "pallas_interpret"):
        from repro_torch.kernels import ops
        d = ops.l2_rerank(q[:, None, :], pts,
                          interpret=(impl == "pallas_interpret"))[:, 0]
    else:
        d = torch.sqrt(torch.clamp_min(
            ((pts - q[:, None, :]) ** 2).sum(-1), 0.0))
    return torch.where(ok, d, _INF)


# ---------------------------------------------------------------------------
# c^2-k-ANN query (Alg. 5) on the vmap engine
# ---------------------------------------------------------------------------

def _auto_cap(n: int, params: LSHParams, cfg: QueryConfig,
              forest: DEForest) -> int:
    round_cap = params.L * min(cfg.M, forest.n_leaves) * forest.leaf_size
    need = int(params.beta * n) + cfg.k
    return max(cfg.cap, need + round_cap) if cfg.cap else need + round_cap


def knn_query_lanes(data: torch.Tensor, forest: DEForest, A: torch.Tensor,
                    params: LSHParams, queries: torch.Tensor,
                    cfg: QueryConfig, *, live: Optional[torch.Tensor] = None,
                    active: Optional[torch.Tensor] = None) -> QueryResult:
    """Answer B c^2-k-ANN queries (Alg. 5), each on its own radius loop.

    queries (B, d).  ``live`` is an optional (n,) bool tombstone mask;
    ``active`` (B,) bool marks the lanes that run (False = done from round
    0, as for pad lanes of a partial batch); None means all run.
    """
    n = data.shape[0]
    B = queries.shape[0]
    K, L = params.K, params.L
    dev = queries.device
    cap = _auto_cap(n, params, cfg, forest)
    q_proj = (queries @ A).reshape(B, L, K).permute(1, 0, 2).contiguous()
    thresh = torch.tensor(params.beta * n + cfg.k, dtype=torch.float32,
                          device=dev)
    rnd = torch.zeros((B,), dtype=torch.int32, device=dev)
    r = torch.full((B,), cfg.r_min, dtype=torch.float32, device=dev)
    cs = cand.init_state(n, cap, B, dev)
    done = (torch.zeros((B,), dtype=torch.bool, device=dev) if active is None
            else ~active.to(device=dev, dtype=torch.bool))
    probed = torch.zeros((B,), dtype=torch.int32, device=dev)
    pcand = torch.zeros((B,), dtype=torch.int32, device=dev)
    while True:
        running = (~done) & (rnd < cfg.max_rounds)
        if not bool(running.any()):                     # one sync a round
            break
        new_ids, ok, pl, pc = range_query_round(
            forest, q_proj, params.epsilon * r, cfg.M, mode=cfg.mode,
            bounds_impl=cfg.bounds_impl, live=live,
            probe_depth=cfg.probe_depth, with_stats=True)      # line 5
        ok = ok & running[:, None]              # stopped lanes merge nothing
        new_d = exact_distances(data, queries, new_ids, ok,
                                impl=cfg.dist_impl)
        new_ids = torch.where(ok, new_ids, n)
        cs = cand.merge_round(n, cs, new_ids, new_d)
        t1 = cs.count.to(torch.float32) >= thresh              # line 7
        within = (cs.dists <= params.c * r[:, None]).sum(1)
        stop = t1 | (within >= cfg.k)                          # line 9
        done = torch.where(running, stop, done)
        r = torch.where(running & ~stop, r * params.c, r)      # line 11
        rnd = rnd + running.to(torch.int32)
        probed = probed + torch.where(running, pl, 0)
        pcand = pcand + torch.where(running, pc, 0)

    sel, dists = _topk_smallest(cs.dists, cfg.k)               # final rerank
    return QueryResult(ids=torch.gather(cs.ids, 1, sel), dists=dists,
                       rounds=rnd, n_candidates=cs.count, final_r=r,
                       probed_leaves=probed, probe_candidates=pcand)


def knn_query(data: torch.Tensor, forest: DEForest, A: torch.Tensor,
              params: LSHParams, q: torch.Tensor, cfg: QueryConfig, *,
              live: Optional[torch.Tensor] = None,
              active: bool = True) -> QueryResult:
    """Answer one c^2-k-ANN query (Alg. 5).  q: (d,).  ``active=False``
    marks the lane done from round 0."""
    res = knn_query_lanes(data, forest, A, params, q[None], cfg, live=live,
                          active=torch.tensor([bool(active)]))
    return QueryResult(*(f[0] for f in res))


# ---------------------------------------------------------------------------
# (r,c)-ANN query (Alg. 4) — single fixed radius
# ---------------------------------------------------------------------------

def rc_ann_query(data: torch.Tensor, forest: DEForest, A: torch.Tensor,
                 params: LSHParams, q: torch.Tensor, r: float,
                 cfg: QueryConfig) -> QueryResult:
    """Answer one (r,c)-ANN query (Alg. 4): returns the closest candidate
    found, or an invalid id (= n) when the algorithm would return nothing."""
    n = data.shape[0]
    dev = q.device
    cap = _auto_cap(n, params, cfg, forest)
    q_proj = (q @ A).reshape(params.L, 1, params.K)
    r_proj = torch.tensor([params.epsilon * r], dtype=torch.float32,
                          device=dev)
    ids, ok = range_query_round(forest, q_proj, r_proj, cfg.M,
                                mode=cfg.mode, bounds_impl=cfg.bounds_impl,
                                probe_depth=cfg.probe_depth)
    d = exact_distances(data, q[None], ids, ok, impl=cfg.dist_impl)
    ids = torch.where(ok, ids, n)
    cs = cand.merge_round(n, cand.init_state(n, cap, 1, dev), ids, d)
    dists, count = cs.dists[0], cs.count[0]
    best = torch.argmin(dists)
    t1 = count >= int(params.beta * n + 1)                     # line 6
    t2 = (dists <= params.c * r).sum() >= 1                    # line 8
    give = t1 | t2
    out_id = torch.where(give, cs.ids[0, best], n).to(torch.int32)
    out_d = torch.where(give, dists[best], _INF)
    return QueryResult(ids=out_id[None], dists=out_d[None],
                       rounds=torch.tensor(1, dtype=torch.int32, device=dev),
                       n_candidates=count,
                       final_r=torch.tensor(r, dtype=torch.float32,
                                            device=dev))


# ---------------------------------------------------------------------------
# Fused batched engine
# ---------------------------------------------------------------------------

class FusedPlan(NamedTuple):
    """Per-index constants of the fused engine, computed once per forest.

    points_sorted: (L, n_pad, d) original-space points in each tree's
        code-sorted order — a leaf is a contiguous block.
    inv_perm: (L, n) int32 — position of point i in tree l's sorted order;
        folds a round's per-tree rows into id order with a gather.
    """
    points_sorted: torch.Tensor
    inv_perm: torch.Tensor


def make_fused_plan(data: torch.Tensor, forest: DEForest) -> FusedPlan:
    n = forest.n
    ids = forest.point_ids.to(torch.int64)                     # (L, n_pad)
    pts = data[torch.clamp(ids, 0, n - 1)]                     # (L, n_pad, d)
    pts.mul_(forest.valid[..., None].to(pts.dtype))            # zero padding
    L, n_pad = ids.shape
    positions = torch.arange(n_pad, dtype=torch.int32,
                             device=ids.device).expand(L, n_pad)
    # Padding rows scatter into a spare column n that is dropped after.
    tgt = torch.where(forest.valid, ids, n)
    inv = torch.zeros((L, n + 1), dtype=torch.int32, device=ids.device)
    inv.scatter_(1, tgt, positions)
    return FusedPlan(points_sorted=pts, inv_perm=inv[:, :n].contiguous())


def fold_by_id(dmat: torch.Tensor, inv_perm: torch.Tensor) -> torch.Tensor:
    """One round's (L, B, n_pad) sorted-order distances -> (B, n) by point
    id, min over trees: ``inv_perm`` turns each tree's sorted-order row into
    id order with a gather (not a scatter).  One gather of all trees, then
    one reduction: on an H100 this beat a tree-by-tree gather + minimum,
    which holds 1.2 GB less at n = 1M (see PERF.md)."""
    L, B, _ = dmat.shape
    n = inv_perm.shape[1]
    idx = inv_perm.to(torch.int64)[:, None, :].expand(L, B, n)
    return torch.gather(dmat, 2, idx).amin(dim=0)


def fused_round_update(best: torch.Tensor, by_id: torch.Tensor,
                       r: torch.Tensor, done: torch.Tensor,
                       rounds: torch.Tensor, rnd: int, *,
                       params: LSHParams, k: int, thresh: torch.Tensor):
    """Fold one round's per-id distance table into the loop state (the
    T1/T2 bookkeeping of Alg. 5)."""
    best = torch.minimum(best, by_id)
    count = (best < float("inf")).sum(dim=1).to(torch.int32)
    t1 = count.to(torch.float32) >= thresh                   # line 7
    within = (best <= params.c * r[:, None]).sum(dim=1)
    t2 = within >= k                                         # line 9
    rounds = torch.where(done, rounds, rnd + 1).to(torch.int32)
    done = done | t1 | t2
    r = torch.where(done, r, r * params.c)                   # line 11
    return best, r, done, rounds


def fused_topk(best: torch.Tensor, k: int, n: int) -> tuple[
        torch.Tensor, torch.Tensor, torch.Tensor]:
    """Final (ids, dists, unique-count) over the dense best-distance table.
    Equal distances come in ascending id order, as the reference's
    ``lax.top_k`` gives them."""
    sel, dists = _topk_smallest(best, k)
    ids = torch.where(torch.isfinite(dists), sel.to(torch.int32), n)
    count = (best < float("inf")).sum(dim=1).to(torch.int32)
    return ids, dists, count


def live_in_sorted_order(forest: DEForest,
                         live: torch.Tensor) -> torch.Tensor:
    """An (n,) id-order tombstone mask in each tree's code-sorted order:
    (L, n_pad) bool, padding rows dead."""
    safe = torch.clamp(forest.point_ids.to(torch.int64), 0, forest.n - 1)
    return live[safe] & forest.valid


def fused_query_batch(data: torch.Tensor, forest: DEForest, A: torch.Tensor,
                      params: LSHParams, queries: torch.Tensor,
                      cfg: QueryConfig, plan: Optional[FusedPlan] = None, *,
                      live_sorted: Optional[torch.Tensor] = None,
                      n_active: Optional[int] = None) -> QueryResult:
    """Batched c^2-k-ANN: all lanes advance through radius rounds together.

    ``live_sorted`` is an optional (L, n_pad) bool tombstone mask in
    code-sorted order.  ``n_active`` marks lanes >= n_active done from
    round 0 with r_eff = -1, so pad lanes of a partial batch admit nothing.
    With ``cfg.probe_depth > 0`` the radius-independent leaf-LB table is
    computed once and every round widens each lane's radius per tree to
    also admit the probe_depth nearest near-miss leaves.
    """
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    n = data.shape[0]
    B = queries.shape[0]
    K, L = params.K, params.L
    dev = queries.device
    if plan is None:
        plan = make_fused_plan(data, forest)
    q_proj = (queries @ A).reshape(B, L, K).permute(1, 0, 2).contiguous()
    thresh = torch.tensor(params.beta * n + cfg.k, dtype=torch.float32,
                          device=dev)
    interpret = cfg.dist_impl == "pallas_interpret"
    nl, ls = forest.n_leaves, forest.leaf_size

    if cfg.probe_depth > 0:
        probe_lb = ref.forest_leaf_lb(q_proj, forest.leaf_lo, forest.leaf_hi,
                                      forest.leaf_valid, forest.breakpoints)

    rnd = 0
    rounds = torch.zeros((B,), dtype=torch.int32, device=dev)
    r = torch.full((B,), cfg.r_min, dtype=torch.float32, device=dev)
    done = (torch.zeros((B,), dtype=torch.bool, device=dev) if n_active is None
            else torch.arange(B, device=dev) >= int(n_active))
    best = torch.full((B, n), float("inf"), dtype=torch.float32, device=dev)
    probed = torch.zeros((B,), dtype=torch.int32, device=dev)
    pcand = torch.zeros((B,), dtype=torch.int32, device=dev)
    while rnd < cfg.max_rounds and bool((~done).any()):     # one sync a round
        r_eff = torch.where(done, -1.0, params.epsilon * r)  # lane mask
        if cfg.probe_depth > 0:
            r_adm, probe_mask = ref.probe_radii_from_lb(
                probe_lb, r_eff, cfg.probe_depth)            # (L, B)
        else:
            r_adm = r_eff                                    # (B,) shared
        dmat = ops.range_rerank(
            queries, q_proj, r_adm, forest.leaf_lo, forest.leaf_hi,
            forest.leaf_valid, forest.breakpoints, plan.points_sorted,
            forest.valid, live_sorted, leaf_size=ls,
            interpret=interpret)                             # (L, B, n_pad)
        if cfg.probe_depth > 0:
            probed = probed + probe_mask.sum((0, 2)).to(torch.int32)
            per_leaf = torch.isfinite(dmat.reshape(L, B, nl, ls)).sum(-1)
            pcand = pcand + torch.where(probe_mask, per_leaf,
                                        0).sum((0, 2)).to(torch.int32)
        by_id = fold_by_id(dmat, plan.inv_perm)              # (B, n)
        del dmat
        best, r, done, rounds = fused_round_update(
            best, by_id, r, done, rounds, rnd, params=params, k=cfg.k,
            thresh=thresh)
        rnd += 1

    ids, dists, count = fused_topk(best, cfg.k, n)
    return QueryResult(ids=ids, dists=dists, rounds=rounds,
                       n_candidates=count, final_r=r,
                       probed_leaves=probed, probe_candidates=pcand)


# Below this batch size the fused engine's full-forest pass is not
# amortized and the reference resolves 'auto' to the per-query engine.
_FUSED_MIN_BATCH = 8


def _run_vmap_engine(data, forest, A, params, queries, cfg, *,
                     plan=None, live=None, live_sorted=None,
                     n_active=None) -> QueryResult:
    """Registry entry point for engine='vmap' (ignores plan/live_sorted)."""
    del plan, live_sorted
    B = queries.shape[0]
    active = (None if n_active is None
              else torch.arange(B, device=queries.device) < int(n_active))
    return knn_query_lanes(data, forest, A, params, queries, cfg, live=live,
                           active=active)


def _run_fused_engine(data, forest, A, params, queries, cfg, *,
                      plan=None, live=None, live_sorted=None,
                      n_active=None) -> QueryResult:
    """Registry entry point for engine='fused' (derives live_sorted)."""
    if live_sorted is None and live is not None:
        live_sorted = live_in_sorted_order(forest, live)
    return fused_query_batch(data, forest, A, params, queries, cfg,
                             plan=plan, live_sorted=live_sorted,
                             n_active=n_active)


engine_registry.register_engine(
    "vmap", _run_vmap_engine, modes=("leaf", "strict"), min_batch=1,
    priority=0,
    doc="per-query radius loops, lanes batched; the only engine "
        "reproducing the unoptimized strict Alg. 3 per-point filter")
engine_registry.register_engine(
    "fused", _run_fused_engine, modes=("leaf",),
    min_batch=_FUSED_MIN_BATCH, priority=10,
    doc="one range_rerank kernel launch per round over all L trees; "
        "leaf-granular admission (a superset of vmap's — Theorems 1-3 "
        "unchanged)")


def knn_query_batch(data: torch.Tensor, forest: DEForest, A: torch.Tensor,
                    params: LSHParams, queries: torch.Tensor,
                    cfg: QueryConfig, plan: Optional[FusedPlan] = None, *,
                    live: Optional[torch.Tensor] = None,
                    live_sorted: Optional[torch.Tensor] = None,
                    n_active: Optional[int] = None) -> QueryResult:
    """Batched c^2-k-ANN over a (b, d) query batch, dispatched through the
    engine registry by ``cfg.engine``, ``cfg.mode`` and the batch size."""
    engine = engine_registry.get_engine(
        engine_registry.resolve_engine(cfg.engine, mode=cfg.mode,
                                       batch=queries.shape[0]))
    return engine.run(data, forest, A, params, queries, cfg, plan=plan,
                      live=live, live_sorted=live_sorted, n_active=n_active)
