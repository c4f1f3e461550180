"""DET-LSH query phase (paper §III-C: Alg. 3, 4, 5) — the fused engine.

The c^2-k-ANN query issues (r,c)-ANN rounds with radii r, c*r, c^2*r, ...
Each round performs a range query with projected radius eps*r in all L
DE-Trees, accumulates unique candidates into S with their exact
original-space distances, and terminates when

    (T1)  |S| >= beta*n + k                                   (Alg. 5 line 7)
    (T2)  at least k candidates satisfy ||o, q|| <= c * r     (Alg. 5 line 9)

returning the top-k of S by exact distance.

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
from repro_torch.core.detree import DEForest
from repro_torch.core.theory import LSHParams


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
    r_min: float = 1.0
    max_rounds: int = 48
    mode: str = "leaf"         # 'leaf' (optimized, default) | 'strict'
    engine: str = "auto"       # batch engine: 'auto' or a registered name
    probe_depth: int = 0       # near-miss leaves admitted per (tree, round)

    def __post_init__(self):
        from repro_torch.api.request import MODES, _check_choice, \
            _check_positive
        _check_positive("k", self.k)
        _check_positive("M", self.M)
        _check_positive("max_rounds", self.max_rounds)
        _check_positive("probe_depth", self.probe_depth, minimum=0)
        if not self.r_min > 0.0:
            raise ValueError(f"r_min must be positive, got {self.r_min!r}")
        _check_choice("mode", self.mode, MODES)
        engine_registry.validate_engine_name(self.engine)
        if self.probe_depth and self.mode == "strict":
            raise ValueError(
                "mode='strict' reproduces the unoptimized Alg. 3 per-point "
                "filter and admits no near-miss leaves; probe_depth must be "
                f"0 in strict mode (got {self.probe_depth})")


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

    Equal distances must come in ascending id order, the tie rule of the
    reference's ``lax.top_k``; ``torch.topk`` promises no tie order.  So the
    selection runs on unique int64 keys: a distance's f32 bit pattern (which
    orders like the value for non-negative floats, +inf included) above its
    id.  ``+ 0.0`` turns a -0.0 distance into +0.0 first."""
    bits = (best + 0.0).view(torch.int32).to(torch.int64)
    ids_all = torch.arange(n, dtype=torch.int64, device=best.device)
    key = torch.topk(bits * (1 << 32) + ids_all, k, dim=1, largest=False,
                     sorted=True).values
    sel = key & 0xFFFFFFFF
    dists = torch.gather(best, 1, sel)
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
            forest.valid, live_sorted, leaf_size=ls)         # (L, B, n_pad)
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
    """Registry entry point for engine='vmap' (not ported yet)."""
    raise NotImplementedError(
        "the per-query 'vmap' engine (core/candidates.py with the leaf_bounds "
        "and l2_rerank kernels) is the next slice of the PyTorch port; use "
        "engine='fused' (mode='leaf', any batch size) meanwhile")


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
    doc="per-query engine; the only one reproducing the unoptimized strict "
        "Alg. 3 per-point filter (raises until its slice of the port)")
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
