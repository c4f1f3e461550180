"""Typed search requests and results — the one query surface.

``SearchRequest`` carries every per-request override the engines accept,
validated at construction.  ``SearchResult`` is what every ``search``
returns: ids + exact distances plus a ``SearchStats`` record (which engine
ran, the r_min used and whether it came from the per-index cache, per-lane
round / candidate counts).  ``raw`` keeps the engine-level ``QueryResult``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

from repro_torch.api import registry

MODES = ("leaf", "strict")
# Implementation names, as the reference package has them.  'auto'/'xla'
# run plain tensor code, 'pallas' the hand-written kernel (CUDA tensors) or
# its plain version (CPU tensors), 'pallas_interpret' the kernel's plain
# version on either device.
IMPLS = ("auto", "xla", "pallas", "pallas_interpret")


def _check_positive(name: str, value: float, minimum: float = 1) -> None:
    if value < minimum:
        raise ValueError(
            f"{name} must be >= {minimum}, got {value!r} — a non-positive "
            f"{name} would make the round loop return empty/garbage results")


def _check_choice(name: str, value: str, choices: Sequence[str]) -> None:
    if value not in choices:
        raise ValueError(f"unknown {name} {value!r}; valid: {choices}")


@dataclasses.dataclass(frozen=True)
class SearchRequest:
    """Per-request overrides for one batched c^2-k-ANN search.

    ``engine=None`` means the index's default (its ``IndexSpec`` engine,
    itself 'auto'); ``r_min=None`` means the index's cached per-k estimate.
    ``n_active`` marks trailing pad lanes of a partial batch done from
    round 0.  ``M`` is the vmap engine's leaves per tree per round;
    ``bounds_impl`` / ``dist_impl`` pick its leaf-bound and rerank code
    ('pallas' reaches the ``leaf_bounds`` / ``l2_rerank`` kernels).
    """

    k: int = 10
    r_min: Optional[float] = None
    M: int = 8
    mode: str = "leaf"
    engine: Optional[str] = None
    n_active: Optional[int] = None
    max_rounds: int = 48
    dist_impl: str = "auto"
    bounds_impl: str = "auto"
    probe_depth: Optional[int] = None

    def __post_init__(self) -> None:
        _check_positive("k", self.k)
        _check_positive("M", self.M)
        _check_positive("max_rounds", self.max_rounds)
        if self.r_min is not None and not self.r_min > 0.0:
            raise ValueError(f"r_min must be positive, got {self.r_min!r} "
                             f"(radii only grow by factors of c)")
        if self.n_active is not None:
            _check_positive("n_active", self.n_active, minimum=0)
        if self.probe_depth is not None:
            _check_positive("probe_depth", self.probe_depth, minimum=0)
        _check_choice("mode", self.mode, MODES)
        _check_choice("dist_impl", self.dist_impl, IMPLS)
        _check_choice("bounds_impl", self.bounds_impl, IMPLS)
        registry.validate_engine_name(self.engine)
        if self.probe_depth and self.mode == "strict":
            raise ValueError(
                "mode='strict' (the unoptimized Alg. 3 per-point filter) "
                "admits no near-miss leaves; probe_depth must be 0/None in "
                f"strict mode (got {self.probe_depth})")

    def to_query_config(self, *, default_engine: str = "auto",
                        r_min: Optional[float] = None,
                        k: Optional[int] = None,
                        default_probe_depth: int = 0) -> Any:
        """Lower to the engine-level ``core.query.QueryConfig``; ``r_min``
        and ``k`` override the request's (the index fills in its cached
        radius estimate)."""
        from repro_torch.core.query import QueryConfig
        rm = self.r_min if r_min is None else r_min
        if rm is None:
            raise ValueError("r_min unresolved: pass r_min= or set it on "
                             "the request")
        pd = (self.probe_depth if self.probe_depth is not None
              else default_probe_depth)
        return QueryConfig(
            k=self.k if k is None else k, M=self.M, r_min=float(rm),
            mode=self.mode, max_rounds=self.max_rounds,
            engine=self.engine or default_engine,
            dist_impl=self.dist_impl, bounds_impl=self.bounds_impl,
            probe_depth=0 if self.mode == "strict" else int(pd))


class SearchStats(NamedTuple):
    """Per-search diagnostics surfaced by every ``search``."""

    engine: str              # concrete engine that ran
    r_min: float             # starting radius actually used
    r_min_cached: bool       # True when it came from the per-(index,k) cache
    rounds: Any              # (B,) int32 — radius enlargements + 1 per lane
    n_candidates: Any        # (B,) int32 — |S| at termination
    final_r: Any             # (B,) f32
    shard_candidates: Any = None  # (n_shards,) f32 — (point, tree) entries
    #                               scanned per shard, summed over lanes and
    #                               rounds (pdet engine only)
    psum_rounds: Any = None       # () int32 — lockstep radius rounds, each
    #                               ending in one cross-shard merge (pdet)
    merge_size: Any = None        # int — elements of each cross-shard merge
    #                               (the B x n table; pdet)
    probed_leaves: Any = None     # (B,) int32 — near-miss leaves admitted
    probe_candidates: Any = None  # (B,) int32 — their candidates


class SearchResult(NamedTuple):
    ids: Any                 # (B, k) int32 — point ids (n = no answer)
    dists: Any               # (B, k) f32  — exact distances
    stats: SearchStats
    raw: Any = None          # engine-level core.query.QueryResult
