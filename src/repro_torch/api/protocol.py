"""The AnnIndex protocol — the one index surface.

``core.DETLSH`` (static), ``core.distributed.PDETIndex`` (sharded) and
``streaming.StreamingDETLSH`` satisfy ``AnnIndex``; the streaming index,
being mutable, additionally satisfies ``MutableAnnIndex``.  Serving talks only to these
protocols — capability checks are ``isinstance`` against a protocol, never
``hasattr`` duck-typing.

``as_ann_index`` adapts pre-protocol objects (anything with a
``query(queries, k=...)`` method — the legacy per-shard ``PDETLSH``,
baselines, user code) so legacy indexes keep serving; the adapter is
where the old signature introspection now lives, in one place.
"""

from __future__ import annotations

import inspect
from typing import Any, Optional, Protocol, runtime_checkable

from repro_torch.api.request import SearchRequest, SearchResult, SearchStats


@runtime_checkable
class AnnIndex(Protocol):
    """A built ANN index answering batched c^2-k-ANN searches."""

    @property
    def n_points(self) -> int:
        """Number of (live) points the index answers over."""
        ...

    def search(self, queries: Any,
               request: Optional[SearchRequest] = None) -> SearchResult:
        """Batched search; ``request=None`` means ``SearchRequest()``."""
        ...

    def r_min_for(self, k: int) -> float:
        """The cached per-(index, k) starting-radius estimate."""
        ...

    def save(self, path: Any) -> None:
        """Write a versioned snapshot directory (repro_torch.api.load reads it)."""
        ...

    def index_size_bytes(self) -> int:
        ...


@runtime_checkable
class MutableAnnIndex(AnnIndex, Protocol):
    """An AnnIndex that additionally supports live mutation."""

    def upsert(self, vectors: Any, gids: Any = None) -> Any:
        ...

    def delete(self, gids: Any) -> int:
        ...

    def maybe_compact(self) -> bool:
        ...


class LegacyIndexAdapter:
    """Wraps a pre-protocol index (``query(queries, k=...)`` and optionally
    ``n_active=``) behind the ``search`` surface.

    Pad-lane masking stays an optimization: if the wrapped ``query`` lacks
    the ``n_active`` kwarg the adapter simply drops it (the index runs the
    radius loop on pad lanes — correct, just not free).  Tuple-returning
    ``query`` implementations (the baselines) are normalized too.
    """

    def __init__(self, index: Any) -> None:
        if not callable(getattr(index, "query", None)):
            raise TypeError(
                f"{type(index).__name__} is not an AnnIndex and has no "
                f"query() method to adapt")
        self.index = index
        try:
            params = inspect.signature(index.query).parameters
            self.supports_n_active = "n_active" in params
        except (TypeError, ValueError):
            self.supports_n_active = False

    def search(self, queries: Any,
               request: Optional[SearchRequest] = None) -> SearchResult:
        req = request or SearchRequest()
        kwargs = {}
        if self.supports_n_active and req.n_active is not None:
            kwargs["n_active"] = req.n_active
        res = self.index.query(queries, k=req.k, **kwargs)
        if hasattr(res, "ids"):                        # QueryResult-style
            ids, dists, raw = res.ids, res.dists, res
            rounds = getattr(res, "rounds", None)
            n_cands = getattr(res, "n_candidates", None)
            final_r = getattr(res, "final_r", None)
        else:                                          # baseline (ids, dists)
            ids, dists = res
            raw = None
            rounds = n_cands = final_r = None
        stats = SearchStats(engine="legacy", r_min=float("nan"),
                            r_min_cached=False, rounds=rounds,
                            n_candidates=n_cands, final_r=final_r)
        return SearchResult(ids=ids, dists=dists, stats=stats, raw=raw)

    # ------------------------------------------------------------------
    # Full AnnIndex surface: delegate where the wrapped index has the
    # capability, fail with a capability error (not AttributeError) where
    # it doesn't — harness code (eval/pareto.py) probes these uniformly.
    # ------------------------------------------------------------------

    @property
    def n_points(self) -> int:
        if hasattr(self.index, "n_points"):
            return int(self.index.n_points)
        data = getattr(self.index, "data", None)
        if data is not None:
            return int(data.shape[0])
        raise TypeError(f"{type(self.index).__name__} exposes neither "
                        f"n_points nor data; cannot report a point count")

    def r_min_for(self, k: int) -> float:
        if hasattr(self.index, "r_min_for"):
            return float(self.index.r_min_for(k))
        raise TypeError(f"{type(self.index).__name__} has no radius-loop "
                        f"state; r_min_for is not adaptable")

    def save(self, path: Any) -> None:
        if hasattr(self.index, "save"):
            return self.index.save(path)
        raise NotImplementedError(
            f"{type(self.index).__name__} has no snapshot format; adapt-"
            f"and-save is not supported (build a protocol index instead)")

    def index_size_bytes(self) -> int:
        if hasattr(self.index, "index_size_bytes"):
            return int(self.index.index_size_bytes())
        if hasattr(self.index, "size_bytes"):
            return int(self.index.size_bytes())
        raise TypeError(f"{type(self.index).__name__} reports no size")


def as_ann_index(index: Any) -> Any:
    """Return ``index`` if it satisfies ``AnnIndex``, else adapt it."""
    if isinstance(index, AnnIndex):
        return index
    return LegacyIndexAdapter(index)
