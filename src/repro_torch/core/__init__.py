"""DET-LSH — the paper's primary contribution, in PyTorch.

High-level API (see ``repro_torch.api``)::

    import torch, repro_torch.api as api
    spec = api.IndexSpec(kind="static", K=16, c=1.5, L=4)
    index = api.build(data, torch.Generator().manual_seed(0), spec)
    res = index.search(queries, api.SearchRequest(k=50))
    index.save("snap/"); index = api.load("snap/")

Submodules: theory, hashing, encoding, detree, candidates, query.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device, to_device
from repro_torch.core import encoding, hashing
from repro_torch.core.detree import (CODE_DTYPE, LEAF_DTYPE, DEForest,
                                     StageClock, build_forest)
from repro_torch.core.query import (FusedPlan, QueryConfig, QueryResult,
                                    knn_query_batch, make_fused_plan)
from repro_torch.core.theory import (SUCCESS_PROBABILITY, LSHParams,
                                     derive_params)

# Storage dtypes of the forest arrays, by the names a snapshot uses.
FOREST_DTYPES = {"point_ids": torch.int32, "proj_sorted": torch.float32,
                 "codes_sorted": CODE_DTYPE, "valid": torch.bool,
                 "leaf_lo": LEAF_DTYPE, "leaf_hi": LEAF_DTYPE,
                 "leaf_valid": torch.bool, "breakpoints": torch.float32}


def forest_from_arrays(arrays: Any, *, n: int, leaf_size: int,
                       device: torch.device) -> DEForest:
    """A ``DEForest`` on ``device`` from the ``forest.<key>`` arrays of a
    snapshot (either package's), cast to the storage dtypes."""
    return DEForest(
        n=int(n), leaf_size=int(leaf_size),
        **{k: to_device(np.asarray(arrays["forest." + k]), device, dt)
           for k, dt in FOREST_DTYPES.items()})


def plan_from_arrays(arrays: Any, device: torch.device) -> Optional[FusedPlan]:
    """The fused plan a snapshot holds (``plan.points_sorted`` /
    ``plan.inv_perm``), or None when it holds none."""
    if "plan.points_sorted" not in arrays:
        return None
    return FusedPlan(
        points_sorted=to_device(arrays["plan.points_sorted"], device,
                                torch.float32),
        inv_perm=to_device(arrays["plan.inv_perm"], device, torch.int32))


def estimate_r_min(data: Any, queries: Any, k: int, c: float, *,
                   sample: int = 2048) -> float:
    """Pick the initial search radius (paper §V-B1, following PM-LSH [9]).

    Estimate the k-NN distance scale on a subsample and start one c-step
    below it.  Runs on the host in numpy, exactly as the reference does, so
    both packages pick the same radius for the same inputs.
    """
    ns = min(sample, data.shape[0])
    nq = min(64, queries.shape[0])
    sub = _host(data[:ns])
    qs = _host(queries[:nq])
    d2 = ((qs[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    kth = np.sqrt(np.partition(d2, min(k, ns - 1), axis=1)[:, min(k, ns - 1)])
    r = float(np.median(kth))
    return max(r / (c * c), 1e-6)


def _host(x: Any) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class DETLSH:
    """A built DET-LSH index: the static kind, on one device."""

    params: LSHParams
    A: torch.Tensor           # (d, L*K) projection matrix
    forest: DEForest
    data: torch.Tensor        # (n, d) — resident for the exact rerank
    spec: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)
    _plan: Optional[FusedPlan] = dataclasses.field(
        default=None, repr=False, compare=False)
    _r_min_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # Seconds per build stage (projection, breakpoints, encode_pack, sort,
    # assemble), each ended by a device sync; empty for a loaded index.
    build_seconds: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @classmethod
    def build(cls, data: Any, generator: Optional[torch.Generator] = None,
              params: Optional[LSHParams] = None, *,
              Nr: int = encoding.DEFAULT_NR, leaf_size: int = 64,
              breakpoint_method: str = "sample_sort",
              project_impl: str = "auto", build_impl: str = "auto",
              encode_impl: str = "auto",
              device: Optional[Any] = None) -> "DETLSH":
        """One-shot static build (Alg. 1 + 2) on ``device`` (CUDA unless
        the caller asks otherwise).  ``generator`` draws A and then the
        breakpoint sample; None means a CPU generator seeded with 0.
        ``project_impl`` picks the projection (``hashing.project``: 'pallas'
        runs the ``lsh_project`` kernel), ``build_impl``/``encode_impl`` the
        builder and its encode step (``detree.build_forest``)."""
        dev = resolve_device(device)
        params = params or derive_params()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        seconds: dict = {}
        clock = StageClock(dev, seconds)
        x = to_device(data, dev, torch.float32)
        A = hashing.sample_projections(generator, x.shape[1], params.K,
                                       params.L, dev)
        proj = hashing.project(x, A, impl=project_impl)
        clock.lap("projection")
        forest = build_forest(proj, params.K, params.L, Nr=Nr,
                              leaf_size=leaf_size,
                              breakpoint_method=breakpoint_method,
                              generator=generator, build_impl=build_impl,
                              encode_impl=encode_impl, stage_seconds=seconds)
        return cls(params=params, A=A, forest=forest, data=x,
                   build_seconds=seconds)

    @classmethod
    def from_spec(cls, data: Any, generator: Optional[torch.Generator],
                  spec: Any, *, device: Optional[Any] = None) -> "DETLSH":
        """Build from one declarative ``repro_torch.api.IndexSpec``."""
        if spec.kind != "static":
            raise ValueError(f"DETLSH.from_spec needs kind='static', got "
                             f"{spec.kind!r} (use repro_torch.api.build)")
        idx = cls.build(data, generator, spec.derive_params(), Nr=spec.Nr,
                        leaf_size=spec.leaf_size,
                        breakpoint_method=spec.breakpoint_method,
                        project_impl=spec.project_impl,
                        build_impl=spec.build_impl,
                        encode_impl=spec.encode_impl, device=device)
        idx.spec = spec
        return idx

    @classmethod
    def from_arrays(cls, arrays: Any, params: LSHParams, *, n: int,
                    leaf_size: int, spec: Optional[Any] = None,
                    device: Optional[Any] = None) -> "DETLSH":
        """An index from the arrays a static snapshot holds, with nothing
        recomputed: ``A``, ``data``, ``forest.<key>`` for every forest array
        and, optionally, ``plan.points_sorted`` / ``plan.inv_perm``.  This is
        how the reference's state (its A and breakpoints, drawn with
        ``jax.random``) crosses into the port."""
        dev = resolve_device(device)
        index = cls(params=params,
                    A=to_device(arrays["A"], dev, torch.float32),
                    forest=forest_from_arrays(arrays, n=n,
                                              leaf_size=leaf_size, device=dev),
                    data=to_device(arrays["data"], dev, torch.float32),
                    spec=spec)
        index._plan = plan_from_arrays(arrays, dev)
        return index

    @property
    def n_points(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def fused_plan(self) -> FusedPlan:
        if self._plan is None:
            self._plan = make_fused_plan(self.data, self.forest)
        return self._plan

    def r_min_for(self, k: int, queries: Any = None) -> float:
        """Cached per-(index, k) starting radius: estimated once, from the
        first ``r_min=None`` search's queries (data rows when none are
        given), and reused for every later search with the same k."""
        if k not in self._r_min_cache:
            probes = (queries if queries is not None
                      else self.data[: min(64, self.data.shape[0])])
            self._r_min_cache[k] = estimate_r_min(self.data, probes, k,
                                                  self.params.c)
        return self._r_min_cache[k]

    def search(self, queries: Any, request: Any = None) -> Any:
        """Typed batched search (``repro_torch.api.SearchRequest`` in,
        ``repro_torch.api.SearchResult`` out); queries move to the index's
        device."""
        from repro_torch.api import registry
        from repro_torch.api.request import (SearchRequest, SearchResult,
                                             SearchStats)
        req = request or SearchRequest()
        queries = to_device(queries, self.device, torch.float32)
        r_min, cached = req.r_min, False
        if r_min is None:
            cached = req.k in self._r_min_cache
            # Zero-vector pad lanes must not skew the cached estimate.
            probes = queries[: req.n_active] if req.n_active else queries
            r_min = self.r_min_for(req.k, probes)
        spec = self.spec
        cfg = req.to_query_config(
            default_engine=spec.engine if spec is not None else "auto",
            r_min=r_min,
            default_probe_depth=spec.probe_depth if spec is not None else 0)
        engine = registry.resolve_engine(cfg.engine, mode=cfg.mode,
                                         batch=queries.shape[0])
        plan = self.fused_plan() if engine == "fused" else None
        res = knn_query_batch(self.data, self.forest, self.A, self.params,
                              queries, cfg, plan=plan, n_active=req.n_active)
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
        """Write a versioned snapshot directory (``repro_torch.api.load``)."""
        from repro_torch.api import persist
        persist.save_static(self, path)

    def index_size_bytes(self) -> int:
        return self.forest.size_bytes() + self.A.numel() * 4


__all__ = [
    "DETLSH", "DEForest", "FusedPlan", "LSHParams", "QueryConfig",
    "QueryResult", "derive_params", "build_forest", "knn_query_batch",
    "make_fused_plan", "estimate_r_min", "SUCCESS_PROBABILITY",
    "FOREST_DTYPES", "forest_from_arrays", "plan_from_arrays",
]
