"""PDET-LSH: the sharded index (paper §IV, Alg. 8), layout-partitioned.

``PDETIndex`` is the index ``repro_torch.api.build`` returns for an
``IndexSpec`` with a ``placement``.  It partitions the *layout* of one
global DE-Forest, as the reference's ``PDETIndex`` does: the code-sorted
points and the leaf summaries are cut along the position axis into
``placement.n_shards`` shards of whole leaves (shard order row-major over
the placement's data axes), each held as a contiguous copy on its own
device.  The breakpoints, and each batch's queries and projections, are
replicated once per distinct device; every shard keeps the fold index it
derives from the global inverse permutation.

One controller process drives every shard, as the reference's one
``PDETIndex`` object drives its ``shard_map``.  Each radius round, every
shard runs the fused engine's ``range_rerank`` on its own leaves and
points, counts its scanned entries, and folds its tree rows into id order
through the global ``inv_perm`` (positions outside the shard read +inf);
the per-shard (B, n) tables merge with ``torch.minimum`` on the first
shard's device -- the reference's ``pmin``, exact because min is order-free
-- and the merged table steps through the fused engine's own
``fused_round_update``.  Every (tree, point) distance lives on exactly one
shard and comes from the same kernel tile, so the merged table, the T1/T2
decisions, the radius schedule and the top-k are bit-identical to the
fused engine on one device, for any shard count (the PDET == DET claim of
Fig. 20/21 as an exact contract).

A mesh may repeat a device, which puts several shards on one card; that
is how one card, or the CPU, runs any shard count.  ``torch.distributed``
is not used: the API returns one index object, and NCCL refuses two ranks
on one card.  The structure-partitioned runtime of the reference
(``PDETLSH``, per-shard forests, Alg. 6/7's parallel build) is not ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional

import torch

from repro_torch._device import to_device
from repro_torch.api import registry as engine_registry
from repro_torch.core.detree import DEForest
from repro_torch.core.query import (FusedPlan, QueryConfig, QueryResult,
                                    fused_round_update, fused_topk,
                                    knn_query_batch)
from repro_torch.core.theory import LSHParams
from repro_torch.launch.mesh import DeviceMesh, mesh_from_placement

_INF = float("inf")
_FOREST_TENSORS = ("point_ids", "proj_sorted", "codes_sorted", "valid",
                   "leaf_lo", "leaf_hi", "leaf_valid", "breakpoints")


def _pad_axis1(x: torch.Tensor, width: int, value: Any) -> torch.Tensor:
    shape = list(x.shape)
    shape[1] = width
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=1)


def _pad_layout_to_shards(forest: DEForest, plan: FusedPlan,
                          n_shards: int) -> tuple[DEForest, FusedPlan]:
    """Pad the leaf axis (and the matching point slots) so every shard
    owns the same number of whole leaves.  Padding leaves are invalid
    (never admitted) and padding point slots carry ``valid=False`` and the
    ``n`` sentinel id, so no answer can change; real sorted positions keep
    their indices (padding appends), so ``inv_perm`` is untouched."""
    pad_l = (-forest.n_leaves) % n_shards
    if pad_l == 0:
        return forest, plan
    pad_p = pad_l * forest.leaf_size
    forest = DEForest(
        n=forest.n, leaf_size=forest.leaf_size,
        point_ids=_pad_axis1(forest.point_ids, pad_p, forest.n),
        proj_sorted=_pad_axis1(forest.proj_sorted, pad_p, 0.0),
        codes_sorted=_pad_axis1(forest.codes_sorted, pad_p, 0),
        valid=_pad_axis1(forest.valid, pad_p, False),
        leaf_lo=_pad_axis1(forest.leaf_lo, pad_l, 0),
        leaf_hi=_pad_axis1(forest.leaf_hi, pad_l, 0),
        leaf_valid=_pad_axis1(forest.leaf_valid, pad_l, False),
        breakpoints=forest.breakpoints)
    plan = FusedPlan(points_sorted=_pad_axis1(plan.points_sorted, pad_p, 0.0),
                     inv_perm=plan.inv_perm)
    return forest, plan


class PDETShard(NamedTuple):
    """One layout shard: leaves [leaf0, leaf0 + nl_local) of every tree and
    their point slots, as contiguous tensors on the shard's device."""

    device: torch.device
    points: torch.Tensor        # (L, n_local, d) f32 code-sorted points
    valid: torch.Tensor         # (L, n_local) bool
    leaf_lo: torch.Tensor       # (L, nl_local, K) int16
    leaf_hi: torch.Tensor       # (L, nl_local, K) int16
    leaf_valid: torch.Tensor    # (L, nl_local) bool
    breakpoints: torch.Tensor   # (L, K, E) f32, shared by the device's shards
    fold_index: torch.Tensor    # (L, n) int64: inv_perm - offset, clamped
    fold_away: torch.Tensor     # (L, n) bool: the id's position is elsewhere


class PDETLayout(NamedTuple):
    """The shards of a placed index, in shard order: what the ``pdet``
    engine takes as its ``plan``."""

    shards: tuple


def shard_layout(forest: DEForest, plan: FusedPlan,
                 devices: list) -> PDETLayout:
    """Cut a padded global layout into ``len(devices)`` shards of whole
    leaves, shard s on ``devices[s]``.  Each shard's slices are copied once
    into contiguous tensors (a slice along the position axis is not
    contiguous, and the kernel takes contiguous inputs); a shard that spans
    the whole layout on the layout's own device is the layout itself."""
    S = len(devices)
    nl = forest.n_leaves // S
    npos = nl * forest.leaf_size
    replicated: dict = {}
    shards = []
    for s, dev in enumerate(devices):
        if dev not in replicated:
            replicated[dev] = (forest.breakpoints.to(dev),
                               plan.inv_perm.to(dev, torch.int64))
        bp, inv = replicated[dev]
        rel = inv - s * npos
        away = (rel < 0) | (rel >= npos)

        def cut(x: torch.Tensor, width: int) -> torch.Tensor:
            return x[:, s * width:(s + 1) * width].to(dev).contiguous()

        shards.append(PDETShard(
            device=dev, points=cut(plan.points_sorted, npos),
            valid=cut(forest.valid, npos), leaf_lo=cut(forest.leaf_lo, nl),
            leaf_hi=cut(forest.leaf_hi, nl),
            leaf_valid=cut(forest.leaf_valid, nl), breakpoints=bp,
            fold_index=rel.clamp(0, npos - 1), fold_away=away))
    return PDETLayout(shards=tuple(shards))


def _fold_shard(dmat: torch.Tensor, shard: PDETShard) -> torch.Tensor:
    """A shard's (L, B, n_local) round distances -> (B, n) by point id, min
    over trees; ids whose position lies on another shard read +inf."""
    L, B, _ = dmat.shape
    n = shard.fold_index.shape[1]
    g = torch.gather(dmat, 2, shard.fold_index[:, None, :].expand(L, B, n))
    g.masked_fill_(shard.fold_away[:, None, :], _INF)
    return g.amin(dim=0)


def pdet_query_batch(layout: PDETLayout, A: torch.Tensor, params: LSHParams,
                     queries: torch.Tensor, cfg: QueryConfig, *, n: int,
                     leaf_size: int, n_active: Optional[int] = None
                     ) -> tuple[QueryResult, torch.Tensor]:
    """Sharded fused c^2-k-ANN round loop (Alg. 8 over the global layout).

    ``queries`` and ``A`` lie on the controller's device, where the merged
    table and the loop state live.  Per round, each shard runs one
    ``range_rerank`` pass over its own leaves and points (done lanes carry
    radius -1), counts its finite entries, and folds its tree rows into id
    order; the shards merge with ``torch.minimum`` and the table steps
    through ``fused_round_update``.  Returns ``(QueryResult,
    shard_candidates)``, the latter the (n_shards,) f32 count of (tree,
    point) entries scanned per shard, summed over rounds.
    """
    if cfg.probe_depth:
        raise NotImplementedError(
            "engine 'pdet' does not support multi-probe (probe_depth > 0): "
            "each shard only sees its own leaves, so a per-shard slack "
            "ranking would admit a different probe set per shard count and "
            "break the bit-identical PDET == DET contract; use "
            "engine='fused' or 'vmap', or probe_depth=0")
    from repro_torch.kernels import ops

    B = queries.shape[0]
    K, L = params.K, params.L
    dev = queries.device
    q_proj = (queries @ A).reshape(B, L, K).permute(1, 0, 2).contiguous()
    thresh = torch.tensor(params.beta * n + cfg.k, dtype=torch.float32,
                          device=dev)
    interpret = cfg.dist_impl == "pallas_interpret"
    inputs = {}                                # replicated once per device
    for shard in layout.shards:
        if shard.device not in inputs:
            inputs[shard.device] = (queries.to(shard.device),
                                    q_proj.to(shard.device))

    rnd = 0
    rounds = torch.zeros((B,), dtype=torch.int32, device=dev)
    r = torch.full((B,), cfg.r_min, dtype=torch.float32, device=dev)
    done = (torch.zeros((B,), dtype=torch.bool, device=dev) if n_active is None
            else torch.arange(B, device=dev) >= int(n_active))
    best = torch.full((B, n), _INF, dtype=torch.float32, device=dev)
    scanned = torch.zeros((len(layout.shards),), dtype=torch.float32,
                          device=dev)
    while rnd < cfg.max_rounds and bool((~done).any()):     # one sync a round
        r_eff = torch.where(done, -1.0, params.epsilon * r)  # lane mask
        by_id = None
        counts = []
        for shard in layout.shards:
            q, qp = inputs[shard.device]
            dmat = ops.range_rerank(
                q, qp, r_eff.to(shard.device), shard.leaf_lo, shard.leaf_hi,
                shard.leaf_valid, shard.breakpoints, shard.points,
                shard.valid, leaf_size=leaf_size, interpret=interpret)
            counts.append(torch.isfinite(dmat).sum().to(dev))
            part = _fold_shard(dmat, shard).to(dev)
            del dmat
            by_id = part if by_id is None else torch.minimum(by_id, part)
        scanned = scanned + torch.stack(counts).to(torch.float32)
        best, r, done, rounds = fused_round_update(
            best, by_id, r, done, rounds, rnd, params=params, k=cfg.k,
            thresh=thresh)
        rnd += 1

    ids, dists, count = fused_topk(best, cfg.k, n)
    return (QueryResult(ids=ids, dists=dists, rounds=rounds,
                        n_candidates=count, final_r=r), scanned)


def _forest_on(forest: DEForest, device: torch.device) -> DEForest:
    return dataclasses.replace(
        forest, **{k: getattr(forest, k).to(device) for k in _FOREST_TENSORS})


@dataclasses.dataclass
class PDETIndex:
    """The sharded PDET-LSH index behind the ``repro_torch.api`` surface.

    Satisfies ``AnnIndex``: built from an ``IndexSpec`` whose ``placement``
    names the mesh, searched through ``SearchRequest``/``SearchResult`` by
    the ``pdet`` engine (with per-shard counters in ``SearchStats``),
    snapshotted as per-shard files (``repro_torch.api.load`` reshards onto
    the devices present).  The global padded layout, A and the data rows
    stay on the controller's device (the mesh's first) for the engines a
    request falls back to: ``fused`` for multi-probe under 'auto', ``vmap``
    for strict mode.
    """

    params: LSHParams
    A: torch.Tensor
    forest: DEForest           # the one global forest, padded to S shards
    data: torch.Tensor         # (n, d)
    plan: FusedPlan            # the global padded fused plan
    layout: PDETLayout         # the shards, each on its own device
    mesh: DeviceMesh
    placement: Any             # repro_torch.api.PlacementSpec
    spec: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)
    _r_min_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # The build's seconds by stage (DETLSH.build_seconds) plus 'shard', the
    # padding and the per-shard copies; empty stages for a loaded index.
    build_seconds: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @classmethod
    def from_spec(cls, data: Any, generator: Optional[torch.Generator],
                  spec: Any, *, mesh: Optional[DeviceMesh] = None,
                  device: Optional[Any] = None) -> "PDETIndex":
        """Build from an ``IndexSpec`` with a ``placement``: the forest is
        built by ``DETLSH.from_spec`` on the same spec minus the placement
        (the same code path and arrays: the ground of the bit-identity
        contract) on the mesh's first device, then sharded.  Without a
        ``mesh``, ``device`` picks the devices as ``mesh_from_placement``
        does (CUDA cards unless 'cpu')."""
        placement = spec.placement
        if placement is None:
            raise ValueError("PDETIndex.from_spec needs spec.placement "
                             "(use repro_torch.api.build for unplaced specs)")
        from repro_torch.core import DETLSH
        if mesh is None:
            mesh = mesh_from_placement(placement, device=device)
        det = DETLSH.from_spec(data, generator,
                               dataclasses.replace(spec, placement=None),
                               device=mesh.devices.flat[0])
        return cls.from_detlsh(det, placement, mesh=mesh, spec=spec)

    @classmethod
    def from_detlsh(cls, det: Any, placement: Any, *,
                    mesh: Optional[DeviceMesh] = None,
                    spec: Optional[Any] = None) -> "PDETIndex":
        """Shard a built static index onto a mesh (a ``DETLSH``, or a
        ``PDETIndex`` to reshard it).  When the leaf count is not a multiple
        of the shard count, the layout is padded with invalid leaves and
        empty point slots, which change no answer.  Without a ``mesh``, the
        index's own device type picks the devices (``mesh_from_placement``).
        """
        if mesh is None:
            mesh = mesh_from_placement(placement, device=det.device)
        if (mesh.axis_names != tuple(placement.mesh_axes)
                or mesh.devices.shape != tuple(placement.mesh_shape)):
            raise ValueError(f"mesh {mesh.shape} does not match placement "
                             f"{placement.mesh_shape} over "
                             f"{placement.mesh_axes}")
        t0 = time.perf_counter()
        dev = mesh.devices.flat[0]
        forest, plan = _pad_layout_to_shards(det.forest, det.fused_plan(),
                                             placement.n_shards)
        forest = _forest_on(forest, dev)
        plan = FusedPlan(points_sorted=plan.points_sorted.to(dev),
                         inv_perm=plan.inv_perm.to(dev))
        layout = shard_layout(forest, plan,
                              mesh.shard_devices(placement.data_axes))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = dict(getattr(det, "build_seconds", {}))
        seconds["shard"] = time.perf_counter() - t0
        idx = cls(params=det.params, A=det.A.to(dev), forest=forest,
                  data=det.data.to(dev), plan=plan, layout=layout, mesh=mesh,
                  placement=placement,
                  spec=spec if spec is not None else det.spec,
                  build_seconds=seconds)
        idx._r_min_cache.update(det._r_min_cache)
        return idx

    @property
    def n_points(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_shards(self) -> int:
        return self.placement.n_shards

    @property
    def device(self) -> torch.device:
        """The controller's device: the mesh's first."""
        return self.data.device

    def fused_plan(self) -> FusedPlan:
        return self.plan

    def r_min_for(self, k: int, queries: Any = None) -> float:
        """Cached per-(index, k) starting radius: the same estimator over
        the same rows as ``DETLSH.r_min_for``, so a PDET index and its
        single-device twin start every search at the same radius."""
        if k not in self._r_min_cache:
            from repro_torch.core import estimate_r_min
            probes = (queries if queries is not None
                      else self.data[: min(64, self.data.shape[0])])
            self._r_min_cache[k] = estimate_r_min(self.data, probes, k,
                                                  self.params.c)
        return self._r_min_cache[k]

    def search(self, queries: Any, request: Any = None) -> Any:
        """Typed batched search.  Resolves through the registry with this
        index's mesh declared, so 'auto' runs the ``pdet`` engine; the
        fallbacks (multi-probe under 'auto' -> fused, strict -> vmap) run
        on the global layout on the controller's device."""
        from repro_torch.api import registry
        from repro_torch.api.request import (SearchRequest, SearchResult,
                                             SearchStats)
        req = request or SearchRequest()
        queries = to_device(queries, self.device, torch.float32)
        r_min, cached = req.r_min, False
        if r_min is None:
            cached = req.k in self._r_min_cache
            probes = queries[: req.n_active] if req.n_active else queries
            r_min = self.r_min_for(req.k, probes)
        spec = self.spec
        default_engine = spec.engine if spec is not None else "auto"
        cfg = req.to_query_config(
            default_engine=default_engine, r_min=r_min,
            default_probe_depth=spec.probe_depth if spec is not None else 0)
        engine = registry.resolve_engine(
            cfg.engine, mode=cfg.mode, batch=queries.shape[0],
            mesh_devices=self.placement.n_devices)
        if engine == "pdet" and cfg.probe_depth > 0 and \
                (req.engine or default_engine) != "pdet":
            # Multi-probe is not expressible per shard (pdet_query_batch);
            # 'auto' falls back to the fused engine, and an explicit
            # engine='pdet' with probe_depth > 0 raises there.
            engine = "fused"
        shard_cands = psum_rounds = merge_size = None
        if engine == "pdet":
            res, shard_cands = pdet_query_batch(
                self.layout, self.A, self.params, queries, cfg,
                n=self.forest.n, leaf_size=self.forest.leaf_size,
                n_active=req.n_active)
            psum_rounds = res.rounds.max()
            merge_size = queries.shape[0] * self.forest.n
        else:
            cfg = dataclasses.replace(cfg, engine=engine)
            plan = self.plan if engine == "fused" else None
            res = knn_query_batch(self.data, self.forest, self.A,
                                  self.params, queries, cfg, plan=plan,
                                  n_active=req.n_active)
        return SearchResult(
            ids=res.ids, dists=res.dists,
            stats=SearchStats(engine=engine, r_min=float(r_min),
                              r_min_cached=cached, rounds=res.rounds,
                              n_candidates=res.n_candidates,
                              final_r=res.final_r,
                              shard_candidates=shard_cands,
                              psum_rounds=psum_rounds,
                              merge_size=merge_size,
                              probed_leaves=res.probed_leaves,
                              probe_candidates=res.probe_candidates),
            raw=res)

    def save(self, path: Any) -> None:
        """Write a sharded snapshot directory: per-shard npz files and the
        shard map in MANIFEST.json (``repro_torch.api.load`` reshards)."""
        from repro_torch.api import persist
        persist.save_pdet(self, path)

    def index_size_bytes(self) -> int:
        return self.forest.size_bytes() + self.A.numel() * 4


def _run_pdet_engine(data, forest, A, params, queries, cfg, *,
                     plan=None, live=None, live_sorted=None,
                     n_active=None) -> QueryResult:
    """Registry entry point for engine='pdet': ``plan`` is the index's
    ``PDETLayout``."""
    del data
    if live is not None or live_sorted is not None:
        raise NotImplementedError(
            "engine 'pdet' serves the static sharded index; tombstones "
            "(live masks) belong to the streaming index's engines")
    if not isinstance(plan, PDETLayout):
        raise ValueError("engine 'pdet' needs the index's sharded layout "
                         "(plan=PDETIndex.layout; build the index with an "
                         "IndexSpec placement)")
    res, _ = pdet_query_batch(plan, A, params, queries, cfg, n=forest.n,
                              leaf_size=forest.leaf_size, n_active=n_active)
    return res


engine_registry.register_engine(
    "pdet", _run_pdet_engine, modes=("leaf",), min_batch=1, priority=20,
    needs_mesh=True,
    doc="the fused round over the shards of a placed index (Alg. 8), "
        "merged with an exact torch.minimum => bit-identical to 'fused' on "
        "one device for any shard count")
