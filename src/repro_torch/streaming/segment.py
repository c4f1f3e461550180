"""Immutable sealed segment: one DE-Forest over a batch of accepted points.

A segment is the unit of the streaming index's LSM structure.  Its rows are
frozen at seal time; the only mutable state is the tombstone bitmap
(``live``), which both query engines honor.

Frozen-breakpoint encoding.  New points are encoded with the *base build's*
breakpoints so codes stay comparable across segments (the compactor's O(n)
merge depends on a shared key space).  ``encode`` reads only the Nr-1
*inner* edges, so per-segment **outer-edge widening** — stretching edge 0 /
edge Nr to cover the segment's actual projected min/max — changes no code
but keeps every point inside its leaf's bounding box, which is what the
Fig. 5 LB admissibility (and hence Theorems 1-3) needs.  The fraction of
coordinates that needed widening is recorded as ``clip_fraction`` — the
breakpoint-drift signal that tells the operator when a re-quantile
(``StreamingDETLSH.requantile``) is worth it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import to_device
from repro_torch.core import hashing
from repro_torch.core.detree import (DEForest, StageClock,
                                     assemble_sorted_forest, build_forest,
                                     check_nr, code_sort_orders)
from repro_torch.core.query import (FusedPlan, live_in_sorted_order,
                                    make_fused_plan)
from repro_torch.core.theory import LSHParams


@dataclasses.dataclass
class Segment:
    """One sealed, code-sorted segment (rows immutable, tombstones mutable)."""

    seg_id: int
    data: torch.Tensor         # (m, d) f32 — segment rows, local order
    gids: np.ndarray           # (m,) int32 — global point ids (host truth)
    live: np.ndarray           # (m,) bool — tombstone bitmap (host truth)
    forest: DEForest           # DE-Forest over local row ids 0..m-1
    clip_fraction: float       # coords outside the frozen outer edges at seal

    # Device-side caches, invalidated on delete (None = stale).  A delete
    # replaces them; it never writes into a tensor an earlier pinned view
    # may still hold.
    _plan: Optional[FusedPlan] = dataclasses.field(
        default=None, repr=False, compare=False)
    _live_dev: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    _live_sorted_dev: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    _gid_map: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def m(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    @property
    def has_tombstones(self) -> bool:
        return bool((~self.live).any())

    def mark_dead(self, local_rows: Any) -> None:
        self.live[np.asarray(local_rows)] = False
        self._live_dev = None
        self._live_sorted_dev = None
        self._gid_map = None

    def plan(self) -> FusedPlan:
        if self._plan is None:
            self._plan = make_fused_plan(self.data, self.forest)
        return self._plan

    def live_dev(self) -> Optional[torch.Tensor]:
        """(m,) bool device mask, or None when every row is live."""
        if not self.has_tombstones:
            return None
        if self._live_dev is None:
            # to_device copies: the host bitmap mutates in place.
            self._live_dev = to_device(self.live, self.data.device)
        return self._live_dev

    def live_sorted_dev(self) -> Optional[torch.Tensor]:
        """(L, n_pad) bool mask in code-sorted order for the fused kernel."""
        live = self.live_dev()
        if live is None:
            return None
        if self._live_sorted_dev is None:
            self._live_sorted_dev = live_in_sorted_order(self.forest, live)
        return self._live_sorted_dev

    def gid_map_dev(self, sentinel: int) -> torch.Tensor:
        """(m+1,) int32: local id -> global id; dead rows and the local
        sentinel m map to ``sentinel`` (the combine step's invalid id)."""
        if self._gid_map is None or self._gid_map[0] != sentinel:
            gids = np.where(self.live, self.gids, sentinel).astype(np.int32)
            self._gid_map = (sentinel, to_device(
                np.concatenate([gids, [sentinel]]).astype(np.int32),
                self.data.device))
        return self._gid_map[1]

    def warm_caches(self, sentinel: int) -> None:
        """Materialize all device caches eagerly (fused plan, tombstone
        masks, gid map), so the next search pays for none of them."""
        self.plan()
        self.live_dev()
        self.live_sorted_dev()
        self.gid_map_dev(sentinel)


def _clip_fraction(outside: torch.Tensor) -> float:
    """The share of coordinates outside the frozen outer edges, as the
    reference's float32 ``mean`` gives it: the count (exact) over the
    total, divided in float32."""
    return float(np.float32(int(outside.sum()))
                 / np.float32(outside.numel()))


def _widen(bp_all: torch.Tensor, pmin: torch.Tensor,
           pmax: torch.Tensor) -> torch.Tensor:
    """The frozen breakpoints with each dim's outer edges stretched to the
    segment's projected min / max (inner edges, hence codes, unchanged)."""
    bp_seg = bp_all.clone()
    bp_seg[:, 0] = torch.minimum(bp_all[:, 0], pmin)
    bp_seg[:, -1] = torch.maximum(bp_all[:, -1], pmax)
    return bp_seg


def _fused_seal(data: torch.Tensor, A: torch.Tensor, bp_all: torch.Tensor, *,
                K: int, L: int, leaf_size: int, impl: str,
                clock: StageClock) -> tuple[dict, torch.Tensor, float]:
    """The whole seal around one ``project_encode_pack`` pass: project ->
    encode -> key-pack (encoding reads only the *inner* edges, so it runs
    with the frozen breakpoints while the outer-edge widening is computed
    from the same pass's projections) -> single sort -> forest arrays.
    Returns (arrays, bp_seg (L*K, Nr+1) widened, clip_fraction).

    ``impl``: 'auto'/'pallas' launch the kernel on a CUDA tensor (its
    plain version on a CPU one); 'xla'/'pallas_interpret' run the plain
    version on either device.
    """
    from repro_torch.kernels import ops
    proj_t, codes_t, key_hi, key_lo = ops.project_encode_pack(
        data, A, bp_all, K=K, L=L, interpret=impl in ("xla",
                                                      "pallas_interpret"))
    clock.lap("project_encode_pack")
    # Dimension D = l*K + j maps to proj_t[l, :, j]: (L, K) stats -> (L*K,).
    pmin = proj_t.amin(dim=1).reshape(-1)
    pmax = proj_t.amax(dim=1).reshape(-1)
    bp_lo = bp_all[:, 0].reshape(L, 1, K)
    bp_hi = bp_all[:, -1].reshape(L, 1, K)
    clip = _clip_fraction((proj_t < bp_lo) | (proj_t > bp_hi))
    bp_seg = _widen(bp_all, pmin, pmax)
    clock.lap("widen")
    order = code_sort_orders(key_hi, key_lo, K)
    clock.lap("sort")
    arrays = assemble_sorted_forest(proj_t, codes_t, order,
                                    n=data.shape[0], leaf_size=leaf_size)
    clock.lap("assemble")
    return arrays, bp_seg, clip


def build_segment(data: Any, gids: Any, A: torch.Tensor,
                  params: LSHParams, bp_all: torch.Tensor, *,
                  Nr: int, leaf_size: int, seg_id: int,
                  live: Optional[np.ndarray] = None,
                  proj: Optional[torch.Tensor] = None,
                  project_impl: str = "auto",
                  encode_impl: str = "auto",
                  build_impl: str = "auto",
                  stage_seconds: Optional[dict] = None) -> Segment:
    """Seal rows into a Segment on A's device, encoding with the frozen
    breakpoints.

    bp_all: (L*K, Nr+1) — the base build's breakpoints.  Outer edges are
    widened per dimension to the segment's projected min/max (no code
    changes; restores Fig. 5 box containment for out-of-range inserts).
    ``proj`` skips re-projection when the caller already has it; the
    forest is then built by ``detree.build_forest`` (the ``encode_pack``
    kernel on the fused builder).

    With no ``proj`` and a fused ``build_impl`` the seal is one
    ``project_encode_pack`` pass plus the sort and the leaf summaries
    (:func:`_fused_seal`); an explicit ``project_impl`` picks kernel or
    plain version there when ``build_impl`` is 'auto', as in the
    reference.  A projection outside the fused pass goes through
    ``hashing.project(impl=project_impl)``: 'pallas' runs the
    ``lsh_project`` kernel there.  ``stage_seconds``, when given, receives
    the seconds of each stage, each ended by a device sync.
    """
    # to_device copies host rows: seal() hands over the memtable's arrays,
    # which are zeroed right after, and the segment must own its rows.
    dev = A.device
    data = to_device(data, dev, torch.float32)
    m = data.shape[0]
    K, L = params.K, params.L
    check_nr(Nr)
    clock = StageClock(dev, stage_seconds)
    if proj is None and build_impl != "reference":
        impl = build_impl
        if impl == "auto" and project_impl != "auto":
            impl = project_impl       # an explicit project impl wins on auto
        arrays, bp_seg, clip_fraction = _fused_seal(
            data, A, bp_all, K=K, L=L, leaf_size=leaf_size, impl=impl,
            clock=clock)
        forest = DEForest(n=m, leaf_size=leaf_size,
                          breakpoints=bp_seg.reshape(L, K, Nr + 1), **arrays)
    else:
        if proj is None:
            proj = hashing.project(data, A, impl=project_impl)  # (m, L*K)
        out_lo = proj < bp_all[:, 0][None, :]
        out_hi = proj > bp_all[:, -1][None, :]
        clip_fraction = _clip_fraction(out_lo | out_hi)
        bp_seg = _widen(bp_all, proj.amin(dim=0), proj.amax(dim=0))
        forest = build_forest(proj, K, L, Nr=Nr, leaf_size=leaf_size,
                              breakpoints=bp_seg, encode_impl=encode_impl,
                              build_impl=build_impl,
                              stage_seconds=stage_seconds)
    live = np.ones(m, bool) if live is None else np.asarray(live, bool).copy()
    return Segment(seg_id=seg_id, data=data,
                   gids=np.asarray(gids, np.int32).copy(), live=live,
                   forest=forest, clip_fraction=clip_fraction)
