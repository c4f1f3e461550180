"""Manifest: the versioned catalog of sealed segments.

The query path reads ``segments`` (fan-out order: oldest first); mutators
go through ``add`` / ``swap`` so every structural change bumps ``version``
— the invalidation key for anything derived from the segment list (device
caches, radius estimates).  ``swap`` is the compactor's atomic install: the
replacement segment appears in the same pass that removes its inputs, so a
reader never sees a point twice or not at all.

Epoch refcounts (docs/DESIGN.md §9).  The serving runtime pins an
*epoch* — an immutable view of one manifest version — for the lifetime of
every query batch, so compaction can swap the next version in underneath
without invalidating in-flight readers (RCU: readers never block writers
and vice versa).  ``retain``/``release`` track how many pinned epochs
still reference each version; ``pinned_versions`` makes the drain state
observable (``describe()`` reports it, tests assert on it).  The refcount
is bookkeeping, not a lock: old ``Segment`` objects stay alive through the
epoch's own references, and a version retires (drops out of the pin table)
exactly when its last reader releases.

``swap_hook`` is the fault-injection boundary for the compaction swap: it
runs *before* any mutation, so a hook that raises models a compaction
crashing mid-install — the manifest is left exactly
as it was, which is what makes the swap atomic under injected faults.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.streaming.segment import Segment


@dataclasses.dataclass
class Manifest:
    segments: List[Segment] = dataclasses.field(default_factory=list)
    version: int = 0
    # version -> number of pinned epochs still reading it (serving runtime)
    _pins: Dict[int, int] = dataclasses.field(default_factory=dict,
                                              repr=False)
    # fault-injection point: called at the top of swap(), before mutation
    swap_hook: Optional[Callable[[], None]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def add(self, seg: Segment) -> None:
        self.segments.append(seg)
        self.version += 1

    def swap(self, remove_ids, add: List[Segment]) -> None:
        """Atomically replace segments ``remove_ids`` with ``add``.

        The hook (if any) fires first: an exception there leaves the
        manifest untouched — the compaction-crash recovery contract."""
        if self.swap_hook is not None:
            self.swap_hook()
        remove_ids = set(remove_ids)
        kept = [s for s in self.segments if s.seg_id not in remove_ids]
        self.segments = kept + list(add)
        self.version += 1

    # ------------------------------------------------------------------
    # Epoch refcounts
    # ------------------------------------------------------------------

    def retain(self) -> int:
        """Pin the current version for a reader epoch; returns the version
        token to pass back to ``release``."""
        self._pins[self.version] = self._pins.get(self.version, 0) + 1
        return self.version

    def release(self, version: int) -> None:
        """Drop one reader pin on ``version``; the version retires (leaves
        the pin table) when its count drains to zero."""
        count = self._pins.get(version)
        if count is None:
            raise ValueError(f"release of unpinned manifest version "
                             f"{version} (double release?)")
        if count <= 1:
            del self._pins[version]
        else:
            self._pins[version] = count - 1

    def pinned_versions(self) -> tuple:
        """Versions with live reader epochs, oldest first."""
        return tuple(sorted(self._pins))

    @property
    def n_rows(self) -> int:
        return sum(s.m for s in self.segments)

    @property
    def n_live(self) -> int:
        return sum(s.n_live for s in self.segments)

    def describe(self) -> dict:
        return {
            "version": self.version,
            "pinned": {v: c for v, c in sorted(self._pins.items())},
            "segments": [
                {"seg_id": s.seg_id, "rows": s.m, "live": s.n_live,
                 "clip_fraction": round(s.clip_fraction, 6)}
                for s in self.segments],
        }
