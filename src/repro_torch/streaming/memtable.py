"""Delta buffer: the mutable head of the streaming index.

Fixed-capacity host-side numpy arrays (one stable shape for the delta's
exact query path), as in the reference package.  Inserts append at a
cursor; deletes of not-yet-sealed rows just clear the slot's live bit.
When the buffer is full the index seals *all* capacity rows into a Segment
(dead slots become tombstoned rows there — the compactor drops them), so
every sealed-from-delta segment has the same shape.
"""

from __future__ import annotations

import numpy as np


class Memtable:
    def __init__(self, capacity: int, d: int):
        assert capacity >= 1
        self.capacity = capacity
        self.d = d
        self.vecs = np.zeros((capacity, d), np.float32)
        self.gids = np.full(capacity, -1, np.int64)
        self.live = np.zeros(capacity, bool)
        self.count = 0            # slots assigned (monotone until reset)
        self.version = 0          # bumped on every mutation (device-cache key)

    @property
    def full(self) -> bool:
        return self.count >= self.capacity

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    def add(self, gid: int, vec: np.ndarray) -> int:
        """Append one row; returns its slot.  Caller checks ``full`` first."""
        return int(self.add_block(np.asarray([gid], np.int64),
                                  np.asarray(vec, np.float32)[None, :])[0])

    def add_block(self, gids: np.ndarray, vecs: np.ndarray) -> np.ndarray:
        """Append a block of rows with one vectorized write; returns the
        assigned slots.  Caller ensures the block fits (seal first)."""
        m = len(gids)
        assert self.count + m <= self.capacity, (self.count, m, self.capacity)
        slots = np.arange(self.count, self.count + m)
        self.vecs[slots] = vecs
        self.gids[slots] = gids
        self.live[slots] = True
        self.count += m
        self.version += 1
        return slots

    def kill(self, slot: int) -> None:
        self.live[slot] = False
        self.version += 1

    def reset(self) -> None:
        self.vecs[:] = 0.0
        self.gids[:] = -1
        self.live[:] = False
        self.count = 0
        self.version += 1


class BatchedMemtable:
    """H parallel delta buffers advancing in lockstep (the KV-decode delta).

    The decode subsystem keeps one DE-Forest per (batch, kv-head); a decode
    step inserts exactly one new key into *every* head's delta at the same
    cache position, so the H buffers share one cursor, one gid (position)
    array, and one live bitmap — only the vectors carry a head axis.
    Same fixed-capacity / stable-shape contract as ``Memtable``.
    """

    def __init__(self, heads: int, capacity: int, d: int):
        assert heads >= 1 and capacity >= 1
        self.heads = heads
        self.capacity = capacity
        self.d = d
        self.vecs = np.zeros((heads, capacity, d), np.float32)
        self.gids = np.full(capacity, -1, np.int64)
        self.live = np.zeros(capacity, bool)
        self.count = 0
        self.version = 0

    @property
    def full(self) -> bool:
        return self.count >= self.capacity

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    def add_step(self, gid: int, vecs: np.ndarray) -> int:
        """Append one row per head (vecs (H, d)); returns the slot."""
        assert self.count < self.capacity, (self.count, self.capacity)
        assert vecs.shape == (self.heads, self.d), vecs.shape
        slot = self.count
        self.vecs[:, slot] = vecs
        self.gids[slot] = gid
        self.live[slot] = True
        self.count += 1
        self.version += 1
        return slot

    def kill(self, slot: int) -> None:
        self.live[slot] = False
        self.version += 1

    def reset(self) -> None:
        self.vecs[:] = 0.0
        self.gids[:] = -1
        self.live[:] = False
        self.count = 0
        self.version += 1
