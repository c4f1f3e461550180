"""Streaming mutable DET-LSH: an LSM-style segmented index, in PyTorch.

The paper's DE-Tree is *Dynamic* by construction — cheap incremental
maintenance is its selling point.  This package is the port of the
reference's ``repro.streaming``:

  * inserts land in a bounded delta buffer (``Memtable``) that is answered
    exactly (brute force over <= capacity rows) until it fills, then is
    projected + encoded with the base build's **frozen breakpoints** (no
    re-quantiling) in one ``project_encode_pack`` kernel pass and sealed
    into an immutable code-sorted ``Segment``;
  * deletes are tombstone bitmaps, honored by both query engines before
    compaction ever runs (the fused ``range_rerank`` kernel masks per
    point, the vmap engine masks at admission);
  * a compactor merges sealed segments by *merging* their already
    code-sorted arrays on the host (O(n) stable merge on the interleaved
    iSAX keys — never a re-projection/re-encode/re-sort) and drops
    tombstoned rows;
  * queries fan out over {sealed segments + delta} and combine through
    ``core/candidates.py``'s incremental merge.

``StreamingDETLSH`` is the user-facing index (``repro_torch.api.build``
with ``IndexSpec(kind="streaming")``).
"""

from repro_torch.streaming.segment import Segment, build_segment
from repro_torch.streaming.memtable import BatchedMemtable, Memtable
from repro_torch.streaming.manifest import Manifest
from repro_torch.streaming.compactor import merge_segments
from repro_torch.streaming.index import StreamingDETLSH

__all__ = ["StreamingDETLSH", "Segment", "build_segment", "Memtable",
           "BatchedMemtable", "Manifest", "merge_segments"]
