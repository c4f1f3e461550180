"""repro_torch.api — the index surface of the PyTorch port.

One build config (``IndexSpec``), one typed request/result pair
(``SearchRequest`` / ``SearchResult``), one engine registry, and snapshot
persistence in the reference package's format::

    import torch
    import repro_torch.api as api

    spec = api.IndexSpec(kind="static", K=16, L=4, c=1.5, beta_override=0.1)
    index = api.build(data, torch.Generator().manual_seed(0), spec)
    res = index.search(queries, api.SearchRequest(k=50))
    index.save("snapshots/my-index")
    index = api.load("snapshots/my-index")          # no rebuild

``build`` and ``load`` run on CUDA unless given ``device=``; with neither
a device nor a CUDA card they raise.  A spec with a ``placement`` builds
the sharded PDET index (``core.distributed.PDETIndex``).
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.api.protocol import (AnnIndex, LegacyIndexAdapter,
                                      MutableAnnIndex, as_ann_index)
from repro_torch.api.persist import (FORMAT_VERSION, SnapshotFormatError,
                                     SnapshotIntegrityError, load, save)
from repro_torch.api.registry import (EngineSpec, available_engines,
                                      get_engine, register_engine,
                                      resolve_engine)
from repro_torch.api.request import SearchRequest, SearchResult, SearchStats
from repro_torch.api.spec import IndexSpec, PlacementSpec


def build(data: Any, generator: Any = None, spec: Optional[IndexSpec] = None,
          *, device: Optional[Any] = None) -> Any:
    """Build an index from an ``IndexSpec`` on ``device``.

    A static spec with a ``placement`` builds the sharded
    ``core.distributed.PDETIndex`` (its devices: ``device='cpu'`` puts every
    shard on the CPU, otherwise the first ``placement.n_devices`` cards;
    ``PDETIndex.from_spec(..., mesh=)`` takes any device list); the static
    kind builds a ``core.DETLSH``, the streaming kind a
    ``streaming.StreamingDETLSH``.
    """
    spec = spec or IndexSpec()
    if spec.placement is not None:
        from repro_torch.core.distributed import PDETIndex
        return PDETIndex.from_spec(data, generator, spec, device=device)
    if spec.kind == "streaming":
        from repro_torch.streaming import StreamingDETLSH
        return StreamingDETLSH.from_spec(data, generator, spec,
                                         device=device)
    from repro_torch.core import DETLSH
    return DETLSH.from_spec(data, generator, spec, device=device)


__all__ = [
    "AnnIndex", "MutableAnnIndex", "LegacyIndexAdapter", "as_ann_index",
    "IndexSpec", "PlacementSpec", "SearchRequest", "SearchResult",
    "SearchStats", "EngineSpec", "register_engine", "resolve_engine",
    "available_engines", "get_engine", "build", "load", "save",
    "SnapshotFormatError", "SnapshotIntegrityError", "FORMAT_VERSION",
]
