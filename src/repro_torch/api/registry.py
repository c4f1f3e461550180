"""Query-engine registry.

Engines are the batched c^2-k-ANN execution strategies.
``core/query.py`` and ``core/distributed.py`` register the built-in ones at
import time:

  * ``vmap``  — the per-query engine (lanes batched); supports both
    admission modes ('leaf' and the unoptimized 'strict' Alg. 3 filter).
  * ``fused`` — the one-pass range_rerank engine; 'leaf' mode only,
    amortized at batch >= its ``min_batch``.
  * ``pdet``  — the fused round over the shards of a placed index (paper
    Alg. 8); 'leaf' mode only, and only with a declared mesh
    (``needs_mesh``).

``resolve_engine`` applies the reference's rules:

  1. an unknown name raises immediately (with the valid names);
  2. an explicitly requested engine that does not support the requested
     mode falls back to the best engine that does;
  3. ``'auto'`` picks the highest-priority engine supporting the mode
     whose ``min_batch`` the batch size meets, falling back to the
     lowest-``min_batch`` eligible engine;
  4. a ``needs_mesh`` engine is eligible only when the caller declares a
     mesh (``mesh_devices=``, its device count; a one-device placement
     counts), so ``'auto'`` prefers ``pdet`` exactly on a placed index,
     and an explicit ``engine='pdet'`` without a mesh raises.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional, Sequence

AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One registered query engine.

    ``run`` has the uniform batched signature
    ``run(data, forest, A, params, queries, cfg, *, plan, live,
    live_sorted, n_active) -> QueryResult``.
    """

    name: str
    run: Callable
    modes: frozenset
    min_batch: int = 1
    priority: int = 0
    doc: str = ""
    needs_mesh: bool = False   # eligible only with a declared mesh


_ENGINES: dict = {}


def register_engine(name: str, run: Callable, *,
                    modes: Sequence[str] = ("leaf",),
                    min_batch: int = 1, priority: int = 0,
                    doc: str = "", needs_mesh: bool = False) -> EngineSpec:
    """Register (or replace) a query engine under ``name``."""
    if name == AUTO:
        raise ValueError(f"'{AUTO}' is reserved for engine resolution")
    spec = EngineSpec(name=name, run=run, modes=frozenset(modes),
                      min_batch=int(min_batch), priority=int(priority),
                      doc=doc, needs_mesh=bool(needs_mesh))
    _ENGINES[name] = spec
    return spec


_builtins_loaded = False


def _ensure_builtins() -> None:
    # core/query.py registers 'vmap' and 'fused', core/distributed.py
    # 'pdet', both as import side effects.  Guarded by a flag, not by
    # `_ENGINES` being empty: a custom engine registered before the first
    # resolve must not mask the built-ins.
    global _builtins_loaded
    if not _builtins_loaded:
        _builtins_loaded = True
        importlib.import_module("repro_torch.core.query")
        importlib.import_module("repro_torch.core.distributed")


def available_engines() -> tuple:
    """Registered engine names, highest priority first."""
    _ensure_builtins()
    return tuple(s.name for s in
                 sorted(_ENGINES.values(), key=lambda s: -s.priority))


def get_engine(name: str) -> EngineSpec:
    _ensure_builtins()
    if name not in _ENGINES:
        raise ValueError(
            f"unknown engine {name!r}; valid: "
            f"{(AUTO,) + available_engines()}")
    return _ENGINES[name]


def validate_engine_name(name: Optional[str]) -> None:
    """Eager validation for config objects: None / 'auto' / registered."""
    if name is None or name == AUTO:
        return
    get_engine(name)  # raises with the valid names


def resolve_engine(requested: Optional[str], *, mode: str = "leaf",
                   batch: Optional[int] = None,
                   mesh_devices: Optional[int] = None) -> str:
    """Map a requested engine (or 'auto' / None) to a concrete engine name.

    ``batch`` is the batch size when known; None means "assume large
    enough".  ``mesh_devices`` declares a mesh (its device count); None
    means "no mesh" and excludes ``needs_mesh`` engines (rule 4).
    """
    _ensure_builtins()
    requested = AUTO if requested is None else requested
    eligible = sorted(
        (s for s in _ENGINES.values()
         if mode in s.modes and (mesh_devices is not None
                                 or not s.needs_mesh)),
        key=lambda s: -s.priority)
    if not eligible:
        raise ValueError(f"no registered engine supports mode={mode!r}")
    if requested != AUTO:
        spec = get_engine(requested)
        if spec.needs_mesh and mesh_devices is None:
            raise ValueError(
                f"engine {requested!r} needs a device mesh; build the index "
                f"with an IndexSpec placement (or pass mesh_devices=): "
                f"without a mesh the sharded round has nothing to shard over")
        if mode in spec.modes:
            return spec.name
        return eligible[0].name          # explicit mode fallback (rule 2)
    for spec in eligible:                # rule 3: priority + min_batch
        if batch is None or batch >= spec.min_batch:
            return spec.name
    return min(eligible, key=lambda s: s.min_batch).name
