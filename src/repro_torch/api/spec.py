"""IndexSpec: one declarative, validated build configuration.

The fields, their defaults and the values they accept are the reference
package's, so a snapshot's ``spec`` dict round-trips between the two
packages (``to_dict``/``from_dict``).  The port builds the static and
the streaming kinds, and a static spec with a ``placement`` builds the
sharded PDET index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from repro_torch.api import registry
from repro_torch.api.request import IMPLS, _check_choice, _check_positive

KINDS = ("static", "streaming")
BREAKPOINT_METHODS = ("sample_sort", "full_sort", "histogram_refine")
BUILD_IMPLS = IMPLS + ("reference",)


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """Where a sharded index lives: mesh shape/axes + the axes the index
    layout shards over (default: all of them)."""

    mesh_shape: tuple = (1,)
    mesh_axes: tuple = ("data",)
    data_axes: Optional[tuple] = None

    def __post_init__(self) -> None:
        shape = tuple(int(s) for s in self.mesh_shape)
        axes = tuple(self.mesh_axes)
        object.__setattr__(self, "mesh_shape", shape)
        object.__setattr__(self, "mesh_axes", axes)
        if len(shape) != len(axes):
            raise ValueError(
                f"mesh_shape {shape} and mesh_axes {axes} must have the "
                f"same length (one device count per axis name)")
        if not shape:
            raise ValueError("placement needs at least one mesh axis")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
        if any(not isinstance(a, str) or not a for a in axes):
            raise ValueError(f"mesh axis names must be non-empty strings, "
                             f"got {axes!r}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate mesh axis names in {axes!r}")
        data_axes = axes if self.data_axes is None else tuple(self.data_axes)
        unknown = [a for a in data_axes if a not in axes]
        if unknown:
            raise ValueError(f"data_axes {unknown} are not mesh axes "
                             f"(mesh has {axes})")
        if len(set(data_axes)) != len(data_axes) or not data_axes:
            raise ValueError(f"data_axes must be a non-empty subset of the "
                             f"mesh axes without repeats, got {data_axes!r}")
        object.__setattr__(self, "data_axes", data_axes)

    @property
    def n_devices(self) -> int:
        return math.prod(self.mesh_shape)

    @property
    def n_shards(self) -> int:
        """Product of mesh sizes over the data axes: the shard count the
        index layout (and the sharded snapshot) is cut into."""
        sizes = dict(zip(self.mesh_axes, self.mesh_shape))
        return math.prod(sizes[a] for a in self.data_axes)

    def to_dict(self) -> dict:
        return {"mesh_shape": list(self.mesh_shape),
                "mesh_axes": list(self.mesh_axes),
                "data_axes": list(self.data_axes)}

    @classmethod
    def from_dict(cls, d: dict) -> "PlacementSpec":
        unknown = set(d) - {"mesh_shape", "mesh_axes", "data_axes"}
        if unknown:
            raise ValueError(f"unknown PlacementSpec fields: "
                             f"{sorted(unknown)} (format drift?)")
        return cls(mesh_shape=tuple(d["mesh_shape"]),
                   mesh_axes=tuple(d["mesh_axes"]),
                   data_axes=tuple(d["data_axes"]) if d.get("data_axes")
                   else None)


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Everything needed to build (and rebuild) an index.

    Theory knobs (K/L/c/beta_override) feed ``derive_params`` (Lemma 3);
    layout knobs (Nr/leaf_size/breakpoint_method) shape the DE-Forest;
    ``engine``/``probe_depth`` set search-time defaults.
    ``build_impl='reference'`` selects the per-tree oracle builder; every
    other value runs the fused builder.  Its encode step follows
    ``build_impl`` (``encode_impl`` where ``build_impl`` is 'auto'), as the
    reference's does: 'auto'/'pallas' run the ``encode_pack`` kernel on a
    CUDA tensor (its plain version on a CPU one), 'xla'/'pallas_interpret'
    its plain version on either device.  ``project_impl='pallas'`` runs the
    build's projection through the ``lsh_project`` kernel, and the reference
    builder with ``encode_impl='pallas'`` encodes through ``encode_bins``
    (each on a CUDA tensor; the plain version on a CPU one, and on either
    device for 'pallas_interpret').  A ``placement`` builds the sharded
    ``core.distributed.PDETIndex`` over the placement's devices.
    ``block_*`` and ``build_chunk`` are the reference's TPU tiling choices,
    kept for the round trip and unused by the port's kernels, which tile
    themselves.
    """

    kind: str = "static"
    K: int = 16
    L: int = 4
    c: float = 1.5
    beta_override: Optional[float] = None
    Nr: int = 256
    leaf_size: int = 64
    breakpoint_method: str = "sample_sort"
    project_impl: str = "auto"
    encode_impl: str = "auto"
    engine: str = "auto"
    block_q: int = 8
    block_l: int = 8
    delta_capacity: int = 512
    max_segments: int = 4
    id_capacity: Optional[int] = None
    placement: Optional[PlacementSpec] = None
    build_impl: str = "auto"
    build_chunk: int = 512
    probe_depth: int = 0

    def __post_init__(self) -> None:
        _check_choice("kind", self.kind, KINDS)
        _check_positive("K", self.K)
        _check_positive("L", self.L)
        if not self.c > 1.0:
            raise ValueError(f"approximation ratio c must be > 1, got "
                             f"{self.c!r} (Lemma 3 needs c > 1)")
        if self.beta_override is not None and not 0.0 < self.beta_override:
            raise ValueError(f"beta_override must be positive, got "
                             f"{self.beta_override!r}")
        _check_positive("Nr", self.Nr, minimum=2)
        from repro_torch.core.detree import check_nr
        check_nr(self.Nr)            # codes are stored as uint8 symbols
        _check_positive("leaf_size", self.leaf_size)
        _check_choice("build_impl", self.build_impl, BUILD_IMPLS)
        _check_positive("build_chunk", self.build_chunk)
        _check_choice("breakpoint_method", self.breakpoint_method,
                      BREAKPOINT_METHODS)
        _check_choice("project_impl", self.project_impl, IMPLS)
        _check_choice("encode_impl", self.encode_impl, IMPLS)
        _check_positive("block_q", self.block_q)
        _check_positive("block_l", self.block_l)
        _check_positive("probe_depth", self.probe_depth, minimum=0)
        registry.validate_engine_name(self.engine)
        _check_positive("delta_capacity", self.delta_capacity)
        _check_positive("max_segments", self.max_segments)
        if self.id_capacity is not None:
            _check_positive("id_capacity", self.id_capacity)
        if self.placement is not None:
            if isinstance(self.placement, dict):
                object.__setattr__(self, "placement",
                                   PlacementSpec.from_dict(self.placement))
            elif not isinstance(self.placement, PlacementSpec):
                raise ValueError(
                    f"placement must be a PlacementSpec (or its dict form), "
                    f"got {type(self.placement).__name__}")
            if self.kind != "static":
                raise ValueError(
                    f"placement is only supported for kind='static' (the "
                    f"sharded PDET index); kind={self.kind!r} cannot be "
                    f"placed on a mesh yet")

    def derive_params(self) -> Any:
        """Solve the Lemma 3 system for this spec -> ``LSHParams``."""
        from repro_torch.core.theory import derive_params
        return derive_params(K=self.K, c=self.c, L=self.L,
                             beta_override=self.beta_override)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "IndexSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown IndexSpec fields in snapshot: "
                             f"{sorted(unknown)} (format drift?)")
        return cls(**d)
