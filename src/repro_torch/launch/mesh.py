"""Device meshes for the sharded PDET index.

The counterpart of the reference's ``repro.launch.mesh.mesh_from_placement``:
a ``PlacementSpec`` names a grid of devices (shape and axis names), and
this module picks the devices.  The port runs one controller process over
them, so a mesh is a grid of ``torch.device``s, not a communicator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``'s shape).

    ``devices`` is an object array of ``torch.device`` of shape
    ``tuple(shape.values())``; a device may appear more than once (several
    shards on one card)."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def shard_devices(self, data_axes: Sequence[str]) -> list:
        """The device of each layout shard, shard order row-major over
        ``data_axes`` (the reference's ``axis_index`` order); along the
        other axes a shard is replicated, and its first replica serves."""
        sizes = [self.shape[a] for a in data_axes]
        out = []
        for s in range(math.prod(sizes)):
            coords = dict(zip(data_axes, np.unravel_index(s, sizes)))
            out.append(self.devices[tuple(int(coords.get(a, 0))
                                          for a in self.axis_names)])
        return out


def _device(d: Any) -> torch.device:
    """``d`` as a ``torch.device`` with its card index filled in, so that
    'cuda' and 'cuda:0' name one device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def mesh_from_placement(placement: Any, *,
                        devices: Optional[Sequence[Any]] = None,
                        device: Optional[Any] = None) -> DeviceMesh:
    """The device mesh a ``repro_torch.api.PlacementSpec`` names.

    ``devices`` (the reference's ``mesh=`` counterpart): an explicit list,
    of which the first ``placement.n_devices`` are used, in order; a device
    may repeat, which puts several shards on one card.  Without it,
    ``device='cpu'`` places every shard on the CPU (any shard count), and
    otherwise (None or 'cuda') the first ``n_devices`` CUDA cards are used,
    raising when the machine has fewer.
    """
    need = placement.n_devices
    if devices is None:
        if device is not None and torch.device(device).type == "cpu":
            devices = [torch.device("cpu")] * need
        else:
            have = torch.cuda.device_count()
            if have < need:
                raise ValueError(
                    f"placement {placement.mesh_shape} over "
                    f"{placement.mesh_axes} needs {need} CUDA devices but "
                    f"{have} are visible; shrink the placement, pass "
                    f"devices=[...] (a card may repeat: several shards on "
                    f"one card) or device='cpu'")
            devices = [torch.device("cuda", i) for i in range(need)]
    devices = [_device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"placement {placement.mesh_shape} needs {need} "
                         f"devices, got {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return DeviceMesh(grid.reshape(placement.mesh_shape),
                      tuple(placement.mesh_axes))
