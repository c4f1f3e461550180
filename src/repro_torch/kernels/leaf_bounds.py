"""Wrapper of the ``leaf_bounds`` CUDA kernel (``csrc/leaf_bounds.cu``).

The vmap engine's per-round pruning step: Fig. 5 lower and upper bounds
from every lane's projected query to every leaf box of every tree, in one
launch.  The plain version is :func:`repro_torch.kernels.ref.leaf_bounds`;
``kernels/ops.py`` picks between the two by device.  Both agree bit for
bit, since the top-M leaf cut that follows is decided by exact LB ties.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("leaf_bounds")
    fn = lib.leaf_bounds_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def leaf_bounds(q_proj: torch.Tensor, leaf_lo: torch.Tensor,
                leaf_hi: torch.Tensor, leaf_valid: torch.Tensor,
                breakpoints: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """q_proj (L, B, K) f32; leaf_lo/hi (L, nl, K) int16, as the forest
    stores them; leaf_valid (L, nl) bool; breakpoints (L, K, E) f32; all on
    one CUDA device -> (lb, ub), each (L, B, nl) f32, +inf on invalid
    leaves.  Launches the kernel once and counts it in
    ``leaf_bounds.launches``."""
    dev = q_proj.device
    tensors = (q_proj, leaf_lo, leaf_hi, leaf_valid, breakpoints)
    if not (q_proj.is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError("leaf_bounds kernel needs every input on one CUDA "
                         "device")
    if q_proj.dtype != torch.float32 or breakpoints.dtype != torch.float32:
        raise TypeError(f"leaf_bounds takes float32 queries and breakpoints, "
                        f"got {q_proj.dtype} and {breakpoints.dtype}")
    if leaf_lo.dtype != torch.int16 or leaf_hi.dtype != torch.int16:
        raise TypeError(f"leaf_bounds takes int16 leaf bounds (the storage "
                        f"dtype), got {leaf_lo.dtype} and {leaf_hi.dtype}")
    if leaf_valid.dtype != torch.bool:
        raise TypeError(f"leaf_valid must be bool, got {leaf_valid.dtype}")
    L, B, K = q_proj.shape
    nl = leaf_lo.shape[1]
    E = breakpoints.shape[2]
    want = {"leaf_lo": (L, nl, K), "leaf_hi": (L, nl, K),
            "leaf_valid": (L, nl), "breakpoints": (L, K, E)}
    for name, t in zip(want, tensors[1:]):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"leaf_bounds: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("leaf_bounds takes contiguous tensors")
    lb = torch.empty((L, B, nl), dtype=torch.float32, device=dev)
    ub = torch.empty((L, B, nl), dtype=torch.float32, device=dev)
    lib = _lib()
    with _build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.leaf_bounds_launch(
            *(t.data_ptr() for t in tensors), lb.data_ptr(), ub.data_ptr(),
            L, B, nl, K, E, stream)
    _build.check(lib, "leaf_bounds", code)
    leaf_bounds.launches += 1
    return lb, ub


leaf_bounds.launches = 0
