"""Wrapper of the ``range_rerank`` CUDA kernel (``csrc/range_rerank.cu``).

One radius round of the fused engine: leaf lower bounds, radius admission
and exact reranking of the admitted leaves' points, for every tree and
query at once.  The plain version is
:func:`repro_torch.kernels.ref.range_rerank`; ``kernels/ops.py`` picks
between the two by device and widens probe radii first.

The kernel masks the ragged edges itself, so no padding is needed: lanes
past B and leaves past nl do not exist for it, which is what the
reference's padded lanes (r_eff = -1) and padded leaves (invalid) amount to.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load("range_rerank")
    fn = lib.range_rerank_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib


def _as_bytes(mask: torch.Tensor) -> torch.Tensor:
    """A bool or uint8 0/1 mask as contiguous one-byte storage."""
    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0
    return mask.contiguous()


def range_rerank(q: torch.Tensor, q_proj: torch.Tensor, r_eff: torch.Tensor,
                 leaf_lo: torch.Tensor, leaf_hi: torch.Tensor,
                 leaf_valid: torch.Tensor, breakpoints: torch.Tensor,
                 points: torch.Tensor, point_valid: torch.Tensor,
                 live: torch.Tensor, *, leaf_size: int) -> torch.Tensor:
    """q (B, d); q_proj (L, B, K); r_eff (L, B) (-1 = done lane);
    leaf_lo/hi (L, nl, K) integer (widened to int32 here); leaf_valid
    (L, nl); breakpoints (L, K, E); points (L, nl*leaf_size, d);
    point_valid, live (L, nl*leaf_size).  All on one CUDA device; float
    inputs float32.  Returns (L, B, nl*leaf_size) f32.  Launches the kernel
    once and counts it in ``range_rerank.launches``."""
    dev = q.device
    tensors = (q, q_proj, r_eff, leaf_lo, leaf_hi, leaf_valid, breakpoints,
               points, point_valid, live)
    if not (q.is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError("range_rerank kernel needs every input on one CUDA "
                         "device")
    for t in (q, q_proj, r_eff, breakpoints, points):
        if t.dtype != torch.float32:
            raise TypeError(f"range_rerank takes float32, got {t.dtype}")
    L, B, K = q_proj.shape
    d = q.shape[1]
    nl = leaf_lo.shape[1]
    E = breakpoints.shape[2]
    npts = nl * leaf_size
    want = {"q": (B, d), "r_eff": (L, B), "leaf_lo": (L, nl, K),
            "leaf_hi": (L, nl, K), "leaf_valid": (L, nl),
            "breakpoints": (L, K, E), "points": (L, npts, d),
            "point_valid": (L, npts), "live": (L, npts)}
    got = dict(zip(("q", "r_eff", "leaf_lo", "leaf_hi", "leaf_valid",
                    "breakpoints", "points", "point_valid", "live"),
                   (q, r_eff, leaf_lo, leaf_hi, leaf_valid, breakpoints,
                    points, point_valid, live)))
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"range_rerank: {name} has shape "
                             f"{tuple(got[name].shape)}, expected {shape}")
    args = (q.contiguous(), q_proj.contiguous(), r_eff.contiguous(),
            leaf_lo.to(torch.int32).contiguous(),
            leaf_hi.to(torch.int32).contiguous(), _as_bytes(leaf_valid),
            breakpoints.contiguous(), points.contiguous(),
            _as_bytes(point_valid), _as_bytes(live))
    out = torch.empty((L, B, npts), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.range_rerank_launch(
            *(a.data_ptr() for a in args), out.data_ptr(), L, B, d, nl, K, E,
            leaf_size, stream)
    _build.check(lib, "range_rerank", code)
    range_rerank.launches += 1
    return out


range_rerank.launches = 0
