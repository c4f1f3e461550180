"""Wrapper of the ``range_rerank`` CUDA kernel (``csrc/range_rerank.cu``).

One radius round of the fused engine: leaf lower bounds, radius admission
and exact reranking of the admitted leaves' points, for every tree and
query at once.  The plain version is
:func:`repro_torch.kernels.ref.range_rerank`; ``kernels/ops.py`` picks
between the two by device and widens probe radii first.

The kernel masks the ragged edges itself, so no padding is needed: lanes
past B and leaves past nl do not exist for it, which is what the
reference's padded lanes (r_eff = -1) and padded leaves (invalid) amount to.
``range_rerank_heads`` runs the same kernel body over H forests at once (the
KV-decode retrieval: one forest per (batch, kv-head)).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("range_rerank")
    lib.range_rerank_launch.restype = ctypes.c_int
    lib.range_rerank_launch.argtypes = ([ctypes.c_void_p] * 12
                                        + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
    lib.range_rerank_heads_launch.restype = ctypes.c_int
    lib.range_rerank_heads_launch.argtypes = ([ctypes.c_void_p] * 12
                                              + [ctypes.c_int] * 8
                                              + [ctypes.c_void_p])
    return lib


def _as_bytes(mask: torch.Tensor) -> torch.Tensor:
    """A bool or uint8 0/1 mask as contiguous one-byte storage."""
    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0
    return mask.contiguous()


_NAMES = ("q", "q_proj", "r_eff", "leaf_lo", "leaf_hi", "leaf_valid",
          "breakpoints", "points", "point_valid", "live")


def _prepare(name: str, tensors: tuple, lead: tuple, leaf_size: int
             ) -> tuple[tuple, tuple[int, ...]]:
    """Check one launch's inputs (every array with the leading axes
    ``lead``: () for one forest, (H,) for H) and lay them out as the
    kernel reads them.  Returns (arguments, (L, B, d, nl, K, E))."""
    q, q_proj = tensors[0], tensors[1]
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError(f"{name} kernel needs every input on one CUDA "
                         f"device")
    for t in (q, q_proj, tensors[2], tensors[6], tensors[7]):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
    n = len(lead)
    L, B, K = q_proj.shape[n:]
    d = q.shape[-1]
    nl = tensors[3].shape[n + 1]
    E = tensors[6].shape[-1]
    npts = nl * leaf_size
    want = ((B, d), (L, B, K), (L, B), (L, nl, K), (L, nl, K), (L, nl),
            (L, K, E), (L, npts, d), (L, npts), (L, npts))
    for key, t, shape in zip(_NAMES, tensors, want):
        if tuple(t.shape) != lead + shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {lead + shape}")
    (q, q_proj, r_eff, leaf_lo, leaf_hi, leaf_valid, breakpoints, points,
     point_valid, live) = tensors
    args = (q.contiguous(), q_proj.contiguous(), r_eff.contiguous(),
            leaf_lo.to(torch.int32).contiguous(),
            leaf_hi.to(torch.int32).contiguous(), _as_bytes(leaf_valid),
            breakpoints.contiguous(), points.contiguous(),
            _as_bytes(point_valid), _as_bytes(live))
    return args, (L, B, d, nl, K, E)


def _launch(fn_name: str, args: tuple, out: torch.Tensor,
            sizes: tuple[int, ...]) -> None:
    """Run the two launches (admission, then rerank) on out's device, with
    the admission table, one byte a (head, tree, leaf, query), as
    scratch."""
    lib = _lib()
    dev = out.device
    n_admit = math.prod(out.shape[:-1]) * args[3].shape[-2]   # (.., nl, B)
    admit = torch.empty((n_admit,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, fn_name)(*(a.data_ptr() for a in args),
                                     out.data_ptr(), admit.data_ptr(),
                                     *sizes, stream)
    _build.check(lib, "range_rerank", code)


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
    args, (L, B, d, nl, K, E) = _prepare(
        "range_rerank", (q, q_proj, r_eff, leaf_lo, leaf_hi, leaf_valid,
                         breakpoints, points, point_valid, live), (),
        leaf_size)
    out = torch.empty((L, B, nl * leaf_size), dtype=torch.float32,
                      device=q.device)
    _launch("range_rerank_launch", args, out,
            (L, B, d, nl, K, E, leaf_size))
    range_rerank.launches += 1
    return out


range_rerank.launches = 0


def range_rerank_heads(q: torch.Tensor, q_proj: torch.Tensor,
                       r_eff: torch.Tensor, leaf_lo: torch.Tensor,
                       leaf_hi: torch.Tensor, leaf_valid: torch.Tensor,
                       breakpoints: torch.Tensor, points: torch.Tensor,
                       point_valid: torch.Tensor, live: torch.Tensor, *,
                       leaf_size: int) -> torch.Tensor:
    """H independent forests in one launch: every argument of
    :func:`range_rerank` with a leading head axis H (q (H, B, d), r_eff
    (H, L, B), ...).  Returns (H, L, B, nl*leaf_size) f32; head h equals
    :func:`range_rerank` on head h's arrays bit for bit.  Counts the launch
    in ``range_rerank_heads.launches``."""
    H = q.shape[0]
    args, (L, B, d, nl, K, E) = _prepare(
        "range_rerank_heads", (q, q_proj, r_eff, leaf_lo, leaf_hi,
                               leaf_valid, breakpoints, points, point_valid,
                               live), (H,), leaf_size)
    out = torch.empty((H, L, B, nl * leaf_size), dtype=torch.float32,
                      device=q.device)
    _launch("range_rerank_heads_launch", args, out,
            (H, L, B, d, nl, K, E, leaf_size))
    range_rerank_heads.launches += 1
    return out


range_rerank_heads.launches = 0
