"""Wrapper of the ``encode_bins`` CUDA kernel (``csrc/encode_bins.cu``).

iSAX encoding (Alg. 1 lines 5-8): each projected coordinate's region id,
#(inner breakpoints <= x) clipped to [0, Nr-1] (0 for a NaN), as a
row-major (n, D) int32 table.  The reference builder
(``build_impl='reference'``) encodes all L*K columns through it when its
``encode_impl`` is 'pallas'.  The plain version is
:func:`repro_torch.kernels.ref.encode_bins`; the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_NR = 8192          # four columns' edge tables (P >= Nr floats each)
                       # beside the warps' buffers in 227 KB


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("encode_bins")
    fn = lib.encode_bins_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return lib


def encode_bins(coords: torch.Tensor, breakpoints: torch.Tensor
                ) -> torch.Tensor:
    """coords (n, D) float32, breakpoints (D, Nr+1) float32 with
    non-decreasing rows, 2 <= Nr <= 8,192 (the edge tables of four columns
    fit a block's shared memory), both on one CUDA device -> codes (n, D)
    int32.  Launches the kernel once and counts it in
    ``encode_bins.launches``."""
    dev = coords.device
    if not (coords.is_cuda and breakpoints.device == dev):
        raise ValueError("encode_bins kernel needs coords and breakpoints on "
                         "one CUDA device")
    for name, t in (("coords", coords), ("breakpoints", breakpoints)):
        if t.dtype != torch.float32:
            raise TypeError(f"encode_bins takes float32, got {name} "
                            f"{t.dtype}")
    if coords.ndim != 2 or breakpoints.ndim != 2 \
            or breakpoints.shape[0] != coords.shape[1] \
            or not 3 <= breakpoints.shape[1] <= MAX_NR + 1:
        raise ValueError(f"encode_bins: coords {tuple(coords.shape)} and "
                         f"breakpoints {tuple(breakpoints.shape)} are not "
                         f"(n, D) and (D, Nr+1) with 2 <= Nr <= {MAX_NR}")
    coords, breakpoints = coords.contiguous(), breakpoints.contiguous()
    n, D = coords.shape
    Nr = breakpoints.shape[1] - 1
    codes = torch.empty((n, D), dtype=torch.int32, device=dev)
    lib = _lib()
    with _build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.encode_bins_launch(
            coords.data_ptr(), breakpoints.data_ptr(), codes.data_ptr(), n,
            D, Nr, stream)
    _build.check(lib, "encode_bins", code)
    encode_bins.launches += 1
    return codes


encode_bins.launches = 0
