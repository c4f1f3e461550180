"""Wrapper of the ``encode_pack`` CUDA kernel (``csrc/encode_pack.cu``).

The static build's fused step: encode every projected coordinate into its
region id and pack each tree's K ids into the interleaved 64-bit sort key,
writing the per-tree (L, n, K) layouts directly.  The plain version is
:func:`repro_torch.kernels.ref.encode_pack`; ``kernels/ops.py`` picks
between the two by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# The kernel keeps a (32, L*K + 1) tile of proj (f32) and of codes (u8) in
# shared memory, which holds at most 227 KB per block on an H100.
_MAX_DIMS = 232448 // (32 * 5) - 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("encode_pack")
    fn = lib.encode_pack_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6
                   + [ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return lib


def encode_pack(proj: torch.Tensor, breakpoints: torch.Tensor, *, K: int,
                L: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """proj (n, L*K) f32, breakpoints (L*K, Nr+1) f32, both contiguous on
    one CUDA device -> (proj_t (L, n, K) f32, codes_t (L, n, K) int32,
    key_hi (L, n) int64, key_lo (L, n) int64), key words holding uint32
    values.  Launches the kernel once and counts it in
    ``encode_pack.launches``."""
    from repro_torch.core.detree import check_nr, key_bit_budget
    if not (proj.is_cuda and breakpoints.device == proj.device):
        raise ValueError("encode_pack kernel needs proj and breakpoints on "
                         "one CUDA device")
    if proj.dtype != torch.float32 or breakpoints.dtype != torch.float32:
        raise TypeError(f"encode_pack takes float32, got {proj.dtype} and "
                        f"{breakpoints.dtype}")
    n, D = proj.shape
    E = breakpoints.shape[1]
    if D != L * K or tuple(breakpoints.shape) != (D, E) or E < 3:
        raise ValueError(f"shapes proj {tuple(proj.shape)}, breakpoints "
                         f"{tuple(breakpoints.shape)} do not fit L={L}, K={K}")
    check_nr(E - 1)
    if D > _MAX_DIMS:
        raise ValueError(f"L*K = {D} exceeds the kernel's shared-memory "
                         f"tile ({_MAX_DIMS} dims)")
    if not (proj.is_contiguous() and breakpoints.is_contiguous()):
        raise ValueError("encode_pack takes contiguous tensors")
    _, hi_bits, lo_bits = key_bit_budget(K)
    dev = proj.device
    proj_t = torch.empty((L, n, K), dtype=torch.float32, device=dev)
    codes_t = torch.empty((L, n, K), dtype=torch.int32, device=dev)
    key_hi = torch.empty((L, n), dtype=torch.int64, device=dev)
    key_lo = torch.empty((L, n), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.encode_pack_launch(
            proj.data_ptr(), breakpoints.data_ptr(), proj_t.data_ptr(),
            codes_t.data_ptr(), key_hi.data_ptr(), key_lo.data_ptr(), n, K, L,
            E - 1, hi_bits, lo_bits, stream)
    _build.check(lib, "encode_pack", code)
    encode_pack.launches += 1
    return proj_t, codes_t, key_hi, key_lo


encode_pack.launches = 0
