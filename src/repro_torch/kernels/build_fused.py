"""Wrappers of the build's CUDA kernels: ``encode_pack``
(``csrc/encode_pack.cu``) and ``project_encode_pack``
(``csrc/project_encode_pack.cu``).

``encode_pack`` is the static build's fused step: encode every projected
coordinate into its region id and pack each tree's K ids into the
interleaved 64-bit sort key, writing the per-tree (L, n, K) layouts
directly.  ``project_encode_pack`` is the streaming seal's: the same with
the projection x @ A computed in the kernel first.  The plain versions are
:func:`repro_torch.kernels.ref.encode_pack` and
:func:`repro_torch.kernels.ref.project_encode_pack`; ``kernels/ops.py``
picks between kernel and plain version by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# A block keeps a (32, L_g*K + 1) tile of projections (f32) and of codes
# (u8) in shared memory, which holds at most 227 KB on an H100; past that a
# call launches once per group of L_g trees (``_tree_groups``).
_MAX_SMEM = 232448
_ROWS = 32
_CHUNK = 256           # x columns project_encode_pack stages at once


def _tree_groups(K: int, L: int, spare: int) -> list[tuple[int, int]]:
    """Split trees 0..L-1 into runs [l0, l1) whose (l1 - l0)*K projected
    dims fit a block's shared memory beside ``spare`` bytes: the
    (32, L_g*K + 1) f32 and u8 tiles of encode_pack_tile.cuh take
    32 * (L_g*K + 1) * 5 bytes.  One run (one launch) up to L*K = 1,451."""
    per = (_MAX_SMEM - spare - _ROWS * 5) // (_ROWS * 5 * K)
    if per < 1:
        raise ValueError(f"K = {K} projected dims of one tree do not fit "
                         f"a block's shared memory")
    return [(l0, min(L, l0 + per)) for l0 in range(0, L, per)]


def _load(name: str, n_ptrs: int, n_ints: int) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with its launch function typed:
    ``n_ptrs`` pointers, the row count (int64), ``n_ints`` ints, the stream."""
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int64]
                   + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
    return lib


def _checked_dims(breakpoints: torch.Tensor, D: int, K: int,
                  L: int) -> tuple[int, int, int]:
    """(Nr, hi_bits, lo_bits) for the launch, after the shape checks both
    kernels share."""
    from repro_torch.core.detree import check_nr, key_bit_budget
    E = breakpoints.shape[1]
    if D != L * K or tuple(breakpoints.shape) != (D, E) or E < 3:
        raise ValueError(f"{D} projected dims and breakpoints "
                         f"{tuple(breakpoints.shape)} do not fit L={L}, "
                         f"K={K}")
    check_nr(E - 1)
    _, hi_bits, lo_bits = key_bit_budget(K)
    return E - 1, hi_bits, lo_bits


def _check_inputs(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if not (tensors[0].is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError(f"{name} kernel needs its inputs on one CUDA device")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def _outputs(n: int, K: int, L: int, dev: torch.device) -> tuple:
    """Empty (proj_t, codes_t, key_hi, key_lo) in the per-tree layouts."""
    return (torch.empty((L, n, K), dtype=torch.float32, device=dev),
            torch.empty((L, n, K), dtype=torch.int32, device=dev),
            torch.empty((L, n), dtype=torch.int64, device=dev),
            torch.empty((L, n), dtype=torch.int64, device=dev))


def encode_pack(proj: torch.Tensor, breakpoints: torch.Tensor, *, K: int,
                L: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """proj (n, L*K) f32, breakpoints (L*K, Nr+1) f32, both contiguous on
    one CUDA device -> (proj_t (L, n, K) f32, codes_t (L, n, K) int32,
    key_hi (L, n) int64, key_lo (L, n) int64), key words holding uint32
    values.  One kernel launch per group of trees whose tile fits a
    block (one group up to L*K = 1,451), counted once in
    ``encode_pack.launches``."""
    _check_inputs("encode_pack", proj, breakpoints)
    n, D = proj.shape
    Nr, hi_bits, lo_bits = _checked_dims(breakpoints, D, K, L)
    out = _outputs(n, K, L, proj.device)
    lib = _load("encode_pack", 6, 6)
    with torch.cuda.device(proj.device):
        stream = torch.cuda.current_stream(proj.device).cuda_stream
        for l0, l1 in _tree_groups(K, L, 0):
            code = lib.encode_pack_launch(
                proj[:, l0 * K:].data_ptr(), breakpoints[l0 * K].data_ptr(),
                *(o[l0].data_ptr() for o in out), n, D, K, l1 - l0, Nr,
                hi_bits, lo_bits, stream)
            _build.check(lib, "encode_pack", code)
    encode_pack.launches += 1
    return out


encode_pack.launches = 0


def project_encode_pack(x: torch.Tensor, a: torch.Tensor,
                        breakpoints: torch.Tensor, *, K: int, L: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """x (n, d) f32, a (d, L*K) f32, breakpoints (L*K, Nr+1) f32, all
    contiguous on one CUDA device -> encode_pack's outputs for x @ a, the
    projection summed in d order inside the kernel (bit-identical to
    :func:`repro_torch.kernels.ref.project_encode_pack`) for any d.  One
    kernel launch per group of trees whose tile fits a block, counted once
    in ``project_encode_pack.launches``."""
    _check_inputs("project_encode_pack", x, a, breakpoints)
    n, d = x.shape
    D = breakpoints.shape[0]
    if tuple(a.shape) != (d, D):
        raise ValueError(f"a {tuple(a.shape)} is not (d, L*K) = ({d}, {D})")
    Nr, hi_bits, lo_bits = _checked_dims(breakpoints, D, K, L)
    out = _outputs(n, K, L, x.device)
    lib = _load("project_encode_pack", 7, 7)
    x_tile = 4 * _ROWS * ((min(d, _CHUNK) + 3) // 4 * 4)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for l0, l1 in _tree_groups(K, L, x_tile):
            code = lib.project_encode_pack_launch(
                x.data_ptr(), a[:, l0 * K:].data_ptr(),
                breakpoints[l0 * K].data_ptr(),
                *(o[l0].data_ptr() for o in out), n, d, D, K, l1 - l0, Nr,
                hi_bits, lo_bits, stream)
            _build.check(lib, "project_encode_pack", code)
    project_encode_pack.launches += 1
    return out


project_encode_pack.launches = 0
