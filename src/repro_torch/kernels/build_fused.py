"""Wrappers of the build's CUDA kernels: ``encode_pack``
(``csrc/encode_pack.cu``) and ``project_encode_pack``
(``csrc/project_encode_pack.cu``).

``encode_pack`` is the static build's fused step: encode every projected
coordinate into its region id and pack each tree's K ids into the
interleaved 64-bit sort key, writing the per-tree (L, n, K) layouts
directly.  ``project_encode_pack`` is the streaming seal's: the same with
the projection x @ A computed in the kernel first, one fused multiply-add
a feature as ``lsh_project`` sums.  The plain versions are
:func:`repro_torch.kernels.ref.encode_pack` and
:func:`repro_torch.kernels.ref.project_encode_pack`; ``kernels/ops.py``
picks between kernel and plain version by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# encode_pack: a block keeps one tree's K edge tables of P floats (P the
# power of two >= Nr) in shared memory, which holds at most 227 KB on an
# H100.  (project_encode_pack groups trees on its grid.y in the launcher,
# ``csrc/project_encode_pack.cu``, which refuses a tile past that size.)
_MAX_SMEM = 232448


def _table_width(breakpoints: torch.Tensor) -> int:
    """P, the power of two >= Nr: the width of a dim's edge table."""
    return 1 << max(0, (breakpoints.shape[1] - 2).bit_length())


@functools.lru_cache(maxsize=None)
def _launcher(name: str, n_ptrs: int, n_ints: int):
    """The typed launch function of ``csrc/<name>.cu``: ``n_ptrs``
    pointers, the row count (int64), ``n_ints`` ints, the stream."""
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int64]
                   + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
    return fn


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
    values.  One kernel launch, counted in ``encode_pack.launches``."""
    _check_inputs("encode_pack", proj, breakpoints)
    n, D = proj.shape
    Nr, hi_bits, lo_bits = _checked_dims(breakpoints, D, K, L)
    if 4 * K * _table_width(breakpoints) > _MAX_SMEM:
        raise ValueError(f"K = {K} edge tables of {Nr} regions do not fit "
                         f"a block's shared memory")
    out = _outputs(n, K, L, proj.device)
    fn = _launcher("encode_pack", 6, 6)
    with _build.on_device(proj.device):
        stream = torch.cuda.current_stream(proj.device).cuda_stream
        code = fn(proj.data_ptr(), breakpoints.data_ptr(),
                  *(o.data_ptr() for o in out), n, D, K, L, Nr, hi_bits,
                  lo_bits, stream)
    _build.check(_build.load("encode_pack"), "encode_pack", code)
    encode_pack.launches += 1
    return out


encode_pack.launches = 0


def project_encode_pack(x: torch.Tensor, a: torch.Tensor,
                        breakpoints: torch.Tensor, *, K: int, L: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """x (n, d) f32, a (d, L*K) f32, breakpoints (L*K, Nr+1) f32, all
    contiguous on one CUDA device -> encode_pack's outputs for x @ a, the
    projection one fused multiply-add a feature in d order inside the
    kernel (bit-identical to
    :func:`repro_torch.kernels.ref.project_encode_pack`) for any d.  One
    call launches the edge-table build and the kernel (its grid.y over
    groups of trees), counted once in ``project_encode_pack.launches``."""
    _check_inputs("project_encode_pack", x, a, breakpoints)
    n, d = x.shape
    D = breakpoints.shape[0]
    if tuple(a.shape) != (d, D):
        raise ValueError(f"a {tuple(a.shape)} is not (d, L*K) = ({d}, {D})")
    Nr, hi_bits, lo_bits = _checked_dims(breakpoints, D, K, L)
    out = _outputs(n, K, L, x.device)
    eyt = torch.empty((D, _table_width(breakpoints)), dtype=torch.float32,
                      device=x.device)
    fn = _launcher("project_encode_pack", 8, 7)
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), a.data_ptr(), breakpoints.data_ptr(),
                  eyt.data_ptr(), *(o.data_ptr() for o in out), n, d, D, K,
                  L, Nr, hi_bits, lo_bits, stream)
    _build.check(_build.load("project_encode_pack"), "project_encode_pack",
                 code)
    project_encode_pack.launches += 1
    return out


project_encode_pack.launches = 0
