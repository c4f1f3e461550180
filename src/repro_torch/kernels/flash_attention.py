"""Wrapper of the ``flash_attention`` CUDA kernel (``csrc/flash_attention.cu``).

Exact softmax attention by online softmax over key tiles, f32 accumulation,
for f32 or bf16 inputs.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention`; ``kernels/ops.py`` picks
between the two by device and folds (b, h) into one axis.  The kernel
masks the ragged edges itself (sq, sk and dh need no padding).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_DH = 128


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: float) -> torch.Tensor:
    """q (bh, sq, dh), k/v (bh, sk, dh), all float32 or all bfloat16,
    contiguous on one CUDA device, dh <= 128 -> (bh, sq, dh) in q's dtype.
    Causal masking is top-left aligned.  Launches the kernel once and
    counts it in ``flash_attention.launches``."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel needs q, k and v on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 inputs "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(bh, sq, dh), (bh, sk, dh), (bh, sk, dh)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    bh, sq, dh = q.shape
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"flash_attention: dh={dh} outside [1, {MAX_DH}]")
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            k.shape[1], dh, int(causal), float(scale),
            int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, "flash_attention", code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
