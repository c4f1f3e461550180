"""Wrapper of the ``l2_rerank`` CUDA kernel (``csrc/l2_rerank.cu``).

The vmap engine's exact rerank: Euclidean distances between each lane's
query and the candidate rows gathered for it, all lanes in one launch (the
group axis).  The plain version is :func:`repro_torch.kernels.ref.l2_rerank`;
``kernels/ops.py`` picks between the two by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = _build.load("l2_rerank")
    fn = lib.l2_rerank_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


def l2_rerank(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """q (G, b, d), c (G, m, d), both float32 or both bfloat16, contiguous
    on one CUDA device -> (G, b, m) f32 distances.  Launches the kernel
    once and counts it in ``l2_rerank.launches``."""
    if not (q.is_cuda and c.device == q.device):
        raise ValueError("l2_rerank kernel needs q and c on one CUDA device")
    if q.dtype not in _DTYPES or c.dtype != q.dtype:
        raise TypeError(f"l2_rerank takes float32 or bfloat16 inputs of one "
                        f"dtype, got {q.dtype} and {c.dtype}")
    if q.ndim != 3 or c.ndim != 3 or c.shape[0] != q.shape[0] \
            or c.shape[2] != q.shape[2]:
        raise ValueError(f"l2_rerank: q {tuple(q.shape)} and c "
                         f"{tuple(c.shape)} are not (G, b, d) and (G, m, d)")
    if not (q.is_contiguous() and c.is_contiguous()):
        raise ValueError("l2_rerank takes contiguous tensors")
    G, b, d = q.shape
    m = c.shape[1]
    bf16 = q.dtype == torch.bfloat16
    per_load = 8 if bf16 else 4                # elements in 16 bytes
    vec = (d % per_load == 0 and q.data_ptr() % 16 == 0
           and c.data_ptr() % 16 == 0)
    out = torch.empty((G, b, m), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.l2_rerank_launch(q.data_ptr(), c.data_ptr(),
                                    out.data_ptr(), G, b, m, d, int(bf16),
                                    int(vec), stream)
    _build.check(lib, "l2_rerank", code)
    l2_rerank.launches += 1
    return out


l2_rerank.launches = 0
