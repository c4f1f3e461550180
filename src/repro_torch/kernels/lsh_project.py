"""Wrapper of the ``lsh_project`` CUDA kernel (``csrc/lsh_project.cu``).

The hashing phase of the build: the p-stable projection x (n, d) @ A
(d, L*K) in f32, one fused multiply-add a feature in index order, so it
equals its plain version (:func:`repro_torch.kernels.ref.lsh_project`,
which emulates the f32 FMA exactly) bit for bit.  It runs where a
build asks for it (``IndexSpec(project_impl='pallas')``, or
``core.hashing.project(impl='pallas')``); ``kernels/ops.py`` picks between
kernel and plain version by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("lsh_project")
    fn = lib.lsh_project_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def lsh_project(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x (n, d), a (d, m), each float32 or bfloat16, on one CUDA device ->
    (n, m) float32.  Where the two dtypes differ, the bfloat16 one widens to
    float32 first (exactly).  Launches the kernel once and counts it in
    ``lsh_project.launches``."""
    dev = x.device
    if not (x.is_cuda and a.device == dev):
        raise ValueError("lsh_project kernel needs x and a on one CUDA "
                         "device")
    for name, t in (("x", x), ("a", a)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"lsh_project takes float32 or bfloat16, got "
                            f"{name} {t.dtype}")
    if x.ndim != 2 or a.ndim != 2 or x.shape[1] != a.shape[0]:
        raise ValueError(f"lsh_project: x {tuple(x.shape)} and a "
                         f"{tuple(a.shape)} are not (n, d) and (d, m)")
    if x.dtype != a.dtype:
        x, a = x.to(torch.float32), a.to(torch.float32)
    x, a = x.contiguous(), a.contiguous()
    n, d = x.shape
    m = a.shape[1]
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lsh_project_launch(
            x.data_ptr(), a.data_ptr(), out.data_ptr(), n, d, m,
            int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, "lsh_project", code)
    lsh_project.launches += 1
    return out


lsh_project.launches = 0
