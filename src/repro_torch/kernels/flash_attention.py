"""Wrapper of the ``flash_attention`` CUDA kernels
(``csrc/flash_attention.cu``).

Exact softmax attention by online softmax over key tiles, f32 accumulation,
for f32 or bf16 inputs and any head width.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention`; ``kernels/ops.py`` picks
between the two by device and folds (b, h) into one axis.  The kernels
mask the ragged edges themselves (sq, sk and dh need no padding).

One wrapper, three launch paths, chosen from the shape by :func:`path`:

- ``"split"``: sq <= 8 (decode), dh <= 4,096.  Memory-bound: keys are
  split over ~1,024 blocks, each block writes a partial (m, l, acc) to f32
  scratch, and a second launch merges the partials in split order.
- ``"mma"``: bf16 with dh <= 256.  The tensor cores through
  ``mma.sync.m16n8k16`` (FlashAttention-2's design), P as two bf16 terms.
- ``"simt"``: everything else (f32 prefill, bf16 at dh > 256, decode at
  dh > 4,096): fp32 FMAs on the CUDA cores, any dh (a grid axis over
  128-feature output chunks).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
DECODE_MAX_SQ = 8          # the split path's register tile holds 8 rows
SPLIT_MAX_DH = 4096        # its q rows and warp partials fit shared memory
MMA_MAX_DH = 256           # the widest tensor-core instance
SPLIT_BLOCKS = 1024        # blocks the split path aims for: ~8 an SM
SPLIT_MIN_KEYS = 512       # keys a split at least: 64 a warp


def path(sq: int, dh: int, dtype: torch.dtype) -> str:
    """The launch path of a call: ``"split"`` for sq <= 8 and dh <= 4,096
    (any dtype), ``"mma"`` for bf16 with dh <= 256, else ``"simt"``
    (which takes any dh)."""
    if sq <= DECODE_MAX_SQ and dh <= SPLIT_MAX_DH:
        return "split"
    if dtype == torch.bfloat16 and dh <= MMA_MAX_DH:
        return "mma"
    return "simt"


def splits(bh: int, sq: int, sk: int, causal: bool) -> tuple[int, int]:
    """(n_splits, keys_per_split) of the split path: enough splits for
    about ``SPLIT_BLOCKS`` blocks over bh heads, none shorter than
    ``SPLIT_MIN_KEYS`` keys.  Causal rows see keys < sq only (top-left
    alignment), so only those are split."""
    k_end = min(sk, sq) if causal else sk
    if k_end == 0:
        return 1, 1
    want = -(-SPLIT_BLOCKS // max(bh, 1))
    n = max(1, min(want, -(-k_end // SPLIT_MIN_KEYS), 65535))
    per = -(-k_end // n)
    return -(-k_end // per), per


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    dec = lib.flash_attention_decode_launch
    dec.restype = ctypes.c_int
    dec.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                    + [ctypes.c_float] + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
    pre = lib.flash_attention_prefill_launch
    pre.restype = ctypes.c_int
    pre.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                    + [ctypes.c_float] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    return lib


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: float) -> torch.Tensor:
    """q (bh, sq, dh), k/v (bh, sk, dh), all float32 or all bfloat16,
    contiguous on one CUDA device, any dh >= 1 -> (bh, sq, dh) in q's
    dtype.  Causal masking is top-left aligned.  Runs the path
    :func:`path` names (one or two CUDA launches), counts the call once in
    ``flash_attention.launches`` and by path in ``flash_attention.paths``."""
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
    sk = k.shape[1]
    if dh < 1:
        raise ValueError(f"flash_attention: dh={dh} must be >= 1")
    bf16 = int(q.dtype == torch.bfloat16)
    out = torch.empty_like(q)
    which = path(sq, dh, q.dtype)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "split" and bh and sq:
            n_splits, per = splits(bh, sq, sk, causal)
            scratch = torch.empty(bh * n_splits * sq * (dh + 2),
                                  dtype=torch.float32, device=q.device)
            vec = dh % (8 if bf16 else 4) == 0 and _aligned(q, k, v)
            code = lib.flash_attention_decode_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), bh, sq, sk, dh, int(causal),
                float(scale), bf16, n_splits, per, int(vec), stream)
        else:
            aligned = dh % 8 == 0 and _aligned(q, k, v)
            code = lib.flash_attention_prefill_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
                sq, sk, dh, int(causal), float(scale), bf16,
                int(which == "mma"), int(aligned), stream)
    _build.check(lib, "flash_attention", code)
    flash_attention.launches += 1
    flash_attention.paths[which] += 1
    return out


flash_attention.launches = 0
flash_attention.paths = {"split": 0, "mma": 0, "simt": 0}
