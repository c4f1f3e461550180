"""DE-Tree / DE-Forest (paper §III-B, Alg. 2) in array form.

Each tree is stored as a *code-sorted array*: points sorted by their
bit-interleaved (MSB-first, round-robin) iSAX code, which is the order the
DE-Tree's recursive binary splits induce; leaves are fixed-size blocks of
``leaf_size`` consecutive sorted points, and each leaf keeps its
per-dimension occupied region interval [lo, hi].  LB/UB distances from a
leaf's intervals and the breakpoints are the paper's Fig. 5 bounds.

Build pipeline: the ``encode_pack`` kernel turns the (n, L*K) projections
into per-tree layouts plus two 32-bit interleaved key words; ONE stable
sort of a 64-bit key orders all L trees at once; a vectorized gather
assembles the sorted forest and its leaf summaries.  ``build_impl=
'reference'`` keeps the paper's per-tree path (encode every column, then a
double argsort per tree) as the in-port oracle; both give bit-identical
forests.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import encoding as enc

# Storage dtypes of the code-side index arrays: region ids are 8-bit
# symbols (Nr <= 256) and leaf bounds are small region indices, so the
# resident index keeps them narrow and every consumer widens at use.
CODE_DTYPE = torch.uint8
LEAF_DTYPE = torch.int16
MAX_NR = 256          # uint8 code storage: region ids must fit [0, 255]
_INF = float("inf")


@dataclasses.dataclass
class DEForest:
    """L DE-Trees over one dataset, in array form."""

    point_ids: torch.Tensor     # (L, n_pad) int32 — original index; n = padding
    proj_sorted: torch.Tensor   # (L, n_pad, K) f32 — projected coords, sorted
    codes_sorted: torch.Tensor  # (L, n_pad, K) uint8 — region ids, sorted
    valid: torch.Tensor         # (L, n_pad) bool
    leaf_lo: torch.Tensor       # (L, n_leaves, K) int16 — occupied interval
    leaf_hi: torch.Tensor       # (L, n_leaves, K) int16
    leaf_valid: torch.Tensor    # (L, n_leaves) bool
    breakpoints: torch.Tensor   # (L, K, Nr+1) f32
    n: int
    leaf_size: int

    @property
    def L(self) -> int:
        return self.point_ids.shape[0]

    @property
    def K(self) -> int:
        return self.breakpoints.shape[1]

    @property
    def n_leaves(self) -> int:
        return self.leaf_lo.shape[1]

    @property
    def Nr(self) -> int:
        return self.breakpoints.shape[2] - 1

    def size_bytes(self) -> int:
        """Resident code-side footprint (codes 1B, ids 4B, bounds 2B,
        breakpoints 4B; proj_sorted excluded, as in the paper's index-size
        accounting)."""
        return int(sum(a.numel() * a.element_size()
                       for a in (self.codes_sorted, self.point_ids,
                                 self.leaf_lo, self.leaf_hi,
                                 self.breakpoints)))


# ---------------------------------------------------------------------------
# Interleaved sort keys
# ---------------------------------------------------------------------------

def key_bit_budget(K: int) -> tuple[int, int, int]:
    """(bits_per_dim, hi_bits, lo_bits) of the interleaved key for K dims.

    Up to 64 total bits split over two 32-bit words.  For K <= 4 the whole
    key fits the hi word (lo_bits == 0) and the low word is all zeros.
    """
    bits_total = min(8, max(1, 64 // K))     # bits per dim that fit 2 words
    hi_bits = min(bits_total, max(1, 32 // K))
    return bits_total, hi_bits, bits_total - hi_bits


def _pack_word(codes: torch.Tensor, K: int, start_bit: int,
               nbits: int) -> torch.Tensor:
    """One 32-bit key word, held as int64 (values in [0, 2^32))."""
    key = torch.zeros(codes.shape[:-1], dtype=torch.int64, device=codes.device)
    if nbits == 0:
        return key
    # Bit level b of dim j lands at position nbits*K - 1 - (b*K + j);
    # positions >= 32 overflow the word and are dropped explicitly.
    pos = (nbits * K - 1
           - (np.arange(nbits)[:, None] * K + np.arange(K)[None, :]))
    weight = torch.tensor(np.where(pos < 32, np.int64(1) << np.minimum(pos, 31),
                                   0), dtype=torch.int64, device=codes.device)
    wide = codes.to(torch.int64)
    for b in range(nbits):                     # bit level, MSB first
        bits = (wide >> (7 - (start_bit + b))) & 1
        key += (bits * weight[b]).sum(dim=-1)
    return key


def interleave_keys(codes: torch.Tensor, K: int) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Bit-interleaved sort keys from (..., K) region ids in [0, 256).

    Returns (key_hi, key_lo) of shape ``codes.shape[:-1]``: MSB-first,
    round-robin over dimensions.  Each word is a uint32 value held in int64
    (torch has no sortable uint32); (hi, lo) compared lexicographically is
    the packed 64-bit key.
    """
    _, hi_bits, lo_bits = key_bit_budget(K)
    return (_pack_word(codes, K, 0, hi_bits),
            _pack_word(codes, K, hi_bits, lo_bits))


def _joint_key(key_hi: torch.Tensor, key_lo: torch.Tensor) -> torch.Tensor:
    """One signed 64-bit key with the unsigned (hi, lo) order.

    ``hi << 32 | lo`` would set the sign bit for hi >= 2^31 and sort those
    keys first; biasing hi by 2^31 keeps the order and cannot overflow:
    (hi - 2^31) * 2^32 + lo lies in [-2^63, 2^63)."""
    return (key_hi - (1 << 31)) * (1 << 32) + key_lo


def code_sort_orders(key_hi: torch.Tensor, key_lo: torch.Tensor,
                     K: int) -> torch.Tensor:
    """Sorting permutations (L, n) int64 for every tree from (L, n) key words.

    ONE stable sort along the last axis orders all L trees; stability makes
    the permutation identical to the reference's stable-by-lo then
    stable-by-hi composition."""
    key = key_hi if key_bit_budget(K)[2] == 0 else _joint_key(key_hi, key_lo)
    return torch.sort(key, dim=-1, stable=True).indices


def _sort_by_code(codes: torch.Tensor, K: int) -> torch.Tensor:
    """Reference path: permutation sorting (n, K) codes by interleaved key
    via two stable argsorts (``build_impl='reference'``)."""
    key_hi, key_lo = interleave_keys(codes, K)
    order = torch.argsort(key_lo, stable=True)
    return order[torch.argsort(key_hi[order], stable=True)]


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def _leaf_summaries(codes_s: torch.Tensor, valid: torch.Tensor,
                    leaf_size: int) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """(..., n_pad, K) int32 sorted codes -> leaf lo/hi (int16) and validity."""
    *lead, n_pad, K = codes_s.shape
    n_leaves = n_pad // leaf_size
    blocks = codes_s.reshape(*lead, n_leaves, leaf_size, K)
    bmask = valid.reshape(*lead, n_leaves, leaf_size)[..., None]
    big = torch.iinfo(torch.int32).max
    lo = torch.where(bmask, blocks, big).amin(dim=-2)
    hi = torch.where(bmask, blocks, -1).amax(dim=-2)
    leaf_valid = bmask[..., 0].any(dim=-1)
    lo = torch.where(leaf_valid[..., None], lo, 0).to(LEAF_DTYPE)
    hi = torch.where(leaf_valid[..., None], hi, 0).to(LEAF_DTYPE)
    return lo, hi, leaf_valid


def assemble_sorted_forest(proj_t: torch.Tensor, codes_t: torch.Tensor,
                           order: torch.Tensor, *, n: int,
                           leaf_size: int) -> dict:
    """Gather per-tree sorted layouts + leaf summaries for all L trees.

    proj_t/codes_t (L, n, K) in input row order, order (L, n) sorting
    permutations.  Returns the DEForest arrays (minus breakpoints/statics)
    in their storage dtypes (codes uint8, bounds int16).
    """
    L, _, K = proj_t.shape
    n_leaves = -(-n // leaf_size)
    pad = n_leaves * leaf_size - n
    idx = order.to(torch.int64)[..., None].expand(L, n, K)
    proj_s = torch.nn.functional.pad(torch.gather(proj_t, 1, idx),
                                     (0, 0, 0, pad))
    codes_s = torch.nn.functional.pad(
        torch.gather(codes_t.to(torch.int32), 1, idx), (0, 0, 0, pad))
    ids = torch.nn.functional.pad(order.to(torch.int32), (0, pad), value=n)
    valid = (torch.arange(n + pad, device=order.device) < n).expand(
        L, n + pad).contiguous()
    lo, hi, leaf_valid = _leaf_summaries(codes_s, valid, leaf_size)
    return dict(point_ids=ids, proj_sorted=proj_s,
                codes_sorted=codes_s.to(CODE_DTYPE), valid=valid,
                leaf_lo=lo, leaf_hi=hi, leaf_valid=leaf_valid)


def check_nr(Nr: int) -> None:
    """uint8 code storage: every builder entry point must refuse Nr > 256
    or codes would silently wrap mod 256."""
    if Nr > MAX_NR:
        raise ValueError(f"Nr={Nr} > {MAX_NR}: region ids are stored as "
                         f"uint8 symbols (paper's 8-bit alphabet)")


def build_tree(proj: torch.Tensor, codes: torch.Tensor,
               breakpoints: torch.Tensor, leaf_size: int) -> dict:
    """Build one DE-Tree (array form) from (n, K) projections + codes: the
    reference per-tree path (double stable argsort)."""
    n, K = proj.shape
    order = _sort_by_code(codes, K)
    pad = -(-n // leaf_size) * leaf_size - n
    ids = torch.nn.functional.pad(order.to(torch.int32), (0, pad), value=n)
    valid = torch.arange(n + pad, device=proj.device) < n
    proj_s = torch.nn.functional.pad(proj[order], (0, 0, 0, pad))
    codes_s = torch.nn.functional.pad(codes[order].to(torch.int32),
                                      (0, 0, 0, pad))
    lo, hi, leaf_valid = _leaf_summaries(codes_s, valid, leaf_size)
    return dict(point_ids=ids, proj_sorted=proj_s,
                codes_sorted=codes_s.to(CODE_DTYPE), valid=valid,
                leaf_lo=lo, leaf_hi=hi, leaf_valid=leaf_valid,
                breakpoints=breakpoints)


class StageClock:
    """Wall-clock seconds per build stage, each ended by a device sync so
    asynchronous CUDA work is charged to the stage that queued it."""

    def __init__(self, device: torch.device,
                 into: Optional[dict] = None) -> None:
        self.device = device
        self.seconds = into if into is not None else {}
        self._t = time.perf_counter()

    def lap(self, stage: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + now - self._t
        self._t = now


def build_forest(proj_all: torch.Tensor, K: int, L: int, *,
                 Nr: int = enc.DEFAULT_NR, leaf_size: int = 64,
                 breakpoint_method: str = "sample_sort",
                 generator: Optional[torch.Generator] = None,
                 breakpoints: Optional[torch.Tensor] = None,
                 build_impl: str = "auto",
                 encode_impl: str = "auto",
                 stage_seconds: Optional[dict] = None) -> DEForest:
    """Build L DE-Trees from projections (n, L*K) (paper Alg. 1 + Alg. 2).

    ``breakpoints`` ((L*K, Nr+1), optional) bypasses breakpoint selection
    and encodes with the given frozen edges, so a caller can feed the same
    projections and breakpoints into this builder and the reference one.

    ``build_impl='reference'`` runs the paper's per-tree path: all L*K
    columns encoded at once through ``encoding.encode(impl=encode_impl)``
    (the ``encode_bins`` kernel for 'pallas' on a CUDA tensor), then a
    double stable argsort per tree.  Every other value runs the fused
    pipeline.  Its ``encode_pack`` step follows ``build_impl``, or
    ``encode_impl`` where ``build_impl`` is 'auto', as the reference's does:
    'auto'/'pallas' launch the CUDA kernel for a CUDA tensor (the plain
    version for a CPU one); 'xla'/'pallas_interpret' run the plain version
    on either device.  ``stage_seconds``, when given, receives the seconds
    of each stage (breakpoints, then encode_pack, sort, assemble, or for
    the reference builder encode, trees).
    """
    n = proj_all.shape[0]
    if proj_all.shape[1] != L * K:
        raise ValueError(f"proj_all {tuple(proj_all.shape)} is not (n, L*K) "
                         f"for L={L}, K={K}")
    check_nr(Nr)
    clock = StageClock(proj_all.device, stage_seconds)
    if breakpoints is None:
        bp_all = enc.select_breakpoints(proj_all, Nr,
                                        method=breakpoint_method,
                                        generator=generator)       # (L*K, Nr+1)
    else:
        bp_all = breakpoints.to(device=proj_all.device, dtype=torch.float32)
        if tuple(bp_all.shape) != (L * K, Nr + 1):
            raise ValueError(f"breakpoints {tuple(bp_all.shape)} are not "
                             f"(L*K, Nr+1) = ({L * K}, {Nr + 1})")
    bp_t = bp_all.reshape(L, K, Nr + 1).contiguous()
    clock.lap("breakpoints")

    if build_impl == "reference":
        codes_all = enc.encode(proj_all, bp_all, impl=encode_impl)  # (n, L*K)
        clock.lap("encode")
        proj_t = proj_all.reshape(n, L, K).permute(1, 0, 2)
        codes_t = codes_all.reshape(n, L, K).permute(1, 0, 2)
        trees = [build_tree(proj_t[l], codes_t[l], bp_t[l], leaf_size)
                 for l in range(L)]
        forest = DEForest(n=n, leaf_size=leaf_size,
                          **{k: torch.stack([t[k] for t in trees])
                             for k in trees[0]})
        clock.lap("trees")
        return forest

    impl = build_impl
    if impl == "auto" and encode_impl != "auto":
        impl = encode_impl            # an explicit encode impl wins on auto
    from repro_torch.kernels import ops
    proj_t, codes_t, key_hi, key_lo = ops.encode_pack(
        proj_all.contiguous(), bp_all.contiguous(), K=K, L=L,
        interpret=impl in ("xla", "pallas_interpret"))
    clock.lap("encode_pack")
    order = code_sort_orders(key_hi, key_lo, K)
    clock.lap("sort")
    arrays = assemble_sorted_forest(proj_t, codes_t, order, n=n,
                                    leaf_size=leaf_size)
    clock.lap("assemble")
    return DEForest(n=n, leaf_size=leaf_size, breakpoints=bp_t, **arrays)


# ---------------------------------------------------------------------------
# Leaf LB/UB bounds (paper Fig. 5)
# ---------------------------------------------------------------------------

def leaf_bounds(q_proj: torch.Tensor, leaf_lo: torch.Tensor,
                leaf_hi: torch.Tensor, leaf_valid: torch.Tensor,
                breakpoints: torch.Tensor, *,
                impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """LB/UB distances from B projected queries to every leaf box of every
    tree (Fig. 5): q_proj (L, B, K), leaf_lo/hi (L, n_leaves, K),
    leaf_valid (L, n_leaves), breakpoints (L, K, Nr+1) -> (lb, ub), each
    (L, B, n_leaves).  Invalid leaves get +inf.

    ``impl``: 'auto'/'xla' evaluate the reference's tensor expression
    (squares summed with ``.sum(-1)``); 'pallas' runs the ``leaf_bounds``
    kernel on a CUDA tensor (its plain version on a CPU one);
    'pallas_interpret' runs that plain version on either device.
    """
    if impl in ("pallas", "pallas_interpret"):
        from repro_torch.kernels import ops
        return ops.leaf_bounds(q_proj, leaf_lo, leaf_hi, leaf_valid,
                               breakpoints,
                               interpret=(impl == "pallas_interpret"))
    from repro_torch.kernels.ref import _edge_coords
    b_lo, b_hi = (e[:, None] for e in _edge_coords(breakpoints, leaf_lo,
                                                   leaf_hi))   # (L, 1, nl, K)
    q = q_proj[:, :, None, :]                                  # (L, B, 1, K)
    lb_dim = torch.clamp_min(torch.maximum(b_lo - q, q - b_hi), 0.0)
    ub_dim = torch.maximum((q - b_lo).abs(), (q - b_hi).abs())
    lb = torch.sqrt((lb_dim * lb_dim).sum(-1))
    ub = torch.sqrt((ub_dim * ub_dim).sum(-1))
    valid = leaf_valid.to(torch.bool)[:, None, :]
    return torch.where(valid, lb, _INF), torch.where(valid, ub, _INF)
