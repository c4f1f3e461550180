"""Device dispatch for the port's kernels.

A CPU tensor goes to the plain version in ``kernels/ref.py``; a CUDA tensor
goes to the hand-written kernel, whose wrapper launches it or raises.
There is no fallback between the two.  ``interpret=True`` is what the
reference's Pallas interpret mode means: the kernel's function without the
kernel, so the plain version runs on either device.  Only a caller that
asks for it (``impl='pallas_interpret'``) gets it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build_fused as _bf
from repro_torch.kernels import encode_bins as _enc
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import l2_rerank as _l2
from repro_torch.kernels import leaf_bounds as _lb
from repro_torch.kernels import lsh_project as _proj
from repro_torch.kernels import range_rerank as _rr
from repro_torch.kernels import ref as _ref


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}: the port runs on "
                     f"cuda, or on cpu through the plain versions")


def lsh_project(x: torch.Tensor, a: torch.Tensor, *,
                interpret: bool = False) -> torch.Tensor:
    """p-stable projection x (n, d) @ a (d, m) -> (n, m) f32, summed in d
    order (see kernels/lsh_project.py); f32 or bf16 inputs."""
    if interpret or not _on_cuda(x):
        return _ref.lsh_project(x, a)
    return _proj.lsh_project(x, a)


def encode_bins(coords: torch.Tensor, breakpoints: torch.Tensor, *,
                interpret: bool = False) -> torch.Tensor:
    """iSAX region ids: coords (n, D), breakpoints (D, Nr+1) -> (n, D)
    int32 (see kernels/encode_bins.py)."""
    if interpret or not _on_cuda(coords):
        return _ref.encode_bins(coords, breakpoints)
    return _enc.encode_bins(coords, breakpoints)


def encode_pack(proj: torch.Tensor, breakpoints: torch.Tensor, *, K: int,
                L: int, interpret: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Fused encode + interleaved key-pack (build; see
    kernels/build_fused.py).  proj (n, L*K) -> (proj_t, codes_t, key_hi,
    key_lo) in the per-tree layouts."""
    if interpret or not _on_cuda(proj):
        return _ref.encode_pack(proj, breakpoints, K=K, L=L)
    return _bf.encode_pack(proj, breakpoints, K=K, L=L)


def project_encode_pack(x: torch.Tensor, a: torch.Tensor,
                        breakpoints: torch.Tensor, *, K: int, L: int,
                        interpret: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """One-pass project -> encode -> key-pack (the frozen-breakpoint seal;
    see kernels/build_fused.py).  x (n, d), a (d, L*K) -> per-tree
    layouts, as :func:`encode_pack` gives them for x @ a."""
    if interpret or not _on_cuda(x):
        return _ref.project_encode_pack(x, a, breakpoints, K=K, L=L)
    return _bf.project_encode_pack(x.contiguous(), a.contiguous(),
                                   breakpoints.contiguous(), K=K, L=L)


def range_rerank(q: torch.Tensor, q_proj: torch.Tensor, r_eff: torch.Tensor,
                 leaf_lo: torch.Tensor, leaf_hi: torch.Tensor,
                 leaf_valid: torch.Tensor, breakpoints: torch.Tensor,
                 points: torch.Tensor, point_valid: torch.Tensor,
                 live: Optional[torch.Tensor] = None, *, leaf_size: int,
                 probe_depth: int = 0, interpret: bool = False
                 ) -> torch.Tensor:
    """Fused batched range query + rerank; see kernels/range_rerank.py.

    ``r_eff`` is (B,) per-lane radii shared across trees, or (L, B)
    per-tree radii.  With ``probe_depth > 0`` and 1-D radii they are first
    widened via :func:`repro_torch.kernels.ref.probe_radii` so the
    probe_depth best near-miss leaves per (tree, lane) are admitted too.
    ``live`` None means every point is live.  Returns (L, B, nl*leaf_size).
    """
    if live is None:
        live = point_valid           # pv & pv == pv: no ones tensor needed
    if probe_depth and r_eff.ndim == 1:
        r_eff = _ref.probe_radii(q_proj, leaf_lo, leaf_hi, leaf_valid,
                                 breakpoints, r_eff, probe_depth)
    if interpret or not _on_cuda(q):
        return _ref.range_rerank(q, q_proj, r_eff, leaf_lo, leaf_hi,
                                 leaf_valid, breakpoints, points, point_valid,
                                 live, leaf_size=leaf_size)
    L, B, _ = q_proj.shape
    return _rr.range_rerank(q, q_proj, r_eff.expand(L, B), leaf_lo, leaf_hi,
                            leaf_valid, breakpoints, points, point_valid,
                            live, leaf_size=leaf_size)


def range_rerank_heads(q: torch.Tensor, q_proj: torch.Tensor,
                       r_eff: torch.Tensor, leaf_lo: torch.Tensor,
                       leaf_hi: torch.Tensor, leaf_valid: torch.Tensor,
                       breakpoints: torch.Tensor, points: torch.Tensor,
                       point_valid: torch.Tensor,
                       live: Optional[torch.Tensor] = None, *,
                       leaf_size: int, interpret: bool = False
                       ) -> torch.Tensor:
    """Batched-forest fused range query + rerank (the KV-decode entry).

    :func:`range_rerank` with a leading head axis H on every array: H
    independent forests, each answering its own query batch.  q (H, B, d);
    q_proj (H, L, B, K); r_eff (H, B) shared across trees or (H, L, B);
    leaf arrays (H, L, nl, ...); points (H, L, nl*leaf_size, d); ``live``
    None means every point is live.  Returns (H, L, B, nl*leaf_size).  On
    a CUDA tensor all H forests share one kernel launch."""
    if live is None:
        live = point_valid
    if interpret or not _on_cuda(q):
        return _ref.range_rerank_heads(q, q_proj, r_eff, leaf_lo, leaf_hi,
                                       leaf_valid, breakpoints, points,
                                       point_valid, live,
                                       leaf_size=leaf_size)
    H, L, B, _ = q_proj.shape
    r3 = r_eff[:, None, :] if r_eff.ndim == 2 else r_eff
    return _rr.range_rerank_heads(q, q_proj, r3.expand(H, L, B), leaf_lo,
                                  leaf_hi, leaf_valid, breakpoints, points,
                                  point_valid, live, leaf_size=leaf_size)


def leaf_bounds(q_proj: torch.Tensor, leaf_lo: torch.Tensor,
                leaf_hi: torch.Tensor, leaf_valid: torch.Tensor,
                breakpoints: torch.Tensor, *, interpret: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fig. 5 leaf LB/UB for the whole forest; see kernels/leaf_bounds.py.
    q_proj (L, B, K), leaf_lo/hi (L, nl, K) int16 (the forest's storage
    dtype) -> (lb, ub) (L, B, nl)."""
    if interpret or not _on_cuda(q_proj):
        return _ref.leaf_bounds(q_proj, leaf_lo, leaf_hi, leaf_valid,
                                breakpoints)
    return _lb.leaf_bounds(q_proj.contiguous(), leaf_lo.contiguous(),
                           leaf_hi.contiguous(), leaf_valid.contiguous(),
                           breakpoints.contiguous())


def l2_rerank(q: torch.Tensor, c: torch.Tensor, *,
              interpret: bool = False) -> torch.Tensor:
    """Exact L2 distances; see kernels/l2_rerank.py.  q (b, d), c (m, d) ->
    (b, m), or with a group axis q (G, b, d), c (G, m, d) -> (G, b, m)."""
    if interpret or not _on_cuda(q):
        return _ref.l2_rerank(q, c)
    if q.ndim == 2:
        return _l2.l2_rerank(q.contiguous()[None], c.contiguous()[None])[0]
    return _l2.l2_rerank(q.contiguous(), c.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    interpret: bool = False) -> torch.Tensor:
    """Exact attention by online softmax; see kernels/flash_attention.py.
    q (b, h, sq, dh), k/v (b, h, sk, dh) -> (b, h, sq, dh) in q's dtype;
    ``scale`` defaults to 1/sqrt(dh); causal is top-left aligned."""
    if interpret or not _on_cuda(q):
        return _ref.flash_attention(q, k, v, causal=causal, scale=scale)
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    out = _fa.flash_attention(q.reshape(b * h, sq, dh).contiguous(),
                              k.reshape(b * h, sk, dh).contiguous(),
                              v.reshape(b * h, sk, dh).contiguous(),
                              causal=causal, scale=scale)
    return out.reshape(b, h, sq, dh)
