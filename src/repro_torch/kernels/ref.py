"""Plain PyTorch versions of the port's kernels: the semantics of record.

``kernels/ops.py`` sends a CPU tensor here; the CPU tests hold them against
the reference package, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card.

Leaf lower and upper bounds accumulate the K per-dimension gaps in the
order k = 0..K-1, one rounded product and one rounded sum per step, exactly
as the CUDA ``range_rerank`` and ``leaf_bounds`` kernels do
(``__fadd_rn(acc, __fmul_rn(t, t))``), so kernel and plain version agree
bit for bit on every bound, on which leaves are admitted and on which M
leaves a top-M cut fetches.
"""

from __future__ import annotations

from typing import Optional

import torch

_INF = float("inf")


def encode_pack(proj: torch.Tensor, breakpoints: torch.Tensor, *, K: int,
                L: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Fused build step: encode + interleaved key-pack.

    proj (n, L*K) f32, breakpoints (L*K, Nr+1) -> (proj_t (L, n, K) f32,
    codes_t (L, n, K) int32, key_hi (L, n), key_lo (L, n)): each key word is
    a uint32 value held in int64.  Codes are #(inner edges <= x), clipped
    to [0, Nr-1], and 0 for a NaN coordinate (:func:`encode_bins`); key
    words are ``core.detree.interleave_keys`` per tree.
    """
    from repro_torch.core.detree import interleave_keys
    n = proj.shape[0]
    codes = encode_bins(proj, breakpoints)                     # (n, L*K)
    proj_t = proj.reshape(n, L, K).permute(1, 0, 2).contiguous()
    codes_t = codes.reshape(n, L, K).permute(1, 0, 2).contiguous()
    key_hi, key_lo = interleave_keys(codes_t, K)
    return proj_t, codes_t, key_hi, key_lo


def project(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x (n, d) @ a (d, D) in f32, summed over d in index order with one
    rounded product and one rounded sum a step (``__fadd_rn(acc,
    __fmul_rn(x, a))``).  No kernel sums so any more: ``lsh_project`` and
    ``project_encode_pack`` take one FMA a step (:func:`lsh_project`)."""
    acc = torch.zeros((x.shape[0], a.shape[1]), dtype=torch.float32,
                      device=x.device)
    for j in range(x.shape[1]):                # fixed order, no contraction
        acc = acc + x[:, j, None] * a[j]
    return acc


def fma_f32(x: torch.Tensor, a: torch.Tensor, acc: torch.Tensor
            ) -> torch.Tensor:
    """The correctly rounded f32 fused multiply-add ``x * a + acc``
    (CUDA's ``__fmaf_rn``), elementwise; x and a hold f32 (or narrower)
    values in any float dtype, acc is f32.  Neither PyTorch nor numpy has
    one, so it is emulated in float64: the product of two f32 values is
    exact there (24 + 24 bits fit in 53), the sum is rounded to odd (TwoSum
    gives its exact error; a sum that is inexact and even steps one ulp
    towards the error), and rounding that to nearest f32 is the correctly
    rounded FMA, because 53 >= 24 + 2 (Boldo and Melquiond, "Emulation of
    FMA and correctly rounded sums: proved algorithms using rounding to
    odd", IEEE Trans. Computers, 2008)."""
    p = x.to(torch.float64) * a.to(torch.float64)
    c = acc.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    step = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, _INF, -_INF).to(torch.float64)
    s = torch.where(step, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def lsh_project(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The projection kernel's function: x (n, d) @ a (d, m) -> (n, m) f32,
    one correctly rounded fused multiply-add a feature in index order
    (``acc = fma(x[:, j], a[j], acc)`` for j = 0..d-1), as the CUDA
    ``lsh_project`` kernel sums (``__fmaf_rn``), so the two agree bit for
    bit.  bf16 inputs widen to f32 exactly; their products are exact in
    f32, so for them this equals :func:`project` bit for bit.  The CUDA
    ``project_encode_pack`` kernel projects with the same sum."""
    xd = x.to(torch.float64)
    ad = a.to(torch.float64)
    acc = torch.zeros((x.shape[0], a.shape[1]), dtype=torch.float32,
                      device=x.device)
    for j in range(x.shape[1]):                # fixed order
        acc = fma_f32(xd[:, j, None], ad[j], acc)
    return acc


def encode_bins(coords: torch.Tensor, breakpoints: torch.Tensor
                ) -> torch.Tensor:
    """iSAX region ids, coords (n, D), breakpoints (D, Nr+1) -> (n, D)
    int32: #(inner edges bp[c, 1..Nr-1] <= x), clipped to [0, Nr-1], as the
    TPU kernel's compare-accumulate ``x >= edge`` counts them: +inf gets
    Nr-1, -inf 0, and a NaN coordinate 0, since no comparison admits it (a
    searchsorted alone would put it past every edge, Nr-1, as the port's
    ``core.encoding.encode`` does for 'auto'/'xla')."""
    from repro_torch.core.encoding import encode
    codes = encode(coords, breakpoints)
    return torch.where(torch.isnan(coords), 0, codes)


def project_encode_pack(x: torch.Tensor, a: torch.Tensor,
                        breakpoints: torch.Tensor, *, K: int, L: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """The seal's fused step: :func:`lsh_project` (one FMA a feature in d
    order, as the CUDA kernel sums) then :func:`encode_pack`.  x (n, d),
    a (d, L*K), breakpoints (L*K, Nr+1) -> encode_pack's outputs."""
    return encode_pack(lsh_project(x.to(torch.float32), a.to(torch.float32)),
                       breakpoints, K=K, L=L)


def _edge_coords(breakpoints: torch.Tensor, leaf_lo: torch.Tensor,
                 leaf_hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K, E) breakpoints, (..., nl, K) bounds -> the leaf boxes'
    lower and upper edge coordinates, each (..., nl, K).  Bounds widen to
    int64 before the +1 (int16 storage would wrap at 32767)."""
    E = breakpoints.shape[-1]
    bp_t = breakpoints.transpose(-1, -2)                       # (..., E, K)
    lo = torch.clamp(leaf_lo.to(torch.int64), 0, E - 1)
    hi = torch.clamp(leaf_hi.to(torch.int64) + 1, 0, E - 1)
    return torch.gather(bp_t, -2, lo), torch.gather(bp_t, -2, hi)


def _sum_in_k_order(x: torch.Tensor, b_lo: torch.Tensor, b_hi: torch.Tensor,
                    gap) -> torch.Tensor:
    """sqrt(sum_k gap(x_k, lo_k, hi_k)^2) over (L, B, nl), summed in the
    order k = 0..K-1 with one rounded product and one rounded sum a step
    (the CUDA kernels' ``__fadd_rn(acc, __fmul_rn(t, t))``).

    x (L, B, K); b_lo/b_hi (L, nl, K) edge coordinates."""
    L, B, K = x.shape
    acc = torch.zeros((L, B, b_lo.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k in range(K):                         # fixed order, no contraction
        t = gap(x[:, :, None, k], b_lo[:, None, :, k], b_hi[:, None, :, k])
        acc = acc + t * t
    return torch.sqrt(acc)


def _lb_gap(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
            ) -> torch.Tensor:
    return torch.clamp_min(torch.maximum(lo - x, x - hi), 0.0)


def _ub_gap(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
            ) -> torch.Tensor:
    return torch.maximum((x - lo).abs(), (x - hi).abs())


def forest_leaf_lb(q_proj: torch.Tensor, leaf_lo: torch.Tensor,
                   leaf_hi: torch.Tensor, leaf_valid: torch.Tensor,
                   breakpoints: torch.Tensor) -> torch.Tensor:
    """Leaf LB distances for the whole forest at once.

    q_proj (L, B, K); leaf_lo/hi (L, nl, K); leaf_valid (L, nl);
    breakpoints (L, K, E) -> (L, B, nl) f32, +inf for invalid leaves.
    """
    b_lo, b_hi = _edge_coords(breakpoints, leaf_lo, leaf_hi)   # (L, nl, K)
    lb = _sum_in_k_order(q_proj, b_lo, b_hi, _lb_gap)
    return torch.where(leaf_valid.to(torch.bool)[:, None, :], lb, _INF)


def leaf_bounds(q: torch.Tensor, leaf_lo: torch.Tensor, leaf_hi: torch.Tensor,
                leaf_valid: torch.Tensor,
                breakpoints: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Fig. 5 LB/UB distances from projected queries to leaf boxes.

    Forest form: q (L, B, K), leaf_lo/hi (L, nl, K), leaf_valid (L, nl),
    breakpoints (L, K, E) -> (lb, ub), each (L, B, nl).  Single-tree form
    (a view of it): q (K,), leaf_lo/hi (nl, K), leaf_valid (nl,),
    breakpoints (K, E) -> (nl,) each.  Invalid leaves get +inf.  Both sums
    run in k order, so the CUDA ``leaf_bounds`` kernel matches bit for bit.
    """
    if q.ndim == 1:
        lb, ub = leaf_bounds(q[None, None, :], leaf_lo[None], leaf_hi[None],
                             leaf_valid[None], breakpoints[None])
        return lb[0, 0], ub[0, 0]
    b_lo, b_hi = _edge_coords(breakpoints, leaf_lo, leaf_hi)   # (L, nl, K)
    valid = leaf_valid.to(torch.bool)[:, None, :]
    lb = _sum_in_k_order(q, b_lo, b_hi, _lb_gap)
    ub = _sum_in_k_order(q, b_lo, b_hi, _ub_gap)
    return torch.where(valid, lb, _INF), torch.where(valid, ub, _INF)


def probe_radii_from_lb(lb: torch.Tensor, r_eff: torch.Tensor,
                        probe_depth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe-widened admission radii from a leaf-LB table.

    lb (L, B, nl) leaf LBs (+inf for invalid leaves); r_eff (B,) radius per
    lane (-1 = done).  Per (tree, lane), widen the radius to also admit the
    ``probe_depth`` valid leaves with the smallest LB above r_eff.  Done
    lanes keep r_eff = -1 and never probe.  Returns (r_adm (L, B),
    probe_mask (L, B, nl)).
    """
    nl = lb.shape[2]
    r = r_eff[None, :]
    outside = lb > r[..., None]                      # invalid leaves too
    slack = torch.where(outside & torch.isfinite(lb), lb, _INF)
    depth = min(int(probe_depth), nl)
    kth = torch.topk(slack, depth, dim=-1, largest=False).values[..., -1]
    # The depth-th probe leaf sits exactly on the widened radius, and a
    # kernel that recomputes leaf LBs in another order could lose it to a
    # 1-ulp difference: one relative-epsilon nudge keeps it in (a superset,
    # so the quality guarantees are untouched).
    kth = torch.where(torch.isfinite(kth), kth * (1 + 1e-5) + 1e-6, kth)
    r_adm = torch.maximum(r, kth)
    r_adm = torch.where(r < 0, r, r_adm)
    probe_mask = outside & torch.isfinite(lb) & (lb <= r_adm[..., None])
    return r_adm, probe_mask


def probe_radii(q_proj: torch.Tensor, leaf_lo: torch.Tensor,
                leaf_hi: torch.Tensor, leaf_valid: torch.Tensor,
                breakpoints: torch.Tensor, r_eff: torch.Tensor,
                probe_depth: int) -> torch.Tensor:
    """Leaf-LB table -> probe-widened (L, B) radii."""
    lb = forest_leaf_lb(q_proj, leaf_lo, leaf_hi, leaf_valid, breakpoints)
    return probe_radii_from_lb(lb, r_eff, probe_depth)[0]


def l2_rerank(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Exact Euclidean distances, ``sqrt(max(qq - 2 q.c + cc, 0))``.

    q (b, d), c (m, d) -> (b, m); or with a leading group axis q (G, b, d),
    c (G, m, d) -> (G, b, m).  bf16 inputs are upcast to f32 first."""
    q = q.to(torch.float32)
    c = c.to(torch.float32)
    qq = (q * q).sum(-1, keepdim=True)                         # (..., b, 1)
    cc = (c * c).sum(-1)[..., None, :]                         # (..., 1, m)
    qc = torch.matmul(q, c.transpose(-1, -2))
    return torch.sqrt(torch.clamp_min(qq - 2.0 * qc + cc, 0.0))


def range_rerank(q: torch.Tensor, q_proj: torch.Tensor, r_eff: torch.Tensor,
                 leaf_lo: torch.Tensor, leaf_hi: torch.Tensor,
                 leaf_valid: torch.Tensor, breakpoints: torch.Tensor,
                 points: torch.Tensor, point_valid: torch.Tensor,
                 live: Optional[torch.Tensor] = None, *,
                 leaf_size: int, probe_depth: int = 0) -> torch.Tensor:
    """Fused batched range query + exact rerank.

    q (B, d); q_proj (L, B, K); r_eff projected admission radii, (B,)
    shared across trees or (L, B) per tree (-1 = inactive lane); leaf_lo/hi
    (L, nl, K); leaf_valid (L, nl); breakpoints (L, K, E); points
    (L, nl*leaf_size, d) code-sorted points; point_valid (L, nl*leaf_size);
    live (L, nl*leaf_size) tombstone mask in sorted order (None = all live).

    With probe_depth > 0 and 1-D r_eff the radii are first widened per
    (tree, lane) via :func:`probe_radii`.

    Returns (L, B, nl*leaf_size) f32: the exact distance for every valid,
    live point whose leaf has LB <= r_eff, +inf elsewhere.
    """
    L, B, _ = q_proj.shape
    if probe_depth and r_eff.ndim == 1:
        r_eff = probe_radii(q_proj, leaf_lo, leaf_hi, leaf_valid,
                            breakpoints, r_eff, probe_depth)
    r2 = r_eff.expand(L, B)
    lb = forest_leaf_lb(q_proj, leaf_lo, leaf_hi, leaf_valid, breakpoints)
    admit = (lb <= r2[..., None]) & leaf_valid.to(torch.bool)[:, None, :]
    keep = point_valid.to(torch.bool)
    if live is not None:
        keep = keep & live.to(torch.bool)
    out = torch.empty((L, B, points.shape[1]), dtype=torch.float32,
                      device=q.device)
    for l in range(L):
        mask = admit[l].repeat_interleave(leaf_size, dim=1) & keep[l][None, :]
        out[l] = torch.where(mask, l2_rerank(q, points[l]), _INF)
    return out


def range_rerank_heads(q: torch.Tensor, q_proj: torch.Tensor,
                       r_eff: torch.Tensor, leaf_lo: torch.Tensor,
                       leaf_hi: torch.Tensor, leaf_valid: torch.Tensor,
                       breakpoints: torch.Tensor, points: torch.Tensor,
                       point_valid: torch.Tensor,
                       live: Optional[torch.Tensor] = None, *,
                       leaf_size: int) -> torch.Tensor:
    """:func:`range_rerank` over H independent forests, head by head.

    Every argument carries a leading head axis H: q (H, B, d); q_proj
    (H, L, B, K); r_eff (H, B) shared across trees or (H, L, B); leaf
    arrays (H, L, nl, ...); points (H, L, nl*leaf_size, d); live None means
    every point is live.  Returns (H, L, B, nl*leaf_size)."""
    return torch.stack([
        range_rerank(q[h], q_proj[h], r_eff[h], leaf_lo[h], leaf_hi[h],
                     leaf_valid[h], breakpoints[h], points[h], point_valid[h],
                     None if live is None else live[h], leaf_size=leaf_size)
        for h in range(q.shape[0])])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    block_k: int = 512) -> torch.Tensor:
    """Blockwise (online-softmax) attention that never holds the (sq, sk)
    score matrix: the ``flash_attention`` kernel's function.

    q (b, h, sq, dh); k/v (b, h, sk, dh) -> (b, h, sq, dh) in q's dtype,
    accumulated in f32.  Causal masking is top-left aligned
    (key position <= query position, both counted from 0).  q is widened
    to f32 before it is scaled, as the Pallas kernel and the CUDA kernel
    do, so a bf16 q is rounded once, not twice."""
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    qf = q.to(torch.float32) * scale
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), -_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, block_k):
        kblk = k[:, :, k0:k0 + block_k].to(torch.float32)
        vblk = v[:, :, k0:k0 + block_k].to(torch.float32)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kblk)
        if causal:
            kpos = torch.arange(k0, k0 + kblk.shape[2], device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], -_INF)
        m_cur = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                    vblk)
        m = m_cur
    return (acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)


def flash_attention_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for :func:`flash_attention`
    outputs ``want`` (b, h, sq, dh), in want's own dtype.

    Both sides accumulate in f32 and round once to the output dtype, so in
    f32 they differ only by summation order: 1e-5 + 1e-5 * |want|.  In
    bf16 two f32 values that close can still round to neighbouring bf16
    values, one unit in the last place apart, at most 2^-7 * |want|; the
    f32 gap itself is covered by 1e-3 of the root mean square of want's
    head (its (sq, dh) slice), which matters only near zero."""
    w = want.to(torch.float32)
    if want.dtype == torch.bfloat16:
        rms = w.square().mean(dim=(-2, -1), keepdim=True).sqrt()
        return 2.0 ** -7 * w.abs() + 1e-3 * rms
    return 1e-5 + 1e-5 * w.abs()


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive softmax attention over the whole (sq, sk) score matrix: the
    oracle of :func:`flash_attention` at small sizes."""
    sq, sk, dh = q.shape[2], k.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = s.masked_fill(~mask, -_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)
