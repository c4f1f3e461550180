#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py            # n = 1,000,000 SIFT-shaped vectors,
                                     # then decode at Qwen3-1.7B's widths

Phases, each printed as one line; any failure exits non-zero:

  env        torch / CUDA versions, the card, TF32 switched off.
  build      every CUDA source under src/repro_torch/kernels/csrc compiled
             at once (one nvcc each, in parallel).
  kernel_sass  the redesigned kernels' instruction mix from cuobjdump -sass:
             HMMA (tensor-core) instructions in each of range_rerank's six
             rerank instances (must be > 0) and its two admission
             instances; FFMA, FMUL and FADD in lsh_project's four (f32
             and bf16, 512- and 128-row blocks; FFMA must be > 0, HMMA 0).
  encode_pack  the kernel against its plain PyTorch version at n rows,
             K=16/L=4 and K=4/L=16 (where the low key word is zero): all
             four outputs bit-identical; CUDA-event times.
  main_path  a static index at SIFT1M's shape (n x 128 f32 from a seed),
             IndexSpec(K=16, L=4, c=1.5, beta_override=0.1, Nr=256,
             leaf_size=64) built through repro_torch.api.build on cuda, one
             batch of 100 perturbed-data-point queries searched with
             SearchRequest(k=50, engine='fused'); recall@50 against exact
             search on the card and the c^2 guarantee rate, which must reach
             1/2 - 1/e.  Both kernels' launch counts must move on this path.
             main_path_scaled_r_min: the same batch started at the true
             k-NN distance scale / c^2, so that several rounds run.
  leaf_bounds  the kernel against its plain version for the 100 main-path
             queries over the whole forest: LB and UB bit-identical.
  l2_rerank  the kernel against its plain version at the vmap path's shape
             (100 lanes of 1 query x 2,048 candidates gathered from the
             first round, d = 128; f32 and bf16) and at one all-pairs shape
             (100 x 65,536); torch.cdist timed beside it as a yardstick.
  vmap_path  the per-query engine on the same index: SearchRequest(k=50,
             engine='vmap', bounds_impl='pallas', dist_impl='pallas') on the
             100 queries (both kernels' launch counts must move), engine=
             'auto' on 1 and 7 queries (must resolve to vmap) and
             mode='strict' on 7, each held lane by lane against the same
             request with 'pallas_interpret' (the plain versions on the
             card); warm ms for B = 1, 7, 100 with 'pallas' and 'auto'
             impls (median of 20 synced searches, min and max beside it),
             recall@50 and the c^2 rate against exact search.
             vmap_scaled_r_min: B = 100 ('vmap') and B = 7 ('auto') started
             at the true k-NN scale / c^2, held lane by lane against
             'pallas_interpret' as above; some lane must run >= 2 rounds.
             vmap_breakdown: CUDA-event ms of each step of one round.
  range_rerank  the kernel against its plain version at the main path's
             last radius round, probe_depth 0 and 2, and at the last round
             of the scaled-r_min search (each lane's final radius):
             identical +inf mask, finite entries within rtol 1e-4 / atol
             1e-4 * max|x|^2 (the qq - 2q.p + pp form cancels near zero,
             and the kernel's q.p is 3xTF32 on the tensor cores); the
             admitted (query, leaf) pair share beside the share of warp
             tiles (16 queries x 64 points) that hold one and so compute.
  search_breakdown  CUDA-event ms of each step of that round (kernel,
             inv_perm fold, T1/T2 update) and of the final top-k.
  persist    save -> load(device='cuda') -> search gives bit-identical ids
             and distances, on the fused and on the vmap request.
  project_encode_pack  the streaming seal's kernel against its plain version
             on the main path's rows (n = 1M x 128, K=16/L=4 and K=4/L=16)
             and at the seal shape (16,384 rows): all four outputs
             bit-identical; CUDA-event times, and the unfused pair
             (torch.matmul, then the encode_pack kernel) as a yardstick.
  streaming_path  a streaming index at SIFT1M's shape through
             repro_torch.api.build(IndexSpec(kind='streaming', ...,
             delta_capacity=16384, max_segments=4)): 4 x 16,384 upserted rows
             seal four times through project_encode_pack (its count must
             move by exactly 4), 2,000 more stay in the delta (1,000 of them
             overwrite base gids), 10,000 gids are deleted across base, sealed
             segments and delta.  Fused (B=100), vmap (B=100, pallas impls)
             and auto (B=7) searches, each at the estimated r_min and again
             started at the survivors' true k-NN scale / c^2 (some lane must
             run >= 2 rounds), each held lane by lane against
             'pallas_interpret'; the fused search at r_min=1e6 equal to brute
             force over the survivors (distance ties excused and counted);
             then maybe_compact() (5 segments > 4) and the same checks again;
             then save -> load(device='cuda'): the same state_digest and
             bit-identical searches.  Seal, upsert, delete, compaction and
             warm search times, recall@50 and the c^2 rate.
  lsh_project  the projection kernel against its plain version (one FMA a
             feature in d order) on the main path's rows and A (1M x 128
             -> 64) and at GIST's width (100,000 x 960 -> 64):
             bit-identical; CUDA-event times, and torch.matmul (TF32 off)
             as a yardstick.
  encode_bins  the encode kernel against its plain version (searchsorted)
             on the main path's projections with its index's breakpoints
             (1M x 64, Nr = 256): bit-identical; torch.searchsorted on the
             transposed coordinates plus the clamp as a yardstick.
  pdet_path  the sharded PDET index at the same shape through
             repro_torch.api.build(IndexSpec(..., project_impl='pallas',
             build_impl='reference', encode_impl='pallas',
             placement=PlacementSpec(mesh_shape=(1,)))): the build launches
             lsh_project and encode_bins once each and encode_pack never
             (seconds by stage); its forest equals the fused builder's from
             the same projection and breakpoints, dtypes included; at S = 1,
             3 and 4 shards of the card (15,625 leaves a tree, so 3 and 4
             pad) 100 queries at the estimated r_min and at the true k-NN
             scale / c^2 (>= 2 rounds) answer as the fused engine on the
             same index bit for bit (ids, distances, rounds, candidates,
             final radii) with range_rerank launched S times a round
             (pdet_breakdown: CUDA-event ms of one round's steps on one
             shard at S = 1 and 4);
             recall@50 and the c^2 rate; engine='pdet' with probe_depth=2
             raises, 'auto' with it runs fused; warm ms (median of 20, min,
             max) of fused and of pdet at S = 1 and 4; save at S = 4 ->
             load(device='cuda') (back as S = 1 on one card) -> the same
             answers, and again resharded onto 4 shards of the card.
  wide_rows  the width limits lifted: range_rerank at d = 1,536 (50,000
             rows, B = 100), range_rerank_heads at d = 1,537 (4 forests,
             each head also bit-identical to a single-forest launch), both
             with the +inf mask of the plain version and finite entries
             within range_rerank's tolerance; project_encode_pack at
             d = 2,048 (16,384 rows) and encode_pack at L*K = 2,048
             (K = 16, L = 128: two launches in one call), bit-identical.
  flash_attention  the kernel against its plain version (blockwise online
             softmax) within ref.flash_attention_tolerance, each call on
             the path flash_attention.path names: Qwen3-1.7B's prefill
             widths (b = 1, h = 16, sq = sk = 32,768, dh = 128, causal;
             prefill_32k's batch 32 cut to 1) in f32 (CUDA cores) and bf16
             (tensor cores: the SASS of its kernels must hold HMMA, read
             with cuobjdump), decode_path's dense step shape (b = 4,
             h = 16, sq = 1, sk = 32,768, dh = 128; split-key path) in f32
             and bf16, and a sweep (tests/test_kernels.py's shapes, sk =
             260 ragged, dh = 32-256, sq = 3; causal and not); CUDA-event
             times of the kernel, its plain version and
             scaled_dot_product_attention (a yardstick the port never
             calls) at the prefill and decode shapes.
  decode_path  LSH decode over one attention layer's KV cache at
             Qwen3-1.7B's widths (16 query heads, 8 kv heads, dh = 128;
             decode_32k's S = 32,768 at batch 4 instead of 128, f32
             caches, keys N(0,1) * 0.3 and values N(0,1) from a numpy seed
             as benchmarks/decode_throughput.py makes them):
             KVCacheIndex.prefill of the first S - 256 positions on cuda
             (encode_pack once a head), then 256 LSHDecoder steps
             (window 64, sinks 4, refresh every 12; KVSpec() defaults, so
             two seals at delta_capacity 128), each beside a dense decode
             step through the flash_attention kernel (its split-key path,
             every step); range_rerank_heads must launch once a retrieval
             round for all 32 heads.  Then:
             range_rerank_heads against its plain version at the
             estimated radius and head by head bit-identical to the
             single-forest kernel; a retrieval at r_min = 1e6 in one round
             whose forest tier is the exact top-64 lane by lane (ties
             counted); planted-position recall over 8 trials; sparse
             attention over every position equal to dense attention within
             1e-4; 1,000 deleted positions absent from the next retrieval;
             save raising as in the reference.  Step, retrieval, seal and
             dense-step times, cosine to dense attention.

Then one JSON line per the kernel table (time, plain time, launches on the
path that runs the kernel, least possible time from bytes and operations,
and a PyTorch call's time where one computes the same function), the card's name
and power limit, and as the last line {"ok": true, "device": {...}}.
Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s HBM, 67 TFLOP/s fp32
on the CUDA cores, 989 TFLOP/s bf16 on the tensor cores.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12          # dense tensor-core rate


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def line(tag: str, **fields) -> None:
    print(f"{tag} {json.dumps(fields, default=float)}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, *, warmup: int = 2, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_encode_pack(torch, n: int, K: int, L: int, Nr: int) -> dict:
    from repro_torch.core.encoding import breakpoints_sample_sort
    from repro_torch.kernels import build_fused, ref
    gen = torch.Generator(device="cuda").manual_seed(K * 100 + L)
    proj = torch.randn((n, L * K), generator=gen, device="cuda") * 2.0
    bp = breakpoints_sample_sort(proj, Nr)
    got = build_fused.encode_pack(proj, bp, K=K, L=L)
    want = ref.encode_pack(proj, bp, K=K, L=L)
    names = ("proj_t", "codes_t", "key_hi", "key_lo")
    max_err = 0.0
    for name, g, w in zip(names, got, want):
        require(g.dtype == w.dtype and g.shape == w.shape,
                f"encode_pack K={K} L={L}: {name} has another dtype or shape")
        max_err = max(max_err, float((g.double() - w.double()).abs().max()))
        require(torch.equal(g, w),
                f"encode_pack K={K} L={L}: {name} differs from the plain "
                f"version")
    require(bool((got[2] >= 0).all() and (got[2] < 2 ** 32).all()),
            "key_hi outside uint32")
    if K <= 4:
        require(not bool(got[3].any()), "K<=4 needs an all-zero low word")
    ms = time_ms(torch, lambda: build_fused.encode_pack(proj, bp, K=K, L=L))
    plain = time_ms(torch, lambda: ref.encode_pack(proj, bp, K=K, L=L),
                    warmup=1, reps=10)
    D = L * K
    nbytes = 4 * n * D + 4 * D * (Nr + 1) + (4 + 4) * n * D + 2 * 8 * L * n
    flops = n * D * math.ceil(math.log2(Nr))          # one compare per step
    bms, by = bound_ms(nbytes, flops)
    out = dict(K=K, L=L, n=n, bit_identical=True, max_abs_err=max_err,
               ms=ms, plain_ms=plain,
               bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops,
               key_hi_max=int(got[2].max()))
    line("encode_pack", **out)
    return out


def _q_proj(index, queries):
    p = index.params
    B = queries.shape[0]
    return (queries @ index.A).reshape(B, p.L, p.K).permute(1, 0,
                                                          2).contiguous()


def check_leaf_bounds(torch, index, queries) -> dict:
    from repro_torch.kernels import leaf_bounds as lbk
    from repro_torch.kernels import ref
    f = index.forest
    q_proj = _q_proj(index, queries)
    args = (q_proj, f.leaf_lo, f.leaf_hi, f.leaf_valid, f.breakpoints)
    got = lbk.leaf_bounds(*args)
    want = ref.leaf_bounds(*args)
    torch.cuda.synchronize()
    max_err = 0.0
    for name, g, w in zip(("lb", "ub"), got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"leaf_bounds: {name} has another shape or dtype")
        fin = torch.isfinite(w)
        require(torch.equal(fin, torch.isfinite(g)),
                f"leaf_bounds: {name} +inf mask differs")
        max_err = max(max_err, float((g[fin].double() - w[fin].double())
                                     .abs().max()))
        require(torch.equal(g, w),
                f"leaf_bounds: {name} is not bit-identical to the plain "
                f"version (max err {max_err})")
    ms = time_ms(torch, lambda: lbk.leaf_bounds(*args))
    plain = time_ms(torch, lambda: ref.leaf_bounds(*args), warmup=1, reps=10)
    L, B, K = q_proj.shape
    nl, E = f.n_leaves, f.breakpoints.shape[2]
    nbytes = (4 * L * B * K + 2 * 2 * L * nl * K + L * nl + 4 * L * K * E
              + 2 * 4 * L * B * nl)
    flops = 13 * L * B * nl * K                  # LB 6 + UB 7 per (k, pair)
    bms, by = bound_ms(nbytes, flops)
    out = dict(L=L, B=B, nl=nl, K=K, bit_identical=True, max_abs_err=max_err,
               invalid_leaves=int((~f.leaf_valid).sum()), ms=ms,
               plain_ms=plain, bound_ms=bms, bound_by=by, bytes=nbytes,
               flops=flops)
    line("leaf_bounds", **out)
    return out


def _l2_case(torch, name, q, c, max_sq, *, timed: bool) -> dict:
    """The l2_rerank kernel against its plain version on q (G, b, d),
    c (G, m, d); tolerance 1e-4 * |d| + 1e-4 * max|x|^2 (f32) or 5e-2 * |d|
    + 5e-2 (bf16 inputs): qq - 2 q.c + cc cancels near zero."""
    from repro_torch.kernels import l2_rerank as l2k
    from repro_torch.kernels import ref
    got = l2k.l2_rerank(q, c)
    want = ref.l2_rerank(q, c)
    torch.cuda.synchronize()
    err = (got - want).abs()
    if q.dtype == torch.bfloat16:
        tol = 5e-2 * want.abs() + 5e-2
    else:
        tol = 1e-4 * want.abs() + 1e-4 * max_sq
    max_err = float(err.max())
    require(bool(torch.isfinite(got).all()) and bool((err <= tol).all()),
            f"l2_rerank {name}: outside tolerance (max err {max_err})")
    G, b, d = q.shape
    m = c.shape[1]
    elem = q.element_size()
    nbytes = elem * G * (b + m) * d + 4 * G * b * m
    flops = 2 * d * G * m * (b + 1)
    bms, by = bound_ms(nbytes, flops)
    out = dict(case=name, G=G, b=b, m=m, d=d, dtype=str(q.dtype),
               max_abs_err=max_err, bound_ms=bms, bound_by=by, bytes=nbytes,
               flops=flops)
    if timed:
        out["ms"] = time_ms(torch, lambda: l2k.l2_rerank(q, c))
        out["plain_ms"] = time_ms(torch, lambda: ref.l2_rerank(q, c),
                                  warmup=1, reps=10)
        out["library_ms"] = time_ms(torch, lambda: torch.cdist(q, c))
    line("l2_rerank", **out)
    return out


def check_l2_rerank(torch, index, queries, r_min: float, M: int) -> dict:
    from repro_torch.core import query
    f, p = index.forest, index.params
    B, n = queries.shape[0], index.n_points
    r = torch.full((B,), r_min, dtype=torch.float32, device=queries.device)
    ids, _ = query.range_query_round(f, _q_proj(index, queries),
                                     p.epsilon * r, M, bounds_impl="pallas")
    pts = index.data[torch.clamp(ids.to(torch.int64), 0, n - 1)]
    max_sq = float((index.data * index.data).sum(-1).max())
    path = _l2_case(torch, "path", queries[:, None, :].contiguous(), pts,
                    max_sq, timed=True)
    bf16 = _l2_case(torch, "path_bf16",
                    queries[:, None, :].to(torch.bfloat16).contiguous(),
                    pts.to(torch.bfloat16), max_sq, timed=False)
    pairs = _l2_case(torch, "all_pairs", queries[None],
                     index.data[None, :65536].contiguous(), max_sq,
                     timed=True)
    return dict(path, max_abs_err=max(path["max_abs_err"],
                                      bf16["max_abs_err"],
                                      pairs["max_abs_err"]))


def held_against_plain(name: str, kern, plain, c: float,
                       max_sq: float) -> int:
    """Hold a search that ran the kernels against the same request on the
    plain versions, lane by lane.  Leaf bounds are bit-identical, so the
    runs admit the same candidates; distances differ by summation order.
    A lane may differ only where that can flip a decision: its k-th
    distance lies within tolerance of c * r (the T2 test stopped one run a
    round early), or every id that differs sits at a distance within
    tolerance of the k-th distance or of a neighbour's (a tie swap).
    Returns the number of such lanes; any other difference fails."""
    ki, pi = kern.ids.cpu().numpy(), plain.ids.cpu().numpy()
    kd = kern.dists.cpu().numpy().astype(np.float64)
    pd = plain.dists.cpu().numpy().astype(np.float64)
    kr, pr = (x.stats.rounds.cpu().numpy() for x in (kern, plain))
    kn, pn = (x.stats.n_candidates.cpu().numpy() for x in (kern, plain))
    kf, pf = (x.stats.final_r.cpu().numpy() for x in (kern, plain))

    def near(x: float, y: float) -> bool:
        return bool(np.isfinite(y)) and abs(x - y) <= 1e-4 * abs(y) \
            + 1e-4 * max_sq

    excused = 0
    for b in range(ki.shape[0]):
        fin = np.isfinite(pd[b])
        dist_ok = (np.array_equal(fin, np.isfinite(kd[b]))
                   and all(near(kd[b][j], pd[b][j]) for j in np.nonzero(fin)[0]))
        same = (np.array_equal(ki[b], pi[b]) and kr[b] == pr[b]
                and kn[b] == pn[b])
        if same and dist_ok:
            continue
        t2_edge = (near(kd[b][-1], c * kf[b]) or near(pd[b][-1], c * pf[b]))
        k = len(pd[b])
        swap = (kr[b] == pr[b] and kn[b] == pn[b] and dist_ok and all(
            near(pd[b][j], pd[b][-1])
            or (j > 0 and near(pd[b][j], pd[b][j - 1]))
            or (j + 1 < k and near(pd[b][j], pd[b][j + 1]))
            for j in np.nonzero(ki[b] != pi[b])[0]))
        require(t2_edge or swap,
                f"{name}: lane {b} differs from the plain versions' run "
                f"(rounds {kr[b]}/{pr[b]}, candidates {kn[b]}/{pn[b]})")
        excused += 1
    return excused


def vmap_breakdown(torch, index, queries, r_min: float, req) -> None:
    """CUDA-event ms of each step of one vmap round at B = 100 (the first
    round, from empty candidate sets) and of the final top-k, one at a
    time; their sum against the search's host-clock time is the launch
    and sync overhead of the round loop."""
    from repro_torch.core import candidates as cand
    from repro_torch.core import query
    from repro_torch.kernels import ops
    f, p = index.forest, index.params
    B, n = queries.shape[0], index.n_points
    q_proj = _q_proj(index, queries)
    r = torch.full((B,), r_min, dtype=torch.float32, device=queries.device)
    cfg = query.QueryConfig(k=req.k, M=req.M, r_min=r_min)
    cap = query._auto_cap(n, p, cfg, f)
    ids, ok = query.range_query_round(f, q_proj, p.epsilon * r, req.M,
                                      bounds_impl="pallas")
    pts = index.data[torch.clamp(ids.to(torch.int64), 0, n - 1)]
    d = query.exact_distances(index.data, queries, ids, ok, impl="pallas")
    cs0 = cand.init_state(n, cap, B, queries.device)
    cs = cand.merge_round(n, cs0, torch.where(ok, ids, n), d)
    steps = {
        "leaf_bounds": lambda: ops.leaf_bounds(
            q_proj, f.leaf_lo, f.leaf_hi, f.leaf_valid, f.breakpoints),
        "range_query_round": lambda: query.range_query_round(
            f, q_proj, p.epsilon * r, req.M, bounds_impl="pallas"),
        "gather_rows": lambda: index.data[torch.clamp(ids.to(torch.int64),
                                                      0, n - 1)],
        "l2_rerank": lambda: ops.l2_rerank(queries[:, None, :], pts),
        "init_state": lambda: cand.init_state(n, cap, B, queries.device),
        "merge_round": lambda: cand.merge_round(
            n, cs0, torch.where(ok, ids, n), d),
        "t1_t2": lambda: (cs.dists <= p.c * r[:, None]).sum(1),
        "final_topk": lambda: query._topk_smallest(cs.dists, req.k),
    }
    line("vmap_breakdown", B=B, cap=cap,
         **{name: time_ms(torch, fn, warmup=1, reps=5)
            for name, fn in steps.items()})


def host_ms(torch, fn, *, reps: int = 20) -> dict:
    """Host-clock ms of ``fn``, each run ended by a device sync, over
    ``reps`` runs after one warm-up: the median, with the min and max as
    its spread."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(median=statistics.median(times), min=min(times),
                max=max(times))


def vmap_path(torch, index, queries) -> tuple:
    """The per-query engine on the main path's index and queries."""
    import repro_torch.api as api
    from repro_torch.baselines.brute_force import BruteForce
    from repro_torch.kernels import l2_rerank as l2k
    from repro_torch.kernels import leaf_bounds as lbk
    kern_impl = dict(bounds_impl="pallas", dist_impl="pallas")
    plain_impl = dict(bounds_impl="pallas_interpret",
                      dist_impl="pallas_interpret")
    c = index.params.c
    max_sq = float((index.data * index.data).sum(-1).max())
    req = api.SearchRequest(k=50, engine="vmap", **kern_impl)

    def counts() -> dict:
        return {"leaf_bounds": lbk.leaf_bounds.launches,
                "l2_rerank": l2k.l2_rerank.launches}

    lbk.leaf_bounds.launches = 0
    l2k.l2_rerank.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = index.search(queries, req)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the vmap path never launched: {launches}")
    require(res.stats.engine == "vmap", "engine='vmap' did not run vmap")

    # The estimated r_min overshoots at n = 1M, so the runs above stop in
    # round 1; started at the true k-NN scale / c^2 the lanes run several
    # rounds (merge into set bitmaps, stopped lanes masked, radius growth).
    gt_ids, gt_d = BruteForce(index.data).query(queries, req.k)
    r_scale = float(gt_d[:, -1].median()) / (c * c)
    scaled = dict(k=50, r_min=r_scale, **kern_impl)
    runs = {"B100": (queries, req),
            "B1_auto": (queries[:1], api.SearchRequest(k=50, engine="auto",
                                                       **kern_impl)),
            "B7_auto": (queries[:7], api.SearchRequest(k=50, engine="auto",
                                                       **kern_impl)),
            "B7_strict": (queries[:7], api.SearchRequest(
                k=50, engine="auto", mode="strict", **kern_impl)),
            "B100_scaled": (queries, api.SearchRequest(engine="vmap",
                                                       **scaled)),
            "B7_auto_scaled": (queries[:7], api.SearchRequest(engine="auto",
                                                              **scaled))}
    excused, results, run_launches = {}, {}, {}
    for name, (qs, r) in runs.items():
        before = counts()
        got = res if name == "B100" else index.search(qs, r)
        after = counts()
        run_launches[name] = (launches if name == "B100" else
                              {k: after[k] - before[k] for k in after})
        require(all(v > 0 for v in run_launches[name].values()),
                f"{name}: the vmap kernels did not launch")
        require(got.stats.engine == "vmap",
                f"{name}: resolved to {got.stats.engine}, not vmap")
        plain = index.search(qs, dataclasses.replace(r, **plain_impl))
        require(counts() == after,
                f"{name}: pallas_interpret launched a kernel")
        excused[name] = held_against_plain(name, got, plain, c, max_sq)
        results[name] = got

    def quality(got, n_q: int) -> dict:
        hits = (got.ids.to(torch.int64)[:, :, None]
                == gt_ids[:n_q, None, :]).any(-1).sum(-1)
        rate = (got.dists <= c * c * gt_d[:n_q] + 1e-4).all(dim=1)
        rounds = got.stats.rounds.float()
        cands = got.stats.n_candidates.float()
        return dict(rounds_mean=float(rounds.mean()),
                    rounds_max=int(rounds.max()),
                    n_candidates_mean=float(cands.mean()),
                    n_candidates_max=int(cands.max()),
                    recall_at_50=float(hits.float().mean()) / req.k,
                    c2_guarantee_rate=float(rate.float().mean()))

    for name in ("B100_scaled", "B7_auto_scaled"):
        q_stats = quality(results[name], runs[name][0].shape[0])
        require(q_stats["rounds_max"] >= 2,
                f"{name}: no lane ran a second round at r_min={r_scale}")
        line("vmap_scaled_r_min", run=name, r_min=r_scale,
             launches=run_launches[name], **q_stats,
             lanes_differing_at_a_tie=excused[name])

    warm_ms = {}
    for B in (1, 7, 100):
        for impl in ("pallas", "auto"):
            r = api.SearchRequest(k=50, engine="vmap" if B == 100 else "auto",
                                  bounds_impl=impl, dist_impl=impl)
            warm_ms[f"B{B}_{impl}"] = host_ms(
                torch, lambda: index.search(queries[:B], r))
    warm_ms["B100_scaled_pallas"] = host_ms(
        torch, lambda: index.search(queries, runs["B100_scaled"][1]))

    vmap_breakdown(torch, index, queries, res.stats.r_min, req)
    line("vmap_path", B=queries.shape[0], k=req.k, M=req.M,
         r_min=res.stats.r_min, first_search_ms=first_ms, warm_ms=warm_ms,
         **quality(res, queries.shape[0]),
         lanes_differing_at_a_tie=excused, launches=launches)
    return res, req, launches


def tile_share(torch, admit, ls: int) -> float:
    """The share of range_rerank's warp tiles (16 queries x one 64-point
    column) that hold an admitted (query, leaf) pair and so run mmas, of
    those that exist; admit (L, B, nl) bool.  Columns start at multiples
    of 64 points (a block's tile is a whole number of columns), and a
    column's pairs are those of every leaf it overlaps."""
    L, B, nl = admit.shape
    npts = nl * ls
    cols = torch.arange(0, npts, 64, device=admit.device)
    lo = cols // ls
    hi = (torch.clamp(cols + 64, max=npts) - 1) // ls
    csum = torch.nn.functional.pad(admit.to(torch.int32).cumsum(-1), (1, 0))
    col_any = (csum[..., hi + 1] - csum[..., lo]) > 0          # (L, B, nc)
    pad = (-B) % 16
    col_any = torch.nn.functional.pad(col_any, (0, 0, 0, pad))
    tiles = col_any.reshape(L, (B + pad) // 16, 16, -1).any(2)
    return float(tiles.float().mean())


def check_range_rerank(torch, index, queries, final_r, probe_depth: int,
                       timed: bool, tag: str = "last round") -> dict:
    from repro_torch.kernels import range_rerank as rr
    from repro_torch.kernels import ref
    f, plan, p = index.forest, index.fused_plan(), index.params
    B = queries.shape[0]
    q_proj = _q_proj(index, queries)
    r_eff = p.epsilon * final_r                          # the last round
    if probe_depth:
        r_adm = ref.probe_radii(q_proj, f.leaf_lo, f.leaf_hi, f.leaf_valid,
                                f.breakpoints, r_eff, probe_depth)
    else:
        r_adm = r_eff.expand(p.L, B).contiguous()
    args = (queries, q_proj, r_adm, f.leaf_lo, f.leaf_hi, f.leaf_valid,
            f.breakpoints, plan.points_sorted, f.valid, f.valid)
    got = rr.range_rerank(*args, leaf_size=f.leaf_size)
    want = ref.range_rerank(*args, leaf_size=f.leaf_size)
    torch.cuda.synchronize()
    require(torch.equal(torch.isinf(got), torch.isinf(want)),
            f"range_rerank probe_depth={probe_depth}: +inf masks differ")
    fin = torch.isfinite(want)
    max_sq = float((index.data * index.data).sum(-1).max())
    err = (got[fin] - want[fin]).abs()
    tol = 1e-4 * want[fin].abs() + 1e-4 * max_sq
    require(bool((err <= tol).all()),
            f"range_rerank probe_depth={probe_depth}: finite entries outside "
            f"tolerance (max err {float(err.max())})")
    max_err = float(err.max()) if err.numel() else 0.0
    lb = ref.forest_leaf_lb(q_proj, f.leaf_lo, f.leaf_hi, f.leaf_valid,
                            f.breakpoints)
    admit = (lb <= r_adm[..., None]) & f.leaf_valid[:, None, :]
    pairs = int(admit.sum())
    leaves_read = int(admit.any(dim=1).sum())
    L, nl, K = f.leaf_lo.shape
    d, ls, E = queries.shape[1], f.leaf_size, f.breakpoints.shape[2]
    npts = nl * ls
    nbytes = (4 * B * d + 4 * L * B * K + 4 * L * B + 2 * 4 * L * nl * K
              + L * nl + 4 * L * K * E + 4 * leaves_read * ls * d
              + 2 * L * npts + 4 * L * B * npts)
    flops = 6 * L * B * nl * K + 2 * d * ls * pairs
    bms, by = bound_ms(nbytes, flops)
    out = dict(radius=tag, probe_depth=probe_depth, mask_identical=True,
               max_abs_err=max_err, finite=int(fin.sum()),
               admitted_pairs=pairs,
               admitted_pair_share=pairs / float(admit.numel()),
               computed_tile_share=tile_share(torch, admit, f.leaf_size),
               leaves_read=leaves_read, bound_ms=bms, bound_by=by,
               bytes=nbytes, flops=flops)
    del got, want, fin, err, tol
    if timed:
        out["ms"] = time_ms(torch, lambda: rr.range_rerank(
            *args, leaf_size=f.leaf_size))
        out["plain_ms"] = time_ms(torch, lambda: ref.range_rerank(
            *args, leaf_size=f.leaf_size), warmup=1, reps=10)
    line("range_rerank", **out)
    return out


def search_breakdown(torch, index, queries, final_r, k: int) -> None:
    """CUDA-event ms of each step of one fused round (the main path's last
    radius) and of the final top-k, run one at a time."""
    from repro_torch.core import query
    from repro_torch.kernels import ops
    f, plan, p = index.forest, index.fused_plan(), index.params
    B, n = queries.shape[0], index.n_points
    q_proj = _q_proj(index, queries)
    r_eff = p.epsilon * final_r

    def rerank():
        return ops.range_rerank(queries, q_proj, r_eff, f.leaf_lo, f.leaf_hi,
                                f.leaf_valid, f.breakpoints,
                                plan.points_sorted, f.valid,
                                leaf_size=f.leaf_size)

    dmat = rerank()
    by_id = query.fold_by_id(dmat, plan.inv_perm)
    best = torch.full((B, n), float("inf"), device="cuda")
    done = torch.zeros((B,), dtype=torch.bool, device="cuda")
    rounds = torch.zeros((B,), dtype=torch.int32, device="cuda")
    thresh = torch.tensor(p.beta * n + k, dtype=torch.float32, device="cuda")
    steps = {
        "range_rerank": rerank,
        "fold_inv_perm": lambda: query.fold_by_id(dmat, plan.inv_perm),
        "round_update": lambda: query.fused_round_update(
            best, by_id, final_r, done, rounds, 0, params=p, k=k,
            thresh=thresh),
        "topk": lambda: query.fused_topk(by_id, k, n),
    }
    line("search_breakdown", **{name: time_ms(torch, fn, warmup=1, reps=5)
                                for name, fn in steps.items()})


def main_path(torch, n: int, B: int) -> tuple:
    import repro_torch.api as api
    from repro_torch import datasets
    from repro_torch.baselines.brute_force import BruteForce
    from repro_torch.core.theory import SUCCESS_PROBABILITY
    from repro_torch.kernels import build_fused, range_rerank

    t0 = time.perf_counter()
    data = datasets.sift_like(n, 128, seed=0)
    queries_np = datasets.perturbed_queries(data, B, seed=1)
    data_s = time.perf_counter() - t0
    spec = api.IndexSpec(kind="static", K=16, L=4, c=1.5, beta_override=0.1,
                         Nr=256, leaf_size=64)
    req = api.SearchRequest(k=50, engine="fused")

    build_fused.encode_pack.launches = 0
    range_rerank.range_rerank.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = api.build(data, torch.Generator().manual_seed(0), spec,
                      device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = index.search(queries_np, req)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    res2 = index.search(queries_np, req)
    torch.cuda.synchronize()
    search_ms = (time.perf_counter() - t0) * 1e3
    launches = {"encode_pack": build_fused.encode_pack.launches,
                "range_rerank": range_rerank.range_rerank.launches}
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    require(torch.equal(res.ids, res2.ids) and torch.equal(res.dists,
                                                           res2.dists),
            "two searches of one batch disagree")

    queries = torch.tensor(queries_np, device="cuda")
    gt_ids, gt_d = BruteForce(index.data).query(queries, req.k)
    ids = res2.ids.to(torch.int64)
    hits = (ids[:, :, None] == gt_ids[:, None, :]).any(-1).sum(-1)
    recall = float(hits.float().mean()) / req.k
    c2 = index.params.c ** 2
    held = (res2.dists <= c2 * gt_d + 1e-4).all(dim=1)
    rate = float(held.float().mean())
    require(rate >= SUCCESS_PROBABILITY,
            f"c^2 guarantee held on {rate:.3f} < {SUCCESS_PROBABILITY:.3f}")
    rounds = res2.stats.rounds.float()
    cands = res2.stats.n_candidates.float()

    # The same batch started one c^2 step below the true k-NN distance
    # scale, where the radius rounds, and not the first, do the work.
    r_scale = float(gt_d[:, -1].median()) / c2
    scaled = api.SearchRequest(k=req.k, engine="fused", r_min=r_scale)
    index.search(queries, scaled)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res3 = index.search(queries, scaled)
    torch.cuda.synchronize()
    scaled_ms = (time.perf_counter() - t0) * 1e3
    hits3 = (res3.ids.to(torch.int64)[:, :, None]
             == gt_ids[:, None, :]).any(-1).sum(-1)
    rate3 = float((res3.dists <= c2 * gt_d + 1e-4).all(dim=1).float().mean())
    require(rate3 >= SUCCESS_PROBABILITY,
            f"c^2 guarantee at r_min={r_scale}: {rate3:.3f}")
    line("main_path_scaled_r_min", r_min=r_scale, search_ms=scaled_ms,
         rounds_mean=float(res3.stats.rounds.float().mean()),
         rounds_max=int(res3.stats.rounds.max()),
         n_candidates_mean=float(res3.stats.n_candidates.float().mean()),
         n_candidates_max=int(res3.stats.n_candidates.max()),
         recall_at_50=float(hits3.float().mean()) / req.k,
         c2_guarantee_rate=rate3)

    line("main_path", n=n, d=128, B=B, k=req.k, data_seconds=data_s,
         build_seconds=build_s, build_stages=index.build_seconds,
         first_search_ms=first_ms, search_ms=search_ms,
         r_min=res2.stats.r_min, rounds_mean=float(rounds.mean()),
         rounds_max=int(rounds.max()), n_candidates_mean=float(cands.mean()),
         n_candidates_max=int(cands.max()), recall_at_50=recall,
         c2_guarantee_rate=rate, success_bound=SUCCESS_PROBABILITY,
         launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return index, queries, res2, req, launches, res3


def check_persist(torch, index, queries, searches) -> None:
    """save -> load -> search is bit-identical for every (result, request)
    of ``searches``."""
    import repro_torch.api as api
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snapshot")
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = api.load(path, device="cuda")
        load_s = time.perf_counter() - t0
        for res, req in searches:
            again = loaded.search(queries, req)
            require(torch.equal(again.ids, res.ids)
                    and torch.equal(again.dists, res.dists),
                    f"save -> load -> search ({req.engine}) is not "
                    f"bit-identical")
    line("persist", bit_identical=True, save_seconds=save_s,
         load_seconds=load_s)


def check_project_encode_pack(torch, x, K: int, L: int, Nr: int,
                              case: str) -> dict:
    """The seal's kernel against its plain version on rows ``x`` (n, d) of
    the card: all four outputs bit-identical (the projection is summed in
    the same d order).  The unfused pair, torch.matmul then the
    encode_pack kernel, is timed beside it as a yardstick."""
    from repro_torch.core.encoding import breakpoints_sample_sort
    from repro_torch.kernels import build_fused, ref
    n, d = x.shape
    D = L * K
    gen = torch.Generator(device="cuda").manual_seed(K * 100 + L + 7)
    a = torch.randn((d, D), generator=gen, device="cuda")
    bp = breakpoints_sample_sort(x @ a, Nr)
    got = build_fused.project_encode_pack(x, a, bp, K=K, L=L)
    want = ref.project_encode_pack(x, a, bp, K=K, L=L)
    max_err = 0.0
    for name, g, w in zip(("proj_t", "codes_t", "key_hi", "key_lo"), got,
                          want):
        require(g.dtype == w.dtype and g.shape == w.shape,
                f"project_encode_pack {case}: {name} has another dtype or "
                f"shape")
        max_err = max(max_err, float((g.double() - w.double()).abs().max()))
        require(torch.equal(g, w),
                f"project_encode_pack {case}: {name} differs from the plain "
                f"version (max err {max_err})")
    del got, want
    ms = time_ms(torch, lambda: build_fused.project_encode_pack(
        x, a, bp, K=K, L=L))
    plain = time_ms(torch, lambda: ref.project_encode_pack(x, a, bp, K=K,
                                                           L=L),
                    warmup=1, reps=3)
    unfused = time_ms(torch, lambda: build_fused.encode_pack(
        torch.matmul(x, a), bp, K=K, L=L))
    nbytes = (4 * n * d + 4 * d * D + 4 * D * (Nr + 1) + (4 + 4) * n * D
              + 2 * 8 * L * n)
    flops = 2 * n * d * D + n * D * math.ceil(math.log2(Nr))
    bms, by = bound_ms(nbytes, flops)
    out = dict(case=case, n=n, d=d, K=K, L=L, bit_identical=True,
               max_abs_err=max_err, ms=ms, plain_ms=plain, unfused_ms=unfused,
               bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops)
    line("project_encode_pack", **out)
    return out


def check_lsh_project(torch, x, a, case: str) -> dict:
    """The projection kernel against its plain version on x (n, d) and
    a (d, m) of the card: bit-identical (both sum in d order);
    torch.matmul with TF32 off timed beside it as the library call."""
    from repro_torch.kernels import lsh_project as lpk
    from repro_torch.kernels import ref
    got = lpk.lsh_project(x, a)
    want = ref.lsh_project(x, a)
    max_err = float((got.double() - want.double()).abs().max())
    require(got.dtype == want.dtype and torch.equal(got, want),
            f"lsh_project {case}: differs from the plain version (max err "
            f"{max_err})")
    del got, want
    n, d = x.shape
    m = a.shape[1]
    ms = time_ms(torch, lambda: lpk.lsh_project(x, a))
    plain = time_ms(torch, lambda: ref.lsh_project(x, a), warmup=1, reps=3)
    library = time_ms(torch, lambda: torch.matmul(x, a))
    nbytes = 4 * (n * d + d * m + n * m)
    flops = 2 * n * d * m
    bms, by = bound_ms(nbytes, flops)
    out = dict(case=case, n=n, d=d, m=m, bit_identical=True,
               max_abs_err=max_err, ms=ms, plain_ms=plain, library_ms=library,
               bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops)
    line("lsh_project", **out)
    return out


def check_encode_bins(torch, coords, bp) -> dict:
    """The encode kernel against its plain version on coords (n, D) and
    breakpoints (D, Nr+1) of the card: bit-identical.  The library call is
    one torch.searchsorted of the transposed coordinates into the inner
    edges, plus the clamp (the transposes are made before the timing)."""
    from repro_torch.kernels import encode_bins as ebk
    from repro_torch.kernels import ref
    got = ebk.encode_bins(coords, bp)
    want = ref.encode_bins(coords, bp)
    max_err = float((got.double() - want.double()).abs().max())
    require(got.dtype == want.dtype and torch.equal(got, want),
            f"encode_bins: differs from the plain version (max err "
            f"{max_err})")
    del got, want
    n, D = coords.shape
    Nr = bp.shape[1] - 1
    inner = bp[:, 1:Nr].contiguous()
    coords_t = coords.T.contiguous()
    ms = time_ms(torch, lambda: ebk.encode_bins(coords, bp))
    plain = time_ms(torch, lambda: ref.encode_bins(coords, bp), warmup=1,
                    reps=5)
    library = time_ms(torch, lambda: torch.clamp(torch.searchsorted(
        inner, coords_t, right=True), 0, Nr - 1))
    nbytes = 4 * n * D + 4 * D * (Nr + 1) + 4 * n * D
    flops = n * D * math.ceil(math.log2(Nr))          # one compare per step
    bms, by = bound_ms(nbytes, flops)
    out = dict(n=n, D=D, Nr=Nr, bit_identical=True, max_abs_err=max_err,
               ms=ms, plain_ms=plain, library_ms=library, bound_ms=bms,
               bound_by=by, bytes=nbytes, flops=flops)
    line("encode_bins", **out)
    return out


def _same_answers(torch, got, want) -> bool:
    return (torch.equal(got.ids, want.ids)
            and torch.equal(got.dists, want.dists)
            and all(torch.equal(getattr(got.stats, f),
                                getattr(want.stats, f))
                    for f in ("rounds", "n_candidates", "final_r")))


def pdet_breakdown(torch, pdet, queries, r_min: float) -> None:
    """CUDA-event ms of each step of one pdet round for shard 0 of
    ``pdet`` (a round repeats the first four steps on every shard) at the
    radius ``r_min``, one step at a time."""
    from repro_torch.core.distributed import _fold_shard
    from repro_torch.kernels import ops
    p, sh = pdet.params, pdet.layout.shards[0]
    q_proj = _q_proj(pdet, queries)
    r_eff = torch.full((queries.shape[0],), p.epsilon * r_min,
                       device=queries.device)

    def rerank():
        return ops.range_rerank(queries, q_proj, r_eff, sh.leaf_lo,
                                sh.leaf_hi, sh.leaf_valid, sh.breakpoints,
                                sh.points, sh.valid,
                                leaf_size=pdet.forest.leaf_size)

    dmat = rerank()
    part = _fold_shard(dmat, sh)
    steps = {"range_rerank": rerank,
             "count_scanned": lambda: torch.isfinite(dmat).sum(),
             "fold_inv_perm": lambda: _fold_shard(dmat, sh),
             "merge_minimum": lambda: torch.minimum(part, part)}
    line("pdet_breakdown", S=pdet.n_shards, shard_positions=sh.points.shape[1],
         **{name: time_ms(torch, fn, warmup=1, reps=5)
            for name, fn in steps.items()})


def pdet_path(torch, data, queries) -> dict:
    """The sharded PDET index at SIFT1M's shape, built through the paper's
    per-tree builder with lsh_project and encode_bins, held bit for bit
    against the fused engine on the same index at 1, 3 and 4 shards."""
    import repro_torch.api as api
    from repro_torch.baselines.brute_force import BruteForce
    from repro_torch.core import DETLSH
    from repro_torch.core.detree import build_forest
    from repro_torch.core.distributed import PDETIndex
    from repro_torch.core.theory import SUCCESS_PROBABILITY
    from repro_torch.kernels import range_rerank as rrk
    from repro_torch.launch.mesh import mesh_from_placement
    spec = api.IndexSpec(kind="static", K=16, L=4, c=1.5, beta_override=0.1,
                         Nr=256, leaf_size=64, project_impl="pallas",
                         build_impl="reference", encode_impl="pallas",
                         placement=api.PlacementSpec(mesh_shape=(1,)))
    cuda = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pdet1 = api.build(data, torch.Generator().manual_seed(0), spec)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = _stream_counts()
    require(isinstance(pdet1, PDETIndex) and pdet1.n_shards == 1,
            "a placed spec did not build a one-shard PDETIndex")
    require(build_launches["lsh_project"] == 1
            and build_launches["encode_bins"] == 1
            and build_launches["encode_pack"] == 0,
            f"the reference-builder build launched {build_launches}")

    # The builders agree: the fused builder's forest from the same
    # projection and breakpoints (through encode_pack), dtypes included.
    from repro_torch.kernels import lsh_project as lpk
    p = pdet1.params
    proj = lpk.lsh_project(pdet1.data, pdet1.A)
    bp = pdet1.forest.breakpoints.reshape(p.L * p.K, spec.Nr + 1)
    fused_forest = build_forest(proj, p.K, p.L, Nr=spec.Nr,
                                leaf_size=spec.leaf_size, breakpoints=bp)
    for name in ("point_ids", "proj_sorted", "codes_sorted", "valid",
                 "leaf_lo", "leaf_hi", "leaf_valid", "breakpoints"):
        got, want = getattr(pdet1.forest, name), getattr(fused_forest, name)
        require(got.dtype == want.dtype and torch.equal(got, want),
                f"pdet_path: the reference builder's {name} differs from "
                f"the fused builder's")
    del proj, fused_forest

    det = DETLSH(params=p, A=pdet1.A, forest=pdet1.forest, data=pdet1.data,
                 spec=dataclasses.replace(spec, placement=None))
    det._plan = pdet1.plan
    c2 = p.c ** 2
    gt_ids, gt_d = BruteForce(det.data).query(queries, 50)
    r_scale = float(gt_d[:, -1].median()) / c2
    requests = {"estimated": api.SearchRequest(k=50),
                "scaled": api.SearchRequest(k=50, r_min=r_scale)}
    fused = {name: det.search(queries, dataclasses.replace(r, engine="fused"))
             for name, r in requests.items()}
    require(int(fused["scaled"].stats.rounds.max()) >= 2,
            f"no lane ran a second round at r_min={r_scale}")

    def placed(S: int):
        placement = api.PlacementSpec(mesh_shape=(S,))
        return PDETIndex.from_detlsh(det, placement, mesh=mesh_from_placement(
            placement, devices=[cuda] * S), spec=spec)

    shards, warm, quality = {}, {}, {}
    for S in (1, 3, 4):
        pdet = pdet1 if S == 1 else placed(S)
        torch.cuda.synchronize()
        for name, req in requests.items():
            before = rrk.range_rerank.launches
            got = pdet.search(queries, req)
            torch.cuda.synchronize()
            launched = rrk.range_rerank.launches - before
            require(got.stats.engine == "pdet",
                    f"S={S} {name}: ran {got.stats.engine}")
            require(_same_answers(torch, got, fused[name]),
                    f"S={S} {name}: pdet differs from fused on the same "
                    f"index")
            rounds_run = int(got.stats.psum_rounds)
            require(launched == S * rounds_run,
                    f"S={S} {name}: {launched} range_rerank launches for "
                    f"{rounds_run} rounds")
            hits = (got.ids.to(torch.int64)[:, :, None]
                    == gt_ids[:, None, :]).any(-1).sum(-1)
            rate = float((got.dists <= c2 * gt_d + 1e-4).all(dim=1)
                         .float().mean())
            require(rate >= SUCCESS_PROBABILITY,
                    f"S={S} {name}: c^2 guarantee held on {rate:.3f}")
            shards[f"S{S}_{name}"] = dict(
                rounds_run=rounds_run, range_rerank_launches=launched,
                shard_candidates=got.stats.shard_candidates.tolist(),
                merge_size=got.stats.merge_size,
                padded_leaves=pdet.forest.n_leaves - det.forest.n_leaves)
            quality[name] = dict(
                recall_at_50=float(hits.float().mean()) / 50,
                c2_guarantee_rate=rate,
                rounds_mean=float(got.stats.rounds.float().mean()),
                rounds_max=int(got.stats.rounds.max()),
                n_candidates_mean=float(
                    got.stats.n_candidates.float().mean()))
        if S in (1, 4):
            pdet_breakdown(torch, pdet, queries,
                           fused["estimated"].stats.r_min)
            warm[f"pdet_S{S}"] = host_ms(
                torch, lambda: pdet.search(queries, requests["estimated"]))
            warm[f"pdet_S{S}_scaled"] = host_ms(
                torch, lambda: pdet.search(queries, requests["scaled"]))
        if S == 4:
            pdet4 = pdet
        del pdet
    warm["fused"] = host_ms(torch, lambda: det.search(
        queries, dataclasses.replace(requests["estimated"], engine="fused")))
    warm["fused_scaled"] = host_ms(torch, lambda: det.search(
        queries, dataclasses.replace(requests["scaled"], engine="fused")))

    try:
        pdet4.search(queries, api.SearchRequest(k=50, engine="pdet",
                                                probe_depth=2))
        raise RuntimeError("check failed: engine='pdet' with probe_depth=2 "
                           "did not raise")
    except NotImplementedError:
        pass
    probed = pdet4.search(queries, api.SearchRequest(k=50, probe_depth=2))
    require(probed.stats.engine == "fused",
            f"'auto' with probe_depth=2 ran {probed.stats.engine}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pdet")
        t0 = time.perf_counter()
        pdet4.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = api.load(path, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    require(isinstance(loaded, PDETIndex) and loaded.n_shards == 1,
            f"the S = 4 snapshot loaded as {loaded.n_shards} shards on "
            f"{torch.cuda.device_count()} card(s), not 1")
    del pdet4
    resharded = PDETIndex.from_detlsh(
        loaded, api.PlacementSpec(mesh_shape=(4,)),
        mesh=mesh_from_placement(api.PlacementSpec(mesh_shape=(4,)),
                                 devices=[cuda] * 4))
    for name, req in requests.items():
        for which, index in (("loaded", loaded), ("resharded", resharded)):
            require(_same_answers(torch, index.search(queries, req),
                                  fused[name]),
                    f"{which} snapshot {name}: answers differ")
    del loaded, resharded
    out = dict(n=int(data.shape[0]), d=int(data.shape[1]),
               B=int(queries.shape[0]), k=50, build_seconds=build_s,
               build_stages=pdet1.build_seconds,
               build_launches=build_launches, r_min=fused[
                   "estimated"].stats.r_min, r_min_scaled=r_scale,
               shards=shards, quality=quality, warm_ms=warm,
               save_seconds=save_s, load_seconds=load_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    line("pdet_path", **out)
    return out


def _kernel_wrappers() -> dict:
    """Every kernel wrapper by name; each carries its ``launches`` count."""
    from repro_torch.kernels import build_fused, encode_bins, l2_rerank
    from repro_torch.kernels import flash_attention, leaf_bounds, lsh_project
    from repro_torch.kernels import range_rerank
    return {"encode_pack": build_fused.encode_pack,
            "project_encode_pack": build_fused.project_encode_pack,
            "range_rerank": range_rerank.range_rerank,
            "range_rerank_heads": range_rerank.range_rerank_heads,
            "leaf_bounds": leaf_bounds.leaf_bounds,
            "l2_rerank": l2_rerank.l2_rerank,
            "lsh_project": lsh_project.lsh_project,
            "encode_bins": encode_bins.encode_bins,
            "flash_attention": flash_attention.flash_attention}


def _stream_counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


def _reset_counts() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def saturating_check(torch, index, queries, k: int, c: float,
                     max_sq: float) -> dict:
    """The fused search at r_min = 1e6 admits every leaf of every segment,
    so it must return the exact top-k over the survivors (tombstones, gid
    maps, the delta and the combine together): ids equal to brute force on
    the card, except where a distance tie at the k-th place swaps an id
    (counted), and distances within 1e-4 * |d| + 1e-4 * max|x|^2."""
    import repro_torch.api as api
    from repro_torch.baselines.brute_force import BruteForce
    vecs, gids = index._survivors()
    surv = torch.tensor(vecs, device="cuda")
    gt_pos, gt_d = BruteForce(surv).query(queries, k)
    del surv
    gt_ids = torch.tensor(gids, device="cuda")[gt_pos]
    res = index.search(queries, api.SearchRequest(k=k, engine="fused",
                                                  r_min=1e6))
    got_d = res.dists.double()
    want_d = gt_d.double()
    tol = 1e-4 * want_d.abs() + 1e-4 * max_sq
    require(bool(((got_d - want_d).abs() <= tol).all()),
            f"saturating search: distances differ from brute force by "
            f"{float((got_d - want_d).abs().max())}")
    excused = 0
    for b in range(queries.shape[0]):
        got_set = set(res.ids[b].tolist())
        want_set = set(gt_ids[b].tolist())
        if got_set == want_set:
            continue
        kth = float(want_d[b, -1])
        for pos in range(k):
            if int(res.ids[b, pos]) not in want_set:
                require(abs(float(got_d[b, pos]) - kth)
                        <= 1e-4 * kth + 1e-4 * max_sq,
                        f"saturating search: lane {b} returns a point that "
                        f"is not among the survivors' top-{k}")
        excused += 1
    return dict(gt_ids=gt_ids, gt_d=gt_d, lanes_excused_at_a_tie=excused)


def streaming_path(torch, n: int) -> dict:
    """The streaming index at SIFT1M's shape under ~7% churn, through the
    entry points a user calls; every search held against its plain run."""
    import repro_torch.api as api
    from repro_torch import datasets
    from repro_torch.core.theory import SUCCESS_PROBABILITY
    cap, n_seals = 16384, 4
    data = datasets.sift_like(n, 128, seed=0)
    new = datasets.sift_like(n_seals * cap + 1000, 128, seed=2)
    spec = api.IndexSpec(kind="streaming", K=16, L=4, c=1.5,
                         beta_override=0.1, Nr=256, leaf_size=64,
                         delta_capacity=cap, max_segments=4)
    c = spec.c
    max_sq = float(max((data * data).sum(-1).max(), (new * new).sum(-1).max()))
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = api.build(data, torch.Generator().manual_seed(0), spec,
                      device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    # One delta's worth of rows per upsert call, so each call seals once
    # and its stages are read from last_seal_seconds right after.
    seal_stages, upsert_s, gids_new = [], 0.0, []
    for i in range(n_seals):
        t0 = time.perf_counter()
        gids_new.append(index.upsert(new[i * cap:(i + 1) * cap]))
        torch.cuda.synchronize()
        upsert_s += time.perf_counter() - t0
        seal_stages.append(index.last_seal_seconds)
    gids_new = np.concatenate(gids_new)
    seals = _stream_counts()["project_encode_pack"]
    require(seals == n_seals
            and len({id(s) for s in seal_stages}) == n_seals,
            f"{n_seals} seals launched project_encode_pack {seals} times")
    require(len(index.manifest.segments) == 1 + n_seals
            and index.memtable.count == 0, "the upserts did not seal 4 times")

    rng = np.random.default_rng(3)
    over = rng.choice(n, 1000, replace=False)         # base gids overwritten
    fresh = np.arange(index.next_gid, index.next_gid + 1000)
    delta_gids = np.concatenate([over, fresh])
    delta_vecs = np.concatenate([data[over] + 0.01, new[n_seals * cap:]])
    t0 = time.perf_counter()
    index.upsert(delta_vecs.astype(np.float32), gids=delta_gids)
    torch.cuda.synchronize()
    upsert2_s = time.perf_counter() - t0
    require(index.memtable.count == 2000 and index.memtable.n_live == 2000,
            "2,000 upserts must stay in the delta")
    keep_base = np.setdiff1d(np.arange(n), over)
    doomed = np.concatenate([rng.choice(keep_base, 7000, replace=False),
                             rng.choice(gids_new, 2500, replace=False),
                             rng.choice(delta_gids, 500, replace=False)])
    t0 = time.perf_counter()
    deleted = index.delete(doomed)
    delete_ms = (time.perf_counter() - t0) * 1e3
    require(deleted == 10000, f"deleted {deleted} of 10,000 gids")
    require(all(s.has_tombstones for s in index.manifest.segments)
            and index.memtable.n_live == 1500,
            "tombstones must sit in every segment and in the delta")

    queries = torch.tensor(datasets.perturbed_queries(
        np.concatenate([data, new]), 100, seed=5), device="cuda")
    kern = dict(bounds_impl="pallas", dist_impl="pallas")
    plain_impl = dict(bounds_impl="pallas_interpret",
                      dist_impl="pallas_interpret")

    def requests(**r_min) -> dict:
        return {"fused_B100": (queries, api.SearchRequest(
                    k=50, engine="fused", **r_min)),
                "vmap_B100": (queries, api.SearchRequest(
                    k=50, engine="vmap", **kern, **r_min)),
                "auto_B7": (queries[:7], api.SearchRequest(
                    k=50, engine="auto", **kern, **r_min))}

    def held(stage: str, runs: dict) -> dict:
        out = {}
        for name, (qs, req) in runs.items():
            got = index.search(qs, req)
            before = _stream_counts()
            plain = index.search(qs, dataclasses.replace(req, **plain_impl))
            require(_stream_counts() == before,
                    f"{stage} {name}: pallas_interpret launched a kernel")
            want_engine = "fused" if "fused" in name else "vmap"
            require(got.stats.engine == want_engine,
                    f"{stage} {name}: ran {got.stats.engine}")
            out[name] = dict(
                result=got,
                excused=held_against_plain(f"{stage} {name}", got, plain, c,
                                           max_sq))
        return out

    def quality(res, gt_ids, gt_d, n_q: int) -> dict:
        hits = (res.ids.to(torch.int64)[:, :, None]
                == gt_ids[:n_q, None, :]).any(-1).sum(-1)
        rate = (res.dists <= c * c * gt_d[:n_q] + 1e-4).all(dim=1)
        return dict(recall_at_50=float(hits.float().mean()) / 50,
                    c2_guarantee_rate=float(rate.float().mean()),
                    rounds_mean=float(res.stats.rounds.float().mean()),
                    rounds_max=int(res.stats.rounds.max()),
                    n_candidates_mean=float(
                        res.stats.n_candidates.float().mean()))

    stages = {}
    for stage in ("churned", "compacted"):
        if stage == "compacted":
            t0 = time.perf_counter()
            require(index.maybe_compact(), "maybe_compact did not compact "
                    "5 segments > max_segments = 4")
            torch.cuda.synchronize()
            compact_s = time.perf_counter() - t0
            require(len(index.manifest.segments) == 1
                    and not index.manifest.segments[0].has_tombstones,
                    "compaction left tombstones or several segments")
        sat = saturating_check(torch, index, queries, 50, c, max_sq)
        # The estimated r_min overshoots at n = 1M and every lane stops in
        # round 1; started at the survivors' k-NN scale / c^2 the lanes run
        # several rounds (tombstoned rows across rounds, radius growth per
        # segment, T2 over the combined sources).
        r_scale = float(sat["gt_d"][:, -1].median()) / (c * c)
        runs = {**requests(),
                **{f"{name}_scaled": run for name, run
                   in requests(r_min=r_scale).items()}}
        searches = held(stage, runs)
        quality_of = {name: quality(v["result"], sat["gt_ids"], sat["gt_d"],
                                    runs[name][0].shape[0])
                      for name, v in searches.items()}
        for name in ("fused_B100", "fused_B100_scaled"):
            require(quality_of[name]["c2_guarantee_rate"]
                    >= SUCCESS_PROBABILITY,
                    f"{stage} {name}: the c^2 guarantee rate fell below "
                    f"the bound")
        for name in runs:
            if name.endswith("_scaled"):
                require(quality_of[name]["rounds_max"] >= 2,
                        f"{stage} {name}: no lane ran a second round at "
                        f"r_min={r_scale}")
        warm = {name: host_ms(torch, lambda qs=qs, req=req:
                              index.search(qs, req))
                for name, (qs, req) in runs.items()}
        stages[stage] = dict(
            segments=len(index.manifest.segments),
            n_live=index.n_live,
            lanes_excused_at_a_tie={k: v["excused"]
                                    for k, v in searches.items()},
            saturating_lanes_excused_at_a_tie=sat["lanes_excused_at_a_tie"],
            warm_ms=warm, quality=quality_of,
            r_min=searches["fused_B100"]["result"].stats.r_min,
            r_min_scaled=r_scale)
        del searches, sat

    digest = index.state_digest()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "streaming")
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = api.load(path, device="cuda")
        load_s = time.perf_counter() - t0
    require(loaded.state_digest() == digest,
            "save -> load changed the state_digest")
    for name, (qs, req) in runs.items():
        a, b = index.search(qs, req), loaded.search(qs, req)
        require(torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists),
                f"save -> load -> search ({name}) is not bit-identical")
    del loaded
    launches = {k: v for k, v in _stream_counts().items()   # this path's
                if k not in ("lsh_project", "encode_bins",
                             "range_rerank_heads", "flash_attention")}
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the streaming path never launched: {launches}")
    require(launches["project_encode_pack"] == n_seals,
            "project_encode_pack launches differ from the number of seals")

    seal_total = [s["total"] for s in seal_stages]
    seal_kernel = [s["project_encode_pack"] for s in seal_stages]
    out = dict(n=n, d=128, delta_capacity=cap, seals=len(seal_total),
               build_seconds=build_s, build_stages=index.build_seconds,
               seal_ms_median=statistics.median(seal_total) * 1e3,
               seal_ms=[t * 1e3 for t in seal_total],
               seal_kernel_share_median=statistics.median(
                   k / t for k, t in zip(seal_kernel, seal_total)),
               seal_stages_ms={k: v * 1e3
                               for k, v in seal_stages[-1].items()},
               upsert_rows_per_s=n_seals * cap / upsert_s,
               upsert_delta_rows_per_s=2000 / upsert2_s,
               delete_ms=delete_ms, compact_seconds=compact_s,
               save_seconds=save_s, load_seconds=load_s,
               digest_equal=True, stages=stages, launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    line("streaming_path", **out)
    return out


# Qwen3-1.7B's attention widths (src/repro/configs/qwen3_1_7b.py).
QWEN3_HEADS, QWEN3_KV_HEADS, QWEN3_DH = 16, 8, 128


def check_flash_attention(torch, b: int, h: int, sq: int, sk: int, dh: int,
                          causal: bool, dtype, *, timed: bool) -> dict:
    """The kernel against its plain version (blockwise online softmax) at
    one shape, within ref.flash_attention_tolerance: both accumulate in
    f32 and round once, so f32 allows 1e-5 + 1e-5 * |plain| (summation
    order) and bf16 one unit in the last place, 2^-7 * |plain|, plus 1e-3
    of the head's rms; the looser tolerances of tests/test_kernels.py (f32
    2e-3, bf16 5e-2) follow from it.  ``worst_ratio`` is the largest
    error over its bound.  Timed: CUDA-event
    ms of both and of scaled_dot_product_attention (flash or
    memory-efficient backend) on the same inputs, a yardstick the port
    never calls."""
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ops, ref
    gen = torch.Generator("cuda").manual_seed(sq + sk + dh)
    q = (torch.randn((b, h, sq, dh), generator=gen, device="cuda")
         * 0.5).to(dtype)
    k = (torch.randn((b, h, sk, dh), generator=gen, device="cuda")
         * 0.5).to(dtype)
    v = torch.randn((b, h, sk, dh), generator=gen, device="cuda").to(dtype)
    which = fak.path(sq, dh, dtype)
    before = fak.flash_attention.launches
    on_path = fak.flash_attention.paths[which]
    got = ops.flash_attention(q, k, v, causal=causal).float()
    require(fak.flash_attention.launches == before + 1,
            "ops.flash_attention did not launch the kernel")
    require(fak.flash_attention.paths[which] == on_path + 1,
            f"flash_attention did not take its {which} path")
    want = ref.flash_attention(q, k, v, causal=causal)
    allowed = ref.flash_attention_tolerance(want)
    want = want.float()
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    err = (got - want).abs()
    worst = float((err / allowed).max())
    tag = (f"flash_attention b={b} h={h} sq={sq} sk={sk} dh={dh} "
           f"causal={causal} {str(dtype).split('.')[-1]}")
    require(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    require(worst <= 1.0, f"{tag}: outside tolerance (max err "
            f"{float(err.max())}, {worst} times its bound)")
    flops = 4 * b * h * sq * sk * dh / (2 if causal else 1)
    nbytes = q.element_size() * (2 * b * h * sq * dh + 2 * b * h * sk * dh)
    t_ops = flops / (BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    out = dict(b=b, h=h, sq=sq, sk=sk, dh=dh, causal=causal, path=which,
               dtype=str(dtype).split(".")[-1], max_abs_err=float(err.max()),
               worst_ratio=worst, out_rms=float(want.square().mean().sqrt()),
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=flops, bytes=nbytes)
    del got, want, err, allowed
    if timed:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        out["ms"] = time_ms(torch, lambda: ops.flash_attention(
            q, k, v, causal=causal), warmup=1, reps=5)
        out["plain_ms"] = time_ms(torch, lambda: ref.flash_attention(
            q, k, v, causal=causal), warmup=1, reps=3)
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            out["library_ms"] = time_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal), warmup=1, reps=5)
    line("flash_attention", **out)
    return out


def sass_counts(library: str, kinds: dict, opcodes: tuple) -> dict:
    """Instructions of each opcode in the SASS of a built library's kernels
    (cuobjdump -sass), summed by kind: ``kinds`` maps a kind to a substring
    of the mangled kernel names; a kernel matching none counts under its
    own name.  Returns {kind: {opcode: count}}."""
    import re
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path(
        library))], capture_output=True, text=True, check=True).stdout
    counts: dict = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        kind = next((k for k, sub in kinds.items() if sub in name), name)
        into = counts.setdefault(kind, dict.fromkeys(opcodes, 0))
        for op in opcodes:
            into[op] += len(re.findall(rf"\b{op}\b", part))
    return counts


def mma_sass() -> dict:
    """HMMA (tensor-core) instructions in the SASS of each kernel of the
    built flash_attention library, by kernel."""
    counts = sass_counts("flash_attention", {
        k: k for k in ("flash_mma_kernel", "split_kernel", "combine_kernel",
                       "flash_simt_kernel")}, ("HMMA",))
    return {k: v["HMMA"] for k, v in counts.items()}


def kernel_sass() -> dict:
    """The redesigned kernels' instruction mix: HMMA in every instance of
    range_rerank's rerank kernel (heads x 64-point columns a block), which
    must be > 0, and in its admission kernel (none); FFMA, FMUL and FADD
    in lsh_project's kernels (f32 and bf16, 512- and 128-row blocks: one
    FFMA a feature and output; FFMA must be > 0)."""
    kinds = {f"{'heads' if h else 'single'}_cols{c}":
             f"range_rerank_kernelILb{h}ELi{c}E"
             for h in (0, 1) for c in (2, 4, 8)}
    kinds.update({f"admit_{'heads' if h else 'single'}": f"admit_kernelILb{h}E"
                  for h in (0, 1)})
    rr = sass_counts("range_rerank", kinds, ("HMMA", "FFMA"))
    rerank = [v for k, v in rr.items() if k.startswith(("single", "heads"))]
    require(len(rr) == 8 and len(rerank) == 6
            and all(v["HMMA"] > 0 for v in rerank),
            f"range_rerank: a rerank instance without HMMA in its SASS: {rr}")
    lp = sass_counts("lsh_project", {
        f"{name}_rows{rows}": f"lsh_project_kernelI{t}Li{rows // 32}E"
        for name, t in (("f32", "f"), ("bf16", "t")) for rows in (512, 128)},
        ("FFMA", "FMUL", "FADD", "HMMA"))
    require(len(lp) == 4 and all(v["FFMA"] > 0 and v["HMMA"] == 0
                                 for v in lp.values()),
            f"lsh_project: no FFMA (or a tensor-core op) in its SASS: {lp}")
    out = {"range_rerank": rr, "lsh_project": lp}
    line("kernel_sass", **out)
    return out


def _wide_forest(torch, n: int, d: int, K: int, L: int, ls: int, B: int,
                 seed: int) -> tuple:
    """A forest over n random rows of width d on the card, B queries near
    its first rows, and per-lane radii at the 5 % point of each lane's leaf
    lower bounds, so that some leaves are admitted and most are not."""
    from repro_torch.core import detree
    from repro_torch.core.query import make_fused_plan
    from repro_torch.kernels import ref
    gen = torch.Generator("cuda").manual_seed(seed)
    data = torch.randn((n, d), generator=gen, device="cuda")
    A = torch.randn((d, L * K), generator=gen, device="cuda")
    q = data[:B] + 0.3 * torch.randn((B, d), generator=gen, device="cuda")
    forest = detree.build_forest(data @ A, K, L, Nr=64, leaf_size=ls,
                                 breakpoint_method="full_sort")
    plan = make_fused_plan(data, forest)
    q_proj = (q @ A).reshape(B, L, K).permute(1, 0, 2).contiguous()
    lb = ref.forest_leaf_lb(q_proj, forest.leaf_lo, forest.leaf_hi,
                            forest.leaf_valid, forest.breakpoints)
    flat = lb.permute(1, 0, 2).reshape(B, -1)
    r = flat.kthvalue(max(1, flat.shape[1] // 20), dim=1).values
    return forest, plan.points_sorted, q, q_proj, r.contiguous()


def _held_rerank(torch, tag: str, got, want, points) -> float:
    """range_rerank's check: the same +inf mask, finite entries within
    1e-4 * |plain| + 1e-4 * max |x|^2.  Returns the largest error."""
    require(torch.equal(torch.isinf(got), torch.isinf(want)),
            f"{tag}: +inf masks differ from the plain version")
    fin = torch.isfinite(want)
    require(bool(fin.any() and (~fin).any()),
            f"{tag}: admission is all or nothing")
    max_sq = float((points * points).sum(-1).max())
    err = (got[fin] - want[fin]).abs()
    require(bool((err <= 1e-4 * want[fin].abs() + 1e-4 * max_sq).all()),
            f"{tag}: finite entries outside tolerance (max err "
            f"{float(err.max())})")
    return float(err.max())


def wide_rows(torch) -> dict:
    """The kernels at widths their first versions refused: range_rerank at
    d = 1,536, range_rerank_heads at d = 1,537, project_encode_pack at
    d = 2,048 and encode_pack at L*K = 2,048, each against its plain
    version (bit-identical where the kernel is)."""
    from repro_torch.kernels import range_rerank as rrk
    from repro_torch.kernels import ref
    out = {}
    f, pts, q, q_proj, r = _wide_forest(torch, 50_000, 1536, 16, 4, 64, 100,
                                        seed=21)
    L, B = q_proj.shape[:2]
    args = (q, q_proj, r.expand(L, B).contiguous(), f.leaf_lo, f.leaf_hi,
            f.leaf_valid, f.breakpoints, pts, f.valid, f.valid)
    got = rrk.range_rerank(*args, leaf_size=f.leaf_size)
    want = ref.range_rerank(*args, leaf_size=f.leaf_size)
    torch.cuda.synchronize()
    out["range_rerank_d1536"] = dict(
        n=50_000, B=B, max_abs_err=_held_rerank(torch, "range_rerank d=1536",
                                                got, want, pts),
        finite=int(torch.isfinite(want).sum()),
        ms=time_ms(torch, lambda: rrk.range_rerank(*args,
                                                   leaf_size=f.leaf_size)))
    del f, pts, q, q_proj, args, got, want
    parts = [_wide_forest(torch, 8192, 1537, 4, 4, 32, 2, seed=30 + h)
             for h in range(4)]
    fs = [p[0] for p in parts]
    H, ls = len(parts), fs[0].leaf_size
    hargs = (torch.stack([p[2] for p in parts]),
             torch.stack([p[3] for p in parts]),
             torch.stack([p[4] for p in parts])[:, None, :].expand(
                 H, 4, 2).contiguous(),
             *(torch.stack([getattr(x, name) for x in fs])
               for name in ("leaf_lo", "leaf_hi", "leaf_valid",
                            "breakpoints")),
             torch.stack([p[1] for p in parts]),
             torch.stack([x.valid for x in fs]),
             torch.stack([x.valid for x in fs]))
    got = rrk.range_rerank_heads(*hargs, leaf_size=ls)
    want = ref.range_rerank_heads(*hargs, leaf_size=ls)
    torch.cuda.synchronize()
    err = _held_rerank(torch, "range_rerank_heads d=1537", got, want,
                       hargs[7])
    for h in range(H):
        single = rrk.range_rerank(*(a[h] for a in hargs), leaf_size=ls)
        require(torch.equal(got[h], single),
                f"range_rerank_heads d=1537: head {h} differs from a "
                f"single-forest launch")
    out["range_rerank_heads_d1537"] = dict(
        H=H, n=8192, g=2, max_abs_err=err, heads_bit_identical=True,
        ms=time_ms(torch, lambda: rrk.range_rerank_heads(*hargs,
                                                         leaf_size=ls)))
    del parts, fs, hargs, got, want
    x = torch.randn((16384, 2048), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(40))
    out["project_encode_pack_d2048"] = check_project_encode_pack(
        torch, x, 16, 4, 256, "d=2048")
    del x
    out["encode_pack_LK2048"] = check_encode_pack(torch, 16384, K=16, L=128,
                                                  Nr=256)
    line("wide_rows", **{k: v for k, v in out.items()
                         if k.startswith("range_rerank")})
    return out


def flash_phase(torch) -> list:
    """Qwen3-1.7B's prefill widths (prefill_32k's batch 32 cut to 1) in f32
    and bf16, and decode_path's dense step shape (b = 4, sq = 1, sk =
    32,768) in f32 and bf16, timed; then tests/test_kernels.py's sweep with
    its ragged sk = 260, head widths 192 and 256 and sq = 3.  The bf16
    prefill must run tensor-core instructions (HMMA in its SASS)."""
    hmma = mma_sass()
    require(hmma.get("flash_mma_kernel", 0) > 0,
            f"no HMMA in the bf16 prefill kernel's SASS: {hmma}")
    line("flash_sass", hmma_by_kernel=hmma)
    cases = [check_flash_attention(torch, 1, QWEN3_HEADS, 32768, 32768,
                                   QWEN3_DH, True, dt, timed=True)
             for dt in (torch.float32, torch.bfloat16)]
    for dt in (torch.float32, torch.bfloat16):
        case = check_flash_attention(torch, 4, QWEN3_HEADS, 1, 32768,
                                     QWEN3_DH, False, dt, timed=True)
        require(case["path"] == "split", "the decode shape did not take "
                "the split-key path")
        cases.append(case)
    for b, h, sq, sk, dh in ((1, 2, 128, 128, 64), (2, 1, 100, 260, 32),
                             (1, 1, 128, 384, 128), (1, 2, 130, 200, 192),
                             (2, 2, 64, 300, 256), (4, 16, 3, 1000, 128)):
        for causal in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                cases.append(check_flash_attention(
                    torch, b, h, sq, sk, dh, causal, dt, timed=False))
    return cases


def dense_decode(torch, q, k_cache, v_cache, length: int):
    """Exact decode attention through the flash_attention kernel: q
    (b, 1, h, dh) against cache positions 0..length-1, kv head kv repeated
    for its g query heads kv*g .. kv*g+g-1."""
    from repro_torch.kernels import ops
    b, _, h, dh = q.shape
    g = h // k_cache.shape[2]

    def heads(c):
        return c[:, :length].permute(0, 2, 1, 3).repeat_interleave(g, dim=1)

    out = ops.flash_attention(q.permute(0, 2, 1, 3), heads(k_cache),
                              heads(v_cache), causal=False)
    return out.permute(0, 2, 1, 3).reshape(b, 1, h, dh)


def _cosine(a, b) -> float:
    a = a.reshape(-1, a.shape[-1]).double()
    b = b.reshape(-1, b.shape[-1]).double()
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)
                                     + 1e-30)).mean())


def check_range_rerank_heads(torch, index, q) -> dict:
    """The heads kernel at the decode forest's shapes and the first round's
    radius (eps * the estimated r_min) against its plain version (identical
    +inf mask, finite entries within range_rerank's tolerance), and every
    head bit-identical to a single-forest launch on that head's arrays."""
    from repro_torch.kernels import range_rerank as rrk
    from repro_torch.kernels import ref
    f, H, L, n = index.forest, index.H, index.spec.L, index.n_sealed
    g = q.shape[2] // index.hk
    inp = index.round_inputs(q)
    q_aug, q_proj = inp.q_aug, inp.q_proj
    K = q_proj.shape[-1]
    r_min = index._estimate_r_min(q_aug)
    r_eff = torch.full((H, L, g), index.params.epsilon * r_min,
                       device="cuda")
    args = (q_aug, q_proj, r_eff, f.leaf_lo, f.leaf_hi, f.leaf_valid,
            f.breakpoints, f.points_sorted, f.valid, inp.live_sorted)
    ls = index.spec.leaf_size
    got = rrk.range_rerank_heads(*args, leaf_size=ls)
    want = ref.range_rerank_heads(*args, leaf_size=ls)
    torch.cuda.synchronize()
    require(torch.equal(torch.isinf(got), torch.isinf(want)),
            "range_rerank_heads: +inf masks differ from the plain version")
    fin = torch.isfinite(want)
    max_sq = float((f.points_sorted ** 2).sum(-1).max())
    err = (got[fin] - want[fin]).abs()
    require(bool((err <= 1e-4 * want[fin].abs() + 1e-4 * max_sq).all()),
            f"range_rerank_heads: finite entries outside tolerance (max err "
            f"{float(err.max())})")
    for h in range(H):
        single = rrk.range_rerank(*(a[h] for a in args), leaf_size=ls)
        require(torch.equal(got[h], single),
                f"range_rerank_heads: head {h} differs from a single-forest "
                f"launch")
    lb = torch.stack([ref.forest_leaf_lb(q_proj[h], f.leaf_lo[h],
                                         f.leaf_hi[h], f.leaf_valid[h],
                                         f.breakpoints[h])
                      for h in range(H)])                   # (H, L, g, nl)
    admit = (lb <= r_eff[..., None]) & f.leaf_valid[:, :, None, :]
    pairs = int(admit.sum())
    leaves_read = int(admit.any(dim=2).sum())
    nl = f.leaf_lo.shape[2]
    d, E = q_aug.shape[-1], f.breakpoints.shape[-1]
    npts = nl * ls
    nbytes = H * (4 * g * d + 4 * L * g * K + 4 * L * g + 2 * 4 * L * nl * K
                  + L * nl + 4 * L * K * E + 2 * L * npts + 4 * L * g * npts
                  ) + 4 * leaves_read * ls * d
    flops = 6 * H * L * g * nl * K + 2 * d * ls * pairs
    bms, by = bound_ms(nbytes, flops)
    out = dict(H=H, L=L, g=g, n=n, d=d, r_min=r_min, mask_identical=True,
               heads_bit_identical=True, max_abs_err=float(err.max()),
               finite=int(fin.sum()), admitted_pairs=pairs,
               leaves_read=leaves_read, bound_ms=bms, bound_by=by,
               bytes=nbytes, flops=flops)
    del got, want, fin, err
    out["ms"] = time_ms(torch, lambda: rrk.range_rerank_heads(
        *args, leaf_size=ls))
    out["plain_ms"] = time_ms(torch, lambda: ref.range_rerank_heads(
        *args, leaf_size=ls), warmup=1, reps=3)
    line("range_rerank_heads", **out)
    return out


def decode_breakdown(torch, index, q, k_cache, v_cache, length: int,
                     window: int, sinks: int) -> None:
    """CUDA-event ms of the parts of a decode step at the index's final
    state: a whole retrieval (host syncs included), its pieces (the round
    inputs: query transform, projection, live mask in sorted order, fold
    index; one range_rerank_heads round, the fold through inv_perm, the
    T1/T2 update, the final top-k), and the sparse attention
    over the retrieved table."""
    from repro_torch.core import query
    from repro_torch.decode import sparse_decode_attention
    from repro_torch.decode.kv_index import _RoundParams
    from repro_torch.kernels import ops
    f, H, n = index.forest, index.H, index.n_sealed
    g = q.shape[2] // index.hk
    inp = index.round_inputs(q)
    r = torch.full((H * g,), index._estimate_r_min(inp.q_aug), device="cuda")
    r_eff = (index.params.epsilon * r).reshape(H, g)

    def rerank():
        return ops.range_rerank_heads(
            inp.q_aug, inp.q_proj, r_eff, f.leaf_lo, f.leaf_hi, f.leaf_valid,
            f.breakpoints, f.points_sorted, f.valid, inp.live_sorted,
            leaf_size=index.spec.leaf_size)

    fold = inp.fold
    dmat = rerank()
    by_id = torch.gather(dmat, 3, fold).amin(dim=1).reshape(H * g, n)
    best = torch.full((H * g, n), float("inf"), device="cuda")
    done = torch.zeros((H * g,), dtype=torch.bool, device="cuda")
    rounds = torch.zeros((H * g,), dtype=torch.int32, device="cuda")
    thresh = torch.tensor(index.params.beta * n + index.spec.m_top,
                          device="cuda")
    positions = index.retrieve(q).ids.reshape(index.b, index.hk, g, -1)
    steps = {
        "retrieve": lambda: index.retrieve(q),
        "round_inputs": lambda: index.round_inputs(q),
        "range_rerank_heads": rerank,
        "fold_inv_perm": lambda: torch.gather(dmat, 3, fold).amin(dim=1),
        "round_update": lambda: query.fused_round_update(
            best, by_id, r, done, rounds, 0,
            params=_RoundParams(c=index.params.c), k=index.spec.m_top,
            thresh=thresh),
        "topk": lambda: query.fused_topk(by_id, index.spec.m_top, n),
        "sparse_attention": lambda: sparse_decode_attention(
            q, k_cache, v_cache, positions, length, window=window,
            sinks=sinks),
    }
    line("decode_breakdown", **{name: time_ms(torch, fn, warmup=1, reps=5)
                                for name, fn in steps.items()})


def _planted_query(torch, k_cache, pos: int, g: int, scale: float):
    """Decode queries aligned with the key at ``pos`` in every kv head."""
    b, _, hk, dh = k_cache.shape
    return (k_cache[:, pos][:, :, None, :].expand(b, hk, g, dh)
            .reshape(b, 1, hk * g, dh) * scale).contiguous()


def decode_path(torch, *, b: int = 4, S: int = 32768, steps: int = 256
                ) -> dict:
    """LSH decode over one attention layer's KV cache at Qwen3-1.7B's
    widths (decode_32k's batch 128 cut to b), through KVCacheIndex.prefill
    and LSHDecoder.step, beside a dense decode step through the
    flash_attention kernel."""
    from repro_torch.decode import (KVCacheIndex, KVSpec, LSHDecoder,
                                    sparse_decode_attention)
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ops
    hk, dh = QWEN3_KV_HEADS, QWEN3_DH
    g = QWEN3_HEADS // hk
    window, sinks, refresh = 64, 4, 12        # benchmarks/decode_throughput.py
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    k_cache = torch.tensor((rng.standard_normal((b, S, hk, dh)) * 0.3)
                           .astype(np.float32), device="cuda")
    v_cache = torch.tensor(rng.standard_normal((b, S, hk, dh))
                           .astype(np.float32), device="cuda")
    data_s = time.perf_counter() - t0
    prefill = S - steps
    spec = KVSpec()
    targets = rng.integers(0, prefill, steps // refresh + 1)
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = KVCacheIndex.prefill(k_cache[:, :prefill],
                                 torch.Generator().manual_seed(0), spec,
                                 device="cuda")
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = _stream_counts()
    require(prefill_launches["encode_pack"] == index.H,
            f"prefill launched encode_pack {prefill_launches['encode_pack']} "
            f"times for {index.H} heads")
    retrievals, seal_ms, tables = [], [], []
    retrieve, seal = index.retrieve, index._seal

    def timed_retrieve(q, r_min=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = retrieve(q, r_min)
        rounds = int(res.rounds.max())           # the loop's round count
        retrievals.append(((time.perf_counter() - t) * 1e3, rounds))
        tables.append(res.ids)                   # read after the run
        return res

    def timed_seal():
        torch.cuda.synchronize()
        t = time.perf_counter()
        seal()
        torch.cuda.synchronize()
        seal_ms.append((time.perf_counter() - t) * 1e3)

    index.retrieve, index._seal = timed_retrieve, timed_seal
    dec = LSHDecoder(index, window=window, sinks=sinks,
                     refresh_every=refresh)
    step_ms, dense_ms, cos = [], [], []
    split_before = fak.flash_attention.paths["split"]
    for t in range(steps):
        length = prefill + t + 1
        q = _planted_query(torch, k_cache, int(targets[t // refresh]), g,
                           16.0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = dec.step(q, k_cache, v_cache, k_cache[:, length - 1], length)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dense = dense_decode(torch, q, k_cache, v_cache, length)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        step_ms.append((t2 - t1) * 1e3)
        dense_ms.append((t3 - t2) * 1e3)
        cos.append(_cosine(out, dense))
    launches = _stream_counts()
    dense_split = fak.flash_attention.paths["split"] - split_before
    index.retrieve, index._seal = retrieve, seal
    rounds_total = sum(r for _, r in retrievals)
    require(launches["range_rerank_heads"] == rounds_total > 0,
            f"range_rerank_heads launched {launches['range_rerank_heads']} "
            f"times for {rounds_total} retrieval rounds")
    require(launches["range_rerank"] == 0,
            "the decode path launched the single-forest range_rerank")
    require(launches["flash_attention"] == steps == dense_split,
            "the dense decode steps did not all launch flash_attention's "
            "split-key path")
    require(index.seals == steps // spec.delta_capacity == len(seal_ms),
            f"{index.seals} seals in {steps} steps")
    require(launches["encode_pack"] == index.H * (1 + index.seals),
            "encode_pack did not launch once a head at prefill and seals")
    require(dec.n_refreshes == len(retrievals) == -(-steps // refresh),
            "retrievals differ from the refresh schedule")
    require(all(math.isfinite(c) for c in cos), "a non-finite decode output")
    minus1 = _minus1_lanes(torch, tables, spec.m_top)

    # Checks after the run (launches here are not the path's).
    length = prefill + steps
    q = _planted_query(torch, k_cache, int(targets[-1]), g, 16.0)
    heads = check_range_rerank_heads(torch, index, q)
    decode_breakdown(torch, index, q, k_cache, v_cache, length, window,
                     sinks)
    wide = _wide_radius_check(torch, index, q)
    hits = []
    for _ in range(8):
        pos = int(rng.integers(0, index.n_sealed))
        res = index.retrieve(_planted_query(torch, k_cache, pos, g, 4.0))
        hits.append(float((res.ids == pos).any(-1).float().mean()))
    positions = torch.arange(length, dtype=torch.int32, device="cuda")
    all_pos = sparse_decode_attention(
        q, k_cache, v_cache,
        positions.expand(b, hk, g, length), length, window=window,
        sinks=sinks)
    dense = dense_decode(torch, q, k_cache, v_cache, length)
    all_err = float((all_pos - dense).abs().max())
    require(all_err <= 1e-4, f"sparse attention over every position differs "
            f"from dense attention by {all_err}")
    del all_pos, dense
    res = index.retrieve(q)
    ids = res.ids[res.ids >= 0].unique()
    extra = torch.tensor(rng.choice(length, 1000, replace=False),
                         device="cuda")
    dead = torch.cat([ids, extra[~torch.isin(extra, ids)]])[:1000]
    before = index.n_points
    require(index.delete(dead.cpu().numpy()) == 1000,
            "delete did not remove 1,000 live positions")
    require(index.n_points == before - 1000, "n_points after delete")
    res = index.retrieve(q)
    require(not bool(torch.isin(res.ids, dead).any()),
            "a deleted position came back from retrieval")
    try:
        index.save(os.path.join(tempfile.gettempdir(), "kv-unused"))
        saved = True
    except NotImplementedError:
        saved = False
    require(not saved, "KVCacheIndex.save must raise NotImplementedError")
    dense_step_ms = time_ms(
        torch, lambda: dense_decode(torch, q, k_cache, v_cache, length),
        warmup=1, reps=5)
    kh, vh = (c.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
              for c in (k_cache, v_cache))
    dense_kernel_ms = time_ms(torch, lambda: ops.flash_attention(
        q.permute(0, 2, 1, 3), kh, vh), warmup=1, reps=5)
    del kh, vh

    def spread(xs):
        return dict(median=statistics.median(xs), min=min(xs), max=max(xs))

    out = dict(
        b=b, S=S, hk=hk, g=g, dh=dh, H=index.H, prefill_positions=prefill,
        steps=steps, spec=dataclasses.asdict(spec), window=window,
        sinks=sinks, refresh_every=refresh, data_seconds=data_s,
        prefill_seconds=prefill_s, step_ms=spread(step_ms),
        dense_step_ms=spread(dense_ms), dense_step_ms_timed=dense_step_ms,
        dense_kernel_ms=dense_kernel_ms, dense_split_launches=dense_split,
        retrieval_ms=spread([m for m, _ in retrievals]),
        retrieval_rounds=[r for _, r in retrievals],
        n_refreshes=dec.n_refreshes, seal_ms=seal_ms, seals=index.seals,
        clipped_upserts=index.clip_total,
        cosine_vs_dense=dict(mean=statistics.fmean(cos), min=min(cos)),
        planted_recall=statistics.fmean(hits), all_positions_max_err=all_err,
        **minus1,
        deleted=1000, launches=launches, prefill_launches=prefill_launches,
        index_gb=index.index_size_bytes() / 1e9,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **wide)
    line("decode_path", **out)
    return dict(out, heads=heads)


def _minus1_lanes(torch, tables, m_top: int) -> dict:
    """How often a retrieved table's -1 (no candidate) reaches the sparse
    attention: clipped to position 0, it comes before the sink 0 in the
    repeat mask, so sink 0 drops out of a lane whose first -1 precedes its
    first real 0 (the reference's behaviour, which the port keeps).
    Counted over the lanes of every refresh of the run; the forest tier
    is a table's first m_top entries, the delta tier the rest."""
    ids = torch.stack(tables)                       # (refreshes, H, g, m)
    m = ids.shape[-1]
    pos = torch.arange(m, device=ids.device)

    def first(mask):
        return torch.where(mask, pos, m).amin(dim=-1)

    neg = ids < 0
    return dict(lanes_retrieved=neg[..., 0].numel(),
                lanes_holding_minus1=int(neg.any(-1).sum()),
                lanes_forest_tier_minus1=int(neg[..., :m_top].any(-1).sum()),
                lanes_sink0_masked=int((first(neg) < first(ids == 0)).sum()))


def _wide_radius_check(torch, index, q) -> dict:
    """r_min = 1e6 admits every leaf in round one, so the forest tier must
    be the exact top-m_top over augmented distances, lane by lane as sets;
    a lane may differ only by points tied with the m-th distance (within
    range_rerank's tolerance), counted."""
    H, m = index.H, index.spec.m_top
    g = q.shape[2] // index.hk
    res = index.retrieve(q, r_min=1e6)
    require(int(res.rounds.max()) == 1,
            "the wide-radius retrieval ran more than one round")
    q_aug = index.round_inputs(q).q_aug
    live = torch.tensor(index._live[:index.n_sealed], device="cuda")
    aug = torch.tensor(index._aug, device="cuda")
    exact = torch.cdist(q_aug.double(), aug.double())          # (H, g, n)
    exact[:, :, ~live] = float("inf")
    top = exact.topk(m + 1, dim=-1, largest=False)
    max_sq = float((aug.double() ** 2).sum(-1).max())
    got = res.ids[..., :m]
    excused = 0
    for h in range(H):
        for j in range(g):
            want = set(top.indices[h, j, :m].tolist())
            have = set(got[h, j].tolist())
            if want == have:
                continue
            mth = float(top.values[h, j, m - 1])
            for pos in have - want:
                require(pos >= 0 and abs(float(exact[h, j, pos]) - mth)
                        <= 1e-4 * max_sq,
                        f"wide retrieval: head {h} lane {j} holds position "
                        f"{pos}, not among the exact top-{m}")
            excused += 1
    return dict(wide_lanes=H * g, wide_lanes_excused_at_a_tie=excused)


def main() -> int:
    n = 1_000_000                   # SIFT1M's size, for every phase
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not next to this script ({exc})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    line("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, gpu=smi,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    _build.build_all()
    line("build", seconds=time.perf_counter() - t0,
         libraries=[str(_build.library_path(k).relative_to(ROOT))
                    for k in _build.KERNELS])
    kernel_sass()

    enc = check_encode_pack(torch, n, K=16, L=4, Nr=256)
    enc4 = check_encode_pack(torch, n, K=4, L=16, Nr=256)
    index, queries, res, req, launches, res_scaled = main_path(torch, n,
                                                               B=100)
    lbd = check_leaf_bounds(torch, index, queries)
    l2 = check_l2_rerank(torch, index, queries, res.stats.r_min, M=8)
    vres, vreq, vlaunches = vmap_path(torch, index, queries)
    rr0 = check_range_rerank(torch, index, queries, res.stats.final_r, 0,
                             timed=True)
    rr2 = check_range_rerank(torch, index, queries, res.stats.final_r, 2,
                             timed=False)
    rr_scaled = check_range_rerank(torch, index, queries,
                                   res_scaled.stats.final_r, 0, timed=True,
                                   tag="scaled r_min, last round")
    search_breakdown(torch, index, queries, res.stats.final_r, req.k)
    check_persist(torch, index, queries, [(res, req), (vres, vreq)])
    pep = [check_project_encode_pack(torch, index.data, 16, 4, 256, "n=1M"),
           check_project_encode_pack(torch, index.data, 4, 16, 256,
                                     "n=1M K=4"),
           check_project_encode_pack(torch, index.data[:16384].contiguous(),
                                     16, 4, 256, "seal")]
    lsh = [check_lsh_project(torch, index.data, index.A, "n=1M"),
           check_lsh_project(torch, torch.randn(
               (100_000, 960), generator=torch.Generator("cuda").manual_seed(
                   9), device="cuda"), torch.randn(
               (960, 64), generator=torch.Generator("cuda").manual_seed(10),
               device="cuda"), "gist")]
    ebins = check_encode_bins(
        torch, torch.matmul(index.data, index.A),
        index.forest.breakpoints.reshape(64, 257))
    del res, vres, res_scaled
    torch.cuda.empty_cache()
    pdet = pdet_path(torch, index.data, queries)
    del index, queries
    torch.cuda.empty_cache()
    stream = streaming_path(torch, n)
    torch.cuda.empty_cache()
    wide = wide_rows(torch)
    torch.cuda.empty_cache()
    flash = flash_phase(torch)
    prefill_bf16, decode32, decode16 = flash[1], flash[2], flash[3]
    decode = decode_path(torch)

    print(json.dumps({"kernels": [
        {"name": "encode_pack", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/encode_pack.cu",
         "replaces": "src/repro/kernels/build_fused.py:105",
         "launches": launches["encode_pack"],
         "max_abs_err": max(enc["max_abs_err"], enc4["max_abs_err"],
                            wide["encode_pack_LK2048"]["max_abs_err"]),
         "ms": enc["ms"], "plain_ms": enc["plain_ms"],
         "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
         "library_ms": None},
        {"name": "range_rerank", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/range_rerank.cu",
         "replaces": "src/repro/kernels/range_rerank.py:90",
         "launches": launches["range_rerank"],
         "max_abs_err": max(rr0["max_abs_err"], rr2["max_abs_err"],
                            rr_scaled["max_abs_err"],
                            wide["range_rerank_d1536"]["max_abs_err"]),
         "ms": rr0["ms"], "plain_ms": rr0["plain_ms"],
         "bound_ms": rr0["bound_ms"], "bound_by": rr0["bound_by"],
         "library_ms": None},
        {"name": "leaf_bounds", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/leaf_bounds.cu",
         "replaces": "src/repro/kernels/leaf_bounds.py:50",
         "launches": vlaunches["leaf_bounds"],
         "max_abs_err": lbd["max_abs_err"],
         "ms": lbd["ms"], "plain_ms": lbd["plain_ms"],
         "bound_ms": lbd["bound_ms"], "bound_by": lbd["bound_by"],
         "library_ms": None},
        {"name": "l2_rerank", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/l2_rerank.cu",
         "replaces": "src/repro/kernels/l2_rerank.py:29",
         "launches": vlaunches["l2_rerank"],
         "max_abs_err": l2["max_abs_err"],
         "ms": l2["ms"], "plain_ms": l2["plain_ms"],
         "bound_ms": l2["bound_ms"], "bound_by": l2["bound_by"],
         "library_ms": l2["library_ms"]},
        {"name": "project_encode_pack", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/project_encode_pack.cu",
         "replaces": "src/repro/kernels/build_fused.py:128",
         "launches": stream["launches"]["project_encode_pack"],
         "max_abs_err": max(p["max_abs_err"] for p in
                            pep + [wide["project_encode_pack_d2048"]]),
         "ms": pep[0]["ms"], "plain_ms": pep[0]["plain_ms"],
         "bound_ms": pep[0]["bound_ms"], "bound_by": pep[0]["bound_by"],
         "library_ms": None},
        {"name": "lsh_project", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lsh_project.cu",
         "replaces": "src/repro/kernels/lsh_project.py:27",
         "launches": pdet["build_launches"]["lsh_project"],
         "max_abs_err": max(x["max_abs_err"] for x in lsh),
         "ms": lsh[0]["ms"], "plain_ms": lsh[0]["plain_ms"],
         "bound_ms": lsh[0]["bound_ms"], "bound_by": lsh[0]["bound_by"],
         "library_ms": lsh[0]["library_ms"]},
        {"name": "encode_bins", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/encode_bins.cu",
         "replaces": "src/repro/kernels/encode_bins.py:31",
         "launches": pdet["build_launches"]["encode_bins"],
         "max_abs_err": ebins["max_abs_err"],
         "ms": ebins["ms"], "plain_ms": ebins["plain_ms"],
         "bound_ms": ebins["bound_ms"], "bound_by": ebins["bound_by"],
         "library_ms": ebins["library_ms"]},
        {"name": "range_rerank_heads", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/range_rerank.cu",
         "replaces": "src/repro/kernels/ops.py:187",
         "launches": decode["launches"]["range_rerank_heads"],
         "max_abs_err": max(decode["heads"]["max_abs_err"],
                            wide["range_rerank_heads_d1537"]["max_abs_err"]),
         "ms": decode["heads"]["ms"], "plain_ms": decode["heads"]["plain_ms"],
         "bound_ms": decode["heads"]["bound_ms"],
         "bound_by": decode["heads"]["bound_by"], "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:66",
         "launches": decode["launches"]["flash_attention"],
         "max_abs_err": max(c["max_abs_err"] for c in flash),
         "max_abs_err_f32": max(c["max_abs_err"] for c in flash
                                if c["dtype"] == "float32"),
         "max_abs_err_bf16": max(c["max_abs_err"] for c in flash
                                 if c["dtype"] == "bfloat16"),
         "ms": flash[0]["ms"], "plain_ms": flash[0]["plain_ms"],
         "bound_ms": flash[0]["bound_ms"], "bound_by": flash[0]["bound_by"],
         "library_ms": flash[0]["library_ms"],
         "decode_ms": decode32["ms"], "decode_bound_ms": decode32["bound_ms"],
         "decode_library_ms": decode32["library_ms"],
         "decode_plain_ms": decode32["plain_ms"],
         "decode_bf16_ms": decode16["ms"],
         "decode_bf16_bound_ms": decode16["bound_ms"],
         "decode_bf16_library_ms": decode16["library_ms"],
         "prefill_bf16_ms": prefill_bf16["ms"],
         "prefill_bf16_bound_ms": prefill_bf16["bound_ms"],
         "prefill_bf16_plain_ms": prefill_bf16["plain_ms"],
         "prefill_bf16_library_ms": prefill_bf16["library_ms"],
         "launches_by_path": {"split": decode["dense_split_launches"]}},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
