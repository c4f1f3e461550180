#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py            # n = 1,000,000 SIFT-shaped vectors

Phases, each printed as one line; any failure exits non-zero:

  env        torch / CUDA versions, the card, TF32 switched off.
  build      every CUDA source under src/repro_torch/kernels/csrc compiled
             at once (one nvcc each, in parallel).
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
  range_rerank  the kernel against its plain version at the main path's
             last radius round, probe_depth 0 and 2: identical +inf mask,
             finite entries within rtol 1e-4 / atol 1e-4 * max|x|^2 (the
             qq - 2q.p + pp form cancels near zero, so summation order shows).
  search_breakdown  CUDA-event ms of each step of that round (kernel,
             inv_perm fold, T1/T2 update) and of the final top-k.
  persist    save -> load(device='cuda') -> search gives bit-identical ids
             and distances.

Then one JSON line per the kernel table (time, plain time, launches on the
main path, least possible time from bytes and operations), the card's name
and power limit, and as the last line {"ok": true, "device": {...}}.
Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s HBM, 67 TFLOP/s fp32
on the CUDA cores.
"""

from __future__ import annotations

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


def check_range_rerank(torch, index, queries, final_r, probe_depth: int,
                       timed: bool) -> dict:
    from repro_torch.kernels import range_rerank as rr
    from repro_torch.kernels import ref
    f, plan, p = index.forest, index.fused_plan(), index.params
    B = queries.shape[0]
    q_proj = (queries @ index.A).reshape(B, p.L, p.K).permute(1, 0, 2)
    q_proj = q_proj.contiguous()
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
    out = dict(probe_depth=probe_depth, mask_identical=True,
               max_abs_err=max_err, finite=int(fin.sum()),
               admitted_pairs=pairs, leaves_read=leaves_read,
               bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops)
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
    q_proj = (queries @ index.A).reshape(B, p.L, p.K).permute(1, 0, 2)
    q_proj = q_proj.contiguous()
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
    return index, queries, res2, req, launches


def check_persist(torch, index, queries, res, req) -> None:
    import repro_torch.api as api
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snapshot")
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = api.load(path, device="cuda")
        load_s = time.perf_counter() - t0
        again = loaded.search(queries, req)
    require(torch.equal(again.ids, res.ids)
            and torch.equal(again.dists, res.dists),
            "save -> load -> search is not bit-identical")
    line("persist", bit_identical=True, save_seconds=save_s,
         load_seconds=load_s)


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

    enc = check_encode_pack(torch, n, K=16, L=4, Nr=256)
    enc4 = check_encode_pack(torch, n, K=4, L=16, Nr=256)
    index, queries, res, req, launches = main_path(torch, n, B=100)
    rr0 = check_range_rerank(torch, index, queries, res.stats.final_r, 0,
                             timed=True)
    rr2 = check_range_rerank(torch, index, queries, res.stats.final_r, 2,
                             timed=False)
    search_breakdown(torch, index, queries, res.stats.final_r, req.k)
    check_persist(torch, index, queries, res, req)

    print(json.dumps({"kernels": [
        {"name": "encode_pack", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/encode_pack.cu",
         "replaces": "src/repro/kernels/build_fused.py:105",
         "launches": launches["encode_pack"],
         "max_abs_err": max(enc["max_abs_err"], enc4["max_abs_err"]),
         "ms": enc["ms"], "plain_ms": enc["plain_ms"],
         "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
         "library_ms": None},
        {"name": "range_rerank", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/range_rerank.cu",
         "replaces": "src/repro/kernels/range_rerank.py:90",
         "launches": launches["range_rerank"],
         "max_abs_err": max(rr0["max_abs_err"], rr2["max_abs_err"]),
         "ms": rr0["ms"], "plain_ms": rr0["plain_ms"],
         "bound_ms": rr0["bound_ms"], "bound_by": rr0["bound_by"],
         "library_ms": None},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
