#!/usr/bin/env python3
"""Time this checkout's searches against an earlier tree's, in turns, on one
card, each tree's package in its own process.

    python3 scripts/ab_search.py OLD_TREE [--rounds 2]

OLD_TREE is an unpacked earlier tree of the repository (for example
``git archive <commit> | tar -x -C build/old``).  Each process imports one
tree's ``repro_torch``, builds chip_smoke's main-path index with it
(n = 1,000,000 SIFT-shaped rows from ``datasets.sift_like(seed=0)``, d =
128, IndexSpec(K=16, L=4, c=1.5, beta_override=0.1, Nr=256,
leaf_size=64), 100 ``perturbed_queries(seed=1)``) and times, after one
warm-up each:

- ``warm_ms``: host-clock ms of a search ended by a device sync (median
  of 20, with min and max) for the vmap engine at B = 100
  (``bounds_impl``/``dist_impl='pallas'``), the auto engine at B = 7 and
  1 with the same impls, and the fused engine at B = 100;
- ``rounds``: each search's mean and largest round count;
- ``round_ms``: CUDA-event ms (median of 10) of the vmap round's
  ``leaf_bounds`` call and of a whole ``range_query_round`` at B = 100,
  the estimated r_min, M = 8, each call alone on an idle card, and the
  host ms of one ``leaf_bounds`` call at B = 100 and 7 (``host_*``: from
  the call to its return, the card idle before);
- ``profile``: ``torch.profiler``'s device and host totals over five warm
  auto B = 7 searches, and its ten costliest device ops.

The processes run old, new, new, old, ``--rounds`` times; each entry is
the median over a tree's processes.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(tree: str) -> dict:
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch.api as api
    from repro_torch import datasets
    from repro_torch.core import query
    from repro_torch.kernels import ops
    data = datasets.sift_like(1_000_000, 128, seed=0)
    queries = torch.as_tensor(datasets.perturbed_queries(data, 100, seed=1),
                              device="cuda")
    spec = api.IndexSpec(kind="static", K=16, L=4, c=1.5, beta_override=0.1,
                         Nr=256, leaf_size=64)
    index = api.build(data, torch.Generator().manual_seed(0), spec,
                      device="cuda")
    kern = dict(bounds_impl="pallas", dist_impl="pallas")
    runs = {"vmap_B100": (queries, api.SearchRequest(k=50, engine="vmap",
                                                     **kern)),
            "auto_B7": (queries[:7], api.SearchRequest(k=50, engine="auto",
                                                       **kern)),
            "auto_B1": (queries[:1], api.SearchRequest(k=50, engine="auto",
                                                       **kern)),
            "fused_B100": (queries, api.SearchRequest(k=50, engine="fused"))}
    warm, rounds = {}, {}
    for name, (qs, req) in runs.items():
        st = index.search(qs, req).stats.rounds.float()
        rounds[name] = (float(st.mean()), int(st.max()))
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            index.search(qs, req)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        warm[name] = dict(median=statistics.median(times), min=min(times),
                          max=max(times))

    f, p = index.forest, index.params
    r_min = index.search(queries, runs["vmap_B100"][1]).stats.r_min
    q_proj = (queries @ index.A).reshape(100, p.L, p.K).permute(
        1, 0, 2).contiguous()
    r = torch.full((100,), p.epsilon * r_min, device="cuda")
    steps = {"leaf_bounds": lambda: ops.leaf_bounds(
                 q_proj, f.leaf_lo, f.leaf_hi, f.leaf_valid, f.breakpoints),
             "range_query_round": lambda: query.range_query_round(
                 f, q_proj, r, 8, bounds_impl="pallas")}
    round_ms = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        round_ms[name] = statistics.median(times)
    for B in (100, 7):
        qp = q_proj[:, :B].contiguous()
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.leaf_bounds(qp, f.leaf_lo, f.leaf_hi, f.leaf_valid,
                            f.breakpoints)
            times.append((time.perf_counter() - t0) * 1e3)
        round_ms[f"host_leaf_bounds_B{B}"] = statistics.median(times)

    from torch.profiler import ProfilerActivity, profile
    qs, req = runs["auto_B7"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            index.search(qs, req)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    top = sorted(events, key=device_us, reverse=True)[:10]
    prof_out = {"device_ms": sum(device_us(e) for e in events) / 1e3,
                "host_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
                "top": [[e.key[:60], device_us(e) / 1e3, e.count]
                        for e in top]}
    return {"warm_ms": warm, "rounds": rounds, "round_ms": round_ms,
            "profile": prof_out}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("old_tree")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    tree = os.path.abspath(args.old_tree)
    if args.worker:
        print(json.dumps(_worker(tree)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ab_search: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    got = {"old": [], "new": []}
    for _ in range(args.rounds):
        for side in ("old", "new", "new", "old"):
            where = tree if side == "old" else ROOT
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  where, "--worker"], capture_output=True,
                                 text=True, check=True)
            got[side].append(json.loads(out.stdout.strip().splitlines()[-1]))
    summary = {"gpu": chip_smoke.nvidia_smi()}
    for side, runs in got.items():
        summary[side] = {
            "warm_ms": {k: statistics.median(r["warm_ms"][k]["median"]
                                             for r in runs)
                        for k in runs[0]["warm_ms"]},
            "round_ms": {k: statistics.median(r["round_ms"][k] for r in runs)
                         for k in runs[0]["round_ms"]},
            "profile_ms": {k: statistics.median(r["profile"][k]
                                                for r in runs)
                           for k in ("device_ms", "host_ms")},
            "runs": runs}
    print(json.dumps({"ab_search": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
