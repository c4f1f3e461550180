#!/usr/bin/env python3
"""Time this checkout's kernels against an earlier tree's, in turns, on one
card.

    python3 scripts/ab_kernels.py OLD_TREE [--rounds 4]

OLD_TREE is an unpacked earlier tree of the repository (for example
``git archive <commit> | tar -x -C build/old``).  Its
``src/repro_torch/kernels/csrc/<name>.cu`` sources are built with the
port's nvcc flags beside this checkout's, and each pair runs on the same
inputs in the order old, new, new, old, ``--rounds`` times; each entry is
a median of CUDA-event timings.  The cases, at the shapes ``chip_smoke.py``
times:

- ``range_rerank``: the main path's last radius round (n = 1,000,000
  SIFT-shaped rows, d = 128, IndexSpec(K=16, L=4, c=1.5,
  beta_override=0.1, Nr=256, leaf_size=64), 100 perturbed queries at the
  fused search's final radius); outputs must be bit-identical.
- ``project_encode_pack``: those rows and a (128, 64) matrix, K = 16,
  L = 4, Nr = 256; bit-identical.
- ``flash_f32_prefill``, ``flash_bf16_prefill``: b = 1, h = 16, sq = sk =
  32,768, dh = 128, causal (old: its one kernel; new: the wrapper's path).
- ``flash_f32_decode``, ``flash_bf16_decode``: b = 4, h = 16, sq = 1,
  sk = 32,768, dh = 128.
  Flash outputs are compared by their largest difference.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build_old(old_tree: str, name: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    src = os.path.join(old_tree, "src", "repro_torch", "kernels", "csrc",
                       f"{name}.cu")
    out_dir = os.path.join(ROOT, "build", "ab_kernels")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{name}_old.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib)


def _typed(fn, n_ptrs: int, ints: str):
    """Type a launch function: n_ptrs pointers, then one ctypes type per
    letter of ``ints`` (i int, l int64, f float), then the stream."""
    kinds = {"i": ctypes.c_int, "l": ctypes.c_int64, "f": ctypes.c_float}
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [kinds[c] for c in ints]
                   + [ctypes.c_void_p])
    return fn


def _flat(result):
    """A launch's output(s) as one float64 vector (exact for int32, uint32
    key words and f32)."""
    import torch
    parts = result if isinstance(result, tuple) else (result,)
    return torch.cat([p.reshape(-1).double() for p in parts])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("old_tree")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--cases", default="all",
                        help="comma-separated case names, or all")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    import repro_torch.api as api
    from repro_torch import datasets
    from repro_torch.core.detree import key_bit_budget
    from repro_torch.core.encoding import breakpoints_sample_sort
    from repro_torch.kernels import _build, build_fused, ops
    from repro_torch.kernels import range_rerank as rr
    old_tree = os.path.abspath(args.old_tree)
    stream = torch.cuda.current_stream().cuda_stream

    data = datasets.sift_like(1_000_000, 128, seed=0)
    queries_np = datasets.perturbed_queries(data, 100, seed=1)
    spec = api.IndexSpec(kind="static", K=16, L=4, c=1.5, beta_override=0.1,
                         Nr=256, leaf_size=64)
    index = api.build(data, torch.Generator().manual_seed(0), spec,
                      device="cuda")
    res = index.search(queries_np, api.SearchRequest(k=50, engine="fused"))
    cases = {}

    # range_rerank: one C signature in both trees.
    queries = torch.as_tensor(queries_np, device="cuda")
    f, plan, p = index.forest, index.fused_plan(), index.params
    B = queries.shape[0]
    r_adm = (p.epsilon * res.stats.final_r).expand(p.L, B).contiguous()
    laid, (L, B, d, nl, K, E) = rr._prepare(
        "range_rerank", (queries, chip_smoke._q_proj(index, queries), r_adm,
                         f.leaf_lo, f.leaf_hi, f.leaf_valid, f.breakpoints,
                         plan.points_sorted, f.valid, f.valid), (),
        f.leaf_size)
    rr_out = {v: torch.empty((L, B, nl * f.leaf_size), device="cuda")
              for v in ("old", "new")}
    rr_fn = {"old": _typed(_build_old(old_tree, "range_rerank")
                           .range_rerank_launch, 11, "iiiiiii"),
             "new": _typed(_build.load("range_rerank").range_rerank_launch,
                           11, "iiiiiii")}

    def rr_run(v):
        code = rr_fn[v](*(a.data_ptr() for a in laid), rr_out[v].data_ptr(),
                        L, B, d, nl, K, E, f.leaf_size, stream)
        assert code == 0, (v, code)
        return rr_out[v]
    cases["range_rerank"] = (rr_run, "equal", 10)

    # project_encode_pack: the new launch takes a's row stride after d.
    x, a = index.data, torch.randn((128, 64), device="cuda",
                                   generator=torch.Generator(
                                       "cuda").manual_seed(7))
    bp = breakpoints_sample_sort(x @ a, 256)
    _, hi, lo = key_bit_budget(16)
    n = x.shape[0]
    pep_out = {v: build_fused._outputs(n, 16, 4, x.device)
               for v in ("old", "new")}
    pep_old = _typed(_build_old(old_tree, "project_encode_pack")
                     .project_encode_pack_launch, 7, "liiiiii")
    pep_new = _typed(_build.load("project_encode_pack")
                     .project_encode_pack_launch, 7, "liiiiiii")

    def pep_run(v):
        ptrs = (x.data_ptr(), a.data_ptr(), bp.data_ptr(),
                *(o.data_ptr() for o in pep_out[v]))
        code = (pep_old(*ptrs, n, 128, 16, 4, 256, hi, lo, stream)
                if v == "old" else
                pep_new(*ptrs, n, 128, 64, 16, 4, 256, hi, lo, stream))
        assert code == 0, (v, code)
        return pep_out[v]
    cases["project_encode_pack"] = (pep_run, "equal", 10)

    # flash_attention: the old tree's launch (one kernel before the launch
    # paths, else its prefill or decode launch) against the new wrapper.
    from repro_torch.kernels import flash_attention as fak
    fa_lib = _build_old(old_tree, "flash_attention")
    paths = hasattr(fa_lib, "flash_attention_prefill_launch")
    if paths:
        fa_pre = _typed(fa_lib.flash_attention_prefill_launch, 4,
                        "iiiiifiii")
        fa_dec = _typed(fa_lib.flash_attention_decode_launch, 5,
                        "iiiiifiiii")
    else:
        fa_old = _typed(fa_lib.flash_attention_launch, 4, "iiiiifi")

    def flash_case(b, h, sq, sk, dtype, causal):
        gen = torch.Generator("cuda").manual_seed(sq + sk)
        q, k, v = ((torch.randn((b, h, s_, 128), generator=gen,
                                device="cuda") * sc).to(dtype)
                   for s_, sc in ((sq, 0.5), (sk, 0.5), (sk, 1.0)))
        out = torch.empty_like(q)

        bf16 = int(dtype == torch.bfloat16)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())

        def run(which):
            if which == "new":
                return ops.flash_attention(q, k, v, causal=causal)
            if not paths:
                code = fa_old(*ptrs, b * h, sq, sk, 128, int(causal),
                              128 ** -0.5, bf16, stream)
            elif sq <= 8:
                n_splits, per = fak.splits(b * h, sq, sk, causal)
                scratch = torch.empty(b * h * n_splits * 8 * sq * 130,
                                      device="cuda")   # room for any tree
                code = fa_dec(*ptrs, scratch.data_ptr(), b * h, sq, sk, 128,
                              int(causal), 128 ** -0.5, bf16, n_splits, per,
                              1, stream)
            else:
                code = fa_pre(*ptrs, b * h, sq, sk, 128, int(causal),
                              128 ** -0.5, bf16, bf16, 1, stream)
            assert code == 0, code
            return out
        return run
    cases["flash_f32_prefill"] = (flash_case(1, 16, 32768, 32768,
                                             torch.float32, True), "diff", 3)
    cases["flash_bf16_prefill"] = (flash_case(1, 16, 32768, 32768,
                                              torch.bfloat16, True), "diff",
                                   3)
    cases["flash_f32_decode"] = (flash_case(4, 16, 1, 32768, torch.float32,
                                            False), "diff", 10)
    cases["flash_bf16_decode"] = (flash_case(4, 16, 1, 32768,
                                             torch.bfloat16, False), "diff",
                                  10)

    out = {"gpu": chip_smoke.nvidia_smi()}
    ok = True
    for name, (run, compare, reps) in cases.items():
        if args.cases != "all" and name not in args.cases.split(","):
            continue
        got = {v: _flat(run(v)) for v in ("old", "new")}
        torch.cuda.synchronize()
        if compare == "equal":
            agree = bool(torch.equal(got["old"], got["new"]))
            ok &= agree
        else:
            agree = float((got["old"] - got["new"]).abs().max())
        del got
        times = {"old": [], "new": []}
        for _ in range(args.rounds):
            for v in ("old", "new", "new", "old"):
                times[v].append(chip_smoke.time_ms(
                    torch, lambda: run(v), warmup=1, reps=reps))
        med = {v: statistics.median(ts) for v, ts in times.items()}
        out[name] = {"agree": agree, "times_ms": times, "median_ms": med,
                     "new_over_old": med["new"] / med["old"]}
    print(json.dumps({"ab_kernels": out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
