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
  fused search's final radius); the two outputs must have the same +inf
  mask and finite entries within 1e-4 * |old| + 1e-4 * max |x|^2, the
  tolerance the kernel is held to against its plain version (the
  products run on the tensor cores in 3xTF32 since the tree of PR 18, on
  the CUDA cores before).
- ``range_rerank_heads``: 32 forests at decode's widths (32,768 random
  rows of d = 129 each, K = 4, L = 4, leaves of 32, g = 2 lanes a forest
  at the 5 % point of their leaf bounds: ``chip_smoke._wide_forest``);
  held as ``range_rerank``.  This tree reads the rows as the decode index
  stores them (a pitch of 132 floats, ``pad_rows``), the old one densely.
  ``range_rerank_heads_d1537``: the same at 4 forests of 8,192 rows of
  d = 1,537 (chip_smoke's ``wide_rows``).
- ``encode_pack``: 1,000,000 rows, K = 16, L = 4, Nr = 256;
  ``encode_pack_LK2048``: 16,384 rows, K = 16, L = 128;
  ``encode_pack_decode_head``: 32,768 rows, K = 4, L = 4, Nr = 64 (a
  decode prefill's per-head build); bit-identical.
- ``lsh_project``: those rows times the index's (128, 64) A, f32 (the
  sum is one FMA a feature since PR 18, a rounded product and a rounded
  sum before, so the two differ in the last bits: compared by their
  largest difference).
- ``project_encode_pack``: those rows and a (128, 64) matrix, K = 16,
  L = 4, Nr = 256; ``project_encode_pack_seal``: their first 16,384
  rows; ``project_encode_pack_d2048``: 16,384 random rows of d = 2,048.
  Bit-identical where both trees sum alike; against a tree whose sum is
  a rounded product and a rounded sum the count of unequal entries is
  printed.
- ``encode_bins``: the main path's projections (1,000,000 x 64, the
  index's A) with its index's breakpoints (Nr = 256); bit-identical.
- ``leaf_bounds``: the main path's forest (L = 4, nl = 15,625, K = 16)
  and its 100 projected queries; ``leaf_bounds_b1``: the first of them
  alone (the auto engine's single query).  Bit-identical.
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

    def wanted(*names):
        return args.cases == "all" or any(
            n in args.cases.split(",") for n in names)

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
    laid, (L, B, d, nl, K, E), pitches = rr._prepare(
        "range_rerank", (queries, chip_smoke._q_proj(index, queries), r_adm,
                         f.leaf_lo, f.leaf_hi, f.leaf_valid, f.breakpoints,
                         plan.points_sorted, f.valid, f.valid), (),
        f.leaf_size)
    rr_out = {v: torch.empty((L, B, nl * f.leaf_size), device="cuda")
              for v in ("old", "new")}
    # A tree with an admission kernel takes its scratch after out; one whose
    # launch knows row pitches takes them (ldq, ldp) after the leaf size.
    old_rr_lib = _build_old(old_tree, "range_rerank")
    rr_src = open(os.path.join(old_tree, "src", "repro_torch", "kernels",
                               "csrc", "range_rerank.cu")).read()
    scratch = "admit_kernel" in rr_src
    old_pitch = "int ldq" in rr_src
    new_lib = _build.load("range_rerank")
    rr_fn = {"old": _typed(old_rr_lib.range_rerank_launch,
                           12 if scratch else 11,
                           "iiiiiiiii" if old_pitch else "iiiiiii"),
             "new": _typed(new_lib.range_rerank_launch, 12, "iiiiiiiii")}
    admit = torch.empty((L * nl * B,), dtype=torch.uint8, device="cuda")

    def rr_run(v):
        extra = (admit.data_ptr(),) if v == "new" or scratch else ()
        ld = pitches if v == "new" or old_pitch else ()
        code = rr_fn[v](*(a.data_ptr() for a in laid), rr_out[v].data_ptr(),
                        *extra, L, B, d, nl, K, E, f.leaf_size, *ld, stream)
        assert code == 0, (v, code)
        return rr_out[v]
    max_sq = float((index.data * index.data).sum(-1).max())
    cases["range_rerank"] = (rr_run, ("held", max_sq), 10)

    # range_rerank_heads: the same signatures with a leading H.  The old
    # tree reads the rows densely (row pitch d); this one reads them as the
    # decode index stores them, at a pitch of a multiple of 4 floats.
    old_rrh = _typed(old_rr_lib.range_rerank_heads_launch,
                     12 if scratch else 11,
                     "iiiiiiiiii" if old_pitch else "iiiiiiii")
    new_rrh = _typed(new_lib.range_rerank_heads_launch, 12, "iiiiiiiiii")

    def heads_case(H, n, dim, K_, seed):
        parts = [chip_smoke._wide_forest(torch, n, dim, K_, 4, 32, 2,
                                         seed=seed + h) for h in range(H)]
        fs = [x[0] for x in parts]
        hargs = (torch.stack([x[2] for x in parts]),
                 torch.stack([x[3] for x in parts]),
                 torch.stack([x[4] for x in parts])[:, None, :].expand(
                     H, 4, 2).contiguous(),
                 *(torch.stack([getattr(f_, name) for f_ in fs])
                   for name in ("leaf_lo", "leaf_hi", "leaf_valid",
                                "breakpoints")),
                 rr.pad_rows(torch.stack([x[1] for x in parts])),
                 torch.stack([f_.valid for f_ in fs]),
                 torch.stack([f_.valid for f_ in fs]))
        del parts, fs
        laid_v = {"new": rr._prepare("range_rerank_heads", hargs, (H,), 32)}
        dense = list(hargs)
        dense[0], dense[7] = hargs[0].contiguous(), hargs[7].contiguous()
        old_laid, old_sizes, old_pitches = rr._prepare(
            "range_rerank_heads", tuple(dense), (H,), 32)
        if not old_pitch:          # a tree that reads q at a pitch of d
            old_laid = (dense[0], *old_laid[1:])
        laid_v["old"] = (old_laid, old_sizes, old_pitches)
        sizes = laid_v["new"][1]
        outs = {v: torch.empty((H, *sizes[:2], sizes[3] * 32),
                               device="cuda") for v in ("old", "new")}
        hadmit = torch.empty((H * sizes[0] * sizes[3] * sizes[1],),
                             dtype=torch.uint8, device="cuda")

        def run(v):
            hl, hs, hp = laid_v[v]
            extra = (hadmit.data_ptr(),) if v == "new" or scratch else ()
            ld = hp if v == "new" or old_pitch else ()
            code = (new_rrh if v == "new" else old_rrh)(
                *(a.data_ptr() for a in hl), outs[v].data_ptr(), *extra, H,
                *hs, 32, *ld, stream)
            assert code == 0, (v, code)
            return outs[v]
        return run, ("held", float((dense[7] ** 2).sum(-1).max()))
    if wanted("range_rerank_heads"):
        run, held = heads_case(32, 32768, 129, 4, 60)
        cases["range_rerank_heads"] = (run, held, 10)
    if wanted("range_rerank_heads_d1537"):
        run, held = heads_case(4, 8192, 1537, 4, 30)
        cases["range_rerank_heads_d1537"] = (run, held, 10)

    # lsh_project: one C signature in both trees.
    lp_out = {v: torch.empty((index.data.shape[0], 64), device="cuda")
              for v in ("old", "new")}
    lp_fn = {"old": _typed(_build_old(old_tree, "lsh_project")
                           .lsh_project_launch, 3, "liii"),
             "new": _typed(_build.load("lsh_project").lsh_project_launch, 3,
                           "liii")}

    def lp_run(v):
        x = index.data
        code = lp_fn[v](x.data_ptr(), index.A.data_ptr(),
                        lp_out[v].data_ptr(), x.shape[0], x.shape[1], 64, 0,
                        stream)
        assert code == 0, (v, code)
        return lp_out[v]
    cases["lsh_project"] = (lp_run, "diff", 10)

    # encode_pack: a tree whose source builds Eytzinger tables covers every
    # tree in one launch; an older one was launched once per group of trees
    # whose (32, L_g*K + 1) f32 + u8 tile fit 227 KB, with proj offset to
    # the group's columns.  The launch signature is the same.
    old_src = os.path.join(old_tree, "src", "repro_torch", "kernels", "csrc")
    old_single = "eytzinger" in open(os.path.join(old_src,
                                                  "encode_pack.cu")).read()
    ep_old = _typed(_build_old(old_tree, "encode_pack").encode_pack_launch,
                    6, "liiiiii")
    ep_new = _typed(_build.load("encode_pack").encode_pack_launch, 6,
                    "liiiiii")

    def encode_case(n, K, L, Nr):
        D = L * K
        proj = torch.randn((n, D), device="cuda", generator=torch.Generator(
            "cuda").manual_seed(K * 100 + L)) * 2.0
        bp = breakpoints_sample_sort(proj, Nr)
        _, hi, lo = key_bit_budget(K)
        outs = {v: build_fused._outputs(n, K, L, proj.device)
                for v in ("old", "new")}
        per = (232448 - 32 * 5) // (32 * 5 * K)

        def run(v):
            o = outs[v]
            if v == "new" or old_single:
                code = (ep_new if v == "new" else ep_old)(
                    proj.data_ptr(), bp.data_ptr(),
                    *(t.data_ptr() for t in o), n, D, K, L, Nr, hi, lo,
                    stream)
                assert code == 0, (v, code)
                return o
            for l0 in range(0, L, per):
                code = ep_old(proj[:, l0 * K:].data_ptr(),
                              bp[l0 * K].data_ptr(),
                              *(t[l0].data_ptr() for t in o), n, D, K,
                              min(L, l0 + per) - l0, Nr, hi, lo, stream)
                assert code == 0, (v, code)
            return o
        return run
    for name, shape in (("encode_pack", (1_000_000, 16, 4, 256)),
                        ("encode_pack_LK2048", (16384, 16, 128, 256)),
                        ("encode_pack_decode_head", (32768, 4, 4, 64))):
        if wanted(name):
            cases[name] = (encode_case(*shape), "equal", 10)

    # project_encode_pack: a tree whose launch takes a's row stride (lda)
    # has it after d; one that reads Eytzinger tables takes their scratch
    # after bp, and sums one FMA a feature (a rounded product and a rounded
    # sum in older trees: the codes of the two then differ near edges, so
    # they are compared by the count of unequal entries).
    old_pep_src = open(os.path.join(old_src, "project_encode_pack.cu")).read()
    old_lda = "int lda" in old_pep_src
    old_pep_eyt = "eyt" in old_pep_src
    pep_old = _typed(_build_old(old_tree, "project_encode_pack")
                     .project_encode_pack_launch,
                     8 if old_pep_eyt else 7,
                     "liiiiiii" if old_lda else "liiiiii")
    pep_new = _typed(_build.load("project_encode_pack")
                     .project_encode_pack_launch, 8, "liiiiiii")

    def pep_case(x):
        n, dim = x.shape
        a = torch.randn((dim, 64), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(7))
        bp = breakpoints_sample_sort(x @ a, 256)
        _, hi, lo = key_bit_budget(16)
        outs = {v: build_fused._outputs(n, 16, 4, x.device)
                for v in ("old", "new")}
        eyt = torch.empty((64, build_fused._table_width(bp)), device="cuda")

        def run(v):
            ptrs = (x.data_ptr(), a.data_ptr(), bp.data_ptr())
            if v == "new" or old_pep_eyt:
                ptrs += (eyt.data_ptr(),)
            lda = (64,) if v == "new" or old_lda else ()
            code = (pep_new if v == "new" else pep_old)(
                *ptrs, *(o.data_ptr() for o in outs[v]), n, dim, *lda, 16, 4,
                256, hi, lo, stream)
            assert code == 0, (v, code)
            return outs[v]
        return run
    x = index.data
    if wanted("project_encode_pack"):
        cases["project_encode_pack"] = (pep_case(x), "count", 10)
    if wanted("project_encode_pack_seal"):
        cases["project_encode_pack_seal"] = (
            pep_case(x[:16384].contiguous()), "count", 10)
    if wanted("project_encode_pack_d2048"):
        cases["project_encode_pack_d2048"] = (pep_case(torch.randn(
            (16384, 2048), device="cuda",
            generator=torch.Generator("cuda").manual_seed(40))), "count", 10)

    # encode_bins and leaf_bounds: one C signature in both trees.
    if wanted("encode_bins"):
        eb_fn = {"old": _typed(_build_old(old_tree, "encode_bins")
                               .encode_bins_launch, 3, "lii"),
                 "new": _typed(_build.load("encode_bins").encode_bins_launch,
                               3, "lii")}
        coords = torch.matmul(index.data, index.A)
        eb_bp = f.breakpoints.reshape(p.L * p.K, -1).contiguous()
        eb_out = {v: torch.empty(coords.shape, dtype=torch.int32,
                                 device="cuda") for v in ("old", "new")}

        def eb_run(v):
            code = eb_fn[v](coords.data_ptr(), eb_bp.data_ptr(),
                            eb_out[v].data_ptr(), coords.shape[0],
                            coords.shape[1], eb_bp.shape[1] - 1, stream)
            assert code == 0, (v, code)
            return eb_out[v]
        cases["encode_bins"] = (eb_run, "equal", 10)
    if wanted("leaf_bounds", "leaf_bounds_b1"):
        lb_fn = {"old": _typed(_build_old(old_tree, "leaf_bounds")
                               .leaf_bounds_launch, 7, "iiiii"),
                 "new": _typed(_build.load("leaf_bounds").leaf_bounds_launch,
                               7, "iiiii")}

        def lb_case(q_proj):
            Lq, Bq, Kq = q_proj.shape
            outs = {v: (torch.empty((Lq, Bq, f.n_leaves), device="cuda"),
                        torch.empty((Lq, Bq, f.n_leaves), device="cuda"))
                    for v in ("old", "new")}

            def run(v):
                code = lb_fn[v](
                    q_proj.data_ptr(), f.leaf_lo.data_ptr(),
                    f.leaf_hi.data_ptr(), f.leaf_valid.data_ptr(),
                    f.breakpoints.data_ptr(), outs[v][0].data_ptr(),
                    outs[v][1].data_ptr(), Lq, Bq, f.n_leaves, Kq,
                    f.breakpoints.shape[2], stream)
                assert code == 0, (v, code)
                return outs[v]
            return run
        q_proj = chip_smoke._q_proj(index, queries)
        cases["leaf_bounds"] = (lb_case(q_proj), "equal", 10)
        cases["leaf_bounds_b1"] = (lb_case(q_proj[:, :1].contiguous()),
                                   "equal", 10)

    # flash_attention: the old tree's launch (one kernel before the launch
    # paths, else its prefill or decode launch) against the new wrapper.
    from repro_torch.kernels import flash_attention as fak
    fa_lib = (_build_old(old_tree, "flash_attention")
              if wanted("flash_f32_prefill", "flash_bf16_prefill",
                        "flash_f32_decode", "flash_bf16_decode") else None)
    paths = hasattr(fa_lib, "flash_attention_prefill_launch")
    if fa_lib is None:
        pass
    elif paths:
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
    for name, shape, dtype, causal, reps in (
            ("flash_f32_prefill", (1, 16, 32768, 32768), torch.float32, True,
             3),
            ("flash_bf16_prefill", (1, 16, 32768, 32768), torch.bfloat16,
             True, 3),
            ("flash_f32_decode", (4, 16, 1, 32768), torch.float32, False, 10),
            ("flash_bf16_decode", (4, 16, 1, 32768), torch.bfloat16, False,
             10)):
        if wanted(name):
            cases[name] = (flash_case(*shape, dtype, causal), "diff", reps)

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
        elif compare == "count":
            agree = {"unequal_entries": int((got["old"] != got["new"]).sum())}
        elif compare == "diff":
            agree = float((got["old"] - got["new"]).abs().max())
        else:                       # ("held", max |x|^2)
            fin = torch.isfinite(got["old"])
            err = (got["new"][fin] - got["old"][fin]).abs()
            held = bool(torch.equal(fin, torch.isfinite(got["new"])) and (
                err <= 1e-4 * got["old"][fin].abs() + 1e-4 * compare[1]
            ).all())
            ok &= held
            agree = {"mask_and_tolerance": held,
                     "max_abs_err": float(err.max())}
            del fin, err
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
