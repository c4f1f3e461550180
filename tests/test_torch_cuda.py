"""PyTorch port: the hand-written CUDA kernels against their plain versions.

These run only on a CUDA card (the kernels have no CPU mode) and skip
elsewhere; they import neither JAX nor the reference package, so they run
on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import detree, encoding  # noqa: E402
from repro_torch.core.query import make_fused_plan  # noqa: E402
from repro_torch.kernels import build_fused, ops, ref  # noqa: E402
from repro_torch.kernels import range_rerank as rr  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,K,L,Nr", [(3001, 16, 4, 256), (3001, 4, 16, 256),
                                      (777, 5, 3, 64), (40, 33, 1, 256)])
def test_encode_pack_kernel_bit_identical(cuda, n, K, L, Nr):
    rng = np.random.default_rng(K)
    proj = torch.tensor(rng.standard_normal((n, L * K)) * 2.0,
                        dtype=torch.float32, device=cuda)
    bp = encoding.full_sort(proj, Nr)
    before = build_fused.encode_pack.launches
    got = ops.encode_pack(proj, bp, K=K, L=L)
    assert build_fused.encode_pack.launches == before + 1
    for g, w in zip(got, ref.encode_pack(proj, bp, K=K, L=L)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _forest_inputs(cuda, n, B, K, L, ls, d, seed):
    rng = np.random.default_rng(seed)
    data = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                        device=cuda)
    A = torch.tensor(rng.standard_normal((d, L * K)), dtype=torch.float32,
                     device=cuda)
    q = data[torch.tensor(rng.choice(n, B, replace=False), device=cuda)]
    q = q + 0.3 * torch.randn(q.shape, device=cuda,
                              generator=torch.Generator(cuda).manual_seed(0))
    forest = detree.build_forest(data @ A, K, L, Nr=64, leaf_size=ls,
                                 breakpoint_method="full_sort")
    plan = make_fused_plan(data, forest)
    q_proj = (q @ A).reshape(B, L, K).permute(1, 0, 2).contiguous()
    return forest, plan, q, q_proj, rng


@pytest.mark.parametrize("probe_depth", [0, 2])
@pytest.mark.parametrize("n,B,ls,d", [(1500, 13, 16, 40), (3000, 33, 64, 128),
                                      (700, 5, 50, 7)])
def test_range_rerank_kernel_matches_plain(cuda, probe_depth, n, B, ls, d):
    f, plan, q, q_proj, rng = _forest_inputs(cuda, n, B, 4, 3, ls, d, seed=n)
    r = torch.tensor(rng.uniform(0.5, 3.0, B), dtype=torch.float32,
                     device=cuda)
    r[1] = -1.0                                   # a done lane
    live = torch.tensor(rng.random(f.valid.shape) > 0.1, device=cuda)
    args = (q, q_proj, r, f.leaf_lo, f.leaf_hi, f.leaf_valid, f.breakpoints,
            plan.points_sorted, f.valid, live)
    before = rr.range_rerank.launches
    got = ops.range_rerank(*args, leaf_size=ls, probe_depth=probe_depth)
    assert rr.range_rerank.launches == before + 1
    r_adm = (ref.probe_radii(q_proj, f.leaf_lo, f.leaf_hi, f.leaf_valid,
                             f.breakpoints, r, probe_depth)
             if probe_depth else r)
    want = ref.range_rerank(q, q_proj, r_adm, *args[3:], leaf_size=ls)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    assert fin.any() and (~fin).any()
    # The qq - 2 q.p + pp form cancels near a query, and the kernel sums its
    # dot products in another order than torch.matmul: the error scales with
    # |x|^2, not with the distance.
    max_sq = float((plan.points_sorted ** 2).sum(-1).max())
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4,
                               atol=1e-4 * max_sq)
    assert torch.isinf(got[:, 1]).all()


@pytest.mark.parametrize("build_impl,encode_impl,launched", [
    ("auto", "auto", True), ("pallas", "auto", True), ("auto", "pallas", True),
    ("auto", "pallas_interpret", False), ("pallas_interpret", "auto", False),
    ("xla", "auto", False)])
def test_fused_builder_impl_names_pick_kernel_or_plain(cuda, build_impl,
                                                       encode_impl, launched):
    import repro_torch.api as api
    rng = np.random.default_rng(5)
    data = rng.standard_normal((2000, 16)).astype(np.float32)
    spec = api.IndexSpec(K=4, L=2, build_impl=build_impl,
                         encode_impl=encode_impl)
    base = api.build(data, torch.Generator().manual_seed(0),
                     api.IndexSpec(K=4, L=2), device=cuda)
    before = build_fused.encode_pack.launches
    idx = api.build(data, torch.Generator().manual_seed(0), spec, device=cuda)
    assert (build_fused.encode_pack.launches > before) == launched
    assert torch.equal(idx.forest.point_ids, base.forest.point_ids)


def test_wrappers_refuse_bad_inputs(cuda):
    proj = torch.zeros((8, 8), device=cuda)
    with pytest.raises(TypeError):
        build_fused.encode_pack(proj.double(), torch.zeros((8, 5),
                                device=cuda), K=4, L=2)
    with pytest.raises(ValueError):
        build_fused.encode_pack(proj, torch.zeros((8, 5)), K=4, L=2)


# ---------------------------------------------------------------------------
# The vmap engine's kernels: leaf_bounds and l2_rerank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nl,K,Nr", [(256, 4, 256), (300, 16, 64),
                                     (17, 2, 16), (512, 8, 128)])
def test_leaf_bounds_kernel_bit_identical(cuda, nl, K, Nr):
    from repro_torch.kernels import leaf_bounds as lbk
    rng = np.random.default_rng(nl + K)
    L, B = 3, 37
    bp = torch.tensor(np.sort(rng.standard_normal((L, K, Nr + 1)) * 3.0,
                              axis=-1, kind="stable"),
                      dtype=torch.float32, device=cuda)
    lo = rng.integers(0, Nr, (L, nl, K))
    hi = np.clip(lo + rng.integers(0, 8, (L, nl, K)), 0, Nr - 1)
    lo = torch.tensor(lo, dtype=torch.int16, device=cuda)
    hi = torch.tensor(hi, dtype=torch.int16, device=cuda)
    valid = torch.tensor(rng.random((L, nl)) > 0.1, device=cuda)
    q = torch.tensor(rng.standard_normal((L, B, K)) * 2.0,
                     dtype=torch.float32, device=cuda)
    before = lbk.leaf_bounds.launches
    got = ops.leaf_bounds(q, lo, hi, valid, bp)
    assert lbk.leaf_bounds.launches == before + 1
    for g, w in zip(got, ref.leaf_bounds(q, lo, hi, valid, bp)):
        assert torch.equal(g, w)                    # bit for bit, +inf too


@pytest.mark.parametrize("b,m,d", [(128, 256, 128), (1, 1000, 64),
                                   (20, 300, 420), (128, 256, 96),
                                   (1, 2048, 128), (3, 70, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_rerank_kernel_matches_plain(cuda, b, m, d, dtype):
    from repro_torch.kernels import l2_rerank as l2k
    gen = torch.Generator(cuda).manual_seed(b + m + d)
    G = 5
    q = torch.randn((G, b, d), generator=gen, device=cuda).to(dtype)
    c = torch.randn((G, m, d), generator=gen, device=cuda).to(dtype)
    before = l2k.l2_rerank.launches
    got = ops.l2_rerank(q, c)
    flat = ops.l2_rerank(q[1], c[1])
    assert l2k.l2_rerank.launches == before + 2
    want = ref.l2_rerank(q, c)
    assert got.dtype == torch.float32 and got.shape == (G, b, m)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got, want, rtol=5e-2, atol=5e-2)
    else:
        # qq - 2 q.c + cc cancels near zero: the error scales with |x|^2.
        max_sq = float(torch.maximum((q * q).sum(-1).max(),
                                     (c * c).sum(-1).max()))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * max_sq)
    torch.testing.assert_close(flat, got[1], rtol=0, atol=0)


def test_vmap_engine_on_the_card_matches_plain_versions(cuda):
    import repro_torch.api as api
    from repro_torch.kernels import l2_rerank as l2k
    from repro_torch.kernels import leaf_bounds as lbk
    rng = np.random.default_rng(3)
    data = rng.standard_normal((4000, 32)).astype(np.float32)
    q = data[:7] + 0.05 * rng.standard_normal((7, 32)).astype(np.float32)
    idx = api.build(data, torch.Generator().manual_seed(0),
                    api.IndexSpec(K=8, L=3, leaf_size=32), device=cuda)
    for mode in ("leaf", "strict"):
        lb0, l20 = lbk.leaf_bounds.launches, l2k.l2_rerank.launches
        kern = idx.search(q, api.SearchRequest(
            k=10, r_min=0.3, engine="auto", mode=mode, bounds_impl="pallas",
            dist_impl="pallas"))
        assert kern.stats.engine == "vmap"
        assert lbk.leaf_bounds.launches > lb0 and l2k.l2_rerank.launches > l20
        lb0, l20 = lbk.leaf_bounds.launches, l2k.l2_rerank.launches
        plain = idx.search(q, api.SearchRequest(
            k=10, r_min=0.3, engine="auto", mode=mode,
            bounds_impl="pallas_interpret", dist_impl="pallas_interpret"))
        assert (lbk.leaf_bounds.launches, l2k.l2_rerank.launches) == (lb0, l20)
        assert torch.equal(kern.ids, plain.ids)
        assert torch.equal(kern.stats.rounds, plain.stats.rounds)
        assert torch.equal(kern.stats.n_candidates, plain.stats.n_candidates)
        torch.testing.assert_close(kern.dists, plain.dists, rtol=1e-4,
                                   atol=1e-4 * float((idx.data ** 2).sum(
                                       -1).max()))


def test_vmap_wrappers_refuse_bad_inputs(cuda):
    from repro_torch.kernels import l2_rerank as l2k
    from repro_torch.kernels import leaf_bounds as lbk
    q = torch.zeros((2, 3, 4), device=cuda)
    lo = torch.zeros((2, 5, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int16"):
        lbk.leaf_bounds(q, lo, lo, torch.ones((2, 5), dtype=torch.bool,
                                              device=cuda),
                        torch.zeros((2, 4, 9), device=cuda))
    with pytest.raises(TypeError):
        l2k.l2_rerank(q.double(), q.double())
    with pytest.raises(ValueError):
        l2k.l2_rerank(q, q.cpu())


# ---------------------------------------------------------------------------
# The streaming seal's kernel: project_encode_pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,K,L,Nr", [(16384, 128, 16, 4, 256),
                                        (3001, 128, 4, 16, 256),
                                        (777, 17, 5, 3, 64),
                                        (40, 33, 33, 1, 256),
                                        (5, 3, 2, 2, 16),
                                        (1000, 960, 8, 2, 128)])
def test_project_encode_pack_kernel_bit_identical(cuda, n, d, K, L, Nr):
    """Ragged row counts, d off the float4 width and a wide d (GIST's 960):
    every output equal to the plain version bit for bit (the projection is
    summed in the same d order, each step rounded alike)."""
    gen = torch.Generator(cuda).manual_seed(n + d)
    x = torch.randn((n, d), generator=gen, device=cuda)
    a = torch.randn((d, L * K), generator=gen, device=cuda)
    bp = encoding.full_sort(ref.project(x, a), Nr)
    before = build_fused.project_encode_pack.launches
    got = ops.project_encode_pack(x, a, bp, K=K, L=L)
    assert build_fused.project_encode_pack.launches == before + 1
    want = ref.project_encode_pack(x, a, bp, K=K, L=L)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    interp = ops.project_encode_pack(x, a, bp, K=K, L=L, interpret=True)
    assert build_fused.project_encode_pack.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(interp, want))


def test_project_encode_pack_refuses_rows_too_wide(cuda):
    x = torch.zeros((64, 2048), device=cuda)
    a = torch.zeros((2048, 64), device=cuda)
    bp = torch.sort(torch.randn((64, 257), device=cuda), dim=1).values
    with pytest.raises(ValueError, match="shared memory"):
        build_fused.project_encode_pack(x, a, bp, K=16, L=4)
    with pytest.raises(TypeError):
        build_fused.project_encode_pack(x.double(), a, bp, K=16, L=4)
    with pytest.raises(ValueError):
        build_fused.project_encode_pack(x[:, :128], a.cpu()[:128], bp, K=16,
                                        L=4)


def _streaming_index(cuda, build_impl="auto"):
    import repro_torch.api as api
    rng = np.random.default_rng(8)
    data = rng.standard_normal((3000, 32)).astype(np.float32)
    spec = api.IndexSpec(kind="streaming", K=8, L=3, leaf_size=32,
                         delta_capacity=256, max_segments=2,
                         build_impl=build_impl)
    return api.build(data, torch.Generator().manual_seed(0), spec,
                     device=cuda), rng


@pytest.mark.parametrize("build_impl,launched", [
    ("auto", True), ("pallas", True), ("xla", False),
    ("pallas_interpret", False)])
def test_seal_on_the_card_runs_the_kernel(cuda, build_impl, launched):
    """A seal launches project_encode_pack once on 'auto'/'pallas' and
    never on the plain names; either way the segment equals the one the
    plain version seals, bit for bit."""
    from repro_torch.core import FOREST_DTYPES
    from repro_torch.streaming import build_segment
    idx, rng = _streaming_index(cuda, build_impl)
    before = build_fused.project_encode_pack.launches
    idx.upsert(rng.standard_normal((600, 32)).astype(np.float32))
    assert len(idx.manifest.segments) == 3              # two seals
    moved = build_fused.project_encode_pack.launches - before
    assert moved == (2 if launched else 0)
    seg = idx.manifest.segments[1]
    plain = build_segment(seg.data, seg.gids, idx.A, idx.params, idx.bp_all,
                          Nr=idx.Nr, leaf_size=idx.leaf_size,
                          seg_id=seg.seg_id, live=seg.live, build_impl="xla")
    assert seg.clip_fraction == plain.clip_fraction
    for name in FOREST_DTYPES:
        got = getattr(seg.forest, name)
        assert got.is_cuda and torch.equal(got, getattr(plain.forest, name))


def test_streaming_searches_on_the_card_match_plain_versions(cuda):
    """Fused and vmap searches over segments with tombstones and a delta,
    through the kernels, against the same requests on the plain versions."""
    import repro_torch.api as api
    from repro_torch.kernels import range_rerank as rrk
    idx, rng = _streaming_index(cuda)
    g = idx.upsert(rng.standard_normal((600, 32)).astype(np.float32))
    idx.delete(np.concatenate([np.arange(0, 300, 4), g[::5]]))
    assert idx.memtable.n_live > 0 and all(
        s.has_tombstones for s in idx.manifest.segments)
    q = torch.tensor(rng.standard_normal((12, 32)), dtype=torch.float32,
                     device=cuda)
    max_sq = float(max((s.data ** 2).sum(-1).max()
                       for s in idx.manifest.segments))
    for kw, impls, reranks in (
            (dict(engine="fused"), ("auto", "pallas_interpret"), True),
            (dict(engine="vmap"), ("pallas", "pallas_interpret"), False)):
        before = rrk.range_rerank.launches
        kern = idx.search(q, api.SearchRequest(
            k=10, r_min=0.5, bounds_impl=impls[0], dist_impl=impls[0], **kw))
        assert (rrk.range_rerank.launches > before) == reranks
        plain = idx.search(q, api.SearchRequest(
            k=10, r_min=0.5, bounds_impl=impls[1], dist_impl=impls[1], **kw))
        assert torch.equal(kern.ids, plain.ids)
        assert torch.equal(kern.stats.rounds, plain.stats.rounds)
        assert torch.equal(kern.stats.n_candidates, plain.stats.n_candidates)
        torch.testing.assert_close(kern.dists, plain.dists, rtol=1e-4,
                                   atol=1e-4 * max_sq)
        dead = {int(x) for x in np.arange(0, 300, 4)} | {int(x) for x in g[::5]}
        assert not set(kern.ids.flatten().tolist()) & dead
