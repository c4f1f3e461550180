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
                                      (777, 5, 3, 64), (40, 33, 1, 256),
                                      (3001, 16, 128, 256)])
def test_encode_pack_kernel_bit_identical(cuda, n, K, L, Nr):
    """L*K = 2,048 is past one block's tile (1,451 dims): the wrapper
    launches once per group of trees and counts one launch."""
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
                                      (700, 5, 50, 7), (3000, 40, 64, 1536),
                                      (2000, 33, 32, 2048)])
def test_range_rerank_kernel_matches_plain(cuda, probe_depth, n, B, ls, d):
    """d = 1,536 and 2,048 are past the old whole-row query tile (d <=
    1,472): queries are staged per feature chunk now."""
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


def _held(got, want, points):
    """range_rerank's check: the plain version's +inf mask, finite entries
    within 1e-4 * |plain| + 1e-4 * max |x|^2 (the qq - 2 q.p + pp form
    cancels near a query; the kernel's q.p is 3xTF32 on the tensor cores,
    ~1e-6 of sum |q||p| from f32)."""
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    max_sq = float((points ** 2).sum(-1).max())
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4,
                               atol=1e-4 * max_sq)
    return fin


@pytest.mark.parametrize("B,d,ls", [(1, 3, 32), (17, 127, 64),
                                    (100, 129, 32), (100, 1536, 64),
                                    (200, 64, 64), (40, 128, 16)])
def test_range_rerank_kernel_edges(cuda, B, d, ls):
    """The tensor-core body at its edges: B = 1 (one lane of a 16-row
    tile), 17 (a second, nearly empty tile), 40, 100 and 200 (two passes),
    d not a multiple of 4 (4-byte copies) or of 8 (zero-padded k steps),
    d = 1,536 (96 ring chunks), leaves of 16, 32 and 64 points, each lane's
    radius at the 20 % point of its leaf bounds.  Two copies of the forest
    through the heads entry equal the single-forest launch bit for bit."""
    n = 3000
    f, plan, q, q_proj, rng = _forest_inputs(cuda, n, B, 4, 3, ls, d,
                                             seed=B + d)
    lb = ref.forest_leaf_lb(q_proj, f.leaf_lo, f.leaf_hi, f.leaf_valid,
                            f.breakpoints)
    flat = lb.permute(1, 0, 2).reshape(B, -1)
    r = flat.kthvalue(max(1, flat.shape[1] // 5), dim=1).values.contiguous()
    if B > 1:
        r[1] = -1.0                               # a done lane
    live = torch.tensor(rng.random(f.valid.shape) > 0.1, device=cuda)
    args = (q, q_proj, r.expand(3, B).contiguous(), f.leaf_lo, f.leaf_hi,
            f.leaf_valid, f.breakpoints, plan.points_sorted, f.valid, live)
    got = rr.range_rerank(*args, leaf_size=ls)
    want = ref.range_rerank(*args, leaf_size=ls)
    fin = _held(got, want, plan.points_sorted)
    assert fin.any() and (~fin).any()
    heads = rr.range_rerank_heads(*(torch.stack([a, a]) for a in args),
                                  leaf_size=ls)
    torch.cuda.synchronize()
    assert torch.equal(heads[0], got) and torch.equal(heads[1], got)


@pytest.mark.parametrize("case", ["one_pair", "none"])
def test_range_rerank_kernel_one_pair_and_none(cuda, case):
    """Per-tree radii that admit exactly one (query, leaf) pair of the
    whole forest, and radii that admit none (every lane done): the one
    leaf's valid points get distances, everything else +inf, as in the
    plain version; with none admitted the output is +inf throughout."""
    B, L, ls = 40, 3, 32
    f, plan, q, q_proj, _ = _forest_inputs(cuda, 2000, B, 4, L, ls, 64,
                                           seed=77)
    r = torch.full((L, B), -1.0, device=cuda)
    if case == "one_pair":
        lb = ref.forest_leaf_lb(q_proj, f.leaf_lo, f.leaf_hi, f.leaf_valid,
                                f.breakpoints)
        two = lb.sort(dim=-1).values[..., :2]
        l, b = map(int, torch.nonzero(two[..., 0] < two[..., 1])[0])
        r[l, b] = two[l, b, 0]
        admitted = (lb <= r[..., None]) & f.leaf_valid[:, None, :]
        assert int(admitted.sum()) == 1
    args = (q, q_proj, r, f.leaf_lo, f.leaf_hi, f.leaf_valid, f.breakpoints,
            plan.points_sorted, f.valid, f.valid)
    got = ops.range_rerank(*args, leaf_size=ls)
    want = ref.range_rerank(*args, leaf_size=ls)
    fin = _held(got, want, plan.points_sorted)
    if case == "one_pair":
        assert 0 < int(fin.sum()) <= ls
    else:
        assert torch.isinf(got).all()


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
                                        (1000, 960, 8, 2, 128),
                                        (4096, 2048, 16, 4, 256),
                                        (300, 300, 16, 100, 64)])
def test_project_encode_pack_kernel_bit_identical(cuda, n, d, K, L, Nr):
    """Ragged row counts, d off the float4 width, a wide d (GIST's 960)
    and d = 2,048 (eight 256-column chunks of x), and L*K = 1,600 (two
    launches, one per group of trees): every output equal to the plain
    version bit for bit (the projection is summed in the same d order,
    each step rounded alike)."""
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


def test_project_encode_pack_refuses_bad_inputs(cuda):
    x = torch.zeros((64, 2048), device=cuda)
    a = torch.zeros((2048, 64), device=cuda)
    bp = torch.sort(torch.randn((64, 257), device=cuda), dim=1).values
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


# ---------------------------------------------------------------------------
# lsh_project, encode_bins and the sharded PDET index on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,m", [(256, 128, 128), (300, 100, 64),
                                   (512, 960, 64), (1, 17, 3),
                                   (3001, 1700, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lsh_project_kernel_bit_identical(cuda, n, d, m, dtype):
    """The reference's sweep (and a d wider than one staged chunk, m over
    one column tile): the kernel equals the plain d-order sum bit for bit,
    bf16 inputs widened exactly."""
    from repro_torch.kernels import lsh_project as lpk
    gen = torch.Generator(cuda).manual_seed(n + d)
    x = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    a = torch.randn((d, m), generator=gen, device=cuda).to(dtype)
    before = lpk.lsh_project.launches
    got = ops.lsh_project(x, a)
    assert lpk.lsh_project.launches == before + 1
    want = ref.lsh_project(x, a)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(ops.lsh_project(x, a, interpret=True), want)
    assert lpk.lsh_project.launches == before + 1


@pytest.mark.parametrize("n,d,m", [(1000, 17, 3), (1000, 960, 64),
                                   (777, 17, 65), (300, 960, 65),
                                   (513, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lsh_project_kernel_ragged_edges(cuda, n, d, m, dtype):
    """Rows not a multiple of the block's 256, m = 3, 64 and 65 (a ragged
    column tile, 4-byte stores), d = 17 (plain loads into the ring) and
    960 (60 chunks): bit-identical to the plain FMA chain; bf16 outputs
    also equal the mul-then-add form (ref.project), which the kernel had
    before it summed with FMAs."""
    from repro_torch.kernels import lsh_project as lpk
    gen = torch.Generator(cuda).manual_seed(n * d + m)
    x = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    a = torch.randn((d, m), generator=gen, device=cuda).to(dtype)
    got = lpk.lsh_project(x, a)
    assert torch.equal(got, ref.lsh_project(x, a))
    if dtype == torch.bfloat16:
        assert torch.equal(got, ref.project(x.float(), a.float()))


@pytest.mark.parametrize("n,D,Nr", [(512, 64, 256), (700, 16, 64),
                                    (64, 4, 16), (1024, 128, 256),
                                    (5000, 200, 256)])
def test_encode_bins_kernel_bit_identical(cuda, n, D, Nr):
    """The reference's sweep (and a panel too wide for one block, D = 200
    at Nr = 256): codes equal the plain searchsorted bit for bit, at edges
    and outside the outer edges too."""
    from repro_torch.kernels import encode_bins as ebk
    gen = torch.Generator(cuda).manual_seed(n + D)
    coords = torch.randn((n, D), generator=gen, device=cuda) * 3.0
    bp = torch.sort(torch.randn((D, Nr + 1), generator=gen, device=cuda)
                    * 3.0, dim=1, stable=True).values
    coords[0] = bp[:, 1]                          # exactly on an inner edge
    coords[1] = bp[:, Nr // 2]
    before = ebk.encode_bins.launches
    got = ops.encode_bins(coords, bp)
    assert ebk.encode_bins.launches == before + 1
    want = ref.encode_bins(coords, bp)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_build_kernels_refuse_bad_inputs(cuda):
    from repro_torch.kernels import encode_bins as ebk
    from repro_torch.kernels import lsh_project as lpk
    x = torch.zeros((8, 4), device=cuda)
    with pytest.raises(TypeError):
        lpk.lsh_project(x.double(), torch.zeros((4, 3), device=cuda))
    with pytest.raises(ValueError):
        lpk.lsh_project(x, torch.zeros((5, 3), device=cuda))
    with pytest.raises(ValueError):
        lpk.lsh_project(x, torch.zeros((4, 3)))
    with pytest.raises(ValueError):
        ebk.encode_bins(x, torch.zeros((4, 2), device=cuda))
    with pytest.raises(TypeError):
        ebk.encode_bins(x.double(), torch.zeros((4, 9), device=cuda))


def test_reference_builder_on_the_card_launches_both_kernels(cuda):
    """project_impl='pallas' with the reference builder and a pallas encode
    launches lsh_project and encode_bins once each, encode_pack never, and
    builds the fused builder's forest from the same projection."""
    import repro_torch.api as api
    from repro_torch.kernels import encode_bins as ebk
    from repro_torch.kernels import lsh_project as lpk
    rng = np.random.default_rng(11)
    data = rng.standard_normal((5000, 48)).astype(np.float32)
    spec = api.IndexSpec(K=8, L=3, leaf_size=32, Nr=128,
                         project_impl="pallas", build_impl="reference",
                         encode_impl="pallas")
    counts = (lpk.lsh_project.launches, ebk.encode_bins.launches,
              build_fused.encode_pack.launches)
    idx = api.build(data, torch.Generator().manual_seed(0), spec,
                    device=cuda)
    moved = (lpk.lsh_project.launches - counts[0],
             ebk.encode_bins.launches - counts[1],
             build_fused.encode_pack.launches - counts[2])
    assert moved == (1, 1, 0)
    proj = ref.lsh_project(torch.tensor(data, device=cuda), idx.A)
    bp = idx.forest.breakpoints.reshape(24, 129)
    fused = detree.build_forest(proj, 8, 3, Nr=128, leaf_size=32,
                                breakpoints=bp)
    for name in ("point_ids", "proj_sorted", "codes_sorted", "valid",
                 "leaf_lo", "leaf_hi", "leaf_valid", "breakpoints"):
        got, want = getattr(idx.forest, name), getattr(fused, name)
        assert got.dtype == want.dtype and torch.equal(got, want), name


@pytest.mark.parametrize("S", [1, 3, 4])
def test_pdet_on_one_card_bit_identical_to_fused(cuda, S):
    """S shards on one card answer as the fused engine on the same index,
    bit for bit, and launch range_rerank once per shard per round."""
    import repro_torch.api as api
    from repro_torch.core.distributed import PDETIndex
    from repro_torch.launch.mesh import mesh_from_placement
    rng = np.random.default_rng(12)
    data = rng.standard_normal((4000, 32)).astype(np.float32)   # 125 leaves
    det = api.build(data, torch.Generator().manual_seed(0),
                    api.IndexSpec(K=8, L=3, leaf_size=32), device=cuda)
    placement = api.PlacementSpec(mesh_shape=(S,))
    pdet = PDETIndex.from_detlsh(det, placement, mesh=mesh_from_placement(
        placement, devices=[cuda] * S))
    q = torch.tensor(data[:20] + 0.05 * rng.standard_normal((20, 32)),
                     dtype=torch.float32, device=cuda)
    for r_min in (None, 0.3):
        want = det.search(q, api.SearchRequest(k=10, r_min=r_min,
                                               engine="fused"))
        before = rr.range_rerank.launches
        got = pdet.search(q, api.SearchRequest(k=10, r_min=r_min))
        assert got.stats.engine == "pdet"
        assert rr.range_rerank.launches - before == S * int(
            got.stats.psum_rounds)
        for name in ("ids", "dists"):
            assert torch.equal(getattr(got, name), getattr(want, name))
        for name in ("rounds", "n_candidates", "final_r"):
            assert torch.equal(getattr(got.stats, name),
                               getattr(want.stats, name))


def test_pdet_across_cards_bit_identical_to_fused(cuda):
    """On a machine with several cards the default mesh puts one shard on
    each: queries, projections and per-shard tables cross devices, and the
    answers still equal the fused engine's bit for bit; a snapshot loads
    back onto the same cards."""
    import tempfile
    import repro_torch.api as api
    S = min(4, torch.cuda.device_count())
    if S < 2:
        pytest.skip("needs two or more CUDA devices")
    rng = np.random.default_rng(13)
    data = rng.standard_normal((4000, 32)).astype(np.float32)   # 125 leaves
    spec = api.IndexSpec(K=8, L=3, leaf_size=32,
                         placement=api.PlacementSpec(mesh_shape=(S,)))
    pdet = api.build(data, torch.Generator().manual_seed(0), spec)
    det = api.build(data, torch.Generator().manual_seed(0),
                    api.IndexSpec(K=8, L=3, leaf_size=32), device=cuda)
    assert [sh.device for sh in pdet.layout.shards] == [
        torch.device("cuda", i) for i in range(S)]
    assert all(sh.points.device == sh.device for sh in pdet.layout.shards)
    q = data[:20] + 0.05 * rng.standard_normal((20, 32)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        pdet.save(tmp + "/pdet")
        loaded = api.load(tmp + "/pdet")
    assert loaded.n_shards == S
    for r_min in (None, 0.3):
        want = det.search(q, api.SearchRequest(k=10, r_min=r_min,
                                               engine="fused"))
        for index in (pdet, loaded):
            before = rr.range_rerank.launches
            got = index.search(q, api.SearchRequest(k=10, r_min=r_min))
            assert rr.range_rerank.launches - before == S * int(
                got.stats.psum_rounds)
            assert got.ids.device == torch.device("cuda", 0)
            for name in ("ids", "dists"):
                assert torch.equal(getattr(got, name), getattr(want, name))
            for name in ("rounds", "n_candidates", "final_r"):
                assert torch.equal(getattr(got.stats, name),
                                   getattr(want.stats, name))


# ---------------------------------------------------------------------------
# The decode slice: flash_attention, range_rerank_heads, the decode loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,sq,sk,dh", [(1, 2, 128, 128, 64),
                                          (2, 1, 100, 260, 32),
                                          (1, 1, 128, 384, 128),
                                          (2, 3, 77, 77, 40),
                                          (4, 16, 1, 1000, 128),
                                          (1, 2, 130, 200, 192),
                                          (2, 2, 64, 300, 256),
                                          (4, 16, 3, 1000, 128),
                                          (1, 4, 1, 65536, 128),
                                          (1, 2, 20, 50, 300),
                                          (2, 2, 5, 70, 3),
                                          (1, 1, 2, 70, 4100)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, b, h, sq, sk, dh, causal,
                                              dtype):
    """The reference's sweep plus ragged, wide (dh = 192, 256, 300, and
    4,100 past the split path's shared memory) and decode-shaped (sq = 1,
    2, 3, 5) cases; causal is top-left aligned, so it
    runs at any sq and sk.  Each call takes the path ``fak.path`` names
    (split-key decode, bf16 tensor cores, CUDA cores).  Tolerances of
    tests/test_kernels.py (f32 2e-3, bf16 5e-2) against the naive softmax,
    and against the plain blockwise version the bound both sides' single
    f32 accumulation allows (ref.flash_attention_tolerance: summation
    order in f32, one unit in the last place in bf16)."""
    from repro_torch.kernels import flash_attention as fak
    gen = torch.Generator(cuda).manual_seed(sq * 7 + sk)
    q = (torch.randn((b, h, sq, dh), generator=gen, device=cuda)
         * 0.5).to(dtype)
    k = (torch.randn((b, h, sk, dh), generator=gen, device=cuda)
         * 0.5).to(dtype)
    v = torch.randn((b, h, sk, dh), generator=gen, device=cuda).to(dtype)
    which = fak.path(sq, dh, dtype)
    before = fak.flash_attention.launches
    on_path = fak.flash_attention.paths[which]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert fak.flash_attention.launches == before + 1
    assert fak.flash_attention.paths[which] == on_path + 1
    assert which == ("split" if sq <= 8 and dh <= 4096 else
                     "mma" if dtype == torch.bfloat16 and dh <= 256 else
                     "simt")
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs()
    assert bool((err <= ref.flash_attention_tolerance(want)).all()), \
        float(err.max())
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-3
    if sq * sk <= 128 * 384:
        naive = ref.attention_reference(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), naive.float(), rtol=tol,
                                   atol=tol)


def test_flash_attention_kernel_refuses_bad_inputs(cuda):
    from repro_torch.kernels import flash_attention as fak
    x = torch.zeros((2, 8, 16), device=cuda)
    with pytest.raises(TypeError):
        fak.flash_attention(x.double(), x.double(), x.double(), causal=False,
                            scale=1.0)
    with pytest.raises(ValueError):
        fak.flash_attention(x, x[:, :, :8].contiguous(), x, causal=False,
                            scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fak.flash_attention(x.transpose(1, 2), x.transpose(1, 2),
                            x.transpose(1, 2), causal=False, scale=1.0)


@pytest.mark.parametrize("d", [129, 1537])
def test_range_rerank_heads_kernel_matches_plain(cuda, d):
    """H = 5 forests of the decode shape (d = 129, g = 2 lanes a head, a
    done lane, tombstones) and of a width past the old whole-row query
    tile (d = 1,537): the +inf mask of the plain version, finite entries
    within the range_rerank test's tolerance, and every head equal bit for
    bit to a single-forest launch on that head's arrays."""
    H, g, L, K, ls, n = 5, 2, 4, 4, 32, 3000
    parts = [_forest_inputs(cuda, n, g, K, L, ls, d, seed=50 + h)
             for h in range(H)]
    f = [p[0] for p in parts]
    cat = {name: torch.stack([getattr(x, name) for x in f])
           for name in ("leaf_lo", "leaf_hi", "leaf_valid", "breakpoints",
                        "valid")}
    pts = torch.stack([p[1].points_sorted for p in parts])
    q = torch.stack([p[2] for p in parts])
    q_proj = torch.stack([p[3] for p in parts])
    r = torch.tensor(parts[0][4].uniform(0.5, 3.0, (H, g)),
                     dtype=torch.float32, device=cuda)
    r[1, 1] = -1.0
    live = torch.tensor(parts[0][4].random(cat["valid"].shape) > 0.1,
                        device=cuda)
    args = (q, q_proj, r, cat["leaf_lo"], cat["leaf_hi"], cat["leaf_valid"],
            cat["breakpoints"], pts, cat["valid"], live)
    before = rr.range_rerank_heads.launches
    got = ops.range_rerank_heads(*args, leaf_size=ls)
    assert rr.range_rerank_heads.launches == before + 1
    want = ref.range_rerank_heads(*args, leaf_size=ls)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    assert fin.any() and (~fin).any()
    max_sq = float((pts ** 2).sum(-1).max())
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4,
                               atol=1e-4 * max_sq)
    assert torch.isinf(got[1, :, 1]).all()
    for h in range(H):
        single = rr.range_rerank(
            q[h], q_proj[h], r[h].expand(L, g), cat["leaf_lo"][h],
            cat["leaf_hi"][h], cat["leaf_valid"][h], cat["breakpoints"][h],
            pts[h], cat["valid"][h], live[h], leaf_size=ls)
        assert torch.equal(got[h], single), h


def test_lsh_decoder_on_the_card_matches_the_cpu(cuda):
    """A short LSHDecoder loop over one index state on both devices (the
    CPU index's forests moved to the card): the same candidate tables and
    outputs within 1e-5; on the card the retrieval launches the heads
    kernel once a round."""
    from repro_torch.decode import (HeadForest, KVCacheIndex, KVSpec,
                                    LSHDecoder)
    rng = np.random.default_rng(3)
    b, S, hk, g, dh = 2, 1024, 2, 2, 64
    k = (rng.standard_normal((b, S, hk, dh)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, S, hk, dh)).astype(np.float32)
    prefill = S - 24
    spec = KVSpec(m_top=32, delta_capacity=32)
    cpu = KVCacheIndex.prefill(k[:, :prefill], torch.Generator().manual_seed(0),
                               spec, device="cpu")
    card = KVCacheIndex(spec, cpu.params,
                        cpu.A.to(cuda), b, hk, dh, cpu.R2.to(cuda),
                        HeadForest(*(t.to(cuda) for t in cpu.forest)),
                        cpu._aug.copy())
    dec = {"cpu": LSHDecoder(cpu, window=16, sinks=4, refresh_every=4),
           "cuda": LSHDecoder(card, window=16, sinks=4, refresh_every=4)}
    caches = {dev: (torch.tensor(k, device=dev), torch.tensor(v, device=dev))
              for dev in dec}
    before = rr.range_rerank_heads.launches
    for t in range(12):
        length = prefill + t + 1
        pos = int(rng.integers(0, prefill))
        q = np.repeat(k[:, pos][:, :, None, :], g, 2).reshape(
            b, 1, hk * g, dh) * 8.0
        out = {dev: dec[dev].step(torch.tensor(q, device=dev), *caches[dev],
                                  caches[dev][0][:, length - 1], length)
               for dev in dec}
        assert torch.equal(dec["cuda"]._positions.cpu(),
                           dec["cpu"]._positions)
        torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=1e-5,
                                   atol=1e-5)
    assert dec["cuda"].n_refreshes == 3
    assert rr.range_rerank_heads.launches > before
