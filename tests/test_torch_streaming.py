"""PyTorch port: the streaming mutable index against the reference package.

jax.random cannot be reproduced in torch, so the reference's state crosses
over through a snapshot: a streaming index built and mutated by ``repro``
(seals, deletes, overwrites, a compaction, then more seals with tombstones
and un-sealed delta rows) is loaded by ``repro_torch`` and has the same
``state_digest`` and the same answers on both engines, and the reverse.

Tolerances, each with its reason:
  * distances: rtol 1e-5 plus atol 1e-6 * max|x|^2 — the engines'
    qq - 2 q.p + pp form cancels near a query and both packages sum dot
    products in their own order (tests/test_torch_search.py); ids, rounds
    and candidate counts are exact.
  * the seal's projection: the port sums x @ A over d in index order (so
    its CUDA kernel can match it bit for bit), XLA in another order, so
    proj_t agrees within 1e-6 * max|proj|; a code (and its tree's key) may
    differ only where the coordinate lies within that distance of an inner
    breakpoint edge.
  * compaction and every cross-loaded array: bit-identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.streaming import merge_segments as jmerge  # noqa: E402
from repro.streaming.segment import build_segment as jbuild_segment  # noqa: E402
from repro_torch.core.detree import code_sort_orders, interleave_keys  # noqa: E402
from repro_torch.core.theory import LSHParams  # noqa: E402
from repro_torch.kernels import build_fused, ops as tops  # noqa: E402
from repro_torch.streaming import StreamingDETLSH, merge_segments  # noqa: E402
from repro_torch.streaming.compactor import interleave_keys64  # noqa: E402
from repro_torch.streaming.segment import build_segment  # noqa: E402
from tests.conftest import make_clustered, make_queries_near  # noqa: E402

D = 16
SAT = dict(r_min=1e6, M=10**6)         # saturating query: admit everything
_FOREST = ("point_ids", "proj_sorted", "codes_sorted", "valid", "leaf_lo",
           "leaf_hi", "leaf_valid", "breakpoints")


def _spec(api, **kw):
    base = dict(kind="streaming", K=4, L=4, c=1.5, beta_override=0.1, Nr=32,
                leaf_size=16, delta_capacity=128, max_segments=2)
    base.update(kw)
    return api.IndexSpec(**base)


def _assert_same_answers(j, t, scale):
    np.testing.assert_array_equal(np.asarray(j.ids), t.ids.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(j.stats.rounds),
                                  t.stats.rounds.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(j.stats.n_candidates),
                                  t.stats.n_candidates.cpu().numpy())
    np.testing.assert_allclose(t.dists.cpu().numpy(), np.asarray(j.dists),
                               rtol=1e-5, atol=1e-6 * scale)


def _max_sq(*arrays):
    return float(max((a * a).sum(-1).max() for a in arrays))


# ---------------------------------------------------------------------------
# The seal's kernel: the plain project_encode_pack against the reference's
# ---------------------------------------------------------------------------

def _near_inner_edge(proj, bp, tol):
    """(n, D) bool: coordinate within ``tol`` of one of its dim's inner
    breakpoint edges (the only places a code may differ)."""
    inner = bp[:, 1:-1]                                        # (D, Nr-1)
    gap = np.abs(proj[:, :, None] - inner[None, :, :]).min(-1)
    return gap <= tol


def _check_codes_under_edge_rule(got, want, bp, K, L):
    """proj_t within 1e-6 * max|proj|; codes and keys equal except at
    coordinates that close to an inner edge.  Returns the mismatch count."""
    proj_w = np.asarray(want[0])
    tol = 1e-6 * float(np.abs(proj_w).max())
    np.testing.assert_allclose(got[0].numpy(), proj_w, rtol=0, atol=tol)
    n = proj_w.shape[1]
    proj_rows = got[0].numpy().transpose(1, 0, 2).reshape(n, L * K)
    near = _near_inner_edge(proj_rows, bp, tol)                # (n, L*K)
    near_t = near.reshape(n, L, K).transpose(1, 0, 2)          # (L, n, K)
    diff = got[1].numpy() != np.asarray(want[1])
    assert not (diff & ~near_t).any(), "a code differs away from any edge"
    rows_same = ~diff.any(-1)                                  # (L, n)
    for g, w in zip(got[2:], want[2:]):
        w = np.asarray(w).astype(np.int64)
        np.testing.assert_array_equal(g.numpy()[rows_same], w[rows_same])
    return int(diff.sum())


@pytest.mark.parametrize("n,d,K,L,Nr", [(256, 32, 4, 4, 64),
                                        (100, 17, 2, 3, 16),
                                        (512, 128, 8, 2, 256),
                                        (300, 128, 16, 4, 256)])
def test_project_encode_pack_plain_matches_reference(n, d, K, L, Nr):
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    a = rng.standard_normal((d, L * K)).astype(np.float32)
    bp = np.sort(rng.standard_normal((L * K, Nr + 1)).astype(np.float32) * 3,
                 axis=1, kind="stable")
    want = jops.project_encode_pack(jnp.asarray(x), jnp.asarray(a),
                                    jnp.asarray(bp), K=K, L=L,
                                    interpret=True, block_n=64)
    before = build_fused.project_encode_pack.launches
    got = tops.project_encode_pack(torch.tensor(x), torch.tensor(a),
                                   torch.tensor(bp), K=K, L=L)
    assert build_fused.project_encode_pack.launches == before  # CPU: plain
    assert [g.dtype for g in got] == [torch.float32, torch.int32,
                                      torch.int64, torch.int64]
    _check_codes_under_edge_rule(got, want, bp, K, L)
    # interpret=True is the same plain version
    again = tops.project_encode_pack(torch.tensor(x), torch.tensor(a),
                                     torch.tensor(bp), K=K, L=L,
                                     interpret=True)
    for g, h in zip(got, again):
        assert torch.equal(g, h)


def test_plain_projection_sums_in_index_order():
    """The plain projection is the left-to-right f32 sum of rounded
    products (what the CUDA kernel computes), not a reassociated dot."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 37)).astype(np.float32)
    a = rng.standard_normal((37, 8)).astype(np.float32)
    want = np.zeros((64, 8), np.float32)
    for j in range(37):
        want = (want + (x[:, j, None] * a[j]).astype(np.float32)).astype(
            np.float32)
    np.testing.assert_array_equal(
        ref.project(torch.tensor(x), torch.tensor(a)).numpy(), want)


@pytest.mark.parametrize("K,L", [(4, 4), (16, 2)])
def test_build_segment_matches_reference(K, L):
    """The seal (one project_encode_pack pass, widening, sort, assembly)
    from the same rows, A and frozen breakpoints: forests, widened
    breakpoints and clip_fraction as the reference's, under the edge rule;
    bit-identical wherever no code differs."""
    rng = np.random.default_rng(K * 10 + L)
    base = make_clustered(rng, 800, D)
    rows = np.concatenate([make_clustered(rng, 190, D),
                           4.0 * make_clustered(rng, 10, D)])   # some clip
    A = rng.standard_normal((D, L * K)).astype(np.float32)
    proj = base @ A
    bp_all = np.sort(proj[rng.choice(800, 200, replace=False)].T, axis=1,
                     kind="stable")[:, np.linspace(0, 199, 33).astype(int)]
    bp_all = np.ascontiguousarray(bp_all.astype(np.float32))
    params = japi.IndexSpec(K=K, L=L, beta_override=0.1).derive_params()
    live = rng.random(200) > 0.2
    gids = np.arange(1000, 1200)
    want = jbuild_segment(jnp.asarray(rows), gids, jnp.asarray(A), params,
                          jnp.asarray(bp_all), Nr=32, leaf_size=16,
                          seg_id=3, live=live)
    got = build_segment(rows, gids, torch.tensor(A),
                        LSHParams(**dataclasses.asdict(params)),
                        torch.tensor(bp_all), Nr=32, leaf_size=16, seg_id=3,
                        live=live)
    assert got.m == want.m and got.seg_id == 3
    np.testing.assert_array_equal(got.gids, want.gids)
    np.testing.assert_array_equal(got.live, want.live)
    assert got.gids.dtype == want.gids.dtype == np.int32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    # codes/keys under the edge rule, through the per-row layouts
    fw, fg = want.forest, got.forest
    tol = 1e-6 * float(np.abs(np.asarray(fw.proj_sorted)).max())
    bp_w, bp_g = np.asarray(fw.breakpoints), fg.breakpoints.numpy()
    np.testing.assert_array_equal(bp_g[..., 1:-1], bp_w[..., 1:-1])
    np.testing.assert_allclose(bp_g, bp_w, rtol=0, atol=tol)
    exact_proj = torch.tensor(rows) @ torch.tensor(A)
    near_outer = np.minimum(
        np.abs(exact_proj.numpy() - bp_all[:, 0]),
        np.abs(exact_proj.numpy() - bp_all[:, -1])).min() <= 2 * tol
    if not near_outer:
        assert got.clip_fraction == want.clip_fraction > 0.0
    mism = 0
    for l in range(L):
        pid_w = np.asarray(fw.point_ids[l])[np.asarray(fw.valid[l])]
        pid_g = fg.point_ids[l].numpy()[fg.valid[l].numpy()]
        cw = np.empty((200, K), np.int64)
        cg = np.empty((200, K), np.int64)
        cw[pid_w] = np.asarray(fw.codes_sorted[l])[np.asarray(fw.valid[l])]
        cg[pid_g] = fg.codes_sorted[l].numpy()[fg.valid[l].numpy()]
        near = _near_inner_edge(exact_proj.numpy()[:, l * K:(l + 1) * K],
                                bp_all[l * K:(l + 1) * K], 2 * tol)
        assert not ((cw != cg) & ~near).any()
        mism += int((cw != cg).sum())
    if mism == 0:
        for name in _FOREST:
            w, g = np.asarray(getattr(fw, name)), getattr(fg, name).numpy()
            assert g.dtype == w.dtype, name
            if name in ("proj_sorted", "breakpoints"):
                np.testing.assert_allclose(g, w, rtol=0, atol=tol)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla", "pallas_interpret"])
def test_seal_impl_names_run_the_same_function_on_the_cpu(impl):
    """Every seal impl name is project_encode_pack's function: on a CPU
    tensor the kernel's plain version, launching nothing."""
    rng = np.random.default_rng(2)
    data = make_clustered(rng, 300, D)
    rows = make_clustered(rng, 64, D)
    idx, ref_idx = (tapi.build(data, torch.Generator().manual_seed(0),
                               _spec(tapi, delta_capacity=64, build_impl=b),
                               device="cpu") for b in (impl, "auto"))
    before = build_fused.project_encode_pack.launches
    for x in (idx, ref_idx):
        x.upsert(rows)
    assert build_fused.project_encode_pack.launches == before
    assert set(idx.last_seal_seconds) == {"project_encode_pack", "widen",
                                          "sort", "assemble", "total"}
    assert ref_idx.state_digest() == idx.state_digest()


# ---------------------------------------------------------------------------
# Compaction: host keys in the device's sort order; cross-loaded merges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [4, 9, 16])
def test_interleave_keys64_order_equals_code_sort_orders(K):
    """The compactor merges on host uint64 keys; the segments' arrays are
    in the device sort order (biased int64 keys).  The two orders must be
    one order, dropped bits (K = 9: lo positions past 32) included."""
    rng = np.random.default_rng(K)
    codes = rng.integers(0, 256, size=(3, 500, K))
    codes[:, :100] = codes[:, 100:200]               # plenty of equal keys
    codes[:, :50, 0] = 255                           # hi words >= 2^31
    hi, lo = interleave_keys(torch.tensor(codes, dtype=torch.int32), K)
    keys = interleave_keys64(codes.astype(np.uint8), K)
    np.testing.assert_array_equal(
        keys, (hi.numpy().astype(np.uint64) << np.uint64(32))
        | lo.numpy().astype(np.uint64))
    device_order = code_sort_orders(hi, lo, K).numpy()
    host_order = np.argsort(keys, axis=1, kind="stable")
    np.testing.assert_array_equal(device_order, host_order)


@pytest.fixture(scope="module")
def reference_pair(tmp_path_factory):
    """A reference streaming index after seals, deletes, overwrites, a
    compaction, then more seals with tombstones and un-sealed delta rows;
    saved, and loaded by the port."""
    rng = np.random.default_rng(21)
    data = make_clustered(rng, 1200, D)
    jidx = japi.build(jnp.asarray(data), jax.random.key(0), _spec(japi))
    g1 = jidx.upsert(make_clustered(rng, 300, D))      # 2 seals + 44 delta
    jidx.delete(np.arange(0, 60, 3))                   # base tombstones
    jidx.upsert(make_clustered(rng, 30, D), gids=np.arange(100, 130))
    jidx.delete(g1[:20])                               # sealed tombstones
    assert jidx.maybe_compact()                        # 3 segments > 2
    g2 = jidx.upsert(make_clustered(rng, 200, D))      # 2 seals + 18 delta
    jidx.delete(g2[::7])
    jidx.delete(np.arange(300, 320))
    assert len(jidx.manifest.segments) == 3
    assert jidx.memtable.count == 18 and jidx.memtable.n_live < 18
    assert all(s.has_tombstones for s in jidx.manifest.segments[1:])
    path = tmp_path_factory.mktemp("stream") / "snap"
    jidx.save(str(path))
    tidx = tapi.load(path, device="cpu")
    queries = make_queries_near(data, rng, 12)
    return jidx, tidx, queries, path, _max_sq(data)


def test_cross_loaded_state_digest_is_equal(reference_pair):
    jidx, tidx, _, _, _ = reference_pair
    assert isinstance(tidx, StreamingDETLSH)
    assert isinstance(tidx, tapi.MutableAnnIndex)
    assert tidx.state_digest() == jidx.state_digest()
    assert tidx.n_live == jidx.n_live and tidx.n_total == jidx.n_total
    assert tidx.locator == jidx.locator
    st, sj = tidx.stats(), jidx.stats()
    # manifest versions count structural changes since build or load
    assert st["manifest"].pop("version") == len(tidx.manifest.segments)
    sj["manifest"].pop("version")
    assert st == sj


@pytest.mark.parametrize("kw", [dict(engine="fused"),
                                dict(engine="fused", r_min=0.05),
                                dict(engine="fused", r_min=0.05, n_active=9),
                                dict(engine="vmap"),
                                dict(engine="vmap", r_min=0.05, M=4),
                                dict(engine="vmap", r_min=0.05, n_active=9),
                                dict(engine="vmap", mode="strict",
                                     r_min=0.05)],
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_cross_loaded_searches_answer_as_the_reference(reference_pair, kw):
    jidx, tidx, q, _, scale = reference_pair
    want = jidx.search(jnp.asarray(q), japi.SearchRequest(k=10, **kw))
    got = tidx.search(q, tapi.SearchRequest(k=10, **kw))
    assert got.stats.r_min == want.stats.r_min
    assert got.stats.engine == want.stats.engine
    _assert_same_answers(want, got, scale)
    np.testing.assert_array_equal(np.asarray(want.stats.probed_leaves),
                                  got.stats.probed_leaves.numpy())
    if "n_active" in kw:
        assert not got.stats.n_candidates[kw["n_active"]:].any()


def test_merge_segments_of_cross_loaded_segments_is_bit_identical(
        reference_pair):
    jidx, tidx, _, _, _ = reference_pair
    want = jmerge(jidx.manifest.segments, leaf_size=16, seg_id=50)
    got = merge_segments(tidx.manifest.segments, leaf_size=16, seg_id=50)
    assert got.m == want.m and got.clip_fraction == want.clip_fraction
    np.testing.assert_array_equal(got.gids, want.gids)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    for name in _FOREST:
        w, g = np.asarray(getattr(want.forest, name)), \
            getattr(got.forest, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_pinned_views_and_further_mutation_stay_equal(reference_pair):
    """Fresh loads of the same snapshot in both packages: pin a view,
    apply the same delete + compaction to both, and the digests stay equal
    while each pinned view still answers as before the mutation."""
    _, _, q, path, scale = reference_pair
    jidx = japi.load(str(path))
    tidx = tapi.load(path, device="cpu")
    req_j = japi.SearchRequest(k=10, r_min=0.05, engine="fused")
    req_t = tapi.SearchRequest(k=10, r_min=0.05, engine="fused")
    view_j, view_t = jidx.pin_state(), tidx.pin_state()
    before = tidx.search(q, req_t)
    for idx in (jidx, tidx):
        idx.delete(np.arange(400, 700, 2))
        assert idx.compact()
    assert tidx.state_digest() == jidx.state_digest()
    pinned_t = tidx.search(q, req_t, view=view_t)
    assert torch.equal(pinned_t.ids, before.ids)
    assert torch.equal(pinned_t.dists, before.dists)
    _assert_same_answers(jidx.search(jnp.asarray(q), req_j, view=view_j),
                         pinned_t, scale)
    vecs_j, gids_j = view_j.survivors()
    vecs_t, gids_t = view_t.survivors()
    np.testing.assert_array_equal(gids_t, gids_j)
    np.testing.assert_array_equal(vecs_t, vecs_j)
    _assert_same_answers(jidx.search(jnp.asarray(q), req_j),
                         tidx.search(q, req_t), scale)


def test_port_snapshot_loads_in_the_reference(tmp_path):
    rng = np.random.default_rng(31)
    data = make_clustered(rng, 900, D)
    tidx = tapi.build(data, torch.Generator().manual_seed(4), _spec(tapi),
                      device="cpu")
    g = tidx.upsert(make_clustered(rng, 280, D))       # 2 seals + 24 delta
    tidx.upsert(make_clustered(rng, 5, D), gids=np.arange(10, 15))
    tidx.delete(np.concatenate([np.arange(200, 260), g[::9]]))
    q = make_queries_near(data, rng, 10)
    got = {e: tidx.search(q, tapi.SearchRequest(k=8, r_min=0.05, engine=e))
           for e in ("fused", "vmap")}
    tidx.save(tmp_path / "snap")
    jidx = japi.load(str(tmp_path / "snap"))
    assert jidx.state_digest() == tidx.state_digest()
    assert jidx.spec == japi.IndexSpec(**tidx.spec.to_dict())
    for e, res in got.items():
        want = jidx.search(jnp.asarray(q), japi.SearchRequest(
            k=8, r_min=0.05, engine=e))
        _assert_same_answers(want, res, _max_sq(data))
    # the r_min cache persists only while current for the structure
    tidx.search(q, tapi.SearchRequest(k=8))
    tidx.save(tmp_path / "snap2")
    assert 8 in tapi.load(tmp_path / "snap2", device="cpu")._rmin_entries()
    tidx.delete([1])
    tidx.upsert(data[:1])
    tidx.save(tmp_path / "snap3")
    assert not tapi.load(tmp_path / "snap3",
                         device="cpu")._rmin_entries()


# ---------------------------------------------------------------------------
# Behaviour, mirroring tests/test_streaming.py on the port alone
# ---------------------------------------------------------------------------

def _index(rng, n=300, **kw):
    data = make_clustered(rng, n, D)
    kw.setdefault("delta_capacity", 64)
    kw.setdefault("max_segments", 3)
    idx = tapi.build(data, torch.Generator().manual_seed(0), _spec(tapi, **kw),
                     device="cpu")
    return idx, data


def _survivors_bf(idx, queries, k):
    vecs, gids = idx._survivors()
    d2 = ((queries[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    sel = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return gids[sel], np.sqrt(np.take_along_axis(d2, sel, axis=1))


@pytest.mark.parametrize("engine", ["fused", "vmap"])
def test_saturating_search_is_brute_force_over_survivors(engine):
    """At a saturating radius every live point is reranked exactly, so the
    answer is the exact top-k of the survivors, before and after
    compaction; deleted ids never come back."""
    rng = np.random.default_rng(11)
    idx, data = _index(rng, n=600)
    gids_new = idx.upsert(make_clustered(rng, 150, D))
    idx.delete(np.arange(0, 40))
    idx.delete(gids_new[:10])
    idx.delete(gids_new[-3:])                          # in the delta
    queries = make_clustered(rng, 8, D)
    dead = set(range(40)) | {int(g) for g in gids_new[:10]} \
        | {int(g) for g in gids_new[-3:]}
    for stage in ("tombstones", "compacted"):
        res = idx.search(queries, tapi.SearchRequest(k=10, engine=engine,
                                                     **SAT))
        gt_g, gt_d = _survivors_bf(idx, queries, 10)
        np.testing.assert_allclose(res.dists.numpy(), gt_d, rtol=1e-4,
                                   atol=1e-4)
        for b in range(len(queries)):                  # equal up to ties
            assert set(res.ids[b].tolist()) == set(gt_g[b].tolist()), stage
        big = idx.search(queries, tapi.SearchRequest(k=60, engine=engine,
                                                     **SAT))
        assert not set(big.ids.flatten().tolist()) & dead
        if stage == "tombstones":
            assert idx.compact()
            assert not any(s.has_tombstones for s in idx.manifest.segments)


def test_upsert_visible_immediately_and_overwrites():
    rng = np.random.default_rng(3)
    idx, data = _index(rng)
    probe = (data[0] + 50.0).astype(np.float32)
    [gid] = idx.upsert(probe)
    assert idx.memtable.n_live == 1
    res = idx.search(probe[None, :], tapi.SearchRequest(k=1, r_min=1.0))
    assert int(res.ids[0, 0]) == int(gid) and float(res.dists[0, 0]) < 1e-3
    moved = (data[5] + 100.0).astype(np.float32)
    idx.upsert(moved, gids=[5])
    assert idx.n_live == 301                           # moved, not added
    res = idx.search(moved[None, :], tapi.SearchRequest(k=1, **SAT))
    assert int(res.ids[0, 0]) == 5 and float(res.dists[0, 0]) < 1e-3
    old = idx.search(data[5][None, :], tapi.SearchRequest(k=301, **SAT))
    assert float(old.dists[0][old.ids[0] == 5][0]) > 90.0


def test_seal_fixed_shape_and_locator():
    rng = np.random.default_rng(5)
    idx, _ = _index(rng, n=200, delta_capacity=32)
    gids = idx.upsert(make_clustered(rng, 70, D))      # 2 seals + 6 delta
    assert [s.m for s in idx.manifest.segments[1:]] == [32, 32]
    assert idx.memtable.count == 6
    for g in gids:
        where, pos = idx.locator[int(g)]
        if where == "delta":
            assert idx.memtable.gids[pos] == g
        else:
            assert idx._segment(where).gids[pos] == g
    # the segment owns its rows: the memtable was zeroed after the seal
    seg = idx.manifest.segments[1]
    assert float(seg.data.abs().sum()) > 0
    assert not idx.memtable.vecs[6:].any()


def test_compaction_merges_sorted_and_drops_tombstones():
    rng = np.random.default_rng(6)
    idx, _ = _index(rng, n=200, delta_capacity=32, max_segments=1)
    gids = idx.upsert(make_clustered(rng, 64, D))
    idx.delete(gids[:16])
    idx.delete(np.arange(10))
    n_live = idx.n_live
    assert idx.maybe_compact()
    [seg] = idx.manifest.segments
    assert seg.m == n_live - idx.memtable.n_live and not seg.has_tombstones
    for l in range(seg.forest.L):
        valid = seg.forest.valid[l].numpy()
        keys = interleave_keys64(seg.forest.codes_sorted[l].numpy()[valid],
                                 seg.forest.K)
        assert np.all(keys[1:] >= keys[:-1])
    assert not set(seg.gids.tolist()) & {int(g) for g in gids[:16]}


def test_clip_fraction_and_requantile():
    rng = np.random.default_rng(9)
    idx, _ = _index(rng, delta_capacity=32)
    assert idx.clip_fraction() == 0.0
    far = (make_clustered(rng, 64, D) * 20.0).astype(np.float32)
    idx.upsert(far)
    assert idx.clip_fraction() > 0.0
    n_live = idx.n_live
    idx.requantile(torch.Generator().manual_seed(1))
    assert idx.clip_fraction() == 0.0 and idx.n_live == n_live
    assert len(idx.manifest.segments) == 1
    res = idx.search(far[:2], tapi.SearchRequest(k=1, **SAT))
    assert float(res.dists[0, 0]) < 1e-3


def test_gid_exhaustion_negative_gids_and_in_call_dedup():
    rng = np.random.default_rng(12)
    idx, data = _index(rng, n=64, delta_capacity=8, id_capacity=80)
    with pytest.raises(ValueError, match="gid space exhausted"):
        idx.upsert(make_clustered(rng, 20, D))
    assert idx.next_gid == 64 and idx.n_live == 64
    idx.grow_id_capacity(256)
    gids = idx.upsert(make_clustered(rng, 20, D))
    res = idx.search(data[:2], tapi.SearchRequest(k=idx.n_live, **SAT))
    assert {int(g) for g in gids} <= set(res.ids.flatten().tolist())
    with pytest.raises(ValueError, match="shrink"):
        idx.grow_id_capacity(10)
    with pytest.raises(ValueError, match="non-negative"):
        idx.upsert(np.zeros((1, D), np.float32), gids=[-1])
    assert idx.n_live == 84
    v1 = np.full((1, D), 1.0, np.float32)
    v2 = np.full((1, D), 2.0, np.float32)
    idx.upsert(np.concatenate([v1, v2]), gids=[200, 200])
    assert idx.n_live == 85
    res = idx.search(v2, tapi.SearchRequest(k=2, **SAT))
    assert int(res.ids[0, 0]) == 200 and float(res.dists[0, 0]) < 1e-4
    assert int(res.ids[0, 1]) != 200


def test_pad_lanes_admit_nothing_from_delta():
    rng = np.random.default_rng(14)
    idx, data = _index(rng, n=128, delta_capacity=32)
    idx.upsert(make_clustered(rng, 5, D))
    qs = np.concatenate([data[:2], np.zeros((3, D), np.float32)])
    for engine in ("fused", "vmap"):
        res = idx.search(qs, tapi.SearchRequest(k=4, engine=engine,
                                                n_active=2, r_min=1.0))
        assert not res.stats.n_candidates[2:].any(), engine
        assert (res.ids[2:] == idx.id_capacity).all(), engine


def test_streaming_entry_points_follow_the_device_rule(tmp_path,
                                                       monkeypatch):
    rng = np.random.default_rng(15)
    data = make_clustered(rng, 200, D)
    idx = tapi.build(data, None, _spec(tapi, delta_capacity=32),
                     device="cpu")
    assert idx.device == torch.device("cpu")
    idx.save(tmp_path / "snap")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.build(data, None, _spec(tapi))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingDETLSH.build(data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.load(tmp_path / "snap")
    # project_impl in the pallas names builds now: the base build, and a
    # seal on the reference-builder path, project through lsh_project (its
    # plain version on the CPU, the d-order FMA sum).
    from repro_torch.kernels import ref
    rows = make_clustered(rng, 40, D)
    for impl in ("pallas", "pallas_interpret"):
        built = tapi.build(data, None, _spec(tapi, project_impl=impl,
                                             build_impl="reference"),
                           device="cpu")
        assert torch.equal(built.A, idx.A)
        seg = build_segment(rows, np.arange(40), built.A, built.params,
                            built.bp_all, Nr=32, leaf_size=16, seg_id=1,
                            project_impl=impl, build_impl="reference")
        f = seg.forest
        want = ref.lsh_project(torch.tensor(rows), built.A).reshape(40, 4, 4)
        got = torch.empty_like(want)
        for l in range(4):
            got[f.point_ids[l, :40].to(torch.int64), l] = f.proj_sorted[l, :40]
        assert torch.equal(got, want), impl
