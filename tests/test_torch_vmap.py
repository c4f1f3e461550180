"""PyTorch port: the per-query vmap engine against the reference package.

The same numpy inputs go through the JAX function and its port:
  (a) the plain ``leaf_bounds`` against the reference's kernel in interpret
      mode (+inf equal; finite bounds at 1e-6, since XLA sums the K squares
      in another order than the port's fixed k order);
  (b) the plain ``l2_rerank``, 2-D and grouped, against the reference's
      kernel in interpret mode, at the reference's tolerances;
  (c) the incremental candidate merge against the reference's, round by
      round, and against the sort-based oracle;
  (d) a reference snapshot searched by the port's vmap engine: same ids,
      rounds and counters; distances at rtol 1e-5 plus atol
      1e-6 * max|x|^2 (the packages sum in f32 in other orders, and the
      'pallas' rerank's qq - 2 q.p + pp form cancels near a query, so its
      error scales with |x|^2);
  (e) the (r,c)-ANN query (Alg. 4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.core import candidates as jcand  # noqa: E402
from repro.core import query as jquery  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import candidates as tcand  # noqa: E402
from repro_torch.core import detree as tdetree  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402
from repro_torch.core.query import knn_query, rc_ann_query  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from tests.conftest import make_clustered, make_queries_near  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# (a) leaf_bounds
# ---------------------------------------------------------------------------

def _leaf_inputs(rng, nl, K, Nr, trees=1):
    bp = np.sort((rng.standard_normal((trees, K, Nr + 1)) * 3.0)
                 .astype(np.float32), axis=-1, kind="stable")
    lo = rng.integers(0, Nr, (trees, nl, K)).astype(np.int16)
    hi = np.clip(lo + rng.integers(0, 8, (trees, nl, K)), 0,
                 Nr - 1).astype(np.int16)
    valid = rng.random((trees, nl)) > 0.1
    return bp, lo, hi, valid


@pytest.mark.parametrize("nl,K,Nr", [(256, 4, 256), (300, 16, 64),
                                     (17, 2, 16), (512, 8, 128)])
def test_leaf_bounds_plain_matches_reference_kernel(nl, K, Nr):
    rng = np.random.default_rng(nl + K)
    L, B = 3, 5
    bp, lo, hi, valid = _leaf_inputs(rng, nl, K, Nr, trees=L)
    q = (rng.standard_normal((L, B, K)) * 2.0).astype(np.float32)
    lb, ub = tref.leaf_bounds(_t(q), _t(lo), _t(hi), _t(valid), _t(bp))
    assert lb.shape == ub.shape == (L, B, nl)
    for l in (0, L - 1):
        for b in (0, B - 1):
            want_lb, want_ub = jops.leaf_bounds(
                jnp.asarray(q[l, b]), jnp.asarray(lo[l], jnp.int32),
                jnp.asarray(hi[l], jnp.int32), jnp.asarray(valid[l]),
                jnp.asarray(bp[l]), interpret=True)
            for got, want in ((lb[l, b], want_lb), (ub[l, b], want_ub)):
                want = np.asarray(want)
                np.testing.assert_array_equal(np.isinf(got.numpy()),
                                              np.isinf(want))
                fin = np.isfinite(want)
                np.testing.assert_allclose(got.numpy()[fin], want[fin],
                                           rtol=1e-6, atol=1e-6)
            # the single-tree form is a view of the forest form
            one = tref.leaf_bounds(_t(q[l, b]), _t(lo[l]), _t(hi[l]),
                                   _t(valid[l]), _t(bp[l]))
            assert torch.equal(one[0], lb[l, b])
            assert torch.equal(one[1], ub[l, b])
    # The engine's 'auto' expression is the reference's, summed by .sum(-1).
    for impl in ("auto", "pallas", "pallas_interpret"):
        got = tdetree.leaf_bounds(_t(q), _t(lo), _t(hi), _t(valid), _t(bp),
                                  impl=impl)
        for g, w in zip(got, (lb, ub)):
            assert torch.equal(torch.isinf(g), torch.isinf(w))
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# (b) l2_rerank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,m,d", [(128, 256, 128), (1, 1000, 64),
                                   (20, 300, 420), (128, 256, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_rerank_plain_matches_reference_kernel(b, m, d, dtype):
    rng = np.random.default_rng(b + m + d)
    G = 2
    q = rng.standard_normal((G, b, d)).astype(np.float32)
    c = rng.standard_normal((G, m, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    tq, tc = _t(q).to(tdt), _t(c).to(tdt)
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    grouped = tops.l2_rerank(tq, tc)
    assert grouped.shape == (G, b, m) and grouped.dtype == torch.float32
    for g in range(G):
        want = np.asarray(jops.l2_rerank(jnp.asarray(q[g]).astype(jdt),
                                         jnp.asarray(c[g]).astype(jdt),
                                         interpret=True))
        flat = tops.l2_rerank(tq[g], tc[g])                    # 2-D form
        np.testing.assert_allclose(flat.numpy(), want, rtol=tol, atol=tol)
        np.testing.assert_allclose(grouped[g].numpy(), want, rtol=tol,
                                   atol=tol)


def test_ops_refuse_unknown_devices_and_honour_interpret():
    q = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.l2_rerank(q, q)
    rng = np.random.default_rng(0)
    bp, lo, hi, valid = _leaf_inputs(rng, 40, 4, 16, trees=2)
    q = _t(rng.standard_normal((2, 3, 4)).astype(np.float32))
    args = (q, _t(lo), _t(hi), _t(valid), _t(bp))
    for got, want in zip(tops.leaf_bounds(*args, interpret=True),
                         tref.leaf_bounds(*args)):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# (c) candidate merge
# ---------------------------------------------------------------------------

def _round_ids(rng, B, m, n):
    ids = rng.integers(0, n + 8, (B, m))
    return np.minimum(ids, n).astype(np.int32)          # some sentinels n


def _dist_of(ids, n):
    """Id-consistent distances with cross-id ties, +inf for the sentinel."""
    return np.where(ids < n, (ids * 7 % 5).astype(np.float32), np.inf
                    ).astype(np.float32)


@pytest.mark.parametrize("n,B,m,rounds", [(70, 3, 16, 6), (1000, 4, 64, 5),
                                          (33, 2, 40, 3)])
def test_merge_round_matches_reference(n, B, m, rounds):
    rng = np.random.default_rng(n)
    cap = n + m                                       # capacity invariant
    state = tcand.init_state(n, cap, B)
    jstates = [jcand.init_state(n, cap) for _ in range(B)]
    o_ids = torch.full((B, cap), n, dtype=torch.int32)
    o_d = torch.full((B, cap), float("inf"))
    for _ in range(rounds):
        ids = _round_ids(rng, B, m, n)
        d = _dist_of(ids, n)
        state = tcand.merge_round(n, state, _t(ids), _t(d))
        o_ids, o_d, o_count = tquery._merge_candidates(n, o_ids, o_d,
                                                       _t(ids), _t(d))
        for b in range(B):
            jstates[b] = jcand.merge_round(n, jstates[b],
                                           jnp.asarray(ids[b]),
                                           jnp.asarray(d[b]))
            js = jstates[b]
            np.testing.assert_array_equal(state.ids[b].numpy(),
                                          np.asarray(js.ids))
            np.testing.assert_array_equal(state.dists[b].numpy(),
                                          np.asarray(js.dists))
            assert int(state.count[b]) == int(js.count)
            np.testing.assert_array_equal(state.seen[b].numpy().view(
                np.uint32), np.asarray(js.seen))
        # the incremental merge equals the sort-based oracle once sorted
        c_ids, c_d = tcand.canonicalize(n, state.ids, state.dists)
        assert torch.equal(c_ids, o_ids) and torch.equal(c_d, o_d)
        assert torch.equal(o_count, state.count)


def test_merge_oracle_matches_reference_oracle():
    rng = np.random.default_rng(5)
    n, cap = 50, 24                               # capacity pressure too
    t_ids = torch.full((cap,), n, dtype=torch.int32)
    t_d = torch.full((cap,), float("inf"))
    j_ids, j_d = jnp.full((cap,), n, jnp.int32), jnp.full((cap,), jnp.inf)
    for _ in range(6):
        ids = _round_ids(rng, 1, 20, n)[0]
        d = rng.choice(np.array([0.5, 1.0, 2.0], np.float32), 20)
        d = np.where(ids < n, d[ids % 20], np.inf).astype(np.float32)
        t_ids, t_d, t_count = tquery._merge_candidates(n, t_ids, t_d,
                                                       _t(ids), _t(d))
        j_ids, j_d, j_count = jquery._merge_candidates(
            n, j_ids, j_d, jnp.asarray(ids), jnp.asarray(d))
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
        assert int(t_count) == int(j_count)


# ---------------------------------------------------------------------------
# (d) a reference snapshot searched by the port's vmap engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(4, 8), (16, 4)],
                ids=["K4-L8", "K16-L4"])
def indexes(request, tmp_path_factory):
    K, L = request.param
    rng = np.random.default_rng(K)
    data = make_clustered(rng, 2048, 16)
    q = make_queries_near(data, rng, 8, noise=0.1)
    spec = japi.IndexSpec(kind="static", K=K, L=L, c=1.5, beta_override=0.1,
                          leaf_size=32)
    jidx = japi.build(jnp.asarray(data), jax.random.key(0), spec)
    path = tmp_path_factory.mktemp("snap") / f"K{K}L{L}"
    jidx.save(str(path))
    return jidx, tapi.load(path, device="cpu"), data, q


def _assert_same(j, t, data, *, probe=True):
    np.testing.assert_array_equal(np.asarray(j.ids), t.ids.numpy())
    for name in ("rounds", "n_candidates") + (
            ("probed_leaves", "probe_candidates") if probe else ()):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(t, name).numpy(), err_msg=name)
    atol = 1e-6 * float((data * data).sum(-1).max())
    np.testing.assert_allclose(t.dists.numpy(), np.asarray(j.dists),
                               rtol=1e-5, atol=atol)
    np.testing.assert_allclose(t.final_r.numpy(), np.asarray(j.final_r),
                               rtol=1e-6)


_SWEEP = [dict(mode=mode, M=M, probe_depth=pd)
          for mode in ("leaf", "strict") for M in (2, 8)
          for pd in ((0, 2) if mode == "leaf" else (0,))]


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("kw", _SWEEP,
                         ids=[f"{k['mode']}-M{k['M']}-p{k['probe_depth']}"
                              for k in _SWEEP])
def test_reference_snapshot_searched_by_the_vmap_engine(indexes, kw, impl):
    jidx, tidx, data, q = indexes
    req = dict(k=10, r_min=0.01, engine="vmap", bounds_impl=impl,
               dist_impl=impl, **kw)
    want = jidx.search(jnp.asarray(q), japi.SearchRequest(**req))
    got = tidx.search(q, tapi.SearchRequest(**req))
    assert got.stats.engine == want.stats.engine == "vmap"
    _assert_same(want.raw, got.raw, data)
    if not kw["probe_depth"]:
        assert int(got.stats.rounds.max()) >= 2   # several radius rounds


def test_vmap_engine_n_active_and_live_mask(indexes):
    jidx, tidx, data, q = indexes
    rng = np.random.default_rng(11)
    live = rng.random(data.shape[0]) > 0.3
    cfg = dict(k=10, M=4, r_min=0.01, engine="vmap")
    jcfg, tcfg = jquery.QueryConfig(**cfg), tquery.QueryConfig(**cfg)
    for n_active in (None, 5):
        want = jquery.knn_query_batch(
            jidx.data, jidx.forest, jidx.A, jidx.params, jnp.asarray(q),
            jcfg, live=jnp.asarray(live), n_active=n_active)
        got = tquery.knn_query_batch(
            tidx.data, tidx.forest, tidx.A, tidx.params, torch.tensor(q),
            tcfg, live=torch.tensor(live), n_active=n_active)
        _assert_same(want, got, data)
        ids = got.ids.numpy()
        assert live[ids[ids < data.shape[0]]].all()
    assert not got.rounds[5:].any() and (got.ids[5:] == data.shape[0]).all()


def test_single_query_knn_matches_reference(indexes):
    jidx, tidx, data, q = indexes
    cfg = dict(k=5, M=8, r_min=0.02, dist_impl="pallas")
    for i in (0, 3):
        want = jquery.knn_query(jidx.data, jidx.forest, jidx.A, jidx.params,
                                jnp.asarray(q[i]), jquery.QueryConfig(**cfg))
        got = knn_query(tidx.data, tidx.forest, tidx.A, tidx.params,
                        torch.tensor(q[i]), tquery.QueryConfig(**cfg))
        assert got.ids.shape == (5,) and got.rounds.shape == ()
        _assert_same(want, got, data)


# ---------------------------------------------------------------------------
# (e) the (r,c)-ANN query (Alg. 4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["leaf", "strict"])
def test_rc_ann_query_matches_reference(indexes, mode):
    jidx, tidx, data, q = indexes
    cfg = dict(k=1, M=4, mode=mode, bounds_impl="pallas")
    answered = 0
    for i, r in enumerate((0.02, 0.1, 0.3, 0.6)):
        want = jquery.rc_ann_query(
            jidx.data, jidx.forest, jidx.A, jidx.params, jnp.asarray(q[i]), r,
            jquery.QueryConfig(**cfg))
        got = rc_ann_query(tidx.data, tidx.forest, tidx.A, tidx.params,
                           torch.tensor(q[i]), r, tquery.QueryConfig(**cfg))
        _assert_same(want, got, data, probe=False)
        answered += int(got.ids[0]) < data.shape[0]
    assert answered > 0
