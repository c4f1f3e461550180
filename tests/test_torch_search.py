"""PyTorch port: the slice end to end against the reference package.

jax.random cannot be reproduced in torch, so the reference's state crosses
over through a snapshot (or the arrays it holds): an index built by
``repro`` is searched by ``repro_torch`` and answers with the same ids,
round counts and candidate counts, and the reverse.  Distances agree at
rtol 1e-5 plus atol 1e-6 * max|x|^2: both packages compute
sqrt(qq - 2 q.p + pp) in f32 with the dot products summed in another order,
and near a query that form cancels, so its error scales with |x|^2 (about
1e-7 * |x|^2 per term) rather than with the distance.  Data is clustered
and tie-free, so no two candidates sit within that rounding of each other.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.api import registry as jreg  # noqa: E402
from repro_torch.core import DETLSH  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from tests.conftest import make_clustered, make_queries_near  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _dataset(seed=0, n=2048, d=16, nq=16):
    rng = np.random.default_rng(seed)
    data = make_clustered(rng, n, d)
    return data, make_queries_near(data, rng, nq, noise=0.1)


def _assert_same_answers(j, t, data):
    np.testing.assert_array_equal(np.asarray(j.ids), t.ids.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(j.stats.rounds),
                                  t.stats.rounds.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(j.stats.n_candidates),
                                  t.stats.n_candidates.cpu().numpy())
    atol = 1e-6 * float((data * data).sum(-1).max())
    np.testing.assert_allclose(t.dists.cpu().numpy(), np.asarray(j.dists),
                               rtol=1e-5, atol=atol)


def _jax_index(data, K, L):
    spec = japi.IndexSpec(kind="static", K=K, L=L, c=1.5, beta_override=0.1,
                          leaf_size=32)
    return japi.build(jnp.asarray(data), jax.random.key(0), spec)


@pytest.mark.parametrize("probe_depth", [0, 2])
@pytest.mark.parametrize("K,L", [(4, 8), (16, 4)])
def test_reference_snapshot_searched_by_the_port(tmp_path, K, L,
                                                 probe_depth):
    data, q = _dataset()
    jidx = _jax_index(data, K, L)
    jidx.save(tmp_path / "snap")
    tidx = tapi.load(tmp_path / "snap", device="cpu")
    assert tidx.device == torch.device("cpu")
    for r_min in (0.05, 0.4):        # several rounds, and a one-round start
        want = jidx.search(jnp.asarray(q), japi.SearchRequest(
            k=10, r_min=r_min, engine="fused", probe_depth=probe_depth))
        got = tidx.search(q, tapi.SearchRequest(
            k=10, r_min=r_min, engine="fused", probe_depth=probe_depth))
        _assert_same_answers(want, got, data)
        if probe_depth:
            np.testing.assert_array_equal(
                np.asarray(want.stats.probed_leaves),
                got.stats.probed_leaves.numpy())
    assert int(got.stats.rounds.max()) >= 1


def _arrays_of(jidx):
    arrays = {"A": np.asarray(jidx.A), "data": np.asarray(jidx.data)}
    arrays.update({"forest." + k: np.asarray(getattr(jidx.forest, k))
                   for k in ("point_ids", "proj_sorted", "codes_sorted",
                             "valid", "leaf_lo", "leaf_hi", "leaf_valid",
                             "breakpoints")})
    return arrays


def test_reference_arrays_through_from_arrays():
    data, q = _dataset(seed=1)
    jidx = _jax_index(data, 16, 4)
    from repro_torch.core.theory import LSHParams
    tidx = DETLSH.from_arrays(
        _arrays_of(jidx), LSHParams(**dataclasses.asdict(jidx.params)),
        n=jidx.forest.n, leaf_size=jidx.forest.leaf_size, device="cpu")
    # r_min=None on both: the host-side estimate is the same numpy code.
    want = jidx.search(jnp.asarray(q), japi.SearchRequest(k=10,
                                                          engine="fused"))
    got = tidx.search(q, tapi.SearchRequest(k=10, engine="fused"))
    assert got.stats.r_min == want.stats.r_min
    _assert_same_answers(want, got, data)
    # n_active: trailing pad lanes are done from round 0.
    want = jidx.search(jnp.asarray(q), japi.SearchRequest(
        k=10, r_min=0.1, engine="fused", n_active=9))
    got = tidx.search(q, tapi.SearchRequest(k=10, r_min=0.1, engine="fused",
                                            n_active=9))
    _assert_same_answers(want, got, data)
    assert not got.stats.rounds[9:].any()


def test_port_snapshot_loads_in_the_reference(tmp_path):
    data, q = _dataset(seed=2)
    spec = tapi.IndexSpec(kind="static", K=4, L=8, c=1.5, beta_override=0.1,
                          leaf_size=32)
    tidx = tapi.build(data, torch.Generator().manual_seed(3), spec,
                      device="cpu")
    got = tidx.search(q, tapi.SearchRequest(k=10, r_min=0.08,
                                            engine="fused"))
    tidx.save(tmp_path / "snap")
    jidx = japi.load(str(tmp_path / "snap"))
    assert jidx.spec == japi.IndexSpec(**spec.to_dict())
    want = jidx.search(jnp.asarray(q), japi.SearchRequest(k=10, r_min=0.08,
                                                          engine="fused"))
    _assert_same_answers(want, got, data)
    # and back: the port reloads its own snapshot bit-identically
    again = tapi.load(tmp_path / "snap", device="cpu").search(
        q, tapi.SearchRequest(k=10, r_min=0.08, engine="fused"))
    assert torch.equal(again.ids, got.ids)
    assert torch.equal(again.dists, got.dists)


def test_port_search_quality_on_cpu():
    data, q = _dataset(seed=4, n=3000)
    idx = tapi.build(data, torch.Generator().manual_seed(0),
                     tapi.IndexSpec(K=4, L=8, beta_override=0.1,
                                    leaf_size=32), device="cpu")
    res = idx.search(q, tapi.SearchRequest(k=10, engine="fused"))
    from repro_torch.baselines.brute_force import BruteForce
    gt_ids, gt_d = BruteForce(idx.data).query(torch.tensor(q), 10)
    assert bool((res.dists <= idx.params.c ** 2 * gt_d + 1e-4).all())
    hits = (res.ids.long()[:, :, None] == gt_ids[:, None, :]).any(-1)
    assert float(hits.float().mean()) > 0.9
    assert set(idx.build_seconds) == {"projection", "breakpoints",
                                      "encode_pack", "sort", "assemble"}


def test_fused_topk_breaks_ties_like_lax_top_k():
    from repro.core.query import fused_topk as jax_topk
    from repro_torch.core.query import fused_topk
    rng = np.random.default_rng(9)
    best = rng.choice(np.array([0.5, 1.0, 2.0, np.inf], np.float32),
                      size=(6, 300))
    best[0] = np.inf                        # a lane with no candidate
    best[1, 7] = -0.0                       # sqrt(max(-0, 0)) can give -0
    for k in (1, 5, 40):
        got = fused_topk(torch.tensor(best), k, 300)
        want = jax_topk(jnp.asarray(best), k, 300)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# (e) engine resolution: the reference's answer for every request
# ---------------------------------------------------------------------------

def test_resolve_engine_agrees_with_reference():
    for engine in (None, "auto", "fused", "vmap"):
        for mode in ("leaf", "strict"):
            for batch in (1, 4, 7, 8, 9, 64, None):
                assert tapi.resolve_engine(engine, mode=mode, batch=batch) \
                    == jreg.resolve_engine(engine, mode=mode, batch=batch), \
                    (engine, mode, batch)
    for bad in ("fussed", "pdet"):
        with pytest.raises(ValueError):
            tapi.resolve_engine(bad)


@pytest.mark.parametrize("request_kw", [dict(engine="vmap"),
                                        dict(engine="auto"),
                                        dict(engine="fused", mode="strict")])
def test_vmap_engine_raises_until_ported(request_kw):
    """Each request resolves to the vmap engine at batch 4 (strict falls
    back to it), which is ported: the port answers as the reference does."""
    data, q = _dataset(seed=5, n=512, nq=4)     # batch 4 < fused min_batch
    jidx = japi.build(jnp.asarray(data), jax.random.key(0), japi.IndexSpec(
        K=4, L=2, leaf_size=32))
    from repro_torch.core.theory import LSHParams
    tidx = DETLSH.from_arrays(_arrays_of(jidx),
                              LSHParams(**dataclasses.asdict(jidx.params)),
                              n=512, leaf_size=32, device="cpu")
    want = jidx.search(jnp.asarray(q), japi.SearchRequest(k=5, r_min=0.5,
                                                          **request_kw))
    got = tidx.search(q, tapi.SearchRequest(k=5, r_min=0.5, **request_kw))
    assert got.stats.engine == want.stats.engine == "vmap"
    _assert_same_answers(want, got, data)


def test_unported_kernels_refused_at_build(tmp_path):
    """project_impl in the pallas names builds through lsh_project (its
    plain version on the CPU): the forest holds the d-order projection of
    the data rows.  A reference snapshot with such a spec loads too."""
    data, q = _dataset(seed=12, n=256, nq=2)
    x = torch.tensor(data)
    base = tapi.build(data, None, tapi.IndexSpec(K=4, L=2), device="cpu")
    for impl in ("pallas", "pallas_interpret"):
        idx = tapi.build(data, None, tapi.IndexSpec(K=4, L=2,
                                                    project_impl=impl),
                         device="cpu")
        assert torch.equal(idx.A, base.A)
        f = idx.forest
        rows = torch.clamp(f.point_ids.to(torch.int64), 0, 255)
        proj = tref.project(x, idx.A).reshape(256, 2, 4)
        want = proj[rows, torch.arange(2)[:, None]] * f.valid[..., None]
        assert torch.equal(f.proj_sorted, want), impl
        assert idx.search(q, tapi.SearchRequest(k=3)).ids.shape == (2, 3)
    # A snapshot with such a spec loads: nothing is projected at load.
    jspec = japi.IndexSpec(K=4, L=2, project_impl="pallas")
    japi.build(jnp.asarray(data), jax.random.key(0), jspec).save(
        str(tmp_path / "snap"))
    loaded = tapi.load(tmp_path / "snap", device="cpu")
    assert loaded.spec.project_impl == "pallas"
    assert loaded.search(q, tapi.SearchRequest(k=3, r_min=0.5)).ids.shape \
        == (2, 3)


def test_reference_builder_with_pallas_encode_refused():
    """The reference builder with encode_impl in the pallas names encodes
    through encode_bins (its plain version on the CPU) and builds the fused
    builder's forest bit for bit, dtypes included."""
    data, _ = _dataset(seed=13, n=256, nq=1)
    base = tapi.build(data, None, tapi.IndexSpec(K=4, L=2), device="cpu")
    for impl in ("pallas", "pallas_interpret"):
        spec = tapi.IndexSpec(K=4, L=2, build_impl="reference",
                              encode_impl=impl)
        ref_built = tapi.build(data, None, spec, device="cpu")
        assert {"encode", "trees"} <= set(ref_built.build_seconds)
        for name in ("point_ids", "proj_sorted", "codes_sorted", "valid",
                     "leaf_lo", "leaf_hi", "leaf_valid", "breakpoints"):
            got = getattr(ref_built.forest, name)
            want = getattr(base.forest, name)
            assert got.dtype == want.dtype and torch.equal(got, want), name
    # The fused builder runs the ported encode_pack for every impl name:
    # the kernel ('auto'/'pallas') or its plain version ('xla'/
    # 'pallas_interpret'), which are the same function on the CPU.
    for impl in ("pallas", "pallas_interpret", "xla"):
        other = tapi.build(data, None, tapi.IndexSpec(K=4, L=2,
                                                      encode_impl=impl),
                           device="cpu")
        assert torch.equal(other.forest.point_ids, base.forest.point_ids)


# ---------------------------------------------------------------------------
# Device rule, refusals, snapshot integrity
# ---------------------------------------------------------------------------

def test_entry_points_refuse_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    data, _ = _dataset(seed=6, n=256, nq=1)
    tapi.build(data, None, tapi.IndexSpec(K=4, L=2), device="cpu").save(
        tmp_path / "snap")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.build(data, None, tapi.IndexSpec(K=4, L=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DETLSH.build(data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.load(tmp_path / "snap")


def test_unported_kinds_raise(tmp_path):
    """Every kind is ported now: a placed spec builds the sharded PDET
    index (on the CPU, any shard count), the reference's pdet snapshot
    loads as one, and the streaming kind builds and loads with the
    reference's digest."""
    from repro_torch.core.distributed import PDETIndex
    data, q = _dataset(seed=7, n=256, nq=2)
    placed = tapi.build(data, None, tapi.IndexSpec(
        K=4, L=2, placement=tapi.PlacementSpec(mesh_shape=(2,))),
        device="cpu")
    assert isinstance(placed, PDETIndex) and placed.n_shards == 2
    assert placed.search(q, tapi.SearchRequest(k=3)).stats.engine == "pdet"
    pdet = japi.build(jnp.asarray(data), jax.random.key(0), japi.IndexSpec(
        K=4, L=2, placement=japi.PlacementSpec(mesh_shape=(1,))))
    pdet.save(str(tmp_path / "pdet"))
    loaded = tapi.load(tmp_path / "pdet", device="cpu")
    assert isinstance(loaded, PDETIndex) and loaded.n_shards == 1
    want = pdet.search(jnp.asarray(q), japi.SearchRequest(k=3))
    got = loaded.search(q, tapi.SearchRequest(k=3))
    assert got.stats.engine == want.stats.engine == "pdet"
    _assert_same_answers(want, got, data)
    built = tapi.build(data, None, tapi.IndexSpec(kind="streaming", K=4, L=2,
                                                  delta_capacity=64),
                       device="cpu")
    assert built.n_points == 256
    stream = japi.build(jnp.asarray(data), jax.random.key(0), japi.IndexSpec(
        kind="streaming", K=4, L=2, delta_capacity=64))
    stream.save(str(tmp_path / "stream"))
    loaded = tapi.load(tmp_path / "stream", device="cpu")
    assert loaded.state_digest() == stream.state_digest()


def test_corrupt_snapshot_raises_integrity_error(tmp_path):
    data, _ = _dataset(seed=8, n=256, nq=1)
    tapi.build(data, None, tapi.IndexSpec(K=4, L=2), device="cpu").save(
        tmp_path / "snap")
    f = tmp_path / "snap" / "arrays.npz"
    raw = bytearray(f.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(tapi.SnapshotIntegrityError):
        tapi.load(tmp_path / "snap", device="cpu")
    with pytest.raises(tapi.SnapshotFormatError):
        tapi.load(tmp_path, device="cpu")


def test_spec_round_trips_between_packages():
    spec = tapi.IndexSpec(K=8, L=3, beta_override=0.2, build_impl="reference",
                          placement=tapi.PlacementSpec(mesh_shape=(2, 2),
                                                       mesh_axes=("p", "d")))
    assert japi.IndexSpec.from_dict(spec.to_dict()).to_dict() == \
        spec.to_dict()
    back = tapi.IndexSpec.from_dict(japi.IndexSpec(K=5).to_dict())
    assert back == tapi.IndexSpec(K=5)
    for bad in (dict(k=0), dict(mode="lief"), dict(engine="fussed"),
                dict(r_min=-1.0)):
        with pytest.raises(ValueError):
            tapi.SearchRequest(**bad)


# ---------------------------------------------------------------------------
# (f) the port imports neither JAX nor the reference package
# ---------------------------------------------------------------------------

def test_port_imports_no_jax_and_no_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            for root in roots:
                assert root not in ("jax", "jaxlib", "repro"), \
                    f"{path}:{node.lineno} imports {root}"
