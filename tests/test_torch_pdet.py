"""PyTorch port: the sharded PDET index and the build kernels that reach it.

The port's ``PDETIndex`` shards the layout of one global forest across a
mesh of devices (on the CPU, every shard on the CPU) and merges each
round's per-shard tables with an exact ``torch.minimum``, so its answers
equal the fused engine's on the same ``DETLSH`` bit for bit, for any shard
count.  Against the reference package the state crosses over through
snapshots (jax.random cannot be reproduced in torch), in both directions.

Tolerances, each with its reason:
  * distances against the reference: rtol 1e-5 plus atol 1e-6 * max|x|^2
    (tests/test_torch_search.py: the qq - 2 q.p + pp form cancels near a
    query and the two packages sum dot products in their own order); ids,
    rounds, candidate counts and the pdet counters are exact.
  * a projection through lsh_project: the port sums x @ A over d in index
    order, XLA in another, so a code may differ only where its coordinate
    lies within 1e-6 * max|proj| of an inner breakpoint edge (counted), as
    tests/test_torch_streaming.py states for the seal.
  * everything within the port (PDET against fused, builders against each
    other, snapshot round trips): bit-identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.api import registry as jreg  # noqa: E402
from repro.core.detree import build_forest as jbuild_forest  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import DETLSH, hashing  # noqa: E402
from repro_torch.core.detree import build_forest  # noqa: E402
from repro_torch.core.distributed import PDETIndex  # noqa: E402
from repro_torch.core.theory import LSHParams  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import range_rerank as rrk  # noqa: E402
from repro_torch.launch.mesh import mesh_from_placement  # noqa: E402
from tests.conftest import make_clustered, make_queries_near  # noqa: E402

D = 16
N = 980          # 62 leaves of 16: S = 3 and S = 4 pad the layout, S = 2 not
_FOREST = ("point_ids", "proj_sorted", "codes_sorted", "valid", "leaf_lo",
           "leaf_hi", "leaf_valid", "breakpoints")


def _spec(api, **kw):
    base = dict(K=4, L=3, c=1.5, beta_override=0.1, Nr=32, leaf_size=16)
    base.update(kw)
    return api.IndexSpec(**base)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(40)
    data = make_clustered(rng, N, D)
    return data, make_queries_near(data, rng, 12, noise=0.1)


@pytest.fixture(scope="module")
def det(dataset):
    return tapi.build(dataset[0], None, _spec(tapi), device="cpu")


def _placed(det, S):
    placement = tapi.PlacementSpec(mesh_shape=(S,))
    return PDETIndex.from_detlsh(
        det, placement, mesh=mesh_from_placement(placement, device="cpu"))


def _assert_equal_results(got, want):
    for name in ("ids", "dists"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("rounds", "n_candidates", "final_r"):
        assert torch.equal(getattr(got.stats, name),
                           getattr(want.stats, name)), name


def _assert_same_as_reference(j, t, data):
    np.testing.assert_array_equal(np.asarray(j.ids), t.ids.numpy())
    for name in ("rounds", "n_candidates"):
        np.testing.assert_array_equal(np.asarray(getattr(j.stats, name)),
                                      getattr(t.stats, name).numpy())
    atol = 1e-6 * float((data * data).sum(-1).max())
    np.testing.assert_allclose(t.dists.numpy(), np.asarray(j.dists),
                               rtol=1e-5, atol=atol)


# ---------------------------------------------------------------------------
# PDET == DET, bit for bit, at any shard count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("r_min,n_active", [(None, None), (0.05, None),
                                            (0.05, 7)])
def test_pdet_bit_identical_to_fused(det, dataset, S, r_min, n_active):
    q = dataset[1]
    req = dict(k=5, r_min=r_min, n_active=n_active)
    want = det.search(q, tapi.SearchRequest(engine="fused", **req))
    pdet = _placed(det, S)
    assert pdet.n_shards == S and pdet.forest.n_leaves % S == 0
    before = rrk.range_rerank.launches
    got = pdet.search(q, tapi.SearchRequest(**req))
    assert rrk.range_rerank.launches == before        # CPU: plain versions
    assert got.stats.engine == "pdet"
    _assert_equal_results(got, want)
    assert int(got.stats.psum_rounds) == int(want.stats.rounds.max())
    assert got.stats.merge_size == q.shape[0] * N
    assert tuple(got.stats.shard_candidates.shape) == (S,)
    if r_min is not None:
        assert int(want.stats.rounds.max()) >= 2      # the radius grows
    if n_active is not None:
        assert not got.stats.n_candidates[n_active:].any()


def test_pdet_shard_counters_sum_to_the_scanned_entries(det, dataset):
    """The shards' scanned counts partition the entries one fused round
    pass admits: their sum does not depend on the shard count."""
    q = dataset[1]
    totals = {S: float(_placed(det, S).search(
        q, tapi.SearchRequest(k=5, r_min=0.05)).stats.shard_candidates.sum())
        for S in (1, 2, 3, 4)}
    assert len(set(totals.values())) == 1 and totals[1] > 0


def test_pdet_fallbacks_and_refusals(det, dataset):
    q = dataset[1]
    pdet = _placed(det, 3)
    with pytest.raises(NotImplementedError, match="multi-probe"):
        pdet.search(q, tapi.SearchRequest(k=5, engine="pdet", probe_depth=2))
    got = pdet.search(q, tapi.SearchRequest(k=5, probe_depth=2))
    want = det.search(q, tapi.SearchRequest(k=5, engine="fused",
                                            probe_depth=2))
    assert got.stats.engine == "fused" and got.stats.shard_candidates is None
    _assert_equal_results(got, want)
    got = pdet.search(q, tapi.SearchRequest(k=5, mode="strict"))
    want = det.search(q, tapi.SearchRequest(k=5, mode="strict"))
    assert got.stats.engine == want.stats.engine == "vmap"
    _assert_equal_results(got, want)
    assert isinstance(pdet, tapi.AnnIndex)
    assert pdet.r_min_for(5) == det.r_min_for(5)
    assert pdet.index_size_bytes() >= det.index_size_bytes()


def test_registry_mesh_rule_matches_reference():
    for engine in (None, "auto", "fused", "vmap", "pdet"):
        for mode in ("leaf", "strict"):
            for batch in (1, 7, 8, None):
                for mesh in (None, 1, 4):
                    kw = dict(mode=mode, batch=batch, mesh_devices=mesh)
                    try:
                        want = jreg.resolve_engine(engine, **kw)
                    except ValueError:
                        with pytest.raises(ValueError, match="mesh"):
                            tapi.resolve_engine(engine, **kw)
                        continue
                    assert tapi.resolve_engine(engine, **kw) == want, \
                        (engine, kw)
    assert tapi.get_engine("pdet").needs_mesh


def test_mesh_from_placement_picks_devices(monkeypatch):
    four = tapi.PlacementSpec(mesh_shape=(2, 2), mesh_axes=("pod", "data"),
                              data_axes=("data",))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="devices="):
        mesh_from_placement(four)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = mesh_from_placement(four)
    assert mesh.shape == {"pod": 2, "data": 2}
    assert [str(d) for d in mesh.devices.flat] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    # shards are row-major over the data axes; other axes replicate
    assert [str(d) for d in mesh.shard_devices(four.data_axes)] == [
        "cuda:0", "cuda:1"]
    cpu = mesh_from_placement(tapi.PlacementSpec(mesh_shape=(5,)),
                              device="cpu")
    assert [d.type for d in cpu.devices.flat] == ["cpu"] * 5
    given = mesh_from_placement(tapi.PlacementSpec(mesh_shape=(3,)),
                                devices=["cpu", "cpu", "cpu", "meta"])
    assert [d.type for d in given.devices.flat] == ["cpu"] * 3
    with pytest.raises(ValueError, match="needs 3 devices"):
        mesh_from_placement(tapi.PlacementSpec(mesh_shape=(3,)),
                            devices=["cpu"])


def test_placed_build_through_the_api(dataset, det):
    data, q = dataset
    spec = _spec(tapi, placement=tapi.PlacementSpec(mesh_shape=(3,)))
    pdet = tapi.build(data, None, spec, device="cpu")
    assert isinstance(pdet, PDETIndex) and pdet.spec == spec
    assert pdet.n_points == N and pdet.n_shards == 3
    assert {"projection", "breakpoints", "shard"} <= set(pdet.build_seconds)
    # the same build path as the unplaced spec: same A and forest
    assert torch.equal(pdet.A, det.A)
    n_pad = det.forest.point_ids.shape[1]
    assert torch.equal(pdet.forest.point_ids[:, :n_pad],
                       det.forest.point_ids)
    assert (pdet.forest.point_ids[:, n_pad:] == N).all()
    _assert_equal_results(
        pdet.search(q, tapi.SearchRequest(k=5)),
        det.search(q, tapi.SearchRequest(k=5, engine="fused")))


# ---------------------------------------------------------------------------
# Against the reference: answers at one shard, snapshots both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_pdet(dataset, tmp_path_factory):
    data, _ = dataset
    jpdet = japi.build(jnp.asarray(data), jax.random.key(0), _spec(
        japi, placement=japi.PlacementSpec(mesh_shape=(1,))))
    path = tmp_path_factory.mktemp("jpdet") / "snap"
    jpdet.save(str(path))
    return jpdet, path


@pytest.mark.parametrize("r_min", [None, 0.05])
def test_reference_pdet_snapshot_answers_alike(reference_pdet, dataset,
                                               r_min):
    data, q = dataset
    jpdet, path = reference_pdet
    tpdet = tapi.load(path, device="cpu")
    assert isinstance(tpdet, PDETIndex) and tpdet.n_shards == 1
    assert tpdet.spec.to_dict() == jpdet.spec.to_dict()
    want = jpdet.search(jnp.asarray(q), japi.SearchRequest(k=5, r_min=r_min))
    got = tpdet.search(q, tapi.SearchRequest(k=5, r_min=r_min))
    assert got.stats.engine == want.stats.engine == "pdet"
    assert got.stats.r_min == want.stats.r_min
    _assert_same_as_reference(want, got, data)
    np.testing.assert_array_equal(got.stats.shard_candidates.numpy(),
                                  np.asarray(want.stats.shard_candidates))
    assert int(got.stats.psum_rounds) == int(want.stats.psum_rounds)
    assert got.stats.merge_size == want.stats.merge_size
    if r_min is not None:
        assert int(got.stats.psum_rounds) >= 2


def test_port_pdet_snapshot_loads_in_the_reference(reference_pdet, dataset,
                                                   tmp_path):
    """The reference's state, sharded by the port onto 4 shards and saved,
    loads in the reference (resharded to its one device by _fit_placement)
    and answers alike; both packages honour an explicit placement."""
    data, q = dataset
    jpdet, path = reference_pdet
    four = tapi.PlacementSpec(mesh_shape=(4,))
    tpdet = tapi.load(path, four, device="cpu")
    assert tpdet.n_shards == 4 and tpdet.spec.placement == four
    tpdet.save(tmp_path / "port")
    back = japi.load(str(tmp_path / "port"))
    assert back.placement.n_shards == 1
    req = dict(k=5, r_min=0.05)
    want = back.search(jnp.asarray(q), japi.SearchRequest(**req))
    got = tpdet.search(q, tapi.SearchRequest(**req))
    _assert_same_as_reference(want, got, data)
    again = tapi.load(tmp_path / "port", device="cpu")   # CPU holds S = 4
    assert again.n_shards == 4
    _assert_equal_results(again.search(q, tapi.SearchRequest(**req)), got)
    two = tapi.load(tmp_path / "port", tapi.PlacementSpec(mesh_shape=(2,)),
                    device="cpu")
    assert two.n_shards == 2
    _assert_equal_results(two.search(q, tapi.SearchRequest(**req)), got)
    jone = japi.PlacementSpec(mesh_shape=(1,), mesh_axes=("shard",))
    forced = japi.load(str(tmp_path / "port"), placement=jone)
    assert forced.placement == jone
    _assert_same_as_reference(
        forced.search(jnp.asarray(q), japi.SearchRequest(**req)), got, data)
    tapi.build(data, None, _spec(tapi), device="cpu").save(
        tmp_path / "static")
    with pytest.raises(ValueError, match="placement"):
        tapi.load(tmp_path / "static", four, device="cpu")


# ---------------------------------------------------------------------------
# The build kernels' paths: the reference builder and project_impl
# ---------------------------------------------------------------------------

def test_reference_builder_with_pallas_encode_matches_reference(dataset):
    """From the reference's A, projection and breakpoints, the port's
    reference builder with encode_impl='pallas' (encode_bins' plain version
    on the CPU) builds the reference builder's forest, dtypes included."""
    data, _ = dataset
    jidx = japi.build(jnp.asarray(data), jax.random.key(3), _spec(japi))
    proj = jnp.asarray(data) @ jidx.A
    K, L, Nr = 4, 3, 32
    bp = jnp.asarray(jidx.forest.breakpoints).reshape(L * K, Nr + 1)
    want = jbuild_forest(proj, K, L, Nr=Nr, leaf_size=16, breakpoints=bp,
                         build_impl="reference",
                         encode_impl="pallas_interpret")
    got = build_forest(torch.tensor(np.asarray(proj)), K, L, Nr=Nr,
                       leaf_size=16, breakpoints=torch.tensor(np.asarray(bp)),
                       build_impl="reference", encode_impl="pallas")
    for name in _FOREST:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_pallas_projection_index_answers_as_the_reference(dataset):
    """A reference index built with project_impl='pallas': the port's
    projection of the same data through lsh_project's plain version gives
    the same codes (near-edge coordinates excused and counted), and an
    index built from it answers as the reference's does."""
    data, q = dataset
    # Interpolated edges: order-statistic edges are data coordinates, where
    # a one-ulp change of a projection flips codes by construction.
    spec = dict(project_impl="pallas", build_impl="reference",
                encode_impl="pallas", breakpoint_method="histogram_refine")
    jidx = japi.build(jnp.asarray(data), jax.random.key(5),
                      _spec(japi, **spec))
    K, L, Nr = 4, 3, 32
    A = torch.tensor(np.asarray(jidx.A))
    proj = hashing.project(torch.tensor(data), A, impl="pallas")
    assert torch.equal(proj, tref.lsh_project(torch.tensor(data), A))
    want_proj = np.asarray(jnp.asarray(data) @ jidx.A)
    tol = 1e-6 * float(np.abs(want_proj).max())
    np.testing.assert_allclose(proj.numpy(), want_proj, rtol=0, atol=tol)
    bp = np.asarray(jidx.forest.breakpoints).reshape(L * K, Nr + 1)
    codes = tref.encode_bins(proj, torch.tensor(bp)).numpy()
    want_codes = np.asarray(jops.encode_bins(
        jnp.asarray(want_proj), jnp.asarray(bp), interpret=True))
    inner = bp[:, 1:-1]
    near = np.abs(proj.numpy()[:, :, None]
                  - inner[None, :, :]).min(-1) <= tol
    differ = codes != want_codes
    assert not (differ & ~near).any(), "a code differs away from any edge"
    if differ.any():                 # counted; answers may then differ
        return
    forest = build_forest(proj, K, L, Nr=Nr, leaf_size=16,
                          breakpoints=torch.tensor(bp), build_impl="reference",
                          encode_impl="pallas")
    tidx = DETLSH(params=LSHParams(**dataclasses.asdict(jidx.params)), A=A,
                  forest=forest, data=torch.tensor(data))
    for name in ("point_ids", "codes_sorted", "leaf_lo", "leaf_hi"):
        np.testing.assert_array_equal(getattr(forest, name).numpy(),
                                      np.asarray(getattr(jidx.forest, name)))
    for r_min in (None, 0.05):
        want = jidx.search(jnp.asarray(q), japi.SearchRequest(k=5,
                                                              r_min=r_min))
        got = tidx.search(q, tapi.SearchRequest(k=5, r_min=r_min))
        _assert_same_as_reference(want, got, data)
