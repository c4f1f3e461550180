"""PyTorch port: the LSH decode subsystem against the reference package.

The same numpy inputs go through ``repro.decode`` / ``repro.core.
det_attention`` and their ports in ``repro_torch``.  jax.random cannot be
reproduced in torch, so the reference's projection matrix A is handed to
the port (``KVCacheIndex.prefill(A=)``, ``build_kv_index(A=)``), and where
a comparison needs one forest in both packages the port's index is built
from the reference's state through the constructor ("cross-built").

Tolerances, each with its reason:
  * mips functions and R^2: rtol 1e-6 — the squared norms sum over d in
    another order than XLA's reduction (one ulp apart).  The augmentation
    coordinate sqrt(R^2 - |k|^2) magnifies that ulp where the gap is small,
    so it is compared squared, within 1e-6 * R^2; the key coordinates are
    copies and compare exactly.
  * forests from the same projections: bit-identical.  From each
    package's own projections (einsum vs torch.matmul, a last-bit
    difference) a code may differ only where the coordinate lies within
    1e-6 * max|proj| of an inner breakpoint edge: such places are counted,
    and a head whose codes all agree must have the same forest.
  * retrieval on one cross-built forest: ids, rounds and candidate counts
    exact; distances rtol 1e-5 (the qq - 2 q.p + pp form sums q.p in
    another order).  The estimated r_min is numpy on both sides and
    identical for identical q_aug; q_aug itself differs in the last bit
    (the query norm), so r_min agrees to rtol 1e-6.
  * attention outputs: rtol/atol 1e-5 (f32 softmax and value sums in
    another order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import SearchRequest as JRequest  # noqa: E402
from repro.core import det_attention as JDA  # noqa: E402
from repro.decode import KVCacheIndex as JKV  # noqa: E402
from repro.decode import KVSpec as JSpec  # noqa: E402
from repro.decode import LSHDecoder as JDecoder  # noqa: E402
from repro.decode import mips as jmips  # noqa: E402
from repro.decode import sparse_decode_attention as jsparse  # noqa: E402
from repro.models import layers as JL  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.core import det_attention as TDA  # noqa: E402
from repro_torch.core.theory import LSHParams  # noqa: E402
from repro_torch.decode import (HeadForest, KVCacheIndex, KVSpec,  # noqa: E402
                                LSHDecoder, sparse_decode_attention)
from repro_torch.decode import mips as tmips  # noqa: E402
from repro_torch.kernels import range_rerank as rrk  # noqa: E402
from repro_torch.kernels.range_rerank import row_pitch  # noqa: E402

B, S, HK, G, DH = 2, 512, 2, 2, 32
SPEC = dict(m_top=24, delta_capacity=16)


def _cache(seed, b=B, s=S, hk=HK, dh=DH, scale=0.3):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((b, s, hk, dh)) * scale).astype(np.float32)
    v = rng.standard_normal((b, s, hk, dh)).astype(np.float32)
    return k, v, rng


def _query_at(k, pos, g=G, scale=8.0):
    """Decode query aligned with the key at ``pos`` (strong attention)."""
    b, _, hk, dh = k.shape
    q = np.repeat(k[:, pos][:, :, None, :], g, axis=2) * scale
    return q.reshape(b, 1, hk * g, dh).astype(np.float32)


def _cross(j: JKV, spec: KVSpec) -> KVCacheIndex:
    """The port's index over the reference's state (A, R^2, forests,
    augmented keys, tombstones, delta), on the CPU."""
    x = KVCacheIndex(spec, LSHParams(**dataclasses.asdict(j.params)),
                     torch.tensor(np.asarray(j.A)), j.b, j.hk, j.dh,
                     torch.tensor(np.asarray(j.R2)),
                     HeadForest(*(torch.tensor(np.asarray(a))
                                  for a in j.forest)), j._aug.copy())
    x.next_pos = j.next_pos
    x._live = j._live.copy()
    for name in ("vecs", "gids", "live"):
        setattr(x.delta, name, getattr(j.delta, name).copy())
    x.delta.count = j.delta.count
    return x


@pytest.fixture(scope="module")
def ref_index():
    k, v, _ = _cache(0)
    return JKV.prefill(jnp.asarray(k), jax.random.key(3), JSpec(**SPEC)), k, v


def _assert_aug_close(got, want, R2):
    """Augmented keys (..., d+1): key coordinates equal, the augmentation
    coordinate equal when squared within 1e-6 * R^2."""
    np.testing.assert_array_equal(got[..., :-1], want[..., :-1])
    np.testing.assert_allclose(got[..., -1] ** 2, want[..., -1] ** 2,
                               rtol=0, atol=1e-6 * float(np.max(R2)))


def _assert_same_retrieval(rj, rt):
    np.testing.assert_array_equal(rt.ids.numpy(), np.asarray(rj.ids))
    np.testing.assert_array_equal(rt.rounds.numpy(), np.asarray(rj.rounds))
    np.testing.assert_array_equal(rt.n_candidates.numpy(),
                                  np.asarray(rj.n_candidates))
    dj, dt = np.asarray(rj.dists), rt.dists.numpy()
    np.testing.assert_array_equal(np.isinf(dt), np.isinf(dj))
    fin = np.isfinite(dj)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=1e-5)


# ---------------------------------------------------------------------------
# mips: the MIPS -> L2 transform layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,shrink", [((2, 64, 16), 1.0),
                                          ((3, 100, 33), 0.7)])
def test_mips_functions_match_reference(shape, shrink):
    rng = np.random.default_rng(shape[1])
    keys = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    q = rng.standard_normal(shape[:1] + (4, shape[2])).astype(np.float32)
    R2_j = jmips.mips_radius(jnp.asarray(keys)) * shrink
    R2_t = tmips.mips_radius(torch.tensor(keys)) * shrink
    np.testing.assert_allclose(R2_t.numpy(), np.asarray(R2_j), rtol=1e-6)
    aug_j, clip_j = jmips.augment_keys(jnp.asarray(keys), R2_j)
    aug_t, clip_t = tmips.augment_keys(torch.tensor(keys),
                                       torch.tensor(np.asarray(R2_j)))
    assert int(clip_t) == int(clip_j)
    assert (int(clip_t) > 0) == (shrink < 1.0)        # clipping exercised
    _assert_aug_close(aug_t.numpy(), np.asarray(aug_j), np.asarray(R2_j))
    qa_j = jmips.augment_queries(jnp.asarray(q))
    qa_t = tmips.augment_queries(torch.tensor(q))
    np.testing.assert_array_equal(qa_t.numpy(), np.asarray(qa_j))
    qn_j = jmips.normalize_queries(qa_j, R2_j[:, None])
    qn_t = tmips.normalize_queries(qa_t, torch.tensor(np.asarray(R2_j))[:,
                                                                        None])
    np.testing.assert_allclose(qn_t.numpy(), np.asarray(qn_j), rtol=1e-6,
                               atol=1e-7)
    assert tmips.DEFAULT_SLACK == jmips.DEFAULT_SLACK


# ---------------------------------------------------------------------------
# Prefill: forests
# ---------------------------------------------------------------------------

def test_build_heads_bit_identical_from_reference_proj(ref_index):
    """The reference's augmented keys and projections into the port's
    per-head build: every forest array equal."""
    j, _, _ = ref_index
    aug = jnp.asarray(j._aug)
    proj = np.asarray(jnp.einsum("hsd,dp->hsp", aug, j.A))
    got = KVCacheIndex._build_heads(torch.tensor(j._aug), torch.tensor(proj),
                                    KVSpec(**SPEC))
    for name in HeadForest._fields:
        w, g = np.asarray(getattr(j.forest, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _codes(proj, bp):
    """(n, D) projections, (D, Nr+1) breakpoints -> region ids, numpy."""
    Nr = bp.shape[1] - 1
    return np.stack([np.clip(np.searchsorted(bp[j, 1:Nr], proj[:, j],
                                             side="right"), 0, Nr - 1)
                     for j in range(bp.shape[0])], axis=1)


def _near_inner_edge(proj, bp, tol):
    gap = np.abs(proj[:, :, None] - bp[None, :, 1:-1]).min(-1)
    return gap <= tol


def _heads_under_edge_rule(proj_j, bp_j, proj_t, bp_t, forest_j, forest_t,
                           names):
    """Per head: codes from each package's own projections and breakpoints
    differ only near an inner edge; a head with no differing code has
    bit-equal ``names``.  Returns the number of differing codes."""
    tol = 1e-6 * float(np.abs(proj_j).max())
    np.testing.assert_allclose(proj_t, proj_j, rtol=0, atol=tol)
    np.testing.assert_allclose(bp_t, bp_j, rtol=0, atol=tol)
    mism = 0
    for h in range(proj_j.shape[0]):
        diff = _codes(proj_t[h], bp_t[h]) != _codes(proj_j[h], bp_j[h])
        near = _near_inner_edge(proj_j[h], bp_j[h], 2 * tol)
        assert not (diff & ~near).any(), "a code differs away from any edge"
        mism += int(diff.sum())
        if not diff.any():
            for name in names:
                np.testing.assert_array_equal(
                    getattr(forest_t, name)[h].numpy(),
                    np.asarray(getattr(forest_j, name)[h]), err_msg=name)
    return mism


def test_prefill_with_reference_A_matches(ref_index):
    j, k, _ = ref_index
    t = KVCacheIndex.prefill(k, spec=KVSpec(**SPEC), A=np.asarray(j.A),
                             device="cpu")
    assert (t.b, t.hk, t.dh, t.H, t.d_aug) == (j.b, j.hk, j.dh, j.H, j.d_aug)
    np.testing.assert_array_equal(t.A.numpy(), np.asarray(j.A))
    np.testing.assert_allclose(t.R2.numpy(), np.asarray(j.R2), rtol=1e-6)
    _assert_aug_close(t._aug, j._aug, np.asarray(j.R2))
    proj_j = np.asarray(jnp.einsum("hsd,dp->hsp", jnp.asarray(j._aug), j.A))
    proj_t = (torch.tensor(t._aug) @ t.A).numpy()
    E = t.spec.Nr + 1
    mism = _heads_under_edge_rule(
        proj_j, np.asarray(j.forest.breakpoints).reshape(j.H, -1, E),
        proj_t, t.forest.breakpoints.numpy().reshape(t.H, -1, E),
        j.forest, t.forest, ("point_ids", "valid", "leaf_lo", "leaf_hi",
                             "leaf_valid", "inv_perm"))
    assert mism <= 4, mism       # a handful at most, at edges
    for name in HeadForest._fields:
        assert getattr(t.forest, name).dtype == torch.tensor(
            np.asarray(getattr(j.forest, name))).dtype, name
    assert t.n_points == j.n_points == S
    # The port stores each augmented key row at a pitch of a multiple of 4
    # floats (zeros past d_aug) for the heads kernel's 16-byte copies; its
    # size is the reference's plus those pad columns.
    pts = t.forest.points_sorted
    pad = pts.shape[:-1].numel() * (row_pitch(t.d_aug) - t.d_aug) * 4
    assert t.index_size_bytes() == j.index_size_bytes() + pad
    assert t.scan_fraction == j.scan_fraction


def test_stored_points_keep_an_aligned_pitch(ref_index):
    """The prefill and each seal store the augmented keys (d_aug = dh + 1)
    at a row pitch of a multiple of 4 floats, zeros past d_aug, and every
    reader sees only the first d_aug columns: a retrieval over the padded
    rows equals one over the same rows stored densely, bit for bit, and
    ``index_size_bytes`` counts the padding."""
    j, k, _ = ref_index
    t = KVCacheIndex.prefill(k, spec=KVSpec(**SPEC), A=np.asarray(j.A),
                             device="cpu")
    pitch = row_pitch(t.d_aug)
    assert pitch % 4 == 0 and pitch > t.d_aug
    for _ in range(2):
        pts = t.forest.points_sorted
        assert pts.shape[-1] == t.d_aug and pts.stride(-2) == pitch
        full = torch.as_strided(pts, (*pts.shape[:-1], pitch), pts.stride())
        assert not full[..., t.d_aug:].any()
        dense = sum(a.numel() * a.element_size() for a in t.forest)
        pad = pts.shape[:-1].numel() * (pitch - t.d_aug) * 4
        assert t.index_size_bytes() == (dense + pad
                                        + t.delta.vecs.nbytes)
        q = torch.tensor(_query_at(k, 40))
        assert t.round_inputs(q).q_aug.is_contiguous()   # padded per launch
        got = t.retrieve(q, r_min=1e6)
        t.forest = t.forest._replace(points_sorted=pts.contiguous())
        want = t.retrieve(q, r_min=1e6)
        t.forest = t.forest._replace(points_sorted=pts)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        new = np.asarray(k[:, :SPEC["delta_capacity"]])     # one seal
        for step in range(new.shape[1]):
            t.upsert(torch.tensor(new[:, step]))
        assert t.seals == _ + 1


# ---------------------------------------------------------------------------
# Retrieval on one cross-built forest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r_min", [None, 1e6])
def test_retrieve_matches_reference(ref_index, r_min):
    j, k, _ = ref_index
    j._r_min_cache = None
    x = _cross(j, KVSpec(**SPEC))
    q = _query_at(k, 77)
    before = rrk.range_rerank_heads.launches
    rj = j.retrieve(jnp.asarray(q), r_min=r_min)
    rt = x.retrieve(torch.tensor(q), r_min=r_min)
    assert rrk.range_rerank_heads.launches == before      # CPU: plain
    _assert_same_retrieval(rj, rt)
    assert rt.ids.dtype == torch.int32
    assert rt.ids.shape == (j.H, G, SPEC["m_top"] + SPEC["delta_capacity"])
    if r_min is None:
        np.testing.assert_allclose(x._r_min_cache, j._r_min_cache,
                                   rtol=1e-6)
        # identical q_aug -> identical radius (numpy on both sides)
        x._r_min_cache = None
        q_aug = jmips.normalize_queries(
            jmips.augment_queries(jnp.asarray(q).reshape(j.H, G, DH)),
            j.R2[:, None])
        assert x._estimate_r_min(np.asarray(q_aug)) == j._r_min_cache
    else:
        assert (rt.rounds == 1).all()
    assert (rt.ids[..., :SPEC["m_top"]] == 77).any(-1).all()


# ---------------------------------------------------------------------------
# Mutation: upserts, a seal, deletes in forest and delta, search
# ---------------------------------------------------------------------------

def test_mutations_match_reference():
    k, _, rng = _cache(5, s=256)
    spec = dict(m_top=16, delta_capacity=8)
    j = JKV.prefill(jnp.asarray(k), jax.random.key(1), JSpec(**spec))
    x = _cross(j, KVSpec(**spec))
    new = (rng.standard_normal((11, B, HK, DH)) * 0.3).astype(np.float32)
    new[4] *= 3.0                                # beyond R: clipped
    for i in range(11):
        assert x.upsert(torch.tensor(new[i])) == j.upsert(jnp.asarray(new[i]))
    assert x.clip_total == j.clip_total > 0
    assert (x.seals, x.n_sealed, x.delta.count) == (j.seals, j.n_sealed,
                                                    j.delta.count) == (
        1, 264, 3)
    _assert_aug_close(x._aug, j._aug, np.asarray(j.R2))   # rows that sealed
    _assert_aug_close(x.delta.vecs, j.delta.vecs, np.asarray(j.R2))
    # The seal re-projects every row with each package's own product.
    E = x.spec.Nr + 1
    proj_j = np.asarray(jnp.einsum("hsd,dp->hsp", jnp.asarray(j._aug), j.A))
    proj_t = (torch.tensor(x._aug) @ x.A).numpy()
    _heads_under_edge_rule(
        proj_j, np.asarray(j.forest.breakpoints).reshape(j.H, -1, E),
        proj_t, x.forest.breakpoints.numpy().reshape(x.H, -1, E),
        j.forest, x.forest, ("point_ids", "valid", "leaf_lo", "leaf_hi",
                             "leaf_valid", "inv_perm", "points_sorted"))
    # deletes: sealed (prefill and sealed-from-delta) and delta positions
    dead = [50, 258, 262, 9999, 50]
    assert x.delete(dead) == j.delete(dead) == 3
    assert x.n_points == j.n_points == 264 + 3 - 3
    q = _query_at(np.concatenate([k, new.transpose(1, 0, 2, 3)], 1), 262)
    rj = j.retrieve(jnp.asarray(q), r_min=1e6)      # every leaf admitted
    rt = x.retrieve(torch.tensor(q), r_min=1e6)
    np.testing.assert_array_equal(np.sort(rt.ids.numpy(), -1, kind="stable"),
                                  np.sort(np.asarray(rj.ids), -1,
                                          kind="stable"))
    for dead_pos in (50, 258, 262):
        assert not (rt.ids == dead_pos).any()
    # On one forest (the reference's after the seal) every answer agrees.
    y = _cross(j, KVSpec(**spec))
    for r_min in (None, 1e6):
        _assert_same_retrieval(j.retrieve(jnp.asarray(q), r_min=r_min),
                               y.retrieve(torch.tensor(q), r_min=r_min))
    sj = j.search(jnp.asarray(q), JRequest(k=10))
    st = y.search(torch.tensor(q), tapi.SearchRequest(k=10))
    np.testing.assert_array_equal(st.ids.numpy(), np.asarray(sj.ids))
    np.testing.assert_allclose(st.dists.numpy(), np.asarray(sj.dists),
                               rtol=1e-5)
    assert st.stats.engine == "fused-kv" and st.ids.shape == (B * HK * G, 10)
    np.testing.assert_array_equal(st.stats.rounds.numpy(),
                                  np.asarray(sj.stats.rounds))
    assert y.r_min_for(10) == pytest.approx(j.r_min_for(10), rel=1e-6)
    assert y.maybe_compact() is j.maybe_compact() is False


def test_kv_index_surface_and_device_rule(monkeypatch):
    k, _, _ = _cache(2, s=64)
    t = KVCacheIndex.prefill(k, torch.Generator().manual_seed(0),
                             KVSpec(delta_capacity=8, m_top=8), device="cpu")
    assert isinstance(t, tapi.MutableAnnIndex)
    assert t.A.shape == (DH + 1, 16) and t.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="prefill"):
        t.save("unused")
    with pytest.raises(ValueError, match="gids"):
        t.upsert(torch.zeros((B, HK, DH)), gids=np.array([999]))
    with pytest.raises(ValueError, match="expected one key"):
        t.upsert(torch.zeros((B, 3, DH)))
    with pytest.raises(ValueError, match="query shape"):
        t.retrieve(torch.zeros((B + 1, 1, 4, DH)))
    with pytest.raises(ValueError, match="m_top"):
        KVSpec(m_top=0)
    with pytest.raises(ValueError, match="Nr"):
        KVSpec(Nr=300)
    with pytest.raises(ValueError, match="window"):
        LSHDecoder(t, window=4, refresh_every=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCacheIndex.prefill(k)


# ---------------------------------------------------------------------------
# Sparse attention and the decode loop
# ---------------------------------------------------------------------------

def test_sparse_decode_attention_matches_reference():
    k, v, rng = _cache(7, b=2, s=128, hk=2, dh=16)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    cases = {
        "candidates": rng.integers(-1, 128, (2, 2, 2, 12)).astype(np.int32),
        "none": np.full((2, 2, 2, 8), -1, np.int32),
        "zeros": np.zeros((2, 2, 2, 8), np.int32),
        "past_length": np.full((2, 2, 2, 3), 120, np.int32),
    }
    outs = {}
    for name, pos in cases.items():
        for window, sinks in ((16, 0), (8, 4)):
            want = np.asarray(jsparse(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(pos), 100,
                                      window=window, sinks=sinks))
            got = sparse_decode_attention(
                torch.tensor(q), torch.tensor(k), torch.tensor(v),
                torch.tensor(pos), 100, window=window, sinks=sinks).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            outs[name, sinks] = got
    # -1 does not alias position 0 (the reference test's case) ...
    assert not np.allclose(outs["none", 0], outs["zeros", 0])
    np.testing.assert_allclose(outs["none", 0], outs["past_length", 0],
                               rtol=1e-5, atol=1e-6)
    # ... but it takes the first occurrence of the clipped id 0, so a sink
    # at 0 behind a -1 is masked as its repeat, as in the reference.
    assert not np.allclose(outs["none", 4], outs["past_length", 4])
    # bf16 inputs: the output takes q's dtype
    got = sparse_decode_attention(
        torch.tensor(q).bfloat16(), torch.tensor(k).bfloat16(),
        torch.tensor(v).bfloat16(), torch.tensor(cases["candidates"]), 100)
    assert got.dtype == torch.bfloat16


def test_lsh_decoder_loop_matches_reference():
    """16 LSHDecoder steps on one cross-built index, refresh every 4: the
    candidate tables equal and the outputs within tolerance, step by step;
    the outputs track dense attention."""
    k, v, rng = _cache(0)
    prefill = S - 16
    spec = dict(m_top=24, delta_capacity=32, max_rounds=6)
    j = JKV.prefill(jnp.asarray(k[:, :prefill]), jax.random.key(0),
                    JSpec(**spec))
    x = _cross(j, KVSpec(**spec))
    dj = JDecoder(j, window=16, sinks=4, refresh_every=4)
    dt = LSHDecoder(x, window=16, sinks=4, refresh_every=4)
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    kt, vt = torch.tensor(k), torch.tensor(v)
    cos = []
    for t in range(16):
        if t % 4 == 0:
            target = int(rng.integers(0, prefill))
        length = prefill + t + 1
        q = _query_at(k, target, scale=16.0)
        oj = dj.step(jnp.asarray(q), kj, vj, kj[:, length - 1], length)
        ot = dt.step(torch.tensor(q), kt, vt, kt[:, length - 1], length)
        np.testing.assert_array_equal(dt._positions.numpy(),
                                      np.asarray(dj._positions))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                                   atol=1e-5)
        dense = np.asarray(JL.decode_gqa_attention(jnp.asarray(q), kj, vj,
                                                   length)).reshape(-1, DH)
        a = ot.numpy().reshape(-1, DH)
        cos.append(np.mean((a * dense).sum(-1) / (np.linalg.norm(a, axis=-1)
                   * np.linalg.norm(dense, axis=-1) + 1e-9)))
    assert dt.n_refreshes == dj.n_refreshes == 4
    assert np.mean(cos) > 0.9, cos          # the reference test's criterion
    assert x.seals == j.seals == 0 and x.delta.count == 16


# ---------------------------------------------------------------------------
# The seed oracle (core.det_attention)
# ---------------------------------------------------------------------------

def test_det_attention_shims_warn_and_match_reference():
    k, v, rng = _cache(9, b=1, s=256, hk=2, dh=16)
    q = _query_at(k, 123, scale=16.0)
    q = q + 0.05 * rng.standard_normal(q.shape).astype(np.float32)
    with pytest.warns(DeprecationWarning, match="build_kv_index is deprecated"
                      ". use repro.decode.KVCacheIndex.prefill"):
        jidx = JDA.build_kv_index(jnp.asarray(k), jax.random.key(0),
                                  leaf_size=16)
    with pytest.warns(DeprecationWarning, match="build_kv_index is deprecated"
                      ". use repro_torch.decode.KVCacheIndex.prefill"):
        tidx = TDA.build_kv_index(torch.tensor(k), A=np.asarray(jidx.A),
                                  leaf_size=16)
    # The port's seed path and its fused prefill build the same forests.
    kv = KVCacheIndex.prefill(k, spec=KVSpec(leaf_size=16),
                              A=np.asarray(jidx.A), device="cpu")
    for name in ("point_ids", "leaf_lo", "leaf_hi", "leaf_valid",
                 "breakpoints"):
        got = getattr(tidx, name)
        assert torch.equal(got.reshape((-1,) + got.shape[2:]),
                           getattr(kv.forest, name)), name
    np.testing.assert_allclose(tidx.radius.numpy(), np.asarray(jidx.radius),
                               rtol=1e-6)
    # On the reference's forests, the seed retrieval and attention agree.
    cross = TDA.DETKVIndex(*(torch.tensor(np.asarray(a))
                             for a in jidx[:7]), jidx.leaf_size, jidx.S)
    qh = q.reshape(1, 2, 2, 16)
    np.testing.assert_array_equal(
        TDA.retrieve_topm(cross, torch.tensor(qh), 8).numpy(),
        np.asarray(JDA.retrieve_topm(jidx, jnp.asarray(qh), 8)))
    with pytest.warns(DeprecationWarning, match="det_decode_attention is "
                      "deprecated. use repro.decode"):
        want = JDA.det_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jidx, 256,
                                        m_leaves=8, window=16)
    with pytest.warns(DeprecationWarning, match="det_decode_attention is "
                      "deprecated. use repro_torch.decode"):
        got = TDA.det_decode_attention(torch.tensor(q), torch.tensor(k),
                                       torch.tensor(v), cross, 256,
                                       m_leaves=8, window=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="Nr"):
        with pytest.warns(DeprecationWarning):
            TDA.build_kv_index(torch.tensor(k), Nr=300)
