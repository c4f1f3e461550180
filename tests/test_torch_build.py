"""PyTorch port: the static build against the reference package.

Given the same projections (and so the same breakpoints), the port's
builders — the fused pipeline and the per-tree reference one — must give
forests bit-identical to the reference's, storage dtypes included.  The
pieces under them (Lemma 3 parameters, breakpoint selection, encoding,
interleaved keys, the one 64-bit sort key) are held against the reference
on their own.  A from-A-alone comparison is deliberately absent: torch and
XLA may round a projection differently in the last bit, which moves points
that sit exactly on a breakpoint.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import encoding as jenc  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.core.detree import build_forest as jax_build_forest  # noqa: E402
from repro.core.detree import interleave_keys as jax_interleave  # noqa: E402
from repro_torch.core import detree as tdet  # noqa: E402
from repro_torch.core import encoding as tenc  # noqa: E402
from repro_torch.core import theory as ttheory  # noqa: E402

_FOREST_KEYS = ("point_ids", "proj_sorted", "codes_sorted", "valid",
                "leaf_lo", "leaf_hi", "leaf_valid", "breakpoints")


def _proj(n, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D)) * 2.0).astype(np.float32)


@pytest.mark.parametrize("K,c,L,beta", [(16, 1.5, 4, None), (4, 1.5, 16, 0.1),
                                        (8, 2.0, 3, None)])
def test_derive_params_matches_reference(K, c, L, beta):
    got = ttheory.derive_params(K=K, c=c, L=L, beta_override=beta)
    want = jtheory.derive_params(K=K, c=c, L=L, beta_override=beta)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ttheory.SUCCESS_PROBABILITY == jtheory.SUCCESS_PROBABILITY


@pytest.mark.parametrize("method,n", [("full_sort", 1000),
                                      ("sample_sort", 9000),
                                      ("sample_sort", 3000)])
def test_breakpoints_bit_identical_to_reference(method, n):
    # sample_sort without a generator/key is the fixed-stride sample
    # (stride 2 at n=9000, the whole input at n=3000): exact either way.
    proj = _proj(n, 6, seed=n)
    got = tenc.select_breakpoints(torch.tensor(proj), 64, method=method)
    want = jenc.select_breakpoints(jnp.asarray(proj), 64, method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    codes = tenc.encode(torch.tensor(proj), got)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jenc.encode(jnp.asarray(proj), want)))


def test_histogram_refine_matches_reference():
    # Float interpolation in the same order on both sides; a tolerance of a
    # few f32 ulps covers any difference in the division's rounding.
    proj = _proj(4000, 5, seed=1)
    got = tenc.select_breakpoints(torch.tensor(proj), 32,
                                  method="histogram_refine")
    want = jenc.select_breakpoints(jnp.asarray(proj), 32,
                                   method="histogram_refine")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_sample_sort_with_generator_is_a_sample_of_the_data():
    proj = torch.tensor(_proj(20000, 3, seed=2))
    bp = tenc.breakpoints_sample_sort(
        proj, 16, generator=torch.Generator().manual_seed(0))
    assert bp.shape == (3, 17)
    assert torch.equal(bp[:, 0], proj.amin(0))
    assert torch.equal(bp[:, -1], proj.amax(0))
    assert bool((bp[:, 1:] >= bp[:, :-1]).all())
    # every inner edge is one of the data's own coordinates
    for dim in range(3):
        assert bool(torch.isin(bp[dim, 1:-1], proj[:, dim]).all())


@pytest.mark.parametrize("K", [1, 3, 4, 5, 8, 16, 33])
def test_interleave_keys_match_reference(K):
    codes = np.random.default_rng(K).integers(0, 256, (2, 500, K))
    hi, lo = tdet.interleave_keys(torch.tensor(codes, dtype=torch.int32), K)
    jhi, jlo = jax_interleave(jnp.asarray(codes, jnp.int32), K)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi).astype(np.int64))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo).astype(np.int64))


def test_sort_key_keeps_unsigned_order_past_the_sign_bit():
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 2 ** 32, (3, 4000), dtype=np.int64)
    hi[:, ::7] = hi[:, 1::7][:, : hi[:, ::7].shape[1]]   # ties in hi
    lo = rng.integers(0, 2 ** 32, (3, 4000), dtype=np.int64)
    assert (hi >= 2 ** 31).any()
    order = tdet.code_sort_orders(torch.tensor(hi), torch.tensor(lo), K=16)
    for l in range(3):
        np.testing.assert_array_equal(order[l].numpy(),
                                      np.lexsort((lo[l], hi[l])))


# (n, K, L, leaf_size, Nr): the shapes of tests/test_build_fused.py, plus a
# K=16 case at Nr=256 whose hi key word reaches 2^31 and beyond.
_SHAPES = [(1000, 4, 3, 32, 64), (513, 8, 2, 16, 64), (129, 16, 1, 8, 64),
           (300, 5, 4, 8, 64), (2000, 16, 2, 16, 256)]


@pytest.mark.parametrize("build_impl", ["auto", "reference"])
@pytest.mark.parametrize("n,K,L,leaf_size,Nr", _SHAPES)
def test_forest_bit_identical_to_reference(build_impl, n, K, L, leaf_size,
                                           Nr):
    proj = _proj(n, L * K, seed=n + K)
    want = jax_build_forest(jnp.asarray(proj), K, L, Nr=Nr,
                            leaf_size=leaf_size,
                            breakpoint_method="full_sort")
    bp = torch.tensor(np.asarray(want.breakpoints).reshape(L * K, Nr + 1))
    frozen = tdet.build_forest(torch.tensor(proj), K, L, Nr=Nr,
                               leaf_size=leaf_size, breakpoints=bp,
                               build_impl=build_impl)
    selected = tdet.build_forest(torch.tensor(proj), K, L, Nr=Nr,
                                 leaf_size=leaf_size,
                                 breakpoint_method="full_sort",
                                 build_impl=build_impl)
    for got in (frozen, selected):
        assert (got.n, got.leaf_size) == (want.n, want.leaf_size)
        for k in _FOREST_KEYS:
            g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert got.size_bytes() == want.size_bytes()
    if Nr == 256 and K == 16:
        hi, _ = tdet.interleave_keys(
            tenc.encode(torch.tensor(proj), bp).reshape(n, L, K), K)
        assert int(hi.max()) >= 2 ** 31


def test_build_stage_seconds_and_nr_guard():
    proj = torch.tensor(_proj(300, 8, seed=3))
    seconds = {}
    tdet.build_forest(proj, 4, 2, Nr=32, leaf_size=16, stage_seconds=seconds)
    assert set(seconds) == {"breakpoints", "encode_pack", "sort", "assemble"}
    with pytest.raises(ValueError, match="uint8"):
        tdet.build_forest(proj, 4, 2, Nr=300)
