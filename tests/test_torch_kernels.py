"""PyTorch port: the kernels' plain versions against the reference package.

On the CPU the port's ``kernels/ops.py`` runs each kernel's plain PyTorch
version; here it is held against the reference's Pallas kernel (interpret
mode) and its jnp oracle on the same numpy inputs.  The CUDA kernels
themselves are held against the plain versions in tests/test_torch_cuda.py
(and by ``chip_smoke.py``).
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import encoding as jenc  # noqa: E402
from repro.core.detree import build_forest as jax_build_forest  # noqa: E402
from repro.core.query import make_fused_plan as jax_plan  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _proj_bp(n, K, L, Nr, seed):
    rng = np.random.default_rng(seed)
    proj = (rng.standard_normal((n, L * K)) * 2.0).astype(np.float32)
    bp = np.asarray(jenc.select_breakpoints(jnp.asarray(proj), Nr,
                                            method="full_sort"))
    return proj, bp


# ---------------------------------------------------------------------------
# (a) encode_pack: bit-identical to the Pallas kernel and the jnp oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,K,L,Nr", [(300, 4, 3, 64), (257, 5, 2, 64),
                                      (600, 16, 2, 256)])
def test_encode_pack_bit_identical_to_reference(n, K, L, Nr):
    proj, bp = _proj_bp(n, K, L, Nr, seed=K)
    got = tops.encode_pack(torch.tensor(proj), torch.tensor(bp), K=K, L=L)
    kernel = jops.encode_pack(jnp.asarray(proj), jnp.asarray(bp), K=K, L=L,
                              interpret=True, block_n=128)
    oracle = jref.encode_pack(jnp.asarray(proj), jnp.asarray(bp), K=K, L=L)
    for want in (kernel, oracle):
        for name, g, w in zip(("proj_t", "codes_t", "key_hi", "key_lo"),
                              got, want):
            w = np.asarray(w)
            if w.dtype == np.uint32:      # port words: uint32 values in int64
                assert g.dtype == torch.int64, name
                w = w.astype(np.int64)
            else:
                assert g.numpy().dtype == w.dtype, name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if K == 16:                           # the sign-bit half of the hi word
        assert int(got[2].max()) >= 2 ** 31
    if K <= 4:
        assert not bool(got[3].any())     # the key fits the hi word


# ---------------------------------------------------------------------------
# (b) range_rerank: same +inf mask, close finite distances
# ---------------------------------------------------------------------------

def _rerank_inputs(B, n, K, L, ls, d, seed):
    """A reference-built forest + fused plan and a query batch, as numpy."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    A = rng.standard_normal((d, L * K)).astype(np.float32)
    q = (data[rng.choice(n, B, replace=False)]
         + 0.3 * rng.standard_normal((B, d))).astype(np.float32)
    proj = data @ A
    forest = jax_build_forest(jnp.asarray(proj), K, L, Nr=64, leaf_size=ls,
                              breakpoint_method="full_sort")
    plan = jax_plan(jnp.asarray(data), forest)
    q_proj = (q @ A).reshape(B, L, K).transpose(1, 0, 2).copy()
    live = rng.random((L, forest.point_ids.shape[1])) > 0.2
    arrays = dict(q=q, q_proj=q_proj,
                  leaf_lo=np.asarray(forest.leaf_lo),
                  leaf_hi=np.asarray(forest.leaf_hi),
                  leaf_valid=np.asarray(forest.leaf_valid),
                  breakpoints=np.asarray(forest.breakpoints),
                  points=np.asarray(plan.points_sorted),
                  point_valid=np.asarray(forest.valid), live=live)
    return arrays, rng


_ORDER = ("q", "q_proj", "r", "leaf_lo", "leaf_hi", "leaf_valid",
          "breakpoints", "points", "point_valid", "live")


# Tolerance: both sides compute sqrt(max(qq - 2 q.p + pp, 0)) in f32, but
# the q.p sums run in another order (XLA's dot vs torch.matmul), which moves
# the last bits of d^2 (|x|^2 ~ 10 here, so ~1e-6) and of its square root.
RTOL = ATOL = 1e-5


@pytest.mark.parametrize("probe_depth", [0, 2])
@pytest.mark.parametrize("B,n,ls,per_tree,use_live,d",
                         [(5, 700, 16, False, True, 8),
                          (11, 523, 8, True, False, 8),
                          (8, 1000, 32, False, False, 8),
                          (4, 300, 16, False, True, 1536)])
def test_range_rerank_matches_reference(B, n, ls, per_tree, use_live, d,
                                        probe_depth):
    """d = 1,536 is past what the CUDA kernel once held in shared memory
    (d <= 1,472); the plain version has no width limit either."""
    K, L = 4, 3
    a, rng = _rerank_inputs(B, n, K, L, ls, d, seed=n)
    # Radii around the leaf-LB scale, a done lane (-1), per tree or shared.
    shape = (L, B) if per_tree else (B,)
    a["r"] = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    a["r"][..., 1] = -1.0      # per-tree radii are never widened by probes
    live = a["live"] if use_live else None
    args_j = [jnp.asarray(a[k]) for k in _ORDER[:-1]]
    args_t = [torch.tensor(a[k]) for k in _ORDER[:-1]]
    want = np.asarray(jops.range_rerank(
        *args_j, None if live is None else jnp.asarray(live), leaf_size=ls,
        probe_depth=probe_depth, interpret=True))
    got = tops.range_rerank(
        *args_t, None if live is None else torch.tensor(live), leaf_size=ls,
        probe_depth=probe_depth).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.any() and (~fin).any()     # both branches exercised
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
    assert np.isinf(got[:, 1]).all()      # the done lane admits nothing


def test_forest_leaf_lb_and_probe_radii_match_reference():
    a, rng = _rerank_inputs(7, 600, 4, 3, 16, 8, seed=3)
    args = [a[k] for k in ("q_proj", "leaf_lo", "leaf_hi", "leaf_valid",
                           "breakpoints")]
    got = tref.forest_leaf_lb(*map(torch.tensor, args)).numpy()
    want = np.asarray(jref.forest_leaf_lb(*map(jnp.asarray, args)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    r = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    r[0] = -1.0
    r_got, m_got = tref.probe_radii_from_lb(torch.tensor(want),
                                            torch.tensor(r), 2)
    r_want, m_want = jref.probe_radii_from_lb(jnp.asarray(want),
                                              jnp.asarray(r), 2)
    np.testing.assert_array_equal(r_got.numpy(), np.asarray(r_want))
    np.testing.assert_array_equal(m_got.numpy(), np.asarray(m_want))


def test_leaf_bounds_and_l2_rerank_match_reference():
    a, _ = _rerank_inputs(4, 400, 4, 2, 16, 8, seed=5)
    args = (a["q_proj"][0, 0], a["leaf_lo"][0], a["leaf_hi"][0],
            a["leaf_valid"][0], a["breakpoints"][0])
    for g, w in zip(tref.leaf_bounds(*map(torch.tensor, args)),
                    jref.leaf_bounds(*map(jnp.asarray, args))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    pts = a["points"][0]
    np.testing.assert_allclose(
        tref.l2_rerank(torch.tensor(a["q"]), torch.tensor(pts)).numpy(),
        np.asarray(jref.l2_rerank(jnp.asarray(a["q"]), jnp.asarray(pts))),
        rtol=RTOL, atol=ATOL)


def test_ops_refuse_a_device_without_a_kernel():
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.encode_pack(x, torch.zeros((8, 5), device="meta"), K=4, L=2)


@pytest.mark.parametrize("sq,dh,dtype,want", [
    (1, 128, torch.float32, "split"), (8, 1000, torch.bfloat16, "split"),
    (9, 128, torch.bfloat16, "mma"), (32768, 256, torch.bfloat16, "mma"),
    (9, 257, torch.bfloat16, "simt"), (32768, 128, torch.float32, "simt"),
    (1, 5000, torch.float32, "simt")])
def test_flash_attention_path_rule(sq, dh, dtype, want):
    """The CUDA wrapper's launch path from the shape (no card needed): the
    split-key decode up to 8 query rows (dh <= 4,096, for its shared
    memory), the tensor cores for bf16 up to dh = 256, the CUDA cores
    otherwise, at any dh."""
    from repro_torch.kernels import flash_attention as fak
    assert fak.path(sq, dh, dtype) == want


@pytest.mark.parametrize("bh,sq,sk,causal,want", [
    (64, 1, 32768, False, (16, 2048)),      # decode_path's dense step
    (4, 1, 65536, False, (128, 512)),       # few heads: more splits
    (64, 3, 1000, False, (2, 500)),
    (64, 3, 1000, True, (1, 3)),            # causal rows see keys < sq
    (2, 1, 0, False, (1, 1))])
def test_flash_attention_split_rule(bh, sq, sk, causal, want):
    from repro_torch.kernels import flash_attention as fak
    n, per = fak.splits(bh, sq, sk, causal)
    assert (n, per) == want
    k_end = min(sk, sq) if causal else sk
    assert (n - 1) * per < max(k_end, 1) <= n * per    # every key, once


@pytest.mark.parametrize("K,L,spare,want", [
    (16, 4, 0, [(0, 4)]), (16, 128, 0, [(0, 90), (90, 128)]),
    (4, 16, 4 * 32 * 128, [(0, 16)]),
    (16, 128, 4 * 32 * 256, [(0, 77), (77, 128)])])
def test_encode_kernels_tree_groups(K, L, spare, want):
    """Trees per launch of encode_pack / project_encode_pack: each group's
    (32, L_g*K + 1) f32 + u8 tile fits the 232,448 bytes a block has, beside
    project_encode_pack's staged x chunk (``spare``)."""
    from repro_torch.kernels import build_fused as bfk
    groups = bfk._tree_groups(K, L, spare)
    assert groups == want
    for l0, l1 in groups:
        assert 32 * ((l1 - l0) * K + 1) * 5 + spare <= 232448
    with pytest.raises(ValueError):
        bfk._tree_groups(2000, 1, 0)


def test_kernel_build_dir_needs_a_source_checkout(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    root = _build.CSRC.parents[3]
    assert _build.build_dir() == root / "build" / "repro_torch_kernels"
    installed = tmp_path / "site-packages" / "repro_torch" / "kernels" / "csrc"
    monkeypatch.setattr(_build, "CSRC", installed)
    with pytest.raises(RuntimeError, match="source checkout"):
        _build.library_path("encode_pack")


# ---------------------------------------------------------------------------
# (c) lsh_project and encode_bins: the build's projection and encode
# ---------------------------------------------------------------------------

def _bf16_pair(rng, shape, dtype):
    """The same values for both packages: a jnp array of ``dtype`` and the
    torch tensor holding exactly its values (bf16 -> bf16, exact)."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(
        dtype)
    t = torch.tensor(np.asarray(j.astype(jnp.float32)))
    return j, (t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t)


# Tolerance, as tests/test_kernels.py states it for the reference's own
# kernel: the port sums over d in index order, XLA in another order.
@pytest.mark.parametrize("n,d,m", [(256, 128, 128), (300, 100, 64),
                                   (512, 960, 64), (1, 17, 3)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_lsh_project_plain_matches_reference(n, d, m, dtype):
    rng = np.random.default_rng(n + d)
    xj, xt = _bf16_pair(rng, (n, d), dtype)
    aj, at = _bf16_pair(rng, (d, m), dtype)
    want = np.asarray(jops.lsh_project(xj, aj, interpret=True))
    got = tops.lsh_project(xt, at)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, m)
    tol = 2e-2 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * 8)


_F32_HALF_PAST_MAX = (Fraction(2 - Fraction(1, 2 ** 23)) * 2 ** 127
                      + Fraction(2) ** 103)


def _round_f32(v: Fraction, zero: float) -> np.float32:
    """The exact value v rounded to the nearest f32, ties to even; an exact
    zero gets the sign ``zero`` carries (IEEE round to nearest)."""
    if v == 0:
        return np.float32(zero)
    if abs(v) >= _F32_HALF_PAST_MAX:
        return np.float32(np.inf if v > 0 else -np.inf)
    c = np.float32(float(v))       # at most one ulp off (double rounding)
    cands = [x for x in (np.nextafter(c, np.float32(-np.inf)), c,
                         np.nextafter(c, np.float32(np.inf)))
             if np.isfinite(x)]
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - v),
                                     int(np.float32(x).view(np.int32)) & 1))


def _exact_fma(x: np.float32, a: np.float32, acc: np.float32) -> np.float32:
    prod = Fraction(float(x)) * Fraction(float(a))
    neg_zero = (prod == 0 and np.signbit(x) != np.signbit(a)
                and acc == 0 and np.signbit(acc))
    return _round_f32(prod + Fraction(float(acc)), -0.0 if neg_zero else 0.0)


def _fma_triples(case: str, rng, n: int):
    f32 = np.float32

    def signed(v):
        return (v * rng.choice([-1.0, 1.0], v.shape)).astype(f32)
    if case == "random":
        scale = lambda: 10.0 ** rng.uniform(-3, 3, n)      # noqa: E731
        return (signed(rng.random(n) * scale()),
                signed(rng.random(n) * scale()),
                signed(rng.random(n) * scale()))
    if case == "ties":             # x*a is an odd number of half ulps of acc
        acc = signed(rng.uniform(1, 2, n) * 2.0 ** rng.integers(-20, 20, n))
        ulp = np.spacing(np.abs(acc)).astype(np.float64)
        x = (2 * rng.integers(0, 8, n) + 1).astype(f32)
        return x, signed(ulp / 2), acc
    if case == "cancellation":     # the sum is the product's rounding error
        x = signed(rng.uniform(1, 2, n) * 2.0 ** rng.integers(-8, 8, n))
        a = signed(rng.uniform(1, 2, n) * 2.0 ** rng.integers(-8, 8, n))
        acc = -(x * a)
        nudge = rng.random(n) < 0.3
        acc[nudge] = np.nextafter(acc[nudge], np.float32(np.inf))
        return x, a, acc
    if case == "double_rounding":  # x*a within 2^-29 of half an ulp
        acc = signed(2.0 ** rng.integers(-20, 20, n))
        x = rng.uniform(1, 2, n).astype(f32)
        a = signed(np.abs(acc).astype(np.float64) * 2.0 ** -24 / x)
        return x, a, acc
    if case == "subnormal":        # products and sums below 2^-126
        x = signed(rng.uniform(1, 2, n) * 2.0 ** -70)
        a = signed(rng.uniform(1, 2, n) * 2.0 ** rng.integers(-80, -60, n))
        acc = signed(rng.integers(0, 2 ** 23, n) * 2.0 ** -149)
        return x, a, acc
    assert case == "large"         # near the top of the range, some overflow
    x = signed(rng.uniform(1, 2, n) * 2.0 ** rng.integers(55, 64, n))
    a = signed(rng.uniform(1, 2, n) * 2.0 ** rng.integers(55, 64, n))
    acc = signed(rng.uniform(1, 2, n) * 2.0 ** rng.integers(100, 128, n))
    return x, a, acc


_FMA_CASES = ("random", "ties", "double_rounding", "cancellation",
              "subnormal", "large")


@pytest.mark.parametrize("case", _FMA_CASES)
def test_fma_f32_matches_exact_rounding(case):
    """The plain lsh_project's step, ref.fma_f32, is the correctly rounded
    f32 FMA: equal bit for bit to the exact x*a + acc (fractions) rounded
    to nearest f32, ties to even, on seeded triples of each kind.  In
    "double_rounding" a plain float64 sum rounded to f32 is wrong for some
    triples (counted below), so the round-to-odd step is needed."""
    rng = np.random.default_rng(_FMA_CASES.index(case))
    x, a, acc = _fma_triples(case, rng, 3000)
    got = tref.fma_f32(torch.tensor(x), torch.tensor(a),
                       torch.tensor(acc)).numpy()
    want = np.array([_exact_fma(*t) for t in zip(x, a, acc)],
                    dtype=np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if case == "double_rounding":
        naive = (x.astype(np.float64) * a + acc).astype(np.float32)
        assert (naive != want).sum() > 0


def test_lsh_project_plain_is_the_fma_chain():
    """ref.lsh_project sums each output as fma(x[i, j], a[j, c], acc) for
    j = 0..d-1: equal bit for bit to that chain rounded exactly, step by
    step."""
    rng = np.random.default_rng(5)
    n, d, m = 4, 23, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    a = rng.standard_normal((d, m)).astype(np.float32)
    got = tref.lsh_project(torch.tensor(x), torch.tensor(a)).numpy()
    want = np.zeros((n, m), dtype=np.float32)
    for i in range(n):
        for c in range(m):
            acc = np.float32(0.0)
            for j in range(d):
                acc = _exact_fma(x[i, j], a[j, c], acc)
            want[i, c] = acc
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_lsh_project_plain_bf16_equals_mul_then_add():
    """A product of two bf16 values is exact in f32, so for bf16 inputs the
    FMA chain gives the bits of a rounded product and a rounded sum a step:
    ref.lsh_project equals ref.project (and the kernel's bf16 outputs stay
    those of its earlier mul-then-add form)."""
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal((64, 40)) * 3).to(torch.bfloat16)
    a = torch.tensor(rng.standard_normal((40, 24))).to(torch.bfloat16)
    got = tref.lsh_project(x, a)
    assert torch.equal(got.view(torch.int32), tref.project(
        x.to(torch.float32), a.to(torch.float32)).view(torch.int32))


def test_project_plain_is_mul_then_add():
    """ref.project, project_encode_pack's plain sum, is unchanged: one
    rounded f32 product and one rounded f32 sum a step, in d order (numpy
    f32 arithmetic, which does not contract), and project_encode_pack's
    plain version projects through it.  On f32 inputs it differs from the
    FMA chain of ref.lsh_project."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    a = rng.standard_normal((24, 16)).astype(np.float32)
    want = np.zeros((300, 16), dtype=np.float32)
    for j in range(24):
        want = want + x[:, j, None] * a[j]
    got = tref.project(torch.tensor(x), torch.tensor(a)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    bp = torch.sort(torch.tensor(rng.standard_normal((16, 33)),
                                 dtype=torch.float32), dim=1).values
    proj_t = tref.project_encode_pack(torch.tensor(x), torch.tensor(a), bp,
                                      K=4, L=4)[0]
    assert torch.equal(proj_t, torch.tensor(want).reshape(300, 4, 4)
                       .permute(1, 0, 2))
    fma = tref.lsh_project(torch.tensor(x), torch.tensor(a)).numpy()
    assert (fma != want).any()


@pytest.mark.parametrize("n,D,Nr", [(512, 64, 256), (700, 16, 64),
                                    (64, 4, 16), (1024, 128, 256)])
def test_encode_bins_plain_matches_reference(n, D, Nr):
    rng = np.random.default_rng(n + D)
    coords = (rng.standard_normal((n, D)) * 3.0).astype(np.float32)
    bp = np.sort((rng.standard_normal((D, Nr + 1)) * 3.0).astype(np.float32),
                 axis=1, kind="stable")
    want = np.asarray(jops.encode_bins(jnp.asarray(coords), jnp.asarray(bp),
                                       interpret=True))
    got = tops.encode_bins(torch.tensor(coords), torch.tensor(bp))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_project_and_encode_take_the_four_impl_names():
    """hashing.project and encoding.encode accept every impl name; on CPU
    tensors each runs plain code and no kernel launch is counted."""
    from repro_torch.core import encoding, hashing
    from repro_torch.kernels import encode_bins as ebk
    from repro_torch.kernels import lsh_project as lpk
    rng = np.random.default_rng(21)
    x = torch.tensor(rng.standard_normal((300, 24)), dtype=torch.float32)
    a = torch.tensor(rng.standard_normal((24, 12)), dtype=torch.float32)
    before = (lpk.lsh_project.launches, ebk.encode_bins.launches)
    in_order = tref.lsh_project(x, a)
    projs = {impl: hashing.project(x, a, impl=impl)
             for impl in ("auto", "xla", "pallas", "pallas_interpret")}
    for impl in ("pallas", "pallas_interpret"):
        assert torch.equal(projs[impl], in_order), impl
    for impl in ("auto", "xla"):                  # torch.matmul's own order
        torch.testing.assert_close(projs[impl], in_order, rtol=1e-5,
                                   atol=1e-5)
    bp = encoding.full_sort(in_order, 32)
    codes = {impl: encoding.encode(in_order, bp, impl=impl)
             for impl in ("auto", "xla", "pallas", "pallas_interpret")}
    for impl, c in codes.items():
        assert c.dtype == torch.int32 and torch.equal(c, codes["auto"]), impl
    assert (lpk.lsh_project.launches, ebk.encode_bins.launches) == before


# ---------------------------------------------------------------------------
# (d) flash_attention and the head axis of range_rerank (the decode slice)
# ---------------------------------------------------------------------------

# The shapes of tests/test_kernels.py's flash sweep (its causal case with
# sq != sk, which it skips, runs at sq = sk = 384 here); its tolerances: f32
# 2e-3 against the Pallas kernel (its own statement), 2e-5 against the
# blockwise oracle and the naive softmax (the same online-softmax
# arithmetic in f32), bf16 5e-2; and beside them the tighter bound of
# ref.flash_attention_tolerance (f32 summation order, one bf16 unit in
# the last place), which a wrong kernel cannot meet.
_FLASH = [(1, 2, 128, 128, 64, False), (1, 2, 128, 128, 64, True),
          (2, 1, 100, 260, 32, False), (1, 1, 128, 384, 128, False),
          (1, 1, 384, 384, 128, True),
          # head widths past 128 (the reference pads dh to 256) and a
          # decode shape (sq = 1, the CUDA wrapper's split path)
          (1, 2, 64, 96, 160, False), (1, 1, 64, 64, 256, True),
          (2, 4, 1, 300, 128, False)]


@pytest.mark.parametrize("b,h,sq,sk,dh,causal", _FLASH)
def test_flash_attention_plain_matches_reference(b, h, sq, sk, dh, causal):
    from repro_torch.kernels import flash_attention as fak
    rng = np.random.default_rng(sq + sk + dh)
    q = (rng.standard_normal((b, h, sq, dh)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, h, sk, dh)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, h, sk, dh)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kernel = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal,
                                             interpret=True))
    oracle = np.asarray(jref.flash_attention(jq, jk, jv, causal=causal))
    naive = np.asarray(jref.attention_reference(jq, jk, jv, causal=causal))
    before = fak.flash_attention.launches
    got = tops.flash_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), causal=causal)
    assert fak.flash_attention.launches == before      # CPU: plain
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), kernel, rtol=2e-3, atol=2e-3)
    # The same f32 online softmax, in another summation order.
    assert bool(((got - torch.tensor(kernel)).abs() <=
                 tref.flash_attention_tolerance(got)).all())
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), naive, rtol=2e-5, atol=2e-5)
    plain_naive = tref.attention_reference(torch.tensor(q), torch.tensor(k),
                                           torch.tensor(v), causal=causal)
    np.testing.assert_allclose(plain_naive.numpy(), naive, rtol=2e-5,
                               atol=2e-5)
    again = tops.flash_attention(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), causal=causal,
                                 interpret=True, scale=0.5)
    want = jref.attention_reference(jq, jk, jv, causal=causal, scale=0.5)
    np.testing.assert_allclose(again.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_plain_bf16_matches_reference():
    rng = np.random.default_rng(11)
    shapes = [(1, 2, 128, 64)] * 3
    scales = (0.5, 0.5, 1.0)
    pairs = [_bf16_pair(rng, s, jnp.bfloat16) for s in shapes]
    (jq, tq), (jk, tk), (jv, tv) = [
        (j * sc, t * sc) for (j, t), sc in zip(pairs, scales)]
    want = jops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    naive = jref.attention_reference(jq, jk, jv, causal=True)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    for w in (want, naive):
        # Both sides scale q in f32 and round once to bf16: one bf16 unit
        # in the last place apart at most (ref.flash_attention_tolerance).
        w = torch.tensor(np.asarray(w, np.float32)).to(torch.bfloat16)
        err = (got.float() - w.float()).abs()
        assert bool((err <= tref.flash_attention_tolerance(w)).all()), \
            float(err.max())


@pytest.mark.parametrize("per_tree,use_live", [(False, True), (True, False)])
def test_range_rerank_heads_plain_matches_reference(per_tree, use_live):
    """H = 3 forests, each with its own queries and radii: the plain heads
    version against the reference's (the vmap of its single-forest op, in
    interpret mode), and head by head against the single-forest plain
    version (bit-identical: the same function on the same arrays)."""
    H, B, K, L, ls, d = 3, 5, 4, 3, 16, 8
    heads = [_rerank_inputs(B, 600, K, L, ls, d, seed=40 + h)
             for h in range(H)]
    a = {key: np.stack([hd[0][key] for hd in heads])
         for key in heads[0][0]}
    rng = heads[0][1]
    a["r"] = rng.uniform(0.5, 3.0, (H, L, B) if per_tree else (H, B)
                         ).astype(np.float32)
    a["r"][:, ..., 1] = -1.0                       # a done lane in each head
    live = a["live"] if use_live else None
    want = np.asarray(jops.range_rerank_heads(
        *(jnp.asarray(a[k]) for k in _ORDER[:-1]),
        None if live is None else jnp.asarray(live), leaf_size=ls,
        interpret=True))
    args_t = [torch.tensor(a[k]) for k in _ORDER[:-1]]
    live_t = None if live is None else torch.tensor(live)
    got = tops.range_rerank_heads(*args_t, live_t, leaf_size=ls).numpy()
    assert got.shape == want.shape == (H, L, B, heads[0][0]["points"].shape[1])
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.any() and (~fin).any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
    for h in range(H):
        single = tops.range_rerank(
            *(t[h] for t in args_t), None if live_t is None else live_t[h],
            leaf_size=ls)
        assert torch.equal(torch.tensor(got[h]), single)
    assert np.isinf(got[:, :, 1]).all()
