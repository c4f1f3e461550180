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


def test_wrappers_refuse_bad_inputs(cuda):
    proj = torch.zeros((8, 8), device=cuda)
    with pytest.raises(TypeError):
        build_fused.encode_pack(proj.double(), torch.zeros((8, 5),
                                device=cuda), K=4, L=2)
    with pytest.raises(ValueError):
        build_fused.encode_pack(proj, torch.zeros((8, 5)), K=4, L=2)
