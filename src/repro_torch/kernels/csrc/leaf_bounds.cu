// leaf_bounds: Fig. 5 leaf lower and upper bounds for every tree, query
// lane and leaf of the forest in one launch.
//
// Replaces the TPU kernel src/repro/kernels/leaf_bounds.py:leaf_bounds
// (body _kernel), which the reference runs once per (tree, query) under
// jax.vmap; here the vmap is the grid.
//
// What it computes, per (tree l, lane b, leaf j), with
// b_lo = bp[l, k, lo[l, j, k]] and b_hi = bp[l, k, hi[l, j, k] + 1]:
//   lb = sqrt(sum_k max(b_lo - x_k, x_k - b_hi, 0)^2)
//   ub = sqrt(sum_k max(|x_k - b_lo|, |x_k - b_hi|)^2)
// with x = q_proj[l, b], and +inf for both where the leaf is invalid.
//
// What bounds it on an H100: memory.  The two (L, B, nl) f32 outputs are
// the only large traffic (50 MB at L=4, B=100, nl=15,625); the leaf
// intervals (int16, 2 MB per array) and the edge table are re-read by
// every lane from L2.  There are ~2K FLOPs per output pair against 8 bytes
// written, far below the fp32 ridge.
//
// Design: one thread per (tree, lane, leaf), the leaf fastest so a warp's
// output stores are one 128-byte line per bound.  The thread gathers its
// two edge coordinates per k directly through __ldg; the TPU kernel swept
// all E edges with selects instead, because a TPU has no cheap gather.
// The edge table (L*K*E*4 = 66 KB at L*K=64, E=257) does not fit 48 KB of
// static shared memory and every lane of a block touches only a few of its
// lines, so it is read from L1/L2 as range_rerank does.  hi widens to
// int32 before the +1 (int16 storage would wrap at 32767).  Both sums run
// in k order with __fadd_rn(acc, __fmul_rn(t, t)), which nvcc cannot
// contract into an FMA, and sqrtf is IEEE (no --use_fast_math), so both
// outputs equal the plain version (kernels/ref.py) bit for bit: the top-M
// cut that follows is decided by exact LB ties.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) leaf_bounds_kernel(
    const float* __restrict__ q_proj,       // (L, B, K)
    const int16_t* __restrict__ leaf_lo,    // (L, nl, K)
    const int16_t* __restrict__ leaf_hi,    // (L, nl, K)
    const uint8_t* __restrict__ leaf_valid, // (L, nl)
    const float* __restrict__ bp,           // (L, K, E)
    float* __restrict__ lb,                 // (L, B, nl)
    float* __restrict__ ub,                 // (L, B, nl)
    int B, int nl, int K, int E, int64_t total) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int j = static_cast<int>(t % nl);
  const int64_t lb_row = t / nl;                 // l * B + b
  const int l = static_cast<int>(lb_row / B);
  const int64_t leaf = static_cast<int64_t>(l) * nl + j;
  const float kInf = __int_as_float(0x7f800000);
  if (!__ldg(leaf_valid + leaf)) {
    lb[t] = kInf;
    ub[t] = kInf;
    return;
  }
  const float* x = q_proj + lb_row * K;
  const int16_t* lo = leaf_lo + leaf * K;
  const int16_t* hi = leaf_hi + leaf * K;
  const float* bpl = bp + static_cast<int64_t>(l) * K * E;
  float acc_lb = 0.f;
  float acc_ub = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {              // loads pipelined, sums in order
    const int ilo = min(max(static_cast<int>(__ldg(lo + k)), 0), E - 1);
    const int ihi = min(max(static_cast<int>(__ldg(hi + k)) + 1, 0), E - 1);
    const float xk = __ldg(x + k);
    const float b_lo = __ldg(bpl + k * E + ilo);
    const float b_hi = __ldg(bpl + k * E + ihi);
    const float g = fmaxf(fmaxf(b_lo - xk, xk - b_hi), 0.f);
    const float u = fmaxf(fabsf(xk - b_lo), fabsf(xk - b_hi));
    acc_lb = __fadd_rn(acc_lb, __fmul_rn(g, g));
    acc_ub = __fadd_rn(acc_ub, __fmul_rn(u, u));
  }
  lb[t] = sqrtf(acc_lb);
  ub[t] = sqrtf(acc_ub);
}

}  // namespace

extern "C" int leaf_bounds_launch(
    const float* q_proj, const int16_t* leaf_lo, const int16_t* leaf_hi,
    const uint8_t* leaf_valid, const float* bp, float* lb, float* ub, int L,
    int B, int nl, int K, int E, void* stream) {
  const int64_t total = static_cast<int64_t>(L) * B * nl;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  leaf_bounds_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      q_proj, leaf_lo, leaf_hi, leaf_valid, bp, lb, ub, B, nl, K, E, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* leaf_bounds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
