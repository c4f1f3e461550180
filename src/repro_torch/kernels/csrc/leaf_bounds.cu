// leaf_bounds: Fig. 5 leaf lower and upper bounds for every tree, query
// lane and leaf of the forest in one launch.
//
// Replaces the TPU kernel src/repro/kernels/leaf_bounds.py:leaf_bounds
// (body _kernel), which the reference runs once per (tree, query) under
// jax.vmap; here the vmap is the grid.
//
// What it computes, per (tree l, lane b, leaf j), with
// b_lo = bp[l, k, lo[l, j, k]] and b_hi = bp[l, k, hi[l, j, k] + 1] (both
// indices clamped to [0, E-1]), x = q_proj[l, b], d1 = b_lo - x_k and
// d2 = x_k - b_hi:
//   lb = sqrt(sum_k max(d1, d2, 0)^2)
//   ub = sqrt(sum_k max(|d1|, |d2|)^2)
// (|d1| is |x_k - b_lo| exactly), and +inf for both where the leaf is
// invalid.
//
// What bounds it on an H100: the FP32 instructions.  The two (L, B, nl)
// f32 outputs (50 MB at L = 4, B = 100, nl = 15,625, K = 16) take 0.015 ms
// at 3.35 TB/s; the sums take ~9 FP32 instructions a (k, lane, leaf), none
// of which may fuse into an FMA (bit-identity below), 0.9 G instructions
// at ~30 T a second: ~0.03 ms.  The first version (a thread a (tree, lane,
// leaf)) spent most of its time elsewhere: each thread re-gathered its
// leaf's 2K edge coordinates and re-read its 2K int16 bounds, values that
// depend on (tree, leaf) only, and paid three 64-bit divisions.
//
// Design: a block owns (tree l = blockIdx.z, a tile of 128 leaves on
// blockIdx.x, a chunk of <= 32 lanes on blockIdx.y; at B = 100 four chunks
// of 25, so that the grid fills the 132 SMs).  A thread takes one leaf: it
// loads the leaf's bounds (16-byte loads at K = 8, 16), gathers its 2K edge
// coordinates once into registers (templates on K = 4, 8, 16), then loops
// over the chunk's lanes, reading each lane's projected query from shared
// memory (staged once a block, 16-byte broadcasts).  The leaf index is
// fastest, so a warp's stores are one 128-byte line per bound and lane.  A
// warp whose leaves are all invalid (or past nl) only stores +inf.  Other K
// (the generic instance) gather 8 dims at a time and carry the lanes'
// partial sums in shared memory between those chunks, in k order.  Both
// sums run in k order with __fadd_rn(acc, __fmul_rn(t, t)), which nvcc
// cannot contract into an FMA, and sqrtf is IEEE (no --use_fast_math), so
// both outputs equal the plain version (kernels/ref.py) bit for bit: the
// top-M cut that follows is decided by exact LB ties.  hi widens to int32
// before the +1 (int16 storage would wrap at 32767).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLeaves = 128;       // leaves (threads) a block
constexpr int kLanes = 32;         // the most lanes a chunk
constexpr int kChunk = 8;          // dims a gather of the generic instance

struct Args {
  const float* q_proj;             // (L, B, K)
  const int16_t* leaf_lo;          // (L, nl, K)
  const int16_t* leaf_hi;          // (L, nl, K)
  const uint8_t* leaf_valid;       // (L, nl)
  const float* bp;                 // (L, K, E)
  float* lb;                       // (L, B, nl)
  float* ub;                       // (L, B, nl)
  int B, nl, K, E, lanes;
  int vec;                         // leaf rows 16-byte (8-byte at K = 4)
};                                 // aligned

// One dim's step of both sums.
__device__ __forceinline__ void step(float x, float b_lo, float b_hi,
                                     float& acc_lb, float& acc_ub) {
  const float d1 = b_lo - x;
  const float d2 = x - b_hi;
  const float g = fmaxf(fmaxf(d1, d2), 0.f);
  const float u = fmaxf(fabsf(d1), fabsf(d2));
  acc_lb = __fadd_rn(acc_lb, __fmul_rn(g, g));
  acc_ub = __fadd_rn(acc_ub, __fmul_rn(u, u));
}

// The edge coordinates of dim k of a leaf with bounds (lo, hi).
__device__ __forceinline__ void edges(const float* bpl, int k, int E, int lo,
                                      int hi, float& b_lo, float& b_hi) {
  b_lo = __ldg(bpl + k * E + min(max(lo, 0), E - 1));
  b_hi = __ldg(bpl + k * E + min(max(hi + 1, 0), E - 1));
}

// kK int16 bounds of a leaf row into int registers; vec: one 16-byte load
// per 8 dims (8-byte at kK = 4).
template <int kK>
__device__ __forceinline__ void load_bounds(const int16_t* row, bool vec,
                                            int (&v)[kK]) {
  if (vec) {
    uint32_t w[kK / 2];
    if constexpr (kK == 4) {
      const uint2 p = __ldg(reinterpret_cast<const uint2*>(row));
      w[0] = p.x;
      w[1] = p.y;
    } else {
#pragma unroll
      for (int q = 0; q < kK / 8; ++q) {
        const uint4 p = __ldg(reinterpret_cast<const uint4*>(row) + q);
        w[4 * q] = p.x;
        w[4 * q + 1] = p.y;
        w[4 * q + 2] = p.z;
        w[4 * q + 3] = p.w;
      }
    }
#pragma unroll
    for (int h = 0; h < kK / 2; ++h) {        // little-endian halves
      v[2 * h] = static_cast<int16_t>(w[h] & 0xffffu);
      v[2 * h + 1] = static_cast<int16_t>(w[h] >> 16);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kK; ++k) v[k] = __ldg(row + k);
  }
}

// kK: 4, 8 or 16, or 0 for any K.
template <int kK>
__global__ void __launch_bounds__(kLeaves) leaf_bounds_kernel(Args a) {
  constexpr int kXs = kK > 0 ? kLanes * kK : 1;
  __shared__ __align__(16) float xs[kXs];        // the chunk's queries
  const int l = blockIdx.z;
  const int b0 = blockIdx.y * a.lanes;
  const int nb = min(a.lanes, a.B - b0);
  const int j = blockIdx.x * kLeaves + threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(l) * a.B + b0;    // (l, b0)
  if constexpr (kK > 0) {
    const float* xg = a.q_proj + row0 * kK;
    for (int e = threadIdx.x; e < nb * kK; e += kLeaves) xs[e] = xg[e];
    __syncthreads();
  }
  const bool in = j < a.nl;
  const int64_t leaf = static_cast<int64_t>(l) * a.nl + (in ? j : 0);
  const bool valid = in && a.leaf_valid[leaf] != 0;
  float* lb = a.lb + row0 * a.nl + j;
  float* ub = a.ub + row0 * a.nl + j;
  const float kInf = __int_as_float(0x7f800000);
  if (!__any_sync(0xffffffffu, valid)) {        // no valid leaf in the warp
    if (in)
      for (int b = 0; b < nb; ++b) {
        lb[static_cast<int64_t>(b) * a.nl] = kInf;
        ub[static_cast<int64_t>(b) * a.nl] = kInf;
      }
    return;
  }
  const int K = kK > 0 ? kK : a.K;
  const int16_t* lo_row = a.leaf_lo + leaf * K;
  const int16_t* hi_row = a.leaf_hi + leaf * K;
  const float* bpl = a.bp + static_cast<int64_t>(l) * K * a.E;
  if constexpr (kK > 0) {
    float b_lo[kK], b_hi[kK];
    {
      int lo[kK], hi[kK];
      load_bounds<kK>(lo_row, a.vec, lo);
      load_bounds<kK>(hi_row, a.vec, hi);
#pragma unroll
      for (int k = 0; k < kK; ++k)
        edges(bpl, k, a.E, lo[k], hi[k], b_lo[k], b_hi[k]);
    }
#pragma unroll 2
    for (int b = 0; b < nb; ++b) {
      const float4* x4 = reinterpret_cast<const float4*>(xs + b * kK);
      float acc_lb = 0.f, acc_ub = 0.f;
#pragma unroll
      for (int q = 0; q < kK / 4; ++q) {
        const float4 x = x4[q];                  // a broadcast
        step(x.x, b_lo[4 * q], b_hi[4 * q], acc_lb, acc_ub);
        step(x.y, b_lo[4 * q + 1], b_hi[4 * q + 1], acc_lb, acc_ub);
        step(x.z, b_lo[4 * q + 2], b_hi[4 * q + 2], acc_lb, acc_ub);
        step(x.w, b_lo[4 * q + 3], b_hi[4 * q + 3], acc_lb, acc_ub);
      }
      if (in) {
        lb[static_cast<int64_t>(b) * a.nl] = valid ? sqrtf(acc_lb) : kInf;
        ub[static_cast<int64_t>(b) * a.nl] = valid ? sqrtf(acc_ub) : kInf;
      }
    }
  } else {
    // Partial sums of the chunk's lanes between gathers: (2, kLanes,
    // kLeaves), a thread its own column.
    __shared__ float part[2][kLanes][kLeaves];
    const float* xg = a.q_proj + row0 * K;
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      const int nk = min(kChunk, K - k0);
      float b_lo[kChunk], b_hi[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        if (u < nk)
          edges(bpl, k0 + u, a.E, lo_row[k0 + u], hi_row[k0 + u], b_lo[u],
                b_hi[u]);
      const bool last = k0 + kChunk >= K;
      for (int b = 0; b < nb; ++b) {
        float acc_lb = k0 ? part[0][b][threadIdx.x] : 0.f;
        float acc_ub = k0 ? part[1][b][threadIdx.x] : 0.f;
        const float* x = xg + b * K + k0;        // a broadcast through L1
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (u < nk) step(__ldg(x + u), b_lo[u], b_hi[u], acc_lb, acc_ub);
        if (!last) {
          part[0][b][threadIdx.x] = acc_lb;
          part[1][b][threadIdx.x] = acc_ub;
        } else if (in) {
          lb[static_cast<int64_t>(b) * a.nl] = valid ? sqrtf(acc_lb) : kInf;
          ub[static_cast<int64_t>(b) * a.nl] = valid ? sqrtf(acc_ub) : kInf;
        }
      }
    }
  }
}

}  // namespace

extern "C" int leaf_bounds_launch(
    const float* q_proj, const int16_t* leaf_lo, const int16_t* leaf_hi,
    const uint8_t* leaf_valid, const float* bp, float* lb, float* ub, int L,
    int B, int nl, int K, int E, void* stream) {
  if (static_cast<int64_t>(L) * B * nl == 0) return 0;
  // Lanes in as few chunks of <= 32 as B needs, as even as they can be.
  const int chunks = (B + kLanes - 1) / kLanes;
  const int lanes = (B + chunks - 1) / chunks;
  if (chunks > 65535 || L > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const uintptr_t align = K == 4 ? 8 : 16;
  const int vec = (K == 4 || K % 8 == 0)
      && reinterpret_cast<uintptr_t>(leaf_lo) % align == 0
      && reinterpret_cast<uintptr_t>(leaf_hi) % align == 0;
  const Args a{q_proj, leaf_lo, leaf_hi, leaf_valid, bp, lb, ub,
               B, nl, K, E, lanes, vec};
  const dim3 grid(static_cast<unsigned>((nl + kLeaves - 1) / kLeaves),
                  static_cast<unsigned>(chunks), static_cast<unsigned>(L));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 4: leaf_bounds_kernel<4><<<grid, kLeaves, 0, s>>>(a); break;
    case 8: leaf_bounds_kernel<8><<<grid, kLeaves, 0, s>>>(a); break;
    case 16: leaf_bounds_kernel<16><<<grid, kLeaves, 0, s>>>(a); break;
    default: leaf_bounds_kernel<0><<<grid, kLeaves, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* leaf_bounds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
