// project_encode_pack: the streaming seal's one pass, p-stable projection
// fused with the iSAX encode and the interleaved sort-key pack.
//
// Replaces the TPU kernel
// src/repro/kernels/build_fused.py:project_encode_pack (body
// _kernel_from_data), which runs the (bn, d) @ (d, L*K) product on the MXU
// and hands the tile to the shared _encode_pack_tile.
//
// What it computes, for x (n, d) f32, a (d, L*K) f32 and breakpoints
// (L*K, Nr+1) f32: proj = x @ a, summed over d in index order, each product
// and each sum rounded on its own (__fadd_rn(acc, __fmul_rn(x, a)), which
// nvcc cannot contract into an FMA), then encode_pack's outputs from proj:
// proj_t/codes_t (L, n, K), key_hi/key_lo (L, n) int64 holding uint32.  The
// fixed order makes proj, and so every code and key, bit-identical to the
// plain version (kernels/ref.py project): one ulp of a projection flips a
// code at an edge and moves a point to another leaf.
//
// What bounds it on an H100: memory, on paper.  At d = 128, L*K = 64 a row
// reads 512 bytes of x and writes 256 + 256 bytes of proj_t/codes_t plus
// 64 bytes of keys; the product is 2*d*L*K = 16 KFLOP a row, 0.75x the
// bytes' time at the fp32 peak.  Keeping mul and add apart (no FMA) halves
// the rate the CUDA cores give it, so in practice the arithmetic, at 1.5x
// the bytes' time, is the tighter limit; tensor cores are out (TF32 would
// flip codes).
//
// Design: one block per tile of kRows = 32 rows, as encode_pack.  The
// projection stage (project_tile.cuh, shared with lsh_project.cu) stages
// the tile's rows of x in shared memory and has each thread accumulate one
// projected dim for 8 rows in registers, reading the dim's column of a
// through the read-only path; the sums land in the (kRows, L*K + 1) tile
// that encode_pack_tile.cuh encodes and packs.  A block holds 27 KB of
// shared memory and 32 registers a thread, so 8 blocks share an SM and one
// block's projection overlaps another's encode.  Staging all of a in shared
// memory instead (60 KB a block, a persistent grid, 3 blocks an SM) took
// 2.81-2.93 ms at n = 1M against this design's 1.77-1.79 ms, in one run on
// an H100 (chip_smoke.py's project_encode_pack check; PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_pack_tile.cuh"
#include "project_tile.cuh"

namespace {

using encode_pack_tile::kRows;
using encode_pack_tile::kThreads;
using project_tile::kRowGroups;
using project_tile::kRowsPerItem;
using project_tile::padded;

static_assert(project_tile::kRows == kRows, "one tile height for both");
constexpr size_t kMaxSmem = 232448;              // 227 KB a block on an H100

size_t smem_bytes(int d, int D) {
  return sizeof(float) * static_cast<size_t>(kRows) * padded(d)
         + encode_pack_tile::tile_bytes(D);
}

__global__ void __launch_bounds__(kThreads) project_encode_pack_kernel(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ bp, float* __restrict__ proj_t,
    int32_t* __restrict__ codes_t, int64_t* __restrict__ key_hi,
    int64_t* __restrict__ key_lo, int64_t n, int d, int K, int L, int Nr,
    int hi_bits, int lo_bits) {
  extern __shared__ __align__(16) float smem[];
  const int D = L * K;
  const int DP = D + 1;
  float* xin_s = smem;                           // (kRows, padded(d)) x
  float* x_s = xin_s + kRows * padded(d);        // (kRows, D + 1) projections
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(x_s + kRows * DP);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kRows),
                                        n - row0));

  project_tile::stage_rows(x, d, row0, rows, 0, d, xin_s);
  __syncthreads();
  for (int w = threadIdx.x; w < kRowGroups * D; w += blockDim.x) {
    const int c = w % D;
    const int rq = w / D;
    float acc[kRowsPerItem];
#pragma unroll
    for (int i = 0; i < kRowsPerItem; ++i) acc[i] = 0.f;
    project_tile::accumulate(xin_s, d, a + c, D, rq, acc);
#pragma unroll
    for (int i = 0; i < kRowsPerItem; ++i)
      x_s[(rq + kRowGroups * i) * DP + c] = acc[i];
  }
  __syncthreads();

  encode_pack_tile::encode_and_pack(x_s, codes_s, rows, row0, n, bp, proj_t,
                                    codes_t, key_hi, key_lo, K, L, Nr,
                                    hi_bits, lo_bits);
}

}  // namespace

extern "C" int project_encode_pack_launch(
    const float* x, const float* a, const float* bp, float* proj_t,
    int32_t* codes_t, int64_t* key_hi, int64_t* key_lo, int64_t n, int d,
    int K, int L, int Nr, int hi_bits, int lo_bits, void* stream) {
  if (n == 0) return 0;
  const size_t smem = smem_bytes(d, L * K);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        project_encode_pack_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + kRows - 1) / kRows;
  project_encode_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      x, a, bp, proj_t, codes_t, key_hi, key_lo, n, d, K, L, Nr, hi_bits,
      lo_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* project_encode_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
