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
// the tile's rows of x in shared memory, kChunk = 256 columns at a time,
// and has each thread accumulate one projected dim for 8 rows in
// registers, reading the dim's column of a through the read-only path; the
// sums land in the (kRows, L*K + 1) tile that encode_pack_tile.cuh encodes
// and packs.  Past the first chunk an item reloads its 8 sums from that
// tile and adds the next columns in j order, so the bits are those of one
// pass and shared memory stops growing with d (any d runs).  Past what one
// block's tile holds in L*K, the wrapper launches once per group of trees,
// reading a's columns of the group through its row stride lda.  At d = 128
// and L*K = 64 a block holds 27 KB of shared memory and 32 registers a
// thread (one pass, no chunk loop), so 8 blocks share an SM and one
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
constexpr int kChunk = 256;                      // x columns staged at once

size_t smem_bytes(int chunk, int D) {
  return sizeof(float) * static_cast<size_t>(kRows) * padded(chunk)
         + encode_pack_tile::tile_bytes(D);
}

// kChunked false: d <= kChunk, one pass over whole rows; true: the chunk
// loop, whose carried sums cost registers (44 against 32 a thread at
// d = 128, 5 blocks an SM against 8: 15 % slower in one H100 run of
// chip_smoke.py's project_encode_pack check).
template <bool kChunked>
__global__ void __launch_bounds__(kThreads) project_encode_pack_kernel(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ bp, float* __restrict__ proj_t,
    int32_t* __restrict__ codes_t, int64_t* __restrict__ key_hi,
    int64_t* __restrict__ key_lo, int64_t n, int d, int lda, int chunk,
    int K, int L, int Nr, int hi_bits, int lo_bits) {
  extern __shared__ __align__(16) float smem[];
  const int D = L * K;
  const int DP = D + 1;
  float* xin_s = smem;                           // (kRows, padded(chunk)) x
  float* x_s = xin_s + kRows * padded(chunk);    // (kRows, D + 1) projections
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(x_s + kRows * DP);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kRows),
                                        n - row0));

  int j0 = 0;
  do {                                           // once at least: d = 0 sums 0
    const int w = min(chunk, d - j0);
    if (kChunked && j0 > 0) __syncthreads();     // the last chunk is read
    project_tile::stage_rows(x, d, row0, rows, j0, w, xin_s);
    __syncthreads();
    // An item (rq, c) belongs to the same thread in every chunk.
    for (int it = threadIdx.x; it < kRowGroups * D; it += blockDim.x) {
      const int c = it % D;
      const int rq = it / D;
      float acc[kRowsPerItem];
#pragma unroll
      for (int i = 0; i < kRowsPerItem; ++i)
        acc[i] = kChunked && j0 > 0 ? x_s[(rq + kRowGroups * i) * DP + c]
                                    : 0.f;
      const float* ac = a + static_cast<int64_t>(j0) * lda + c;
      project_tile::accumulate(xin_s, w, ac, lda, rq, acc);
#pragma unroll
      for (int i = 0; i < kRowsPerItem; ++i)
        x_s[(rq + kRowGroups * i) * DP + c] = acc[i];
    }
    j0 += chunk;
  } while (kChunked && j0 < d);
  __syncthreads();

  encode_pack_tile::encode_and_pack(x_s, codes_s, rows, row0, n, bp, proj_t,
                                    codes_t, key_hi, key_lo, K, L, Nr,
                                    hi_bits, lo_bits);
}

template <bool kChunked>
cudaError_t launch(const float* x, const float* a, const float* bp,
                   float* proj_t, int32_t* codes_t, int64_t* key_hi,
                   int64_t* key_lo, int64_t n, int d, int lda, int chunk,
                   int K, int L, int Nr, int hi_bits, int lo_bits,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(chunk, L * K);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        project_encode_pack_kernel<kChunked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (n + kRows - 1) / kRows;
  project_encode_pack_kernel<kChunked><<<static_cast<unsigned>(blocks),
                                         kThreads, smem, stream>>>(
      x, a, bp, proj_t, codes_t, key_hi, key_lo, n, d, lda, chunk, K, L, Nr,
      hi_bits, lo_bits);
  return cudaGetLastError();
}

}  // namespace

// x (n, d), a (d, *) read through its row stride lda (its first L*K
// columns), bp (L*K, Nr+1); outputs in the per-tree layouts of L trees.
extern "C" int project_encode_pack_launch(
    const float* x, const float* a, const float* bp, float* proj_t,
    int32_t* codes_t, int64_t* key_hi, int64_t* key_lo, int64_t n, int d,
    int lda, int K, int L, int Nr, int hi_bits, int lo_bits,
    void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d <= kChunk
          ? launch<false>(x, a, bp, proj_t, codes_t, key_hi, key_lo, n, d,
                          lda, d, K, L, Nr, hi_bits, lo_bits, s)
          : launch<true>(x, a, bp, proj_t, codes_t, key_hi, key_lo, n, d, lda,
                         kChunk, K, L, Nr, hi_bits, lo_bits, s);
  return static_cast<int>(err);
}

extern "C" const char* project_encode_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
