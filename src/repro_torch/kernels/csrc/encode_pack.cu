// encode_pack: fused iSAX encode + interleaved sort-key pack (static build).
//
// Replaces the TPU kernel src/repro/kernels/build_fused.py:encode_pack
// (body _encode_pack_tile).
//
// What it computes, for proj (n, L*K) f32 and breakpoints (L*K, Nr+1) f32:
//   code[row, c]  = #(inner edges bp[c, 1..Nr-1] <= proj[row, c]), which lies
//                   in [0, Nr-1] (searchsorted(side='right') on sorted edges);
//   proj_t/codes_t (L, n, K): the per-tree layouts of proj and the codes;
//   key_hi/key_lo (L, n): each tree's K codes bit-interleaved MSB first,
//                   round-robin over dims, into two 32-bit words; bit
//                   positions >= 32 are dropped (core/detree.py
//                   interleave_keys).  Words are stored as int64 holding the
//                   uint32 value, because torch cannot sort uint32.
//
// What bounds it on an H100: memory.  Per row it reads L*K floats and writes
// L*K floats, L*K int32 codes and 2*L int64 words; the binary search costs
// log2(Nr) compares per element against an edge table of L*K*(Nr+1) floats
// (66 KB at L*K=64, Nr=256), above the 48 KB static shared-memory limit.
//
// Design: one block takes a tile of kRows = 32 rows and stages them in
// shared memory with coalesced loads; the encode, the per-tree writes and
// the key pack then run from shared memory (encode_pack_tile.cuh, shared
// with project_encode_pack.cu, which fills the same tile by projecting).
// The tile grows with L*K (5 bytes a dim a row); past 1,451 dims it no
// longer fits a block, so the wrapper launches once per group of trees
// that fits: proj is read through a row stride ld, and the group's rows of
// bp and L-slices of the outputs are contiguous.

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_pack_tile.cuh"

namespace {

using encode_pack_tile::kRows;
using encode_pack_tile::kThreads;

__global__ void __launch_bounds__(kThreads) encode_pack_kernel(
    const float* __restrict__ proj, const float* __restrict__ bp,
    float* __restrict__ proj_t, int32_t* __restrict__ codes_t,
    int64_t* __restrict__ key_hi, int64_t* __restrict__ key_lo, int64_t n,
    int ld, int K, int L, int Nr, int hi_bits, int lo_bits) {
  extern __shared__ float x_s[];          // (kRows, D + 1) tile of proj
  const int D = L * K;
  const int DP = D + 1;
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(x_s + kRows * DP);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kRows), n - row0));

  // stage the tile: rows runs of D consecutive floats, ld apart
  const float* src = proj + row0 * ld;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D;
    const int c = e - r * D;
    x_s[r * DP + c] = src[r * ld + c];
  }
  __syncthreads();
  encode_pack_tile::encode_and_pack(x_s, codes_s, rows, row0, n, bp, proj_t,
                                    codes_t, key_hi, key_lo, K, L, Nr,
                                    hi_bits, lo_bits);
}

}  // namespace

extern "C" int encode_pack_launch(const float* proj, const float* bp,
                                  float* proj_t, int32_t* codes_t,
                                  int64_t* key_hi, int64_t* key_lo,
                                  int64_t n, int ld, int K, int L,
                                  int Nr, int hi_bits, int lo_bits,
                                  void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + kRows - 1) / kRows;
  const size_t smem = encode_pack_tile::tile_bytes(L * K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        encode_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  encode_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      proj, bp, proj_t, codes_t, key_hi, key_lo, n, ld, K, L, Nr, hi_bits,
      lo_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* encode_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
