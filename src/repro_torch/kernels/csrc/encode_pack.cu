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
// Design: the edge table is read through the read-only path (__ldg), where
// it stays resident in L1/L2 after the first tiles, so device memory sees
// only the streaming traffic.  One block takes a tile of kRows = 32 rows:
//   1. the tile's rows are staged in shared memory with coalesced loads;
//   2. one thread per (row, projected dim) binary-searches that dim's inner
//      edges, the 32 lanes of a warp on the 32 rows of ONE dim, so a warp's
//      edge loads fall in one 1 KB edge row (a few cache lines, broadcast in
//      the first steps) instead of 32 rows of 32 dims;
//   3. proj_t/codes_t are written from shared memory in the per-tree layout,
//      contiguous runs of kRows*K elements per tree;
//   4. one thread per (row, tree) packs key_hi/key_lo from the shared codes
//      with the reference's bit table, so codes never make a second trip
//      through device memory before packing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;      // = warp size: a warp searches one dim
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t pack_word(const uint8_t* codes, int K,
                                              int start_bit, int nbits) {
  uint32_t key = 0;
  int pos = nbits * K;
  for (int b = 0; b < nbits; ++b) {       // bit level, MSB first
    for (int j = 0; j < K; ++j) {         // round-robin over dims
      --pos;
      if (pos >= 32) continue;            // overflows the word: dropped
      const uint32_t bit = (codes[j] >> (7 - (start_bit + b))) & 1u;
      key |= bit << pos;
    }
  }
  return key;
}

size_t smem_bytes(int D) {
  // proj tile (kRows, D + 1) f32 + code tile (kRows, D + 1) u8; the +1
  // column keeps a warp's 32 rows of one dim in 32 different banks.
  return static_cast<size_t>(kRows) * (D + 1) * (sizeof(float) + 1);
}

__global__ void __launch_bounds__(kThreads) encode_pack_kernel(
    const float* __restrict__ proj, const float* __restrict__ bp,
    float* __restrict__ proj_t, int32_t* __restrict__ codes_t,
    int64_t* __restrict__ key_hi, int64_t* __restrict__ key_lo, int64_t n,
    int K, int L, int Nr, int hi_bits, int lo_bits) {
  extern __shared__ float x_s[];          // (kRows, D + 1) tile of proj
  const int D = L * K;
  const int DP = D + 1;
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(x_s + kRows * DP);
  const int E = Nr + 1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kRows), n - row0));

  // 1. stage the tile: rows*D consecutive floats of proj
  const float* src = proj + row0 * D;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D;
    x_s[r * DP + (e - r * D)] = src[e];
  }
  __syncthreads();

  // 2. codes: lane = row, warp = dim (kRows == warp size)
  for (int e = threadIdx.x; e < kRows * D; e += blockDim.x) {
    const int c = e / kRows;
    const int r = e - c * kRows;
    if (r >= rows) continue;
    const float x = x_s[r * DP + c];
    const float* edges = bp + static_cast<int64_t>(c) * E + 1;  // inner edges
    int lo = 0, hi = Nr - 1;
    while (lo < hi) {                     // count of inner edges <= x
      const int mid = (lo + hi) >> 1;
      if (__ldg(edges + mid) <= x) lo = mid + 1; else hi = mid;
    }
    codes_s[r * DP + c] = static_cast<uint8_t>(lo);
  }
  __syncthreads();

  // 3. per-tree layouts: for tree l, rows*K contiguous elements
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int l = e / (rows * K);
    const int rem = e - l * rows * K;
    const int r = rem / K;
    const int c = l * K + (rem - r * K);
    const int64_t o = (static_cast<int64_t>(l) * n + row0) * K + rem;
    proj_t[o] = x_s[r * DP + c];
    codes_t[o] = codes_s[r * DP + c];
  }

  // 4. interleaved key words, one thread per (row, tree)
  for (int e = threadIdx.x; e < rows * L; e += blockDim.x) {
    const int l = e / rows;
    const int r = e - l * rows;
    const uint8_t* cs = codes_s + r * DP + l * K;
    const int64_t o = static_cast<int64_t>(l) * n + row0 + r;
    key_hi[o] = static_cast<int64_t>(pack_word(cs, K, 0, hi_bits));
    key_lo[o] = static_cast<int64_t>(pack_word(cs, K, hi_bits, lo_bits));
  }
}

}  // namespace

extern "C" int encode_pack_launch(const float* proj, const float* bp,
                                  float* proj_t, int32_t* codes_t,
                                  int64_t* key_hi, int64_t* key_lo,
                                  int64_t n, int K, int L, int Nr,
                                  int hi_bits, int lo_bits, void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + kRows - 1) / kRows;
  const size_t smem = smem_bytes(L * K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        encode_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  encode_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      proj, bp, proj_t, codes_t, key_hi, key_lo, n, K, L, Nr, hi_bits,
      lo_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* encode_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
