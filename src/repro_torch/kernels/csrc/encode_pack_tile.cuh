// The encode + key-pack tile shared by encode_pack.cu and
// project_encode_pack.cu (the TPU kernels' shared _encode_pack_tile in
// src/repro/kernels/build_fused.py).
//
// A block holds a tile of kRows = 32 rows of projected coordinates in shared
// memory, laid out (kRows, D + 1) with D = L*K (the +1 column keeps a warp's
// 32 rows of one dim in 32 different banks).  From there:
//   1. one thread per (row, projected dim) binary-searches that dim's inner
//      edges (count_le, shared with encode_bins.cu), the 32 lanes of a warp
//      on the 32 rows of ONE dim, so a warp's
//      edge loads fall in one 1 KB edge row (a few cache lines, broadcast in
//      the first steps) instead of 32 rows of 32 dims.  The edge table is
//      read through the read-only path (__ldg), where it stays in L1/L2;
//   2. proj_t/codes_t are written in the per-tree layout, contiguous runs of
//      kRows*K elements per tree;
//   3. one thread per (row, tree) packs key_hi/key_lo from the shared codes
//      with the reference's bit table, so codes never make a second trip
//      through device memory before packing.
//
// code[row, c] = #(inner edges bp[c, 1..Nr-1] <= x[row, c]), in [0, Nr-1];
// key words interleave each tree's K codes MSB first, round-robin over dims,
// into two 32-bit words, dropping bit positions >= 32
// (core/detree.py interleave_keys), stored as int64 holding the uint32.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace encode_pack_tile {

constexpr int kRows = 32;      // = warp size: a warp searches one dim
constexpr int kThreads = 256;

// #(edges[0 .. n_edges-1] <= x) for non-decreasing edges, n_edges >= 1:
// searchsorted(side='right'), and so the reference's compare-accumulate
// count.  A branch-free binary search (binary lifting): floor(log2 n_edges)
// + 1 steps whatever x is, each a clamped load and a select.  kReadOnly
// reads edges in device memory through the read-only path (__ldg); false
// reads them where they are (shared memory).
template <bool kReadOnly>
__device__ __forceinline__ int count_le(const float* edges, int n_edges,
                                        float x) {
  int pos = 0;
  for (int step = 1 << (31 - __clz(n_edges)); step > 0; step >>= 1) {
    const int probe = pos + step;
    const float* at = edges + min(probe, n_edges) - 1;
    const float e = kReadOnly ? __ldg(at) : *at;
    pos = (probe <= n_edges && e <= x) ? probe : pos;
  }
  return pos;
}

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

// Bytes of the (kRows, D + 1) f32 coordinate tile and u8 code tile.
inline size_t tile_bytes(int D) {
  return static_cast<size_t>(kRows) * (D + 1) * (sizeof(float) + 1);
}

// Steps 1-3 for one tile whose coordinates x_s (kRows, D + 1) are in shared
// memory and visible to every thread (the caller synchronised).  rows <=
// kRows rows start at row0 of n.  Every thread of the block calls it.
__device__ __forceinline__ void encode_and_pack(
    const float* x_s, uint8_t* codes_s, int rows, int64_t row0, int64_t n,
    const float* __restrict__ bp, float* __restrict__ proj_t,
    int32_t* __restrict__ codes_t, int64_t* __restrict__ key_hi,
    int64_t* __restrict__ key_lo, int K, int L, int Nr, int hi_bits,
    int lo_bits) {
  const int D = L * K;
  const int DP = D + 1;
  const int E = Nr + 1;

  // 1. codes: lane = row, warp = dim (kRows == warp size)
  for (int e = threadIdx.x; e < kRows * D; e += blockDim.x) {
    const int c = e / kRows;
    const int r = e - c * kRows;
    if (r >= rows) continue;
    const float x = x_s[r * DP + c];
    const float* edges = bp + static_cast<int64_t>(c) * E + 1;  // inner edges
    codes_s[r * DP + c] = static_cast<uint8_t>(count_le<true>(edges, Nr - 1,
                                                              x));
  }
  __syncthreads();

  // 2. per-tree layouts: for tree l, rows*K contiguous elements
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int l = e / (rows * K);
    const int rem = e - l * rows * K;
    const int r = rem / K;
    const int c = l * K + (rem - r * K);
    const int64_t o = (static_cast<int64_t>(l) * n + row0) * K + rem;
    proj_t[o] = x_s[r * DP + c];
    codes_t[o] = codes_s[r * DP + c];
  }

  // 3. interleaved key words, one thread per (row, tree)
  for (int e = threadIdx.x; e < rows * L; e += blockDim.x) {
    const int l = e / rows;
    const int r = e - l * rows;
    const uint8_t* cs = codes_s + r * DP + l * K;
    const int64_t o = static_cast<int64_t>(l) * n + row0 + r;
    key_hi[o] = static_cast<int64_t>(pack_word(cs, K, 0, hi_bits));
    key_lo[o] = static_cast<int64_t>(pack_word(cs, K, hi_bits, lo_bits));
  }
}

}  // namespace encode_pack_tile
