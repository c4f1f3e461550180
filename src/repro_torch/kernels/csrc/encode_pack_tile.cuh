// The encode + key-pack stage shared by encode_pack.cu and
// project_encode_pack.cu (the TPU kernels' shared _encode_pack_tile in
// src/repro/kernels/build_fused.py); encode_bins.cu runs its tables and
// search without the key pack.
//
// code[row, c] = #(inner edges bp[c, 1..Nr-1] <= x[row, c]), in [0, Nr-1]
// (0 for a NaN, which no comparison admits, as the TPU kernel's
// compare-accumulate gives); key words interleave each tree's K codes MSB
// first, round-robin over dims, into two 32-bit words, dropping bit
// positions >= 32 (core/detree.py interleave_keys), stored as int64 holding
// the uint32.
//
// The work is split into warp tasks of (one tree, 32 rows), a lane a row,
// with no barrier between a task's steps:
//   1. The edge search.  Each dim's inner edges are laid out breadth first
//      (Eytzinger order: node i's children are 2i and 2i + 1) in a table of
//      P floats, P = the power of two >= Nr, padded with +inf; a search is
//      log2(P) steps of i = 2i + (t[i] <= x), and the code is i - P,
//      clipped to Nr - 1 so that +inf does not count the padding (a NaN
//      takes every left branch: 0).  All lanes of step s read inside nodes
//      [2^s, 2^(s+1)): at Nr = 256 the eight steps of 32 lanes cost 12
//      shared-memory wavefronts (or L1 lines), where a binary search over
//      the sorted edges touches up to 8 lines a step from its fourth on.  A
//      lane runs 4 or 8 dims' searches at once (independent load chains).
//      encode_pack keeps its tree's tables in shared memory
//      (eytzinger_value builds them from bp); project_encode_pack reads
//      them from a (L*K, P) table in device memory through L1
//      (eytzinger_kernel builds it once a call).
//   2. The key words, from the row's K codes in the lane's registers: each
//      code bit is one mask and one shift-add into its place (templates on
//      K = 4, 8 and 16, where every place is a constant); the
//      generic instance (any K) places bits at run-time positions.  A
//      warp's 32 rows of one tree are 32 consecutive words: one 256-byte
//      store each.
//   3. proj_t/codes_t: a warp's 32 rows of one tree are 32 K contiguous
//      values in both layouts.  Where K is a multiple of 4 the rows'
//      coordinates come in, and coordinates and codes go out, through a
//      small staging buffer of the warp, 16 bytes a lane, so that each load
//      covers whole sectors and each store 512 contiguous bytes (a lane
//      storing its own row's 64 bytes would leave every store a half
//      sector); other K move a lane's row directly.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace encode_pack_tile {

constexpr int kRows = 32;      // rows of a warp task = warp size
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Searches a lane runs at once: tables in shared memory answer in ~30
// cycles, those in device memory (through L1) take longer to hide.
template <bool kSmem>
__host__ __device__ constexpr int ilp() { return kSmem ? 4 : 8; }
constexpr int kGroupDims = 64; // projected dims a project_encode_pack block
                               // owns (one tree past K = 64)

// Pitch (floats) of a shared coordinate tile with Dg dims, read a lane a
// row: for 16-byte reads (rows16, Dg a multiple of 4) four times an odd
// number, so that 8 lanes' accesses hit 32 banks; for 4-byte reads odd, so
// that 32 lanes' accesses do.
__host__ __device__ inline int x_pitch(int Dg, bool rows16) {
  if (rows16) return (Dg / 4) % 2 ? Dg : Dg + 4;
  return Dg + 1 + (Dg & 1);
}

// Trees a project_encode_pack block owns: 64 dims' worth, or one tree past
// K = 64.
__host__ __device__ inline int trees_per_group(int K, int L) {
  const int per = K <= kGroupDims ? kGroupDims / K : 1;
  return per < L ? per : L;
}

// log2 of the Eytzinger table's width: the power of two P >= Nr.
inline int log2_width(int Nr) {
  int s = 0;
  while ((1 << s) < Nr) ++s;
  return s;
}

// Node i (1 <= i < P) of dim row bp_row (Nr+1 edges): node i at level s
// holds the inner edge of sorted rank ((2 (i - 2^s) + 1) << (logP - 1 - s))
// - 1, +inf past the Nr - 1 inner edges; node 0 is never read.
__device__ __forceinline__ float eytzinger_value(const float* bp_row, int i,
                                                 int Nr, int logP) {
  if (i == 0) return __int_as_float(0x7f800000);
  const int s = 31 - __clz(i);
  const int rank = ((2 * (i - (1 << s)) + 1) << (logP - 1 - s)) - 1;
  return rank < Nr - 1 ? bp_row[1 + rank] : __int_as_float(0x7f800000);
}

// eyt (D, P) for every dim of bp (D, Nr+1).
__global__ void eytzinger_kernel(const float* __restrict__ bp,
                                 float* __restrict__ eyt, int D, int Nr,
                                 int logP) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= (static_cast<int64_t>(D) << logP)) return;
  eyt[e] = eytzinger_value(bp + (e >> logP) * (Nr + 1),
                           static_cast<int>(e & ((1 << logP) - 1)), Nr, logP);
}

inline cudaError_t build_eytzinger(const float* bp, float* eyt, int D,
                                   int Nr, cudaStream_t stream) {
  const int logP = log2_width(Nr);
  const int64_t total = static_cast<int64_t>(D) << logP;
  const int threads = 256;
  eytzinger_kernel<<<static_cast<unsigned>((total + threads - 1) / threads),
                     threads, 0, stream>>>(bp, eyt, D, Nr, logP);
  return cudaGetLastError();
}

// Streaming (evict-first) stores: nothing rereads the outputs soon.
__device__ __forceinline__ void store(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store(int32_t* p, int32_t v) {
  __stcs(reinterpret_cast<int*>(p), static_cast<int>(v));
}
__device__ __forceinline__ void store(int64_t* p, int64_t v) {
  __stcs(reinterpret_cast<long long*>(p), static_cast<long long>(v));
}

// What a task needs to know of the call.
struct Call {
  const float* eyt;        // (L*K, P) tables in device memory, or null
  float* proj_t;           // (L, n, K)
  int32_t* codes_t;        // (L, n, K)
  int64_t* key_hi;         // (L, n)
  int64_t* key_lo;         // (L, n)
  int64_t n;
  int K, Nr, logP, hi_bits, lo_bits;
};

// core/detree.py key_bit_budget(K): (bits a dim, hi word's, lo word's).
template <int kK>
struct Budget {
  static constexpr int kBits = 64 / kK < 8 ? (64 / kK > 1 ? 64 / kK : 1) : 8;
  static constexpr int kHiMax = 32 / kK > 1 ? 32 / kK : 1;
  static constexpr int kHi = kBits < kHiMax ? kBits : kHiMax;
  static constexpr int kLo = kBits - kHi;
};

template <bool kSmem>
__device__ __forceinline__ float table_at(const float* t) {
  return kSmem ? *t : __ldg(t);
}

// code[u] of x[u] in the table that starts at t[u], for kN dims at once;
// logP <= kLevels (8: Nr <= 256).
template <bool kSmem, int kN, int kLevels = 8>
__device__ __forceinline__ void search(const float* const (&t)[kN],
                                       const float (&x)[kN], int logP,
                                       int Nr, int (&code)[kN]) {
  int i[kN];
#pragma unroll
  for (int u = 0; u < kN; ++u) i[u] = 1;
#pragma unroll
  for (int s = 0; s < kLevels; ++s) {
    if (s < logP) {
      float e[kN];
#pragma unroll
      for (int u = 0; u < kN; ++u) e[u] = table_at<kSmem>(t[u] + i[u]);
#pragma unroll
      for (int u = 0; u < kN; ++u) i[u] = 2 * i[u] + (e[u] <= x[u] ? 1 : 0);
    }
  }
#pragma unroll
  for (int u = 0; u < kN; ++u) code[u] = min(i[u] - (1 << logP), Nr - 1);
}

// The two key words of one row from its kK codes: bit (7 - level) of code
// j lands at position (nbits - 1 - level) * K + (K - 1 - j) of its word.
template <int kK>
__device__ __forceinline__ void lane_keys(const int (&code)[kK],
                                          uint32_t& hi, uint32_t& lo) {
  using B = Budget<kK>;
  hi = 0;
  lo = 0;
#pragma unroll
  for (int b = 0; b < B::kBits; ++b) {
    const int s = 7 - b;                                // bit of the code
    const int nb = b < B::kHi ? B::kHi : B::kLo;
    const int level = b < B::kHi ? b : b - B::kHi;
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      const int pos = (nb - 1 - level) * kK + (kK - 1 - j);
      const uint32_t m = static_cast<uint32_t>(code[j]) & (1u << s);
      const uint32_t v = pos >= s ? m << (pos - s) : m >> (s - pos);
      if (b < B::kHi) hi += v;           // disjoint bits: + is |
      else lo += v;
    }
  }
}

// Pitch (elements) of a warp's (32, kK) staging buffer, kK % 4 == 0: four
// times an odd number, so that 8 lanes' 16-byte row accesses hit 32 banks.
template <int kK>
__host__ __device__ constexpr int buf_pitch() {
  return (kK / 4) % 2 ? kK : kK + 4;
}

// A warp's 32 rows x kK values between a row-contiguous array (rows kK
// apart there, `ld` apart for loads) and its staging buffer, 16 bytes a
// lane: lane e of chunk q moves 16 bytes of row (32 q + e) / (kK / 4), so
// a warp's access covers 512 contiguous bytes of the array.  Rows past
// n_rows are zeros (loads) or not stored.
template <int kK>
__device__ __forceinline__ void load_rows(const float* src, int64_t ld,
                                          int n_rows, float* buf) {
  constexpr int kC = kK / 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kC; ++q) {
    const int e = q * 32 + lane;
    const int r = e / kC;
    const int c = 4 * (e - r * kC);
    const float4 v = r < n_rows
        ? __ldcs(reinterpret_cast<const float4*>(src + r * ld + c))
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(buf + r * buf_pitch<kK>() + c) = v;
  }
}

template <int kK, typename T>
__device__ __forceinline__ void store_rows(const T* buf, int pitch, T* dst,
                                           int n_rows) {
  constexpr int kC = kK / 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kC; ++q) {
    const int e = q * 32 + lane;
    const int r = e / kC;
    const int c = 4 * (e - r * kC);
    if (r < n_rows)
      __stcs(reinterpret_cast<float4*>(dst + r * kK + c),
             *reinterpret_cast<const float4*>(buf + r * pitch + c));
  }
}

// The codes of one lane's row of one tree with kK > 0 dims, x in
// registers, the dims' tables at tables + j * P; and its two key words,
// stored at o = l*n + row of the (L, n) layouts when ok.
template <int kK, bool kSmem>
__device__ __forceinline__ void search_and_pack(const float (&x)[kK],
                                                const float* tables,
                                                int64_t o, bool ok,
                                                const Call& call,
                                                int (&code)[kK]) {
  constexpr int kN = kK < ilp<kSmem>() ? kK : ilp<kSmem>();
#pragma unroll
  for (int j0 = 0; j0 < kK; j0 += kN) {
    const float* t[kN];
    float xs[kN];
    int c[kN];
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      t[u] = tables + (static_cast<int64_t>(j0 + u) << call.logP);
      xs[u] = x[j0 + u];
    }
    search<kSmem, kN>(t, xs, call.logP, call.Nr, c);
#pragma unroll
    for (int u = 0; u < kN; ++u) code[j0 + u] = c[u];
  }
  uint32_t hi, lo;
  lane_keys<kK>(code, hi, lo);
  if (ok) {
    store(call.key_hi + o, static_cast<int64_t>(hi));
    store(call.key_lo + o, static_cast<int64_t>(lo));
  }
}

// A warp task of one tree with kK > 0 dims, rows [row0, row0 + n_rows)
// (lane = row0 + lane), x the lane's row in registers, o0 = l*n + row0.
// kStaged (kK % 4 == 0): the rows' coordinates are in shared memory too,
// at xs (row 0's first) with a pitch of xp (a multiple of 4), and
// coordinates and codes go out from there and through the warp's staging
// buffer `buf` ((32, buf_pitch) elements) as 512-byte stores.  Otherwise a
// lane stores its own row.
template <int kK, bool kSmem, bool kStaged>
__device__ __forceinline__ void encode_rows(const float (&x)[kK],
                                            const float* xs, int xp,
                                            float* buf, int n_rows,
                                            int64_t o0, const float* tables,
                                            const Call& call) {
  const int lane = threadIdx.x & 31;
  const bool ok = lane < n_rows;
  int code[kK];
  if constexpr (kStaged) {
    static_assert(kK % 4 == 0, "16-byte rows");
    constexpr int P = buf_pitch<kK>();
    store_rows<kK>(xs, xp, call.proj_t + o0 * kK, n_rows);
    search_and_pack<kK, kSmem>(x, tables, o0 + lane, ok, call, code);
    __syncwarp();                        // buf's coordinates are stored
    int* cb = reinterpret_cast<int*>(buf);
#pragma unroll
    for (int j = 0; j < kK; j += 4)
      *reinterpret_cast<int4*>(cb + lane * P + j) =
          make_int4(code[j], code[j + 1], code[j + 2], code[j + 3]);
    __syncwarp();
    store_rows<kK>(cb, P, call.codes_t + o0 * kK, n_rows);
    __syncwarp();                        // buf is free for the next task
  } else {
    search_and_pack<kK, kSmem>(x, tables, o0 + lane, ok, call, code);
    if (ok) {
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        store(call.proj_t + (o0 + lane) * kK + j, x[j]);
        store(call.codes_t + (o0 + lane) * kK + j, code[j]);
      }
    }
  }
}

// The same for any K (the generic instance): x_at(j) gives the row's
// coordinate j; codes are placed in the key words as they come.
template <bool kSmem, class XAt>
__device__ __forceinline__ void encode_row_any(XAt x_at, const float* tables,
                                               int64_t o, bool ok,
                                               const Call& call) {
  const int K = call.K;
  uint32_t hi = 0, lo = 0;
  float* pr = call.proj_t + o * K;
  int32_t* cr = call.codes_t + o * K;
  for (int j = 0; j < K; ++j) {
    const float* t[1] = {tables + (static_cast<int64_t>(j) << call.logP)};
    const float xs[1] = {x_at(j)};
    int c[1];
    search<kSmem, 1>(t, xs, call.logP, call.Nr, c);
    for (int b = 0; b < call.hi_bits + call.lo_bits; ++b) {
      const bool in_hi = b < call.hi_bits;
      const int nb = in_hi ? call.hi_bits : call.lo_bits;
      const int level = in_hi ? b : b - call.hi_bits;
      const int pos = nb * K - 1 - (level * K + j);
      if (pos >= 32) continue;                    // overflows: dropped
      const uint32_t bit = (static_cast<uint32_t>(c[0]) >> (7 - b)) & 1u;
      if (in_hi) hi |= bit << pos;
      else lo |= bit << pos;
    }
    if (ok) {
      store(pr + j, xs[0]);
      store(cr + j, c[0]);
    }
  }
  if (ok) {
    store(call.key_hi + o, static_cast<int64_t>(hi));
    store(call.key_lo + o, static_cast<int64_t>(lo));
  }
}

}  // namespace encode_pack_tile
