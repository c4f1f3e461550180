// The projection tile shared by lsh_project.cu and project_encode_pack.cu
// (the TPU kernels' x @ A on the MXU, src/repro/kernels/lsh_project.py
// _kernel and src/repro/kernels/build_fused.py _kernel_from_data).
//
// out[i, c] = fma(x[i, d-1], a[d-1, c], ... fma(x[i, 0], a[0, c], 0)): one
// correctly rounded fused multiply-add a feature (__fmaf_rn), in feature
// order, so the bits depend neither on the tiling nor on the chunk sizes
// and equal the plain version's (kernels/ref.py lsh_project, which emulates
// the f32 FMA exactly).  x and a are f32, or bf16 (their 16-bit patterns)
// widened to f32 exactly.
//
// A SIMT SGEMM tile: a block of kThreads = 256 threads computes 32 kTR rows
// x kCols = 64 output columns; each thread holds a kTR x 8 register tile,
// rows tr + 32 i (i < kTR, tr = thread / 8) and columns 4 tc..4 tc+3 and
// 32 + 4 tc..32 + 4 tc+3 (tc = thread % 8).  x's rows and a's rows arrive
// kKC = 32 features at a time through a kStages = 2 ring of cp.async
// copies (16 bytes each; one chunk in compute while the next is in
// flight).  A step of 4 features costs a thread kTR 16-byte loads of x
// (one a row) and 8 of a for 32 kTR FMAs.  x's staged rows are padded by
// 16 bytes, so the 4 rows a warp reads at once fall in distinct banks;
// a's rows are read whole by each warp (8 distinct 16-byte words).  Rows
// past n, columns past the end and features past d are zero-filled; where
// d, the columns or a's row stride are not a multiple of a 16-byte vector
// (or a pointer is not 16-byte aligned) the ring is filled by plain loads.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace project_tile {

constexpr int kThreads = 256;
constexpr int kTC = 8;            // columns a thread: 4 tc + u, 32 + 4 tc + u
constexpr int kRowStep = kThreads / kTC;   // 32: rows tr + 32 i a thread
constexpr int kCols = 64;         // output columns a block
constexpr int kKC = 32;           // features a ring stage
constexpr int kStages = 2;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t bf16_bits) {
  return __uint_as_float(static_cast<uint32_t>(bf16_bits) << 16);
}

// Four consecutive elements from shared memory as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const uint16_t* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

template <typename T, int kTR>
struct Ring {
  static constexpr int kRows = kRowStep * kTR;         // rows a block
  static constexpr int kVec = 16 / sizeof(T);          // elements a copy
  static constexpr int kXPitch = kKC + kVec;           // row + 16 bytes
  static constexpr int kXElems = kRows * kXPitch;
  static constexpr int kAElems = kKC * kCols;
  static constexpr int kStageElems = kXElems + kAElems;
  static constexpr size_t kBytes = sizeof(T) * kStages * kStageElems;
};

// What a block projects: x (n, d), a's columns [c0, c0 + kCols) of those
// before m_end (a's rows lda elements apart), rows from row0.
template <typename T>
struct Operands {
  const T* x;
  const T* a;
  int64_t n;
  int d, lda, m_end;
};

// Stage features [k0, k0 + kKC) of the block's x rows and a's rows into
// one ring slot; every thread calls it.  Entries past n, d or m_end are
// zeros.
template <typename T, int kTR>
__device__ __forceinline__ void stage(T* slot, const Operands<T>& op,
                                      int64_t row0, int c0, int k0,
                                      bool vec) {
  using R = Ring<T, kTR>;
  constexpr int kRows = R::kRows;
  T* xs = slot;
  T* as = slot + R::kXElems;
  const int t = threadIdx.x;
  const int d = op.d;
  if (vec) {
    constexpr int xv = kKC / R::kVec;                  // copies a row
    for (int e = t; e < kRows * xv; e += kThreads) {
      const int r = e / xv;
      const int k = k0 + (e - r * xv) * R::kVec;
      const bool ok = row0 + r < op.n && k < d;
      cp_async::copy16(xs + r * R::kXPitch + k - k0,
                       ok ? op.x + (row0 + r) * d + k : op.x, ok);
    }
    constexpr int av = kCols / R::kVec;
    for (int e = t; e < kKC * av; e += kThreads) {
      const int j = e / av;
      const int c = (e - j * av) * R::kVec;
      const bool ok = k0 + j < d && c0 + c < op.m_end;
      cp_async::copy16(as + j * kCols + c,
                       ok ? op.a + static_cast<int64_t>(k0 + j) * op.lda +
                                c0 + c
                          : op.a, ok);
    }
  } else {
    for (int e = t; e < kRows * kKC; e += kThreads) {
      const int r = e / kKC;
      const int k = k0 + e - r * kKC;
      xs[r * R::kXPitch + k - k0] =
          row0 + r < op.n && k < d ? op.x[(row0 + r) * d + k] : T(0);
    }
    for (int e = t; e < kKC * kCols; e += kThreads) {
      const int j = e / kCols;
      const int c = e - j * kCols;
      as[e] = k0 + j < d && c0 + c < op.m_end
                  ? op.a[static_cast<int64_t>(k0 + j) * op.lda + c0 + c]
                  : T(0);
    }
  }
}

// acc[i][u] = fma(x[tr + 32 i, k], a[k, col(u)], acc[i][u]) for the
// chunk's features k .. k+3, in order.
template <typename T, int kTR>
__device__ __forceinline__ void step4(const T* xs, const T* as, int k,
                                      int tr, int tc,
                                      float (&acc)[kTR][kTC]) {
  constexpr int P = Ring<T, kTR>::kXPitch;
  float av[4][kTC];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float4 lo = load4(as + (k + kk) * kCols + 4 * tc);
    const float4 hi = load4(as + (k + kk) * kCols + 32 + 4 * tc);
    av[kk][0] = lo.x; av[kk][1] = lo.y; av[kk][2] = lo.z; av[kk][3] = lo.w;
    av[kk][4] = hi.x; av[kk][5] = hi.y; av[kk][6] = hi.z; av[kk][7] = hi.w;
  }
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const float4 xv = load4(xs + (tr + kRowStep * i) * P + k);
    const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int u = 0; u < kTC; ++u)
        acc[i][u] = __fmaf_rn(xr[kk], av[kk][u], acc[i][u]);
    }
  }
}

template <typename T, int kTR>
__device__ __forceinline__ void step1(const T* xs, const T* as, int k,
                                      int tr, int tc,
                                      float (&acc)[kTR][kTC]) {
  constexpr int P = Ring<T, kTR>::kXPitch;
  float av[kTC];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    av[u] = widen(as[k * kCols + 4 * tc + u]);
    av[4 + u] = widen(as[k * kCols + 32 + 4 * tc + u]);
  }
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const float xr = widen(xs[(tr + kRowStep * i) * P + k]);
#pragma unroll
    for (int u = 0; u < kTC; ++u) acc[i][u] = __fmaf_rn(xr, av[u], acc[i][u]);
  }
}

// The block's kTR x 8 tile of sums for rows row0 + tr + 32 i and columns
// c0 + 4 tc + u, c0 + 32 + 4 tc + u: the ring's prologue, then one chunk of
// kKC features after another.  ring holds Ring<T, kTR>::kBytes; every
// thread calls it.  Before the ring is reused, the caller synchronises:
// other threads may still be reading the last chunk.
template <typename T, int kTR>
__device__ __forceinline__ void project(T* ring, const Operands<T>& op,
                                        int64_t row0, int c0, bool vec,
                                        float (&acc)[kTR][kTC]) {
  using R = Ring<T, kTR>;
  const int tr = threadIdx.x / kTC;
  const int tc = threadIdx.x % kTC;
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int u = 0; u < kTC; ++u) acc[i][u] = 0.f;

  const int nchunks = (op.d + kKC - 1) / kKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks)
      stage<T, kTR>(ring + s * R::kStageElems, op, row0, c0, s * kKC, vec);
    cp_async::commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async::wait<kStages - 2>();       // this thread's copies of chunk c
    __syncthreads();                     // everyone's; chunk c-1 is done
    const int next = c + kStages - 1;
    if (next < nchunks)
      stage<T, kTR>(ring + (next % kStages) * R::kStageElems, op, row0, c0,
                    next * kKC, vec);
    cp_async::commit();
    const T* xs = ring + (c % kStages) * R::kStageElems;
    const T* as = xs + R::kXElems;
    const int w = min(kKC, op.d - c * kKC);
    if (w == kKC) {
#pragma unroll
      for (int k = 0; k < kKC; k += 4) step4<T, kTR>(xs, as, k, tr, tc, acc);
    } else {
      int k = 0;
      for (; k + 4 <= w; k += 4) step4<T, kTR>(xs, as, k, tr, tc, acc);
      for (; k < w; ++k) step1<T, kTR>(xs, as, k, tr, tc, acc);
    }
  }
  cp_async::wait<0>();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace project_tile
