// lsh_project: the p-stable LSH projection X (n, d) @ A (d, m) -> (n, m) f32.
//
// Replaces the TPU kernel src/repro/kernels/lsh_project.py:lsh_project
// (body _kernel), which loads a (block_n, d) tile of X and the whole (d, m)
// panel of A into VMEM and issues one MXU matmul a grid step.
//
// What it computes: out[i, c] = fma(x[i, d-1], a[d-1, c], ... fma(x[i, 1],
// a[1, c], fma(x[i, 0], a[0, c], 0))): one correctly rounded fused
// multiply-add a feature (__fmaf_rn), in feature order.  The order is fixed
// for each output element, so the bits depend neither on the tiling nor on
// the chunk sizes, and equal the plain version's (kernels/ref.py
// lsh_project, which emulates the f32 FMA exactly): one ulp of a projection
// can flip a code at an edge.  x and a are f32, or bf16 (their 16-bit
// patterns) widened to f32 exactly.  The product of two widened bf16 values
// is exact in f32, so for bf16 inputs the FMA gives the bits of a rounded
// product and a rounded sum, the form this kernel had before.  TF32 and the
// tensor cores are not used: they would round the inputs.
//
// What bounds it on an H100: at n = 1M, d = 128, m = 64 the function reads
// 512 MB of x and writes 256 MB, 0.229 ms at 3.35 TB/s; its 8.4 G FMAs
// (16.8 GFLOP) take 0.250 ms at the CUDA cores' 67 TFLOP/s, so operations
// bound it, by a little.  The CUDA cores reach that rate only with one FMA
// an instruction and few other instructions beside it, and each FMA needs
// two operands: a thread's register tile of R rows x C columns loads R + C
// values from shared memory a feature for R C FMAs, and an SM's shared
// memory delivers a quarter of a value for each FMA its cores can issue,
// so an 8 x 8 tile (1/4) leaves no slack and 16 x 8 (3/16) some.
//
// Design: a SIMT SGEMM tile.  A block computes kRows = 512 rows x kCols =
// 64 output columns (grid.y over column tiles, so any m); each of its 256
// threads holds a 16 x 8 register tile: rows tr + 32 i (i = 0..15, tr =
// thread / 8) and columns 4 tc..4 tc+3 and 32 + 4 tc..32 + 4 tc+3 (tc =
// thread % 8), 128 accumulators, so one block an SM.  Where the grid would
// hold fewer than 8 such blocks an SM (GIST's 100,000 rows: 196 blocks on
// 132 SMs, a second wave half empty), an instance of 128-row blocks with
// 4 x 8 tiles runs instead, three blocks an SM.  x's rows and A's
// rows arrive kKC = 32 features at a time through a kStages = 2 ring of
// cp.async copies (16 bytes each; one chunk in compute while the next is
// in flight), so A is read from shared memory once a block, never from
// global memory at every step.  A step of 4 features costs a thread 16 x
// 16-byte loads of x (one a row) and 8 of A for 512 FMAs.  x's staged
// rows are padded by 16 bytes, so the 4 rows a warp reads at once fall in
// distinct banks; A's rows are read whole by each warp (8 distinct
// 16-byte words) and need no padding.  Stores are 16 bytes a thread,
// neighbouring threads on neighbouring columns.  Ragged n, m and d are
// masked in the kernel: rows and columns past the edge are zero-filled
// and never stored, and the sum stops at feature d - 1.  Where d or m is
// not a multiple of a 16-byte vector (or a pointer is not 16-byte
// aligned) the ring is filled by plain loads instead.

#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

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

// Stage features [k0, k0 + kKC) of the block's x rows and A's rows into
// one ring slot; every thread calls it.  Entries past n, d or m are zeros.
template <typename T, int kTR>
__device__ __forceinline__ void stage(T* slot, const T* __restrict__ x,
                                      const T* __restrict__ a, int64_t n,
                                      int d, int m, int64_t row0, int c0,
                                      int k0, bool vec) {
  using R = Ring<T, kTR>;
  constexpr int kRows = R::kRows;
  T* xs = slot;
  T* as = slot + R::kXElems;
  const int t = threadIdx.x;
  if (vec) {
    constexpr int xv = kKC / R::kVec;                  // copies a row
    for (int e = t; e < kRows * xv; e += kThreads) {
      const int r = e / xv;
      const int k = k0 + (e - r * xv) * R::kVec;
      const bool ok = row0 + r < n && k < d;
      cp_async::copy16(xs + r * R::kXPitch + k - k0,
                       ok ? x + (row0 + r) * d + k : x, ok);
    }
    constexpr int av = kCols / R::kVec;
    for (int e = t; e < kKC * av; e += kThreads) {
      const int j = e / av;
      const int c = (e - j * av) * R::kVec;
      const bool ok = k0 + j < d && c0 + c < m;
      cp_async::copy16(as + j * kCols + c,
                       ok ? a + static_cast<int64_t>(k0 + j) * m + c0 + c
                          : a, ok);
    }
  } else {
    for (int e = t; e < kRows * kKC; e += kThreads) {
      const int r = e / kKC;
      const int k = k0 + e - r * kKC;
      xs[r * R::kXPitch + k - k0] =
          row0 + r < n && k < d ? x[(row0 + r) * d + k] : T(0);
    }
    for (int e = t; e < kKC * kCols; e += kThreads) {
      const int j = e / kCols;
      const int c = e - j * kCols;
      as[e] = k0 + j < d && c0 + c < m
                  ? a[static_cast<int64_t>(k0 + j) * m + c0 + c] : T(0);
    }
  }
}

// acc[i][u] = fma(x[tr + 32 i, k], a[k, col(u)], acc[i][u]) for the
// chunk's features k = 0 .. w-1, in order.
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

// kTR rows a thread: 16 (128 accumulators, one block an SM) for large n,
// 4 (three blocks an SM) where 512-row blocks would leave the last wave
// of the grid mostly empty.
template <typename T, int kTR>
__global__ void __launch_bounds__(kThreads, kTR >= 16 ? 1 : 3)
lsh_project_kernel(const T* __restrict__ x, const T* __restrict__ a,
                   float* __restrict__ out, int64_t n, int d, int m,
                   int vec) {
  using R = Ring<T, kTR>;
  constexpr int kRows = R::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int c0 = blockIdx.y * kCols;
  const int tr = threadIdx.x / kTC;
  const int tc = threadIdx.x % kTC;
  float acc[kTR][kTC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int u = 0; u < kTC; ++u) acc[i][u] = 0.f;

  const int nchunks = (d + kKC - 1) / kKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks)
      stage<T, kTR>(ring + s * R::kStageElems, x, a, n, d, m, row0, c0,
                    s * kKC, vec != 0);
    cp_async::commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async::wait<kStages - 2>();       // this thread's copies of chunk c
    __syncthreads();                     // everyone's; chunk c-1 is done
    const int next = c + kStages - 1;
    if (next < nchunks)
      stage<T, kTR>(ring + (next % kStages) * R::kStageElems, x, a, n, d, m,
                    row0, c0, next * kKC, vec != 0);
    cp_async::commit();
    const T* xs = ring + (c % kStages) * R::kStageElems;
    const T* as = xs + R::kXElems;
    const int w = min(kKC, d - c * kKC);
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

  const bool vec_out = m % 4 == 0;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int64_t r = row0 + tr + kRowStep * i;
    if (r >= n) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + 32 * half + 4 * tc;
      if (c >= m) continue;
      float* o = out + r * m + c;
      const float* v = acc[i] + 4 * half;
      if (vec_out) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < m) o[u] = v[u];
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int kTR>
int launch_rows(const T* x, const T* a, float* out, int64_t n, int d, int m,
                cudaStream_t stream) {
  using R = Ring<T, kTR>;
  const int vec = d % R::kVec == 0 && m % R::kVec == 0 && aligned16(x) &&
                  aligned16(a);
  const int64_t row_tiles = (n + R::kRows - 1) / R::kRows;
  if (row_tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (R::kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsh_project_kernel<T, kTR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(R::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>((m + kCols - 1) / kCols));
  lsh_project_kernel<T, kTR><<<grid, kThreads, R::kBytes, stream>>>(
      x, a, out, n, d, m, vec);
  return static_cast<int>(cudaGetLastError());
}

// 512-row blocks when the grid holds at least 8 of them an SM, else
// 128-row blocks.
template <typename T>
int launch(const T* x, const T* a, float* out, int64_t n, int d, int m,
           cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t big_tiles = (n + Ring<T, 16>::kRows - 1) / Ring<T, 16>::kRows;
  return big_tiles >= 8 * static_cast<int64_t>(sms)
             ? launch_rows<T, 16>(x, a, out, n, d, m, stream)
             : launch_rows<T, 4>(x, a, out, n, d, m, stream);
}

}  // namespace

// x (n, d) and a (d, m), both f32 (bf16 == 0) or both bf16 bit patterns
// (bf16 == 1), contiguous; out (n, m) f32.
extern "C" int lsh_project_launch(const void* x, const void* a, float* out,
                                  int64_t n, int d, int m, int bf16,
                                  void* stream) {
  if (n == 0 || m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch(static_cast<const uint16_t*>(x),
                  static_cast<const uint16_t*>(a), out, n, d, m, s);
  return launch(static_cast<const float*>(x), static_cast<const float*>(a),
                out, n, d, m, s);
}

extern "C" const char* lsh_project_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
