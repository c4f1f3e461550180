// project_encode_pack: the streaming seal's one pass, p-stable projection
// fused with the iSAX encode and the interleaved sort-key pack.
//
// Replaces the TPU kernel
// src/repro/kernels/build_fused.py:project_encode_pack (body
// _kernel_from_data), which runs the (bn, d) @ (d, L*K) product on the MXU
// and hands the tile to the shared _encode_pack_tile.
//
// What it computes, for x (n, d) f32, a (d, L*K) f32 and breakpoints
// (L*K, Nr+1) f32: proj = x @ a, each sum one correctly rounded fused
// multiply-add a feature in index order (__fmaf_rn), as lsh_project.cu
// sums, then encode_pack's outputs from proj: proj_t/codes_t (L, n, K),
// key_hi/key_lo (L, n) int64 holding uint32.  The fixed order makes proj,
// and so every code and key, bit-identical to the plain version
// (kernels/ref.py project_encode_pack = encode_pack(lsh_project(x, a))):
// one ulp of a projection flips a code at an edge and moves a point to
// another leaf.
//
// What bounds it on an H100: memory, by a little.  At n = 1M, d = 128,
// L*K = 64 a row reads 512 bytes of x and writes 256 + 256 bytes of
// proj_t/codes_t plus 64 bytes of keys: 0.325 ms at 3.35 TB/s; its
// 8.4 G FMAs take 0.25 ms at the CUDA cores' 67 TFLOP/s.  Tensor cores are
// out (TF32 would flip codes).
//
// Design: a block owns 128 rows (64 where 128-row blocks would not give
// every SM four, as at the seal's 16,384 rows) and a group of trees of at
// most 64 projected dims (grid.y over groups).  The projection is
// lsh_project's SIMT tile (project_tile.cuh): 4 x 8 sums a thread (2 x 8
// in 64-row blocks), x's rows and a's rows staged 32 features at a time
// through a 2-stage cp.async ring.  Its sums land in a (128, Dg)
// coordinate tile in shared memory, which lies over the ring (the ring is
// done by then), and encode_pack_tile.cuh's warp tasks (tree, 32 rows)
// encode and pack them as encode_pack does, reading the Eytzinger edge
// tables that a first small launch builds in device memory through L1.
// 54 KB of shared memory and at most 80 registers a thread, so three
// blocks share an SM and one's projection overlaps another's encode.  (At
// n = 1M on an H100, 256-row blocks of 8 x 8 sums, two an SM, took
// 0.98 ms, the same projection without the encode 0.44 ms; 128-row blocks
// took 0.77 ms.)  Past K = 64 a group is one tree of K > 64 dims: blocks
// of 32 rows (1 x 8 sums a thread) project it 64 columns at a time into a
// tile beside the ring.

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_pack_tile.cuh"
#include "project_tile.cuh"

namespace {

using encode_pack_tile::Call;
using encode_pack_tile::kWarps;
using project_tile::kCols;
using project_tile::kRowStep;
using project_tile::kTC;
using project_tile::kThreads;
using project_tile::Ring;

static_assert(encode_pack_tile::kThreads == kThreads, "one block shape");
static_assert(kRowStep == encode_pack_tile::kRows, "32-row sub-tiles");
constexpr size_t kMaxSmem = 232448;              // 227 KB a block on an H100

// kTR = 4: 128-row blocks (4 x 8 sums a thread); 2: 64-row blocks (2 x 8)
// where 128-row ones would not give every SM four; 1: 32-row blocks for
// one tree of more than 64 dims, projected 64 columns a pass.
// kK: 4, 8 or 16 (the K the repo's configurations use), or 0 for any K.
template <int kK, int kTR>
__global__ void __launch_bounds__(kThreads, kTR >= 2 ? 3 : 4)
project_encode_pack_kernel(const float* __restrict__ x,
                           const float* __restrict__ a, int d, int lda,
                           int L, int vec, int tile_off, Call call) {
  constexpr int kTileRows = Ring<float, kTR>::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* x_s = reinterpret_cast<float*>(smem + tile_off);
  const int K = kK > 0 ? kK : call.K;
  const int Lg0 = encode_pack_tile::trees_per_group(K, L);
  const int l0 = blockIdx.y * Lg0;
  const int Lg = min(Lg0, L - l0);
  const int Dg = Lg * K;
  const int DP = encode_pack_tile::x_pitch(Dg, kK > 0);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kTileRows),
                                        call.n - row0));
  const int tr = threadIdx.x / kTC;
  const int tc = threadIdx.x % kTC;
  const project_tile::Operands<float> op{x, a, call.n, d, lda, (l0 + Lg) * K};

  for (int cp0 = 0; cp0 < Dg; cp0 += kCols) {
    float acc[kTR][kTC];
    project_tile::project<float, kTR>(ring, op, row0, l0 * K + cp0,
                                      vec != 0, acc);
    __syncthreads();                     // the ring is read: x_s may overlay
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      float* xr = x_s + (tr + kRowStep * i) * DP + cp0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {      // columns 4 tc.. and 32 + 4 tc..
        const int c = 32 * h + 4 * tc;
        const float* v = acc[i] + 4 * h;
        if (DP % 4 == 0) {               // Dg % 4 == 0: whole float4s
          if (cp0 + c < Dg)
            *reinterpret_cast<float4*>(xr + c) =
                make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (cp0 + c + u < Dg) xr[c + u] = v[u];
        }
      }
    }
  }
  __syncthreads();

  // Encode and pack: warp tasks of (tree, 32 rows), a lane a row.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int task = warp; task < Lg * kTR; task += kWarps) {
    const int l = task / kTR;
    const int r0 = (task - l * kTR) * kRowStep;
    const int n_rows = min(kRowStep, rows - r0);
    if (n_rows <= 0) continue;
    const float* xr = x_s + (r0 + lane) * DP + l * K;
    const int64_t o0 = (l0 + l) * call.n + row0 + r0;
    const float* tables =
        call.eyt + (static_cast<int64_t>((l0 + l) * K) << call.logP);
    if constexpr (kK > 0) {              // rows 16-byte aligned (x_pitch)
      float x[kK];
#pragma unroll
      for (int j = 0; j < kK; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(xr + j);
        x[j] = v.x;
        x[j + 1] = v.y;
        x[j + 2] = v.z;
        x[j + 3] = v.w;
      }
      float* buf = x_s + kTileRows * DP +
                   warp * kRowStep * encode_pack_tile::buf_pitch<kK>();
      encode_pack_tile::encode_rows<kK, false, true>(
          x, x_s + r0 * DP + l * K, DP, buf, n_rows, o0, tables, call);
    } else {
      encode_pack_tile::encode_row_any<false>(
          [&](int j) { return xr[j]; }, tables, o0 + lane, lane < n_rows,
          call);
    }
  }
}

template <int kK, int kTR>
cudaError_t launch(const float* x, const float* a, int d, int lda, int L,
                   int vec, const Call& call, cudaStream_t stream) {
  using R = Ring<float, kTR>;
  const int Lg = encode_pack_tile::trees_per_group(call.K, L);
  // The coordinate tile, then a staging buffer a warp where K % 4 == 0.
  size_t tile = sizeof(float) * R::kRows *
                encode_pack_tile::x_pitch(Lg * call.K,
                                          kK > 0);
  if constexpr (kK > 0)
    tile += sizeof(float) * kWarps * kRowStep *
            encode_pack_tile::buf_pitch<kK>();
  // One column pass: the tile lies over the ring; several: beside it.
  const bool beside = Lg * call.K > kCols;
  const size_t smem = beside ? R::kBytes + tile
                             : (tile > R::kBytes ? tile : R::kBytes);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // Raised once per device and size, not every call (it costs host time).
  static size_t allowed[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && (dev >= 64 || smem > allowed[dev])) {
    const cudaError_t err = cudaFuncSetAttribute(
        project_encode_pack_kernel<kK, kTR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed[dev] = smem;
  }
  const int64_t row_tiles = (call.n + R::kRows - 1) / R::kRows;
  const int groups = (L + Lg - 1) / Lg;
  if (row_tiles > 0x7fffffff || groups > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>(groups));
  project_encode_pack_kernel<kK, kTR><<<grid, kThreads, smem, stream>>>(
      x, a, d, lda, L, vec, beside ? static_cast<int>(R::kBytes) : 0, call);
  return cudaGetLastError();
}

// 128-row blocks where they give every SM four, else 64-row ones (the
// seal's 16,384 rows: 32-row ones took a third longer on an H100); one
// tree of more than 64 dims (any-K instance only) in 32-row blocks.
template <int kK>
cudaError_t launch_rows(const float* x, const float* a, int d, int lda,
                        int L, int vec, const Call& call,
                        cudaStream_t stream) {
  if constexpr (kK == 0) {
    if (call.K > kCols)
      return launch<0, 1>(x, a, d, lda, L, vec, call, stream);
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int Lg = encode_pack_tile::trees_per_group(call.K, L);
  const int64_t blocks = (call.n + Ring<float, 4>::kRows - 1) /
                         Ring<float, 4>::kRows * ((L + Lg - 1) / Lg);
  return blocks >= 4 * static_cast<int64_t>(sms)
             ? launch<kK, 4>(x, a, d, lda, L, vec, call, stream)
             : launch<kK, 2>(x, a, d, lda, L, vec, call, stream);
}

}  // namespace

// x (n, d), a (d, *) read through its row stride lda (its first L*K
// columns), bp (L*K, Nr+1); eyt is scratch of L*K * P floats (P the power
// of two >= Nr); outputs in the per-tree layouts of L trees.
extern "C" int project_encode_pack_launch(
    const float* x, const float* a, const float* bp, float* eyt,
    float* proj_t, int32_t* codes_t, int64_t* key_hi, int64_t* key_lo,
    int64_t n, int d, int lda, int K, int L, int Nr, int hi_bits,
    int lo_bits, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = encode_pack_tile::build_eytzinger(bp, eyt, L * K, Nr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Call call{eyt, proj_t, codes_t, key_hi, key_lo, n, K, Nr,
                  encode_pack_tile::log2_width(Nr), hi_bits, lo_bits};
  // 16-byte copies: rows of x and a, and every group's columns, whole
  // vectors (K % 4 == 0 keeps each group's first and last column so).
  const int vec = d % 4 == 0 && lda % 4 == 0 && K % 4 == 0 &&
                  project_tile::aligned16(x) && project_tile::aligned16(a);
  switch (K) {
    case 4: err = launch_rows<4>(x, a, d, lda, L, vec, call, s); break;
    case 8: err = launch_rows<8>(x, a, d, lda, L, vec, call, s); break;
    case 16: err = launch_rows<16>(x, a, d, lda, L, vec, call, s); break;
    default: err = launch_rows<0>(x, a, d, lda, L, vec, call, s); break;
  }
  return static_cast<int>(err);
}

extern "C" const char* project_encode_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
