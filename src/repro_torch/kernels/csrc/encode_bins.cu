// encode_bins: iSAX region ids of projected coordinates (Alg. 1 lines 5-8).
//
// Replaces the TPU kernel src/repro/kernels/encode_bins.py:encode_bins
// (body _kernel), which keeps a (block_n, D) tile of coordinates and the
// (D, Nr+1) breakpoint panel in VMEM and counts, per coordinate, the inner
// edges at or below it with a compare-accumulate over b = 1..Nr-1.
//
// What it computes, for coords (n, D) f32 and breakpoints (D, Nr+1) f32
// with non-decreasing rows: codes (n, D) int32, row-major,
//   code[i, c] = #(inner edges bp[c, 1..Nr-1] <= coords[i, c]),
// which lies in [0, Nr-1]: searchsorted(side='right') on the inner edges,
// clipped, and so the plain version (core/encoding.py encode) bit for bit.
//
// What bounds it on an H100: memory.  At n = 1M, D = 64 it reads 256 MB of
// coordinates and writes 256 MB of codes, 0.153 ms at 3.35 TB/s; the search
// is 8 compares a code at Nr = 256, 0.5 G operations, far below that.
//
// Design: one code per thread, the (D, Nr+1) panel's inner edges in shared
// memory (65 KB at D = 64, Nr = 256), laid out (cols, Nr-1) so that the 32
// threads of a warp, on 32 neighbouring columns of one row, read 32 rows of
// the panel at an odd stride: no bank conflicts.  Where the panel does not
// fit kMaxPanel bytes, grid.y tiles D into equal column ranges.  The grid is
// as many blocks as fit on the card at once (each loads its panel once) and
// they stride over the rows.  The search is count_le of
// encode_pack_tile.cuh, a binary search over the sorted edges: branch-free,
// log2(Nr) steps.

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_pack_tile.cuh"

namespace {

constexpr int kThreads = 512;
constexpr size_t kMaxPanel = 96 * 1024;          // shared bytes of a panel

__global__ void __launch_bounds__(kThreads) encode_bins_kernel(
    const float* __restrict__ coords, const float* __restrict__ bp,
    int32_t* __restrict__ codes, int64_t n, int D, int Nr, int cols) {
  extern __shared__ float panel[];               // (cols, Nr - 1)
  const int ne = Nr - 1;                         // inner edges a column
  const int c0 = blockIdx.y * cols;
  const int tc = min(cols, D - c0);
  for (int e = threadIdx.x; e < tc * ne; e += blockDim.x) {
    const int c = e / ne;
    panel[e] = bp[static_cast<int64_t>(c0 + c) * (Nr + 1) + 1 + (e - c * ne)];
  }
  __syncthreads();
  const int64_t total = n * tc;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x; e < total; e += stride) {
    const int64_t row = e / tc;
    const int c = static_cast<int>(e - row * tc);
    const int64_t o = row * D + c0 + c;
    codes[o] = encode_pack_tile::count_le<false>(panel + c * ne, ne,
                                                 __ldg(coords + o));
  }
}

}  // namespace

// coords (n, D) f32, bp (D, Nr + 1) f32, codes (n, D) int32, contiguous.
extern "C" int encode_bins_launch(const float* coords, const float* bp,
                                  int32_t* codes, int64_t n, int D, int Nr,
                                  void* stream) {
  if (n == 0 || D == 0) return 0;
  const size_t col_bytes = sizeof(float) * static_cast<size_t>(Nr - 1);
  const int fit = static_cast<int>(kMaxPanel / col_bytes);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (D + fit - 1) / fit;
  const int cols = (D + tiles - 1) / tiles;
  const size_t smem = col_bytes * cols;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(encode_bins_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, encode_bins_kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t per_tile = n * cols;
  const int64_t need = (per_tile + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int64_t blocks = need < resident ? need : resident;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  encode_bins_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      coords, bp, codes, n, D, Nr, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* encode_bins_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
