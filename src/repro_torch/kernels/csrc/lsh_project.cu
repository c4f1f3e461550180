// lsh_project: the p-stable LSH projection X (n, d) @ A (d, m) -> (n, m) f32.
//
// Replaces the TPU kernel src/repro/kernels/lsh_project.py:lsh_project
// (body _kernel), which loads a (block_n, d) tile of X and the whole (d, m)
// panel of A into VMEM and issues one MXU matmul a grid step.
//
// What it computes: out[i, c] = sum_j x[i, j] * a[j, c], summed over j in
// index order with each product and each sum rounded on its own, so it is
// bit-identical to the plain version (kernels/ref.py lsh_project): one ulp
// of a projection can flip a code at an edge.  x and a are f32, or bf16
// (their 16-bit patterns), widened to f32 exactly; a bf16 product is exact
// in f32.  TF32 and the tensor cores are not used: they would round the
// inputs.
//
// What bounds it on an H100: at n = 1M, d = 128, m = 64 the function reads
// 512 MB of x and writes 256 MB, 0.229 ms at 3.35 TB/s; its 16.8 GFLOP take
// 0.250 ms at the fp32 peak of 67 TFLOP/s, so operations bound it.  Keeping
// mul and add apart (no FMA) halves the rate the CUDA cores give it, so in
// practice about 0.5 ms is the floor of this form.
//
// Design: project_tile.cuh, the projection stage of project_encode_pack.cu.
// A block takes kRows = 32 rows and kCols = 64 output columns (grid.y over
// column tiles, so any m); its 256 threads are the 4 row groups x 64
// columns, one work item each, with 8 accumulators in registers.  Any d:
// x is staged in chunks of at most kChunk = 256 columns (32 KB of shared
// memory), and the accumulators carry from chunk to chunk, so the sum runs
// in j order across chunks.  Each thread writes its column for its 8 rows;
// neighbouring threads write neighbouring columns.

#include <cstdint>
#include <cuda_runtime.h>

#include "project_tile.cuh"

namespace {

using project_tile::kRowGroups;
using project_tile::kRows;
using project_tile::kRowsPerItem;
using project_tile::padded;

constexpr int kCols = 64;                        // output columns a block
constexpr int kThreads = kRowGroups * kCols;     // one item a thread
constexpr int kChunk = 256;                      // x columns staged at once

template <typename T>
__global__ void __launch_bounds__(kThreads) lsh_project_kernel(
    const T* __restrict__ x, const T* __restrict__ a,
    float* __restrict__ out, int64_t n, int d, int m, int chunk) {
  extern __shared__ __align__(16) float xs[];    // (kRows, padded(chunk))
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kRows),
                                        n - row0));
  const int c0 = blockIdx.y * kCols;
  const int c = threadIdx.x % kCols;
  const int rq = threadIdx.x / kCols;
  const bool active = c0 + c < m;
  float acc[kRowsPerItem];
#pragma unroll
  for (int i = 0; i < kRowsPerItem; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < d; j0 += chunk) {
    const int w = min(chunk, d - j0);
    if (j0 > 0) __syncthreads();                 // the last chunk is read
    project_tile::stage_rows(x, d, row0, rows, j0, w, xs);
    __syncthreads();
    if (active)
      project_tile::accumulate(xs, w, a + static_cast<int64_t>(j0) * m + c0
                               + c, m, rq, acc);
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < kRowsPerItem; ++i) {
    const int r = rq + kRowGroups * i;
    if (r < rows) out[(row0 + r) * m + c0 + c] = acc[i];
  }
}

template <typename T>
int launch(const T* x, const T* a, float* out, int64_t n, int d, int m,
           cudaStream_t stream) {
  const int chunk = d < kChunk ? d : kChunk;
  const size_t smem = sizeof(float) * kRows * padded(chunk);
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows),
                  static_cast<unsigned>((m + kCols - 1) / kCols));
  lsh_project_kernel<T><<<grid, kThreads, smem, stream>>>(x, a, out, n, d, m,
                                                          chunk);
  return static_cast<int>(cudaGetLastError());
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
