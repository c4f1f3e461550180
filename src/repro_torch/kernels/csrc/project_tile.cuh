// The projection stage shared by project_encode_pack.cu and lsh_project.cu
// (the TPU kernels' x @ A on the MXU, src/repro/kernels/build_fused.py
// _kernel_from_data and src/repro/kernels/lsh_project.py _kernel).
//
// A block projects a tile of kRows = 32 rows of x.  The rows, or a chunk of
// their columns, are staged in shared memory as (kRows, padded(w)) floats
// with coalesced loads; a work item (row group rq, output column c) then
// sums the products of 8 rows (rq, rq + 4, ..., rq + 28) with column c of
// a, in j order, one rounded product and one rounded sum a step
// (__fadd_rn(acc, __fmul_rn(x, a)), which nvcc cannot contract into an
// FMA).  Each step reads the column's value once for all 8 rows through
// the read-only path, where a (32 KB at d = 128, L*K = 64) stays cached,
// and the rows' values as float4 broadcasts from shared memory.
//
// A caller that stages the columns in several chunks keeps acc from one
// chunk to the next, so the sum still runs in j order: the bits are those
// of one pass, and those of the plain version (kernels/ref.py project).
// bf16 inputs arrive as their 16-bit patterns and widen to f32 exactly;
// the product of two widened bf16 values is exact in f32.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace project_tile {

constexpr int kRows = 32;                        // rows a block projects
constexpr int kRowGroups = 4;                    // an item's rows: rq + 4*i
constexpr int kRowsPerItem = kRows / kRowGroups;  // 8 accumulators an item

__host__ __device__ inline int padded(int w) {  // float4 rows
  return (w + 3) & ~3;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t bf16_bits) {
  return __uint_as_float(static_cast<uint32_t>(bf16_bits) << 16);
}

template <typename T>
__device__ __forceinline__ float load_ro(const T* p) {
  return widen(__ldg(p));
}

// Stage columns [j0, j0 + w) of rows [row0, row0 + rows) of x (row stride
// ld) as f32 into xs (kRows, padded(w)); rows past `rows` are zeros.  Every
// thread of the block calls it; the caller synchronises after.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x,
                                           int64_t ld, int64_t row0,
                                           int rows, int j0, int w,
                                           float* xs) {
  const int wp = padded(w);
  for (int e = threadIdx.x; e < kRows * w; e += blockDim.x) {
    const int r = e / w;
    const int j = e - r * w;
    xs[r * wp + j] = r < rows ? widen(x[(row0 + r) * ld + j0 + j]) : 0.f;
  }
}

// acc[i] += xs[rq + kRowGroups*i, j] * ac[j * lda] for j = 0 .. w-1, in j
// order.  ac points at the column's first element of this chunk.
template <typename T>
__device__ __forceinline__ void accumulate(const float* xs, int w,
                                           const T* __restrict__ ac,
                                           int64_t lda, int rq,
                                           float (&acc)[kRowsPerItem]) {
  const int wp = padded(w);
  int j = 0;
  for (; j + 4 <= w; j += 4) {
    const float a0 = load_ro(ac + (j + 0) * lda);
    const float a1 = load_ro(ac + (j + 1) * lda);
    const float a2 = load_ro(ac + (j + 2) * lda);
    const float a3 = load_ro(ac + (j + 3) * lda);
#pragma unroll
    for (int i = 0; i < kRowsPerItem; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(
          xs + (rq + kRowGroups * i) * wp + j);
      acc[i] = __fadd_rn(acc[i], __fmul_rn(xv.x, a0));
      acc[i] = __fadd_rn(acc[i], __fmul_rn(xv.y, a1));
      acc[i] = __fadd_rn(acc[i], __fmul_rn(xv.z, a2));
      acc[i] = __fadd_rn(acc[i], __fmul_rn(xv.w, a3));
    }
  }
  for (; j < w; ++j) {
    const float aj = load_ro(ac + j * lda);
#pragma unroll
    for (int i = 0; i < kRowsPerItem; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(
          xs[(rq + kRowGroups * i) * wp + j], aj));
  }
}

}  // namespace project_tile
