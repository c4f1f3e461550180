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
// which lies in [0, Nr-1]; a NaN coordinate gets 0, since no comparison
// admits it (the TPU kernel's `x >= edge`), and so the plain version
// (kernels/ref.py encode_bins) bit for bit.
//
// What bounds it on an H100: memory.  At n = 1M, D = 64 it reads 256 MB of
// coordinates and writes 256 MB of codes, 0.153 ms at 3.35 TB/s.  The
// search is 8 dependent compares a code at Nr = 256, 0.5 G operations; what
// kept the first version (a thread a code in a grid-stride loop, a 64-bit
// division by the column count and a clamped binary search a code) at 3x
// its bound was the instructions it issued, ~100 a code.
//
// Design (the encode of encode_pack_tile.cuh without the key pack): a block
// owns a group of <= 16 columns (grid.y; a multiple of 4 wide, so that
// 16-byte accesses stay aligned) and builds their breadth-first
// (Eytzinger) edge tables from bp in shared memory (1 KB a column at
// Nr = 256).  Its 32 warps take tasks of (group, 32 rows) one after
// another on a persistent grid.  A task's 32 rows of the group's columns
// come into the lanes' registers (16-byte loads where D % 4 == 0, covering
// whole sectors) while the warp searches the two tasks before it, then go
// into a buffer of the warp; each lane searches its own row, four columns
// at once: every lane reads the same column's table at once, so a search's
// top levels are broadcasts.  The codes overwrite the row's coordinates in
// the buffer and leave it as 16-byte streaming stores, a warp's stores
// covering its rows' whole segments (a lane storing its own row left
// encode_pack's stores 5x slower).  In variant builds on an H100,
// without the prefetch the search and the memory traffic did not overlap;
// groups of 32 or 64 columns, the column loop fully unrolled, and a
// prefetch of two tasks in blocks of 512 threads were slower.  Offsets
// are int64 only at a task's base; no division runs a code.  The search
// is encode_pack_tile's: log2(P) steps of i = 2i + (t[i] <= x), P the
// power of two >= Nr, code = min(i - P, Nr - 1) (+inf does not count the
// table's +inf padding; NaN takes every left branch, 0); equal edges and
// Nr that are not powers of two need nothing more.  Nr > 256 (up to
// 8,192) runs an instance with more levels.

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_pack_tile.cuh"

namespace {

using encode_pack_tile::kRows;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 16;                           // the most columns a group
constexpr int kIlp = 4;                          // searches at once a lane
constexpr size_t kMaxSmem = 232448;              // a block's shared bytes
// The buffer of a warp: (32, pitch) elements, pitch = 4 x odd (16-byte row
// accesses of 8 lanes hit 32 banks).
constexpr int kP = encode_pack_tile::buf_pitch<kG>();
constexpr size_t kBufferBytes = sizeof(float) * kWarps * kRows * kP;

// A warp's 32 rows x gc (<= kG) columns of an (n, D) array move between
// device memory (`src`: row 0, column 0 of the group), the lanes' registers
// and the warp's buffer in kG slots a lane: slot q of a lane is 16-byte
// chunk q / 4 of the warp's (vec: D and gc multiples of 4, the arrays
// 16-byte aligned) or element q, each covering whole sectors of a row.
// Rows past n_rows and columns past gc are not moved.
__device__ __forceinline__ void slot(int q, bool vec, int& r, int& c) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    constexpr int kC = kG / 4;                   // 16-byte chunks a row
    const int e = (q / 4) * 32 + lane;
    r = e / kC;
    c = 4 * (e - r * kC);
  } else {
    const int e = q * 32 + lane;
    r = e / kG;
    c = e - r * kG;
  }
}

__device__ __forceinline__ void fetch_rows(const float* src, int64_t D,
                                           int n_rows, int gc, bool vec,
                                           float (&v)[kG]) {
#pragma unroll
  for (int q = 0; q < kG; ++q) {
    if (vec && q % 4) continue;
    int r, c;
    slot(q, vec, r, c);
    if (r < n_rows && c < gc) {
      if (vec) {
        const float4 x = __ldcs(reinterpret_cast<const float4*>(
            src + r * D + c));
        v[q] = x.x;
        v[q + 1] = x.y;
        v[q + 2] = x.z;
        v[q + 3] = x.w;
      } else {
        v[q] = __ldcs(src + r * D + c);
      }
    }
  }
}

__device__ __forceinline__ void put_rows(const float (&v)[kG], int n_rows,
                                         int gc, bool vec, float* buf) {
#pragma unroll
  for (int q = 0; q < kG; ++q) {
    if (vec && q % 4) continue;
    int r, c;
    slot(q, vec, r, c);
    if (r < n_rows && c < gc) {
      if (vec)
        *reinterpret_cast<float4*>(buf + r * kP + c) =
            make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      else
        buf[r * kP + c] = v[q];
    }
  }
}

__device__ __forceinline__ void store_codes(const float* buf, int32_t* dst,
                                            int64_t D, int n_rows, int gc,
                                            bool vec) {
#pragma unroll
  for (int q = 0; q < kG; ++q) {
    if (vec && q % 4) continue;
    int r, c;
    slot(q, vec, r, c);
    if (r < n_rows && c < gc) {
      if (vec)
        __stcs(reinterpret_cast<int4*>(dst + r * D + c),
               *reinterpret_cast<const int4*>(buf + r * kP + c));
      else
        encode_pack_tile::store(dst + r * D + c,
                                __float_as_int(buf[r * kP + c]));
    }
  }
}

// Codes of columns [j0, j0 + kN) of a lane's row (kN a multiple of 4), in
// place in the buffer: kN independent searches at once.
template <int kLevels, int kN>
__device__ __forceinline__ void search_cols(float* row, const float* tables,
                                            int j0, int logP, int Nr) {
  float x[kN];
  const float* t[kN];
#pragma unroll
  for (int u = 0; u < kN; u += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + j0 + u);
    x[u] = v.x;
    x[u + 1] = v.y;
    x[u + 2] = v.z;
    x[u + 3] = v.w;
  }
#pragma unroll
  for (int u = 0; u < kN; ++u) t[u] = tables + ((j0 + u) << logP);
  int code[kN];
  encode_pack_tile::search<true, kN, kLevels>(t, x, logP, Nr, code);
#pragma unroll
  for (int u = 0; u < kN; u += 4)
    *reinterpret_cast<int4*>(row + j0 + u) =
        make_int4(code[u], code[u + 1], code[u + 2], code[u + 3]);
}

// kLevels: the most search levels (8: Nr <= 256; 13: Nr <= 8,192).
template <int kLevels>
__global__ void __launch_bounds__(kThreads) encode_bins_kernel(
    const float* __restrict__ coords, const float* __restrict__ bp,
    int32_t* __restrict__ codes, int64_t n, int D, int Nr, int logP, int gw,
    int vec, int64_t row_tiles) {
  extern __shared__ __align__(16) float smem[];  // tables (gw, P), buffers
  const int c0 = blockIdx.y * gw;
  const int gc = min(gw, D - c0);                // this group's columns
  for (int e = threadIdx.x; e < (gc << logP); e += kThreads)
    smem[e] = encode_pack_tile::eytzinger_value(
        bp + static_cast<int64_t>(c0 + (e >> logP)) * (Nr + 1),
        e & ((1 << logP) - 1), Nr, logP);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* buf = smem + (gw << logP) + warp * kRows * kP;
  float* row = buf + lane * kP;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  auto rows_of = [&](int64_t t) {
    return static_cast<int>(min(static_cast<int64_t>(kRows), n - t * kRows));
  };
  // A warp holds the rows of its next two tasks in registers (va and vb in
  // turns): a task's loads are issued two searches before its rows are put
  // into the buffer, so that they overlap the searches.
  float va[kG], vb[kG];
  auto fetch = [&](int64_t t, float (&v)[kG]) {
    if (t < row_tiles)
      fetch_rows(coords + t * kRows * D + c0, D, rows_of(t), gc, vec, v);
  };
  auto task = [&](int64_t t, float (&v)[kG]) {
    const int n_rows = rows_of(t);
    put_rows(v, n_rows, gc, vec, buf);
    __syncwarp();
    fetch(t + 2 * step, v);
    if (gc == kG) {                      // a whole group
#pragma unroll 2
      for (int j0 = 0; j0 < kG; j0 += kIlp)
        search_cols<kLevels, kIlp>(row, smem, j0, logP, Nr);
    } else {                             // past gc: never stored
      for (int j0 = 0; j0 < gc; j0 += 4)
        search_cols<kLevels, 4>(row, smem, j0, logP, Nr);
    }
    __syncwarp();
    store_codes(buf, codes + t * kRows * D + c0, D, n_rows, gc, vec);
    __syncwarp();                        // the buffer is free again
  };
  int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  fetch(tile, va);
  fetch(tile + step, vb);
  for (; tile < row_tiles; tile += 2 * step) {
    task(tile, va);
    if (tile + step >= row_tiles) break;
    task(tile + step, vb);
  }
}

template <int kLevels>
cudaError_t launch(const float* coords, const float* bp, int32_t* codes,
                   int64_t n, int D, int Nr, int logP, int vec,
                   cudaStream_t stream) {
  // Groups of at most kG columns, as many as fit beside the buffers, a
  // multiple of 4 wide and as even as that allows.
  const size_t table = sizeof(float) << logP;
  const int fit = static_cast<int>((kMaxSmem - kBufferBytes) / table);
  const int most = (fit < kG ? fit : kG) & ~3;
  if (most < 4) return cudaErrorInvalidValue;
  const int groups = (D + most - 1) / most;
  const int gw = ((D + groups - 1) / groups + 3) & ~3;
  if (groups > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = table * gw + kBufferBytes;
  // The attribute and the occupancy query cost more host time than a
  // small launch: done once per device and shared-memory size.
  static int last_device = -1, last_sms = 0, last_per_sm = 0;
  static size_t last_smem = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != last_device || smem != last_smem) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(encode_bins_kernel<kLevels>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    err = cudaDeviceGetAttribute(&last_sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &last_per_sm, encode_bins_kernel<kLevels>, kThreads, smem);
    if (err != cudaSuccess) return err;
    last_device = device;
    last_smem = smem;
  }
  if (last_per_sm < 1) return cudaErrorInvalidConfiguration;
  // As many blocks as fit on the card at once, spread over the groups; no
  // more slices of a group than its row tiles fill.
  const int64_t row_tiles = (n + kRows - 1) / kRows;
  int64_t slices = static_cast<int64_t>(last_sms) * last_per_sm / groups;
  const int64_t fill = (row_tiles + kWarps - 1) / kWarps;
  if (slices > fill) slices = fill;
  if (slices < 1) slices = 1;
  const dim3 grid(static_cast<unsigned>(slices),
                  static_cast<unsigned>(groups));
  encode_bins_kernel<kLevels><<<grid, kThreads, smem, stream>>>(
      coords, bp, codes, n, D, Nr, logP, gw, vec, row_tiles);
  return cudaGetLastError();
}

}  // namespace

// coords (n, D) f32, bp (D, Nr + 1) f32, codes (n, D) int32, contiguous.
extern "C" int encode_bins_launch(const float* coords, const float* bp,
                                  int32_t* codes, int64_t n, int D, int Nr,
                                  void* stream) {
  if (n == 0 || D == 0) return 0;
  const int logP = encode_pack_tile::log2_width(Nr);
  if (logP > 13) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = D % 4 == 0
      && reinterpret_cast<uintptr_t>(coords) % 16 == 0
      && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      logP > 8 ? launch<13>(coords, bp, codes, n, D, Nr, logP, vec, s)
               : launch<8>(coords, bp, codes, n, D, Nr, logP, vec, s);
  return static_cast<int>(err);
}

extern "C" const char* encode_bins_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
