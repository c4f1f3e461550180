// encode_pack: fused iSAX encode + interleaved sort-key pack (static build).
//
// Replaces the TPU kernel src/repro/kernels/build_fused.py:encode_pack
// (body _encode_pack_tile).
//
// What it computes, for proj (n, L*K) f32 and breakpoints (L*K, Nr+1) f32:
//   code[row, c]  = #(inner edges bp[c, 1..Nr-1] <= proj[row, c]), which lies
//                   in [0, Nr-1] (searchsorted(side='right') on sorted edges;
//                   0 for a NaN, as the TPU kernel's compare-accumulate);
//   proj_t/codes_t (L, n, K): the per-tree layouts of proj and the codes;
//   key_hi/key_lo (L, n): each tree's K codes bit-interleaved MSB first,
//                   round-robin over dims, into two 32-bit words; bit
//                   positions >= 32 are dropped (core/detree.py
//                   interleave_keys).  Words are stored as int64 holding the
//                   uint32 value, because torch cannot sort uint32.
//
// What bounds it on an H100: memory.  Per row it reads L*K floats and writes
// L*K floats, L*K int32 codes and 2*L int64 words: 0.248 ms at n = 1M,
// L*K = 64 at 3.35 TB/s.  Beside the bytes, each code takes log2(Nr)
// dependent loads of an edge table, about 40 instructions for 32 codes.
//
// Design (encode_pack_tile.cuh, shared with project_encode_pack.cu): a
// block owns one tree (blockIdx.x % L) and builds that tree's K
// breadth-first (Eytzinger) edge tables from bp in shared memory (16 KB at
// K = 16, Nr = 256); its 8 warps then take tiles of 32 rows of that tree
// one after another (every (gridDim.x / L) * 8-th tile: the grid holds as
// many blocks as fit on the card at once, neighbouring blocks on
// neighbouring trees of the same rows), a lane a row.  A warp reads its
// rows' K coordinates into registers (16-byte loads where K is a multiple
// of 4), searches each code in shared memory, packs the row's key words
// from its codes in registers and stores the row's coordinates, codes and
// words; no barrier separates the steps, so one warp's loads overlap
// another's search.  (A block that staged 32 rows of all trees, searched
// them a warp a dim, then packed them by warp ballots between barriers
// took 0.62 ms at n = 1M, K = 16, L = 4 on an H100; the same kernel with
// the search and the per-tree layouts cut out took 0.23 ms: it was bound by
// the instructions it issued and the barriers between them, not by
// memory.)  A template on K (4, 8, 16: the K the repo's configurations use)
// keeps x and the codes in registers and makes every key bit's place a
// constant; other K run a generic instance that loops over the dims.

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_pack_tile.cuh"

namespace {

using encode_pack_tile::Call;
using encode_pack_tile::kRows;
using encode_pack_tile::kThreads;
using encode_pack_tile::kWarps;

// kK: 4, 8 or 16 (the K the repo's configurations use), or 0 for any K.
template <int kK>
__global__ void __launch_bounds__(kThreads) encode_pack_kernel(
    const float* __restrict__ proj, const float* __restrict__ bp, int ld,
    int L, int vec, int64_t row_tiles, Call call) {
  extern __shared__ __align__(16) float tables[];      // (K, P), buffers
  const int K = kK > 0 ? kK : call.K;
  const int l = blockIdx.x % L;
  const int slice = blockIdx.x / L;
  const int slices = gridDim.x / L;
  const int logP = call.logP;
  for (int e = threadIdx.x; e < (K << logP); e += kThreads)
    tables[e] = encode_pack_tile::eytzinger_value(
        bp + static_cast<int64_t>(l * K + (e >> logP)) * (call.Nr + 1),
        e & ((1 << logP) - 1), call.Nr, logP);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t step = static_cast<int64_t>(slices) * kWarps;
  for (int64_t tile = static_cast<int64_t>(slice) * kWarps + warp;
       tile < row_tiles; tile += step) {
    const int64_t row0 = tile * kRows;
    const int n_rows = static_cast<int>(
        min(static_cast<int64_t>(kRows), call.n - row0));
    const float* src = proj + row0 * ld + l * K;
    const int64_t o0 = l * call.n + row0;
    if constexpr (kK > 0) {
      float x[kK];
      if (vec) {                         // 16-byte rows: through the buffer
        constexpr int P = encode_pack_tile::buf_pitch<kK>();
        float* buf = tables + (K << logP) + warp * kRows * P;
        encode_pack_tile::load_rows<kK>(src, ld, n_rows, buf);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kK; ++j) x[j] = buf[lane * P + j];
        encode_pack_tile::encode_rows<kK, true, true>(
            x, buf, P, buf, n_rows, o0, tables, call);
        continue;
      }
      const float* row = src + (lane < n_rows ? lane : 0) * ld;
#pragma unroll
      for (int j = 0; j < kK; ++j) x[j] = __ldcs(row + j);
      encode_pack_tile::encode_rows<kK, true, false>(
          x, nullptr, 0, nullptr, n_rows, o0, tables, call);
    } else {
      const bool ok = lane < n_rows;
      const float* row = src + (ok ? lane : 0) * ld;
      encode_pack_tile::encode_row_any<true>(
          [&](int j) { return __ldcs(row + j); }, tables, o0 + lane, ok,
          call);
    }
  }
}

template <int kK>
cudaError_t launch(const float* proj, const float* bp, int ld, int L,
                   int vec, const Call& call, cudaStream_t stream) {
  // The tree's tables, then a staging buffer a warp where K % 4 == 0.
  size_t smem = sizeof(float) * (static_cast<size_t>(call.K) << call.logP);
  if constexpr (kK > 0)
    smem += sizeof(float) * kWarps * kRows * encode_pack_tile::buf_pitch<kK>();
  // The attribute and the occupancy query cost more host time than a
  // small launch: done once per device and shared-memory size.
  static int last_device = -1, last_sms = 0, last_per_sm = 0;
  static size_t last_smem = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device != last_device || smem != last_smem) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          encode_pack_kernel<kK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    cudaDeviceGetAttribute(&last_sms, cudaDevAttrMultiProcessorCount, device);
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &last_per_sm, encode_pack_kernel<kK>, kThreads, smem);
    if (err != cudaSuccess) return err;
    last_device = device;
    last_smem = smem;
  }
  const int sms = last_sms, per_sm = last_per_sm;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // As many blocks as fit on the card at once, a multiple of L; no more
  // slices of a tree than its row tiles fill.
  const int64_t row_tiles = (call.n + kRows - 1) / kRows;
  int64_t slices = static_cast<int64_t>(sms) * per_sm / L;
  const int64_t most = (row_tiles + kWarps - 1) / kWarps;
  if (slices > most) slices = most;
  if (slices < 1) slices = 1;
  if (slices * L > 0x7fffffff) return cudaErrorInvalidConfiguration;
  encode_pack_kernel<kK><<<static_cast<unsigned>(slices * L), kThreads,
                           smem, stream>>>(proj, bp, ld, L, vec, row_tiles,
                                           call);
  return cudaGetLastError();
}

}  // namespace

// proj (n, L*K) rows ld floats apart, bp (L*K, Nr+1); outputs in the
// per-tree layouts.
extern "C" int encode_pack_launch(const float* proj, const float* bp,
                                  float* proj_t, int32_t* codes_t,
                                  int64_t* key_hi, int64_t* key_lo,
                                  int64_t n, int ld, int K, int L, int Nr,
                                  int hi_bits, int lo_bits, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Call call{nullptr, proj_t, codes_t, key_hi, key_lo, n, K, Nr,
                  encode_pack_tile::log2_width(Nr), hi_bits, lo_bits};
  const int vec = ld % 4 == 0 && reinterpret_cast<uintptr_t>(proj) % 16 == 0;
  cudaError_t err;
  switch (K) {
    case 4: err = launch<4>(proj, bp, ld, L, vec, call, s); break;
    case 8: err = launch<8>(proj, bp, ld, L, vec, call, s); break;
    case 16: err = launch<16>(proj, bp, ld, L, vec, call, s); break;
    default: err = launch<0>(proj, bp, ld, L, vec, call, s); break;
  }
  return static_cast<int>(err);
}

extern "C" const char* encode_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
