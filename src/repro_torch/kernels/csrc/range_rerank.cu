// range_rerank: fused batched range query + exact rerank over all L trees.
//
// Replaces the TPU kernel src/repro/kernels/range_rerank.py:range_rerank
// (body _kernel), and through range_rerank_heads_launch the vmap of it in
// src/repro/kernels/ops.py:range_rerank_heads, which lifts a head axis H
// into the pallas_call grid.
//
// What it computes, per (tree l, query i, sorted point p) with leaf = p / ls:
//   LB(l, i, leaf) = sqrt(sum_k max(b_lo - x_k, x_k - b_hi, 0)^2), the Fig. 5
//     leaf lower bound, b_lo = bp[l, k, lo], b_hi = bp[l, k, hi + 1];
//   out[l, i, p] = sqrt(max(|q_i|^2 - 2 q_i.p + |p|^2, 0)) when the leaf is
//     valid, LB <= r_eff[l, i] (-1 = done lane), and the point is valid and
//     live; +inf everywhere else.
//
// What bounds it on an H100: memory.  The (L, B, npts) f32 output is
// written whole every round (1.6 GB at L = 4, B = 100, n = 1M: 0.48 ms at
// 3.35 TB/s) and the admitted leaves' points are read (up to 2 GB more).
// The products of the admitted pairs, done in f32 on the CUDA cores, would
// take longer than both: ~131 GFLOP at the main path's last round, ~2 ms
// at 67 TFLOP/s.  So they run on the tensor cores, and only where a tile
// of pairs holds an admitted one.
//
// Design: two launches.
//   1. Admission (admit_kernel): LB <= r_eff for every (tree, leaf,
//      query) into a byte table (L, nl, B), the wrapper's scratch.  A block
//      takes 32 leaves of a tree, gathers their edge coordinates once into
//      shared memory (the tree's projected queries too, where they fit),
//      and sums each pair's K clamped gaps in the order k = 0..K-1 with
//      __fadd_rn(acc, __fmul_rn(gap, gap)), which nvcc cannot contract into
//      an FMA; the plain version (kernels/ref.py) loops in the same order,
//      so both agree bit for bit on every LB and on which leaves are
//      admitted, and the +inf mask is the plain version's.  (Done inside
//      the rerank's blocks, these dependent gathers stalled every block
//      before its first load.)
//   2. The rerank (range_rerank_kernel): a block owns a (head, tree, tile
//      of kP = 64 kCols sorted points) and serves every query of the batch,
//      so the points are read once a block.  Its 8 warps each own two warp
//      tiles of 16 queries x one 64-point column; a pass covers 16 warp
//      tiles (kCols columns x 16 / kCols query tiles), and a batch larger
//      than that runs several passes.  kCols = 8 for B <= 32 (4 where the
//      grid would be short), 4 for B <= 64, else 2, so that a small batch
//      (decode: B = g = 2) still fills the warps with columns.  The block
//      copies its leaves' rows of the admission table into shared memory.
//      Leaf skip: a warp tile none of whose (query, leaf) pairs is admitted
//      writes +inf and issues no mma; a column no warp tile computes is not
//      read; a pass with no admitted pair reads no point.  Any leaf size: a
//      column's pairs are those of every leaf it overlaps.
//      The product q.p on the tensor cores, 3xTF32: mma.sync m16n8k8 (A =
//      16 queries x 8 features, B = 8 features x 8 points), each operand
//      split exactly as x = hi + lo, hi = x's top 19 bits (a TF32 value),
//      and summed as q_hi.p_hi + q_hi.p_lo + q_lo.p_hi a k step, in that
//      order (the tensor cores read lo truncated to TF32).  The dropped
//      q_lo.p_lo term, lo's truncation and the tensor cores' own
//      accumulation leave an error of ~1e-6 of sum |q_k||p_k|, inside the
//      tolerance the plain version is held to (1e-4 |plain| + 1e-4 max
//      |x|^2).  Fixed order, so the result is the same from run to run.
//      Features past d are zeros (a multiple of 8 is computed).  |q|^2 and
//      |p|^2 stay on the CUDA cores, fmaf in feature order, as before.
//      Staging: queries and points arrive kDC features at a time through
//      a ring of cp.async stages (16-byte .cg copies where d is a multiple
//      of 4, else 4-byte copies), so the loads of the next chunk overlap
//      the mmas of this one: 32 features and 2 stages at kCols = 2, 16 and
//      3 at kCols = 4, 16 and 2 at kCols = 8 (two blocks an SM, 63-87 KB of
//      shared memory); shared memory does not grow with d, and any d runs.
//      Rows are padded by 4 floats, so the fragment loads (8 rows x 4
//      features a warp) fall in 32 distinct banks.  Both operands are split
//      as their fragments are loaded; a warp's two tiles share the column's
//      point fragments.
//      Stores: the mma's C fragment holds 2 consecutive points of a query a
//      thread, stored as one 8-byte streaming store (__stcs: nothing
//      rereads the output from L2 before the fold); a warp's store covers
//      8 queries x 32 bytes.  A 64-bit mask a query row marks the column's
//      points in admitted leaves, and an invalid or deleted point carries
//      |p|^2 = +inf, so the epilogue needs no per-point lookups.
//   Head axis: every block index of both launches decomposes with a
//   leading head digit and every array is offset by the head's stride; the
//   single-forest entry is the same bodies without the head digit, so head
//   h of a heads launch equals a single-forest launch on head h's arrays
//   bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kTilesPerPass = 16; // warp tiles a pass
constexpr int kWT = 2;            // warp tiles a warp
constexpr int kWarps = kTilesPerPass / kWT;
constexpr int kThreads = 32 * kWarps;
constexpr int kColPts = 64;       // points in a warp tile's column
constexpr int kQT = 16;           // queries in a warp tile (mma M)
constexpr int kAdmLeaves = 32;    // leaves an admission block
constexpr int kAdmThreads = 256;

// 64-point columns a block, from the batch size; a batch of one or two
// query tiles takes 512-point blocks where that grid still gives every SM
// four blocks (decode's 32 forests), else 256-point ones (a few forests).
// The tile shape does not change the arithmetic of an output, so heads
// and single forests agree bit for bit whatever each launch picks.
int cols_for(int B, int64_t forests, int64_t npts) {
  const int qtiles = (B + kQT - 1) / kQT;
  if (qtiles > 4) return 2;
  if (qtiles > 2) return 4;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t blocks8 = forests * ((npts + 8 * kColPts - 1) / (8 * kColPts));
  return blocks8 >= 4 * static_cast<int64_t>(sms) ? 8 : 4;
}

template <int kCols>
struct Tile {
  static constexpr int kP = kCols * kColPts;                    // points
  static constexpr int kQP = kTilesPerPass / kCols * kQT;       // queries
  // The ring: features a stage and stages (two 512-point stages keep two
  // blocks an SM; at 128 points, 32-feature stages halve the barriers).
  static constexpr int kDC = kCols == 2 ? 32 : 16;
  static constexpr int kStages = kCols == 4 ? 3 : 2;
  static constexpr int kPitch = kDC + 4;  // floats a staged row
  static constexpr int kSumRows = (kP + kQP + kThreads - 1) / kThreads;
  static constexpr int kStageFloats = (kP + kQP) * kPitch;
  // Leaves a tile of kP points can overlap, at leaf size ls.
  static int leaves(int ls) { return (kP - 1) / ls + 2; }
  static size_t smem_bytes(int ls) {
    return sizeof(float) * (kStages * kStageFloats + kP + kQP + kCols) +
           sizeof(uint16_t) * kP + kP +
           static_cast<size_t>(leaves(ls)) * kQP;
  }
};

// x = hi + lo exactly: hi keeps x's top 19 bits (a TF32 value), lo is the
// rest, which the tensor cores read truncated to TF32 (its low 13 bits
// are ignored), so lo . p_hi and q_hi . lo carry x's next 11 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) . b (8 x 8, col), TF32 inputs, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage features [k0, k0 + kDC) of the tile's points (the columns whose
// col_on entry is set) and of the pass's queries into one ring slot, kW
// floats a copy (4: 16-byte copies, rows 16-byte aligned; 1: 4-byte
// copies), zeros past d.  Rows past np or nq are left as they are: a row
// of the product depends only on its own row of each operand, and those
// rows' results are never stored.
template <int kCols, int kW>
__device__ __forceinline__ void stage(float* slot, const float* pts,
                                      const float* qs, int np, int nq, int d,
                                      int k0, const int* col_on) {
  using T = Tile<kCols>;
  constexpr int kPerRow = T::kDC / kW;                  // copies a row
  for (int e = threadIdx.x; e < (T::kP + T::kQP) * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int k = k0 + (e - r * kPerRow) * kW;
    const bool point = r < T::kP;
    const int j = point ? r : r - T::kP;             // row of its operand
    if (point ? r >= np || !col_on[r / kColPts] : j >= nq) continue;
    float* dst = slot + r * T::kPitch + k - k0;
    const float* src = point ? pts : qs;
    const bool ok = k < d;
    if (ok) src += static_cast<int64_t>(j) * d + k;
    if constexpr (kW == 4) cp_async::copy16(dst, src, ok);
    else cp_async::copy4(dst, src, ok);
  }
}

template <int kCols>
__device__ __forceinline__ void stage(float* slot, const float* pts,
                                      const float* qs, int np, int nq, int d,
                                      int k0, bool vec, const int* col_on) {
  if (vec) stage<kCols, 4>(slot, pts, qs, np, nq, d, k0, col_on);
  else stage<kCols, 1>(slot, pts, qs, np, nq, d, k0, col_on);
}

// Admission, the first launch: LB(l, i, leaf) <= r_eff[l, i] for every
// (tree, leaf, query), into admit (L, nl, B) bytes (0 for invalid leaves).
// A block takes kAdmLeaves leaves of one tree: their 2K edge coordinates
// are gathered once into shared memory, then every (leaf, query) pair sums
// its K clamped gaps in the order k = 0..K-1 with __fadd_rn(acc,
// __fmul_rn(gap, gap)), which nvcc cannot contract into an FMA.  Queries
// run fastest, so the writes are coalesced.
template <bool kHeads>
__global__ void __launch_bounds__(kAdmThreads) admit_kernel(
    const float* __restrict__ q_proj,       // (L, B, K)
    const float* __restrict__ r_eff,        // (L, B)
    const int32_t* __restrict__ leaf_lo,    // (L, nl, K)
    const int32_t* __restrict__ leaf_hi,    // (L, nl, K)
    const uint8_t* __restrict__ leaf_valid, // (L, nl)
    const float* __restrict__ bp,           // (L, K, E)
    uint8_t* __restrict__ admit,            // (L, nl, B)
    int L, int B, int nl, int K, int E, int n_groups, int q_in_smem) {
  extern __shared__ float edges[];          // (kAdmLeaves, 2, K)
  float* qp_s = edges + 2 * kAdmLeaves * K; // (B, K + 1) when q_in_smem
  const int64_t bid = blockIdx.x;
  const int group = static_cast<int>(bid % n_groups);
  const int64_t tree = bid / n_groups;
  const int l = static_cast<int>(kHeads ? tree % L : tree);
  if constexpr (kHeads) {
    const int64_t h = tree / L;
    q_proj += h * L * B * K;
    r_eff += h * L * B;
    leaf_lo += h * L * nl * K;
    leaf_hi += h * L * nl * K;
    leaf_valid += h * L * nl;
    bp += h * L * K * E;
    admit += h * L * nl * B;
  }
  const int lf0 = group * kAdmLeaves;
  const int n_leaves = min(kAdmLeaves, nl - lf0);
  const float* bpl = bp + static_cast<int64_t>(l) * K * E;
  for (int e = threadIdx.x; e < n_leaves * K; e += kAdmThreads) {
    const int lf = e / K;
    const int k = e - lf * K;
    const int64_t off = (static_cast<int64_t>(l) * nl + lf0 + lf) * K + k;
    const int ilo = min(max(leaf_lo[off], 0), E - 1);
    const int ihi = min(max(leaf_hi[off] + 1, 0), E - 1);
    edges[(2 * lf) * K + k] = bpl[k * E + ilo];
    edges[(2 * lf + 1) * K + k] = bpl[k * E + ihi];
  }
  if (q_in_smem) {                          // padded rows: no conflicts
    const float* xl = q_proj + static_cast<int64_t>(l) * B * K;
    for (int e = threadIdx.x; e < B * K; e += kAdmThreads)
      qp_s[(e / K) * (K + 1) + e % K] = xl[e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_leaves * B; e += kAdmThreads) {
    const int lf = e / B;
    const int j = e - lf * B;
    const int64_t leaf = static_cast<int64_t>(l) * nl + lf0 + lf;
    uint8_t ok = 0;
    if (leaf_valid[leaf]) {
      const float* x = q_in_smem
          ? qp_s + j * (K + 1)
          : q_proj + (static_cast<int64_t>(l) * B + j) * K;
      const float* lo = edges + (2 * lf) * K;
      const float* hi = lo + K;
      float acc = 0.f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float xk = x[k];
        const float gap = fmaxf(fmaxf(lo[k] - xk, xk - hi[k]), 0.f);
        acc = __fadd_rn(acc, __fmul_rn(gap, gap));
      }
      ok = sqrtf(acc) <= r_eff[static_cast<int64_t>(l) * B + j];
    }
    admit[leaf * B + j] = ok;
  }
}

// The rerank, the second launch.  kHeads: every array has a leading head
// axis, and the block index a leading head digit.  The single-forest
// instance compiles without the head digit and the head offsets.
template <bool kHeads, int kCols>
__global__ void __launch_bounds__(kThreads, 2) range_rerank_kernel(
    const float* __restrict__ q,            // (B, d)
    const uint8_t* __restrict__ admit,      // (L, nl, B)
    const float* __restrict__ points,       // (L, nl*ls, d)
    const uint8_t* __restrict__ point_valid,  // (L, nl*ls)
    const uint8_t* __restrict__ live,       // (L, nl*ls)
    float* __restrict__ out,                // (L, B, nl*ls)
    int L, int B, int d, int nl, int ls, int64_t n_ptiles, int vec) {
  using T = Tile<kCols>;
  constexpr int kP = T::kP;
  constexpr int kQP = T::kQP;
  constexpr int kDC = T::kDC;
  constexpr int kPitch = T::kPitch;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // kStages slots
  float* pp_s = ring + kStages * T::kStageFloats;      // (kP,) |p|^2
  float* qq_s = pp_s + kP;                             // (kQP,) |q|^2
  int* col_on = reinterpret_cast<int*>(qq_s + kQP);    // (kCols,) staged
  uint16_t* lf_s = reinterpret_cast<uint16_t*>(col_on + kCols);  // leaf
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(lf_s + kP);  // of a point
  uint8_t* admit_s = keep_s + kP;                      // (leaves, kQP)

  const int64_t bid = blockIdx.x;
  const int64_t pt = bid % n_ptiles;
  const int64_t tree = bid / n_ptiles;
  const int l = static_cast<int>(kHeads ? tree % L : tree);
  const int64_t npts = static_cast<int64_t>(nl) * ls;
  if constexpr (kHeads) {             // head h's arrays
    const int64_t h = tree / L;
    q += h * B * d;
    admit += h * L * nl * B;
    points += h * L * npts * d;
    point_valid += h * L * npts;
    live += h * L * npts;
    out += h * L * B * npts;
  }
  const int64_t p0 = pt * kP;
  const int np = static_cast<int>(min(static_cast<int64_t>(kP), npts - p0));
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2;                     // fragment row group
  const int t4 = lane & 3;                     // fragment column
  const int col = warp % kCols;                // this warp's column
  int qt_of[kWT];                              // this warp's query tiles
#pragma unroll
  for (int s = 0; s < kWT; ++s) qt_of[s] = warp / kCols + s * kWarps / kCols;
  const float kInf = __int_as_float(0x7f800000);

  const int leaf0 = static_cast<int>(p0 / ls);
  const int n_tile_leaves = static_cast<int>((p0 + np - 1) / ls) - leaf0 + 1;
  const float* pts = points + (static_cast<int64_t>(l) * npts + p0) * d;
  const uint8_t* adm = admit + (static_cast<int64_t>(l) * nl + leaf0) * B;
  float* out_l = out + static_cast<int64_t>(l) * B * npts + p0;
  const int o0 = static_cast<int>(p0 - static_cast<int64_t>(leaf0) * ls);
  for (int i = t; i < kP; i += kThreads) {
    keep_s[i] = i < np && point_valid[l * npts + p0 + i] &&
                live[l * npts + p0 + i];
    lf_s[i] = static_cast<uint16_t>((o0 + i) / ls);   // the tile's leaf
  }

  for (int qp0 = 0; qp0 < B; qp0 += kQP) {
    const int nq = min(kQP, B - qp0);
    if (qp0 > 0) __syncthreads();      // the last pass is done with smem
    if (t < kCols) col_on[t] = 0;

    // 1. The admission of every (leaf of the tile, query of the pass).
    for (int e = t; e < n_tile_leaves * kQP; e += kThreads) {
      const int lf = e / kQP;
      const int j = e - lf * kQP;
      admit_s[e] = j < nq ? adm[static_cast<int64_t>(lf) * B + qp0 + j] : 0;
    }
    __syncthreads();

    // 2. Which of this warp's tiles hold an admitted pair.
    bool act[kWT];
    bool any_act = false;
#pragma unroll
    for (int s = 0; s < kWT; ++s) {
      const int q0 = qt_of[s] * kQT;
      const int c0 = col * kColPts;
      int any = 0;
      if (q0 < nq && c0 < np) {
        const int lf_a = lf_s[c0];
        const int lf_b = lf_s[min(c0 + kColPts, np) - 1];
        for (int e = lane; e < (lf_b - lf_a + 1) * kQT; e += 32)
          any |= admit_s[(lf_a + e / kQT) * kQP + q0 + (e % kQT)];
      }
      act[s] = __any_sync(0xffffffffu, any);
      any_act |= act[s];
    }
    if (lane == 0 && any_act) col_on[col] = 1;
    const int block_any = __syncthreads_or(any_act);

    // 3. The product of the computed tiles, through the ring.
    float acc[kWT][8][4];
#pragma unroll
    for (int s = 0; s < kWT; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[s][j][u] = 0.f;
    if (block_any) {
      const float* qs = q + static_cast<int64_t>(qp0) * d;
      float sums[T::kSumRows];
#pragma unroll
      for (int i = 0; i < T::kSumRows; ++i) sums[i] = 0.f;
      const int nchunks = (d + kDC - 1) / kDC;
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nchunks)
          stage<kCols>(ring + s * T::kStageFloats, pts, qs, np, nq, d,
                       s * kDC, vec != 0, col_on);
        cp_async::commit();
      }
      for (int c = 0; c < nchunks; ++c) {
        cp_async::wait<kStages - 2>();     // this thread's copies of chunk c
        __syncthreads();                   // everyone's; chunk c-1 is done
        const int next = c + kStages - 1;
        if (next < nchunks)
          stage<kCols>(ring + (next % kStages) * T::kStageFloats, pts, qs,
                       np, nq, d, next * kDC, vec != 0, col_on);
        cp_async::commit();
        const float* ps = ring + (c % kStages) * T::kStageFloats;
        const float* qd = ps + kP * kPitch;
        // |p|^2 and |q|^2, one row a thread, fmaf in feature order (the
        // zeros past d add nothing).
#pragma unroll
        for (int i = 0; i < T::kSumRows; ++i) {
          const int r = t + kThreads * i;
          if (r >= kP + kQP) break;
          const float* row = r < kP ? ps + r * kPitch : qd + (r - kP) * kPitch;
#pragma unroll
          for (int k = 0; k < kDC; k += 4) {
            const float4 v = *reinterpret_cast<const float4*>(row + k);
            sums[i] = fmaf(v.x, v.x, sums[i]);
            sums[i] = fmaf(v.y, v.y, sums[i]);
            sums[i] = fmaf(v.z, v.z, sums[i]);
            sums[i] = fmaf(v.w, v.w, sums[i]);
          }
        }
        if (any_act) {
#pragma unroll
          for (int kk = 0; kk < kDC; kk += 8) {
            uint32_t ah[kWT][4], al[kWT][4];
#pragma unroll
            for (int s = 0; s < kWT; ++s) {
              if (!act[s]) continue;
              const float* qa = qd + (qt_of[s] * kQT + g) * kPitch + kk + t4;
              split_tf32(qa[0], ah[s][0], al[s][0]);
              split_tf32(qa[8 * kPitch], ah[s][1], al[s][1]);
              split_tf32(qa[4], ah[s][2], al[s][2]);
              split_tf32(qa[8 * kPitch + 4], ah[s][3], al[s][3]);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float* pb = ps + (col * kColPts + j * 8 + g) * kPitch +
                                kk + t4;
              uint32_t bh0, bl0, bh1, bl1;
              split_tf32(pb[0], bh0, bl0);
              split_tf32(pb[4], bh1, bl1);
#pragma unroll
              for (int s = 0; s < kWT; ++s)
                if (act[s]) mma_tf32(acc[s][j], ah[s], bh0, bh1);
#pragma unroll
              for (int s = 0; s < kWT; ++s)
                if (act[s]) mma_tf32(acc[s][j], ah[s], bl0, bl1);
#pragma unroll
              for (int s = 0; s < kWT; ++s)
                if (act[s]) mma_tf32(acc[s][j], al[s], bh0, bh1);
            }
          }
        }
      }
      cp_async::wait<0>();
#pragma unroll
      for (int i = 0; i < T::kSumRows; ++i) {
        const int r = t + kThreads * i;
        if (r < kP) pp_s[r] = keep_s[r] ? sums[i] : kInf;
        else if (r < kP + kQP) qq_s[r - kP] = sums[i];
      }
      __syncthreads();
    }

    // 4. Each warp writes its tiles: distances where computed and
    // admitted, +inf elsewhere.  C fragment: query rows g and g + 8,
    // points 8 j + 2 t4 and + 1 of the column.  A 64-bit mask a row says
    // which of the column's points lie in an admitted leaf; a point that
    // is not valid or not live has |p|^2 = +inf, so its distance is +inf.
    const bool pairs = (npts & 1) == 0;      // 8-byte aligned point pairs
    const int c0 = col * kColPts;
#pragma unroll
    for (int s = 0; s < kWT; ++s) {
      const int jq0 = qt_of[s] * kQT + g;
      const int jq1 = jq0 + 8;
      if (jq0 - g >= nq || c0 >= np) continue;
      uint64_t m0 = 0, m1 = 0;
      float qq0 = 0.f, qq1 = 0.f;
      if (act[s]) {
        const int lf_b = lf_s[min(c0 + kColPts, np) - 1];
        for (int lf = lf_s[c0]; lf <= lf_b; ++lf) {
          const int a = max(lf * ls - o0 - c0, 0);
          const int b = min(lf * ls - o0 - c0 + ls, kColPts);
          const uint64_t range = (b == kColPts ? ~0ull : (1ull << b) - 1) &
                                 ~((1ull << a) - 1);
          if (jq0 < nq && admit_s[lf * kQP + jq0]) m0 |= range;
          if (jq1 < nq && admit_s[lf * kQP + jq1]) m1 |= range;
        }
        qq0 = qq_s[jq0];
        qq1 = qq_s[jq1];
      }
      float* o0p = out_l + static_cast<int64_t>(qp0 + jq0) * npts + c0;
      float* o1p = o0p + 8 * npts;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int pc = j * 8 + 2 * t4;        // point in the column
        if (c0 + pc >= np) continue;
        const bool two = c0 + pc + 1 < np;
        float v[4] = {kInf, kInf, kInf, kInf};
        if (act[s]) {
          const float pp0 = pp_s[c0 + pc];
          const float pp1 = pp_s[c0 + pc + 1];
          const float* a = acc[s][j];
          if ((m0 >> pc) & 1) v[0] = sqrtf(fmaxf(qq0 - 2.f * a[0] + pp0, 0.f));
          if ((m0 >> pc) & 2) v[1] = sqrtf(fmaxf(qq0 - 2.f * a[1] + pp1, 0.f));
          if ((m1 >> pc) & 1) v[2] = sqrtf(fmaxf(qq1 - 2.f * a[2] + pp0, 0.f));
          if ((m1 >> pc) & 2) v[3] = sqrtf(fmaxf(qq1 - 2.f * a[3] + pp1, 0.f));
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if ((half ? jq1 : jq0) >= nq) continue;
          float* o = (half ? o1p : o0p) + pc;
          if (two && pairs) {
            __stcs(reinterpret_cast<float2*>(o),
                   make_float2(v[2 * half], v[2 * half + 1]));
          } else {
            __stcs(o, v[2 * half]);
            if (two) __stcs(o + 1, v[2 * half + 1]);
          }
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kHeads, int kCols>
int launch_c(const float* q, const uint8_t* admit, const float* points,
             const uint8_t* point_valid, const uint8_t* live, float* out,
             int H, int L, int B, int d, int nl, int ls, cudaStream_t stream) {
  using T = Tile<kCols>;
  const int64_t npts = static_cast<int64_t>(nl) * ls;
  const int64_t n_ptiles = (npts + T::kP - 1) / T::kP;
  const int64_t blocks = static_cast<int64_t>(H) * L * n_ptiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = T::smem_bytes(ls);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        range_rerank_kernel<kHeads, kCols>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte copies need rows of a multiple of 4 floats (the head strides
  // then keep the bases' alignment).
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(points);
  range_rerank_kernel<kHeads, kCols><<<static_cast<unsigned>(blocks),
                                       kThreads, smem, stream>>>(
      q, admit, points, point_valid, live, out, L, B, d, nl, ls, n_ptiles,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kHeads>
int launch(const float* q, const float* q_proj, const float* r_eff,
           const int32_t* leaf_lo, const int32_t* leaf_hi,
           const uint8_t* leaf_valid, const float* bp, const float* points,
           const uint8_t* point_valid, const uint8_t* live, float* out,
           uint8_t* admit, int H, int L, int B, int d, int nl, int K, int E,
           int ls, void* stream_ptr) {
  if (H == 0 || L == 0 || B == 0 || static_cast<int64_t>(nl) * ls == 0)
    return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_groups = (nl + kAdmLeaves - 1) / kAdmLeaves;
  const int64_t adm_blocks = static_cast<int64_t>(H) * L * n_groups;
  if (adm_blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // The tree's projected queries go to shared memory where they fit.
  const size_t edge_bytes = sizeof(float) * 2 * kAdmLeaves * K;
  const size_t q_bytes = sizeof(float) * static_cast<size_t>(B) * (K + 1);
  const int q_in_smem = edge_bytes + q_bytes <= 96 * 1024;
  const size_t adm_smem = edge_bytes + (q_in_smem ? q_bytes : 0);
  if (adm_smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        admit_kernel<kHeads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(adm_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  admit_kernel<kHeads><<<static_cast<unsigned>(adm_blocks), kAdmThreads,
                         adm_smem, stream>>>(
      q_proj, r_eff, leaf_lo, leaf_hi, leaf_valid, bp, admit, L, B, nl, K, E,
      n_groups, q_in_smem);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (cols_for(B, static_cast<int64_t>(H) * L,
                   static_cast<int64_t>(nl) * ls)) {
    case 8:
      return launch_c<kHeads, 8>(q, admit, points, point_valid, live, out, H,
                                 L, B, d, nl, ls, stream);
    case 4:
      return launch_c<kHeads, 4>(q, admit, points, point_valid, live, out, H,
                                 L, B, d, nl, ls, stream);
    default:
      return launch_c<kHeads, 2>(q, admit, points, point_valid, live, out, H,
                                 L, B, d, nl, ls, stream);
  }
}

}  // namespace

// One forest: arrays as the kernels' comments give them; admit is scratch
// of L * nl * B bytes.
extern "C" int range_rerank_launch(
    const float* q, const float* q_proj, const float* r_eff,
    const int32_t* leaf_lo, const int32_t* leaf_hi, const uint8_t* leaf_valid,
    const float* bp, const float* points, const uint8_t* point_valid,
    const uint8_t* live, float* out, uint8_t* admit, int L, int B, int d,
    int nl, int K, int E, int ls, void* stream) {
  return launch<false>(q, q_proj, r_eff, leaf_lo, leaf_hi, leaf_valid, bp,
                       points, point_valid, live, out, admit, 1, L, B, d, nl,
                       K, E, ls, stream);
}

// H forests in one launch pair: every array with a leading head axis H;
// admit is scratch of H * L * nl * B bytes.
extern "C" int range_rerank_heads_launch(
    const float* q, const float* q_proj, const float* r_eff,
    const int32_t* leaf_lo, const int32_t* leaf_hi, const uint8_t* leaf_valid,
    const float* bp, const float* points, const uint8_t* point_valid,
    const uint8_t* live, float* out, uint8_t* admit, int H, int L, int B,
    int d, int nl, int K, int E, int ls, void* stream) {
  return launch<true>(q, q_proj, r_eff, leaf_lo, leaf_hi, leaf_valid, bp,
                      points, point_valid, live, out, admit, H, L, B, d, nl,
                      K, E, ls, stream);
}

extern "C" const char* range_rerank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
