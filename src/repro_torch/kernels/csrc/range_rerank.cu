// range_rerank: fused batched range query + exact rerank over all L trees.
//
// Replaces the TPU kernel src/repro/kernels/range_rerank.py:range_rerank
// (body _kernel).
//
// What it computes, per (tree l, query i, sorted point p) with leaf = p / ls:
//   LB(l, i, leaf) = sqrt(sum_k max(b_lo - x_k, x_k - b_hi, 0)^2), the Fig. 5
//     leaf lower bound, b_lo = bp[l, k, lo], b_hi = bp[l, k, hi + 1];
//   out[l, i, p] = sqrt(max(|q_i|^2 - 2 q_i.p + |p|^2, 0)) when the leaf is
//     valid, LB <= r_eff[l, i] (-1 = done lane), and the point is valid and
//     live; +inf everywhere else.
//
// What bounds it on an H100: by the least work, memory — the (L, B, npts)
// f32 output is written whole every round (1.6 GB at L=4, B=100, n=1M) and
// the admitted leaves' points are read.  As built, the fp32 products: an
// admitted tile computes all 32 queries against all 256 points, far more
// FMAs than the admitted (query, leaf) pairs need when admission is sparse,
// and the staging of each tile's points through shared memory behind two
// barriers per feature chunk.
//
// Design: one block per (tree, tile of kP = 256 sorted points, tile of
// kQ = 32 queries), the query tile fastest in the linear block index so the
// blocks that share a point tile run together and find it in L2; at B = 100
// a point tile is read by 4 query tiles.
//   Head axis (range_rerank_heads_launch; replaces the vmap of the TPU
//   kernel in src/repro/kernels/ops.py:range_rerank_heads, which lifts H
//   into the pallas_call grid): H independent forests, each with its own
//   query batch, in one launch.  The block index decomposes into
//   (head, tree, point tile, query tile) and every array is offset by the
//   head's stride; the single-forest entry is the same body without the
//   head digit, so head h of a heads launch equals a single-forest launch
//   on head h's arrays bit for bit.  At decode (B = g = 2 query heads a
//   forest) a query tile is 1/16 full: tiling several heads' lanes
//   together is later work.
//   1. LB and admission per (leaf of the tile, query): the leaf's edge
//      coordinates are gathered directly (on the TPU an edge sweep), and the
//      K clamped gaps accumulate in the order k = 0..K-1 with
//      __fadd_rn(acc, __fmul_rn(t, t)), which nvcc cannot contract into an
//      FMA; the plain version (kernels/ref.py) loops in the same order, so
//      both agree bit for bit on every LB and on which leaves are admitted.
//   2. A tile with no admitted leaf writes +inf and reads no points.
//   3. An admitted tile is a small fp32 matrix product, (32 queries x d) by
//      (d x 256 points), on the CUDA cores (no TF32, no tensor cores: a TF32
//      drift would move the T2 test best <= c*r and with it the round
//      count).  Points are staged through shared memory in chunks of kDC
//      features, feature-major (coalesced 128-byte row loads, 8 in flight
//      per thread); queries sit feature-major in shared memory, whole up
//      to d = kQC = 128, and past it kQC features at a time (a kWide
//      instance: staging queries per chunk at every d ran up to 13 %
//      slower at d = 128 on an H100, timed in turns by
//      scripts/ab_kernels.py), so
//      shared memory (57 KB) does not grow with d and any d runs.  Each
//      thread owns a 4-point x 8-query register tile and keeps it, and its
//      |p|^2 sums, from chunk to chunk; warp 0 carries |q|^2 the same way.
//      Every sum runs in feature order with the same fmaf as one pass over
//      whole rows, so the bits do not depend on the chunk sizes.  One
//      feature costs a thread 3 float4 shared loads for 32 FMAs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 32;     // queries per block
constexpr int kP = 256;    // sorted points per block
constexpr int kDC = 32;    // feature chunk staged in shared memory
constexpr int kThreads = 256;
constexpr int kTP = 4;     // points per thread
constexpr int kTQ = 8;     // queries per thread
constexpr int kQG = kQ / kTQ;          // query groups: thread t takes t % kQG
constexpr int kPS = kP + 4;            // p_s row stride, keeps float4 alignment
static_assert(kThreads == (kP / kTP) * kQG, "one register tile per thread");

__host__ __device__ inline int padded_dim(int d) { return (d + kDC - 1) / kDC * kDC; }

constexpr int kQC = 128;   // query features staged at once, at most
static_assert(kQC % kDC == 0, "a query chunk holds whole point chunks");

size_t smem_bytes(int d) {
  const size_t qc = padded_dim(d) < kQC ? padded_dim(d) : kQC;
  return sizeof(float) * (qc * kQ + kQ + static_cast<size_t>(kDC) * kPS) +
         static_cast<size_t>(kP + 1) * kQ;
}

// kHeads: every array has a leading head axis, and the block index a
// leading head digit.  The single-forest instance compiles without the
// head digit and the head offsets.  kWide: d > kQC, queries staged kQC
// features at a time.
template <bool kHeads, bool kWide>
__global__ void __launch_bounds__(kThreads) range_rerank_kernel(
    const float* __restrict__ q,            // (B, d)
    const float* __restrict__ q_proj,       // (L, B, K)
    const float* __restrict__ r_eff,        // (L, B)
    const int32_t* __restrict__ leaf_lo,    // (L, nl, K)
    const int32_t* __restrict__ leaf_hi,    // (L, nl, K)
    const uint8_t* __restrict__ leaf_valid, // (L, nl)
    const float* __restrict__ bp,           // (L, K, E)
    const float* __restrict__ points,       // (L, nl*ls, d)
    const uint8_t* __restrict__ point_valid,  // (L, nl*ls)
    const uint8_t* __restrict__ live,       // (L, nl*ls)
    float* __restrict__ out,                // (L, B, nl*ls)
    int L, int B, int d, int nl, int K, int E, int ls,
    int n_qtiles, int64_t n_ptiles) {
  extern __shared__ float smem[];
  const int dp = padded_dim(d);
  const int qc = kWide ? kQC : dp;          // query features staged
  float* q_s = smem;                        // (qc, kQ), zero past d / B
  float* qq_s = q_s + qc * kQ;              // (kQ,)
  float* p_s = qq_s + kQ;                   // (kDC, kPS), feature-major
  uint8_t* admit_s = reinterpret_cast<uint8_t*>(p_s + kDC * kPS);

  const int64_t bid = blockIdx.x;
  const int qt = static_cast<int>(bid % n_qtiles);
  const int64_t pt = (bid / n_qtiles) % n_ptiles;
  const int64_t tree = bid / (static_cast<int64_t>(n_qtiles) * n_ptiles);
  const int l = static_cast<int>(kHeads ? tree % L : tree);
  const int q0 = qt * kQ;
  const int nq = min(kQ, B - q0);
  const int64_t npts = static_cast<int64_t>(nl) * ls;
  if constexpr (kHeads) {             // head h's arrays
    const int64_t h = tree / L;
    q += h * B * d;
    q_proj += h * L * B * K;
    r_eff += h * L * B;
    leaf_lo += h * L * nl * K;
    leaf_hi += h * L * nl * K;
    leaf_valid += h * L * nl;
    bp += h * L * K * E;
    points += h * L * npts * d;
    point_valid += h * L * npts;
    live += h * L * npts;
    out += h * L * B * npts;
  }
  const int64_t p0 = pt * kP;
  const int t = threadIdx.x;

  // 1. LB + admission for every (leaf of the tile, query of the tile).
  const int leaf0 = static_cast<int>(p0 / ls);
  const int leaf1 = static_cast<int>((min(p0 + kP, npts) - 1) / ls);
  const int n_tile_leaves = leaf1 - leaf0 + 1;
  int any_admit = 0;
  for (int e = t; e < n_tile_leaves * kQ; e += kThreads) {
    const int lf = e / kQ;
    const int j = e - lf * kQ;
    const int leaf = leaf0 + lf;
    uint8_t ok = 0;
    if (j < nq && leaf_valid[static_cast<int64_t>(l) * nl + leaf]) {
      const int64_t lo_off = (static_cast<int64_t>(l) * nl + leaf) * K;
      const float* bpl = bp + static_cast<int64_t>(l) * K * E;
      const float* x = q_proj + (static_cast<int64_t>(l) * B + q0 + j) * K;
      float acc = 0.f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {         // loads pipelined, sum in order
        const int ilo = min(max(leaf_lo[lo_off + k], 0), E - 1);
        const int ihi = min(max(leaf_hi[lo_off + k] + 1, 0), E - 1);
        const float xk = x[k];
        const float gap = fmaxf(fmaxf(bpl[k * E + ilo] - xk,
                                      xk - bpl[k * E + ihi]), 0.f);
        acc = __fadd_rn(acc, __fmul_rn(gap, gap));
      }
      ok = sqrtf(acc) <= r_eff[static_cast<int64_t>(l) * B + q0 + j];
    }
    admit_s[e] = ok;
    any_admit |= ok;
  }
  const int any = __syncthreads_or(any_admit);   // also publishes admit_s

  // This thread's register tile: points p0 + tp*4 + i, queries q0 + tq*8 + jj.
  const int tq = t % kQG;
  const int tp = t / kQG;
  const float kInf = __int_as_float(0x7f800000);
  float* out_l = out + static_cast<int64_t>(l) * B * npts;

  // 2. No admitted leaf in the tile: +inf, no point is read.
  if (!any) {
#pragma unroll
    for (int jj = 0; jj < kTQ; ++jj) {
      const int j = tq * kTQ + jj;
      if (j >= nq) continue;
#pragma unroll
      for (int i = 0; i < kTP; ++i) {
        const int64_t p = p0 + tp * kTP + i;
        if (p < npts) out_l[static_cast<int64_t>(q0 + j) * npts + p] = kInf;
      }
    }
    return;
  }

  // 3. Exact distances for the admitted tile, full fp32.  Queries:
  // features [c0, c0 + qc), feature-major; |q_t|^2 carried on in order.
  float qq = 0.f;                           // threads t < kQ
  for (int e = t; e < qc * kQ; e += kThreads) {
    const int c = e / kQ;
    const int j = e - c * kQ;
    q_s[e] = (j < nq && c < d) ? q[static_cast<int64_t>(q0 + j) * d + c] : 0.f;
  }
  __syncthreads();
  if (t < kQ) {
    for (int c = 0; c < min(qc, d); ++c)
      qq = fmaf(q_s[c * kQ + t], q_s[c * kQ + t], qq);
    qq_s[t] = qq;
  }
  float acc[kTP][kTQ];
  float pp[kTP];
#pragma unroll
  for (int i = 0; i < kTP; ++i) {
    pp[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kTQ; ++jj) acc[i][jj] = 0.f;
  }
  // Staging: lane = feature, warp w = rows w, w + 8, ... of the tile.
  const int lane = t & 31;
  const int w = t >> 5;
  for (int k0 = 0; k0 < dp; k0 += kDC) {
    const bool col_ok = lane < min(kDC, d - k0);
    const float* src = points + (static_cast<int64_t>(l) * npts + p0 + w) * d
                       + k0 + lane;
    if constexpr (kWide) {
      if (k0 > 0 && k0 % kQC == 0) {        // the next query chunk
        __syncthreads();                    // q_s is free to overwrite
        for (int e = t; e < kQC * kQ; e += kThreads) {
          const int c = e / kQ;
          const int j = e - c * kQ;
          q_s[e] = (j < nq && k0 + c < d)
                       ? q[static_cast<int64_t>(q0 + j) * d + k0 + c] : 0.f;
        }
        __syncthreads();
        if (t < kQ) {                       // read after the next barrier
          for (int c = 0; c < min(kQC, d - k0); ++c)
            qq = fmaf(q_s[c * kQ + t], q_s[c * kQ + t], qq);
          qq_s[t] = qq;
        }
      }
    }
    const float* qk = q_s + (kWide ? k0 % kQC : k0) * kQ;
    __syncthreads();                        // p_s is free to overwrite
#pragma unroll 1
    for (int i0 = 0; i0 < kP / 8; i0 += 8) {   // 8 row loads in flight
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = w + 8 * (i0 + u);
        v[u] = (col_ok && p0 + r < npts)
                   ? src[static_cast<int64_t>(8 * (i0 + u)) * d] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) p_s[lane * kPS + w + 8 * (i0 + u)] = v[u];
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kDC; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(p_s + c * kPS + tp * kTP);
      const float4 qa = *reinterpret_cast<const float4*>(qk + c * kQ + tq * kTQ);
      const float4 qb = *reinterpret_cast<const float4*>(qk + c * kQ + tq * kTQ + 4);
      const float pr[kTP] = {pv.x, pv.y, pv.z, pv.w};
      const float qr[kTQ] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int i = 0; i < kTP; ++i) {
        pp[i] = fmaf(pr[i], pr[i], pp[i]);
#pragma unroll
        for (int jj = 0; jj < kTQ; ++jj) acc[i][jj] = fmaf(qr[jj], pr[i], acc[i][jj]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTP; ++i) {
    const int64_t p = p0 + tp * kTP + i;
    if (p >= npts) continue;
    const bool keep = point_valid[static_cast<int64_t>(l) * npts + p] &&
                      live[static_cast<int64_t>(l) * npts + p];
    const int lf = static_cast<int>(p / ls) - leaf0;
#pragma unroll
    for (int jj = 0; jj < kTQ; ++jj) {
      const int j = tq * kTQ + jj;
      if (j >= nq) continue;
      const bool hit = keep && admit_s[lf * kQ + j];
      out_l[static_cast<int64_t>(q0 + j) * npts + p] =
          hit ? sqrtf(fmaxf(qq_s[j] - 2.f * acc[i][jj] + pp[i], 0.f)) : kInf;
    }
  }
}

template <bool kHeads, bool kWide>
int launch_w(const float* q, const float* q_proj, const float* r_eff,
             const int32_t* leaf_lo, const int32_t* leaf_hi,
             const uint8_t* leaf_valid, const float* bp, const float* points,
             const uint8_t* point_valid, const uint8_t* live, float* out,
             int H, int L, int B, int d, int nl, int K, int E, int ls,
             void* stream) {
  const int64_t npts = static_cast<int64_t>(nl) * ls;
  const int n_qtiles = (B + kQ - 1) / kQ;
  const int64_t n_ptiles = (npts + kP - 1) / kP;
  const int64_t blocks = static_cast<int64_t>(H) * L * n_qtiles * n_ptiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = smem_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        range_rerank_kernel<kHeads, kWide>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  range_rerank_kernel<kHeads, kWide><<<static_cast<unsigned>(blocks),
                                       kThreads, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      q, q_proj, r_eff, leaf_lo, leaf_hi, leaf_valid, bp, points, point_valid,
      live, out, L, B, d, nl, K, E, ls, n_qtiles, n_ptiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool kHeads>
int launch(const float* q, const float* q_proj, const float* r_eff,
           const int32_t* leaf_lo, const int32_t* leaf_hi,
           const uint8_t* leaf_valid, const float* bp, const float* points,
           const uint8_t* point_valid, const uint8_t* live, float* out, int H,
           int L, int B, int d, int nl, int K, int E, int ls, void* stream) {
  if (H == 0 || L == 0 || B == 0 || static_cast<int64_t>(nl) * ls == 0)
    return 0;
  return d > kQC
      ? launch_w<kHeads, true>(q, q_proj, r_eff, leaf_lo, leaf_hi, leaf_valid,
                               bp, points, point_valid, live, out, H, L, B, d,
                               nl, K, E, ls, stream)
      : launch_w<kHeads, false>(q, q_proj, r_eff, leaf_lo, leaf_hi,
                                leaf_valid, bp, points, point_valid, live, out,
                                H, L, B, d, nl, K, E, ls, stream);
}

}  // namespace

// One forest: arrays as the kernel's comments give them.
extern "C" int range_rerank_launch(
    const float* q, const float* q_proj, const float* r_eff,
    const int32_t* leaf_lo, const int32_t* leaf_hi, const uint8_t* leaf_valid,
    const float* bp, const float* points, const uint8_t* point_valid,
    const uint8_t* live, float* out, int L, int B, int d, int nl, int K,
    int E, int ls, void* stream) {
  return launch<false>(q, q_proj, r_eff, leaf_lo, leaf_hi, leaf_valid, bp,
                       points, point_valid, live, out, 1, L, B, d, nl, K, E,
                       ls, stream);
}

// H forests in one launch: every array with a leading head axis H.
extern "C" int range_rerank_heads_launch(
    const float* q, const float* q_proj, const float* r_eff,
    const int32_t* leaf_lo, const int32_t* leaf_hi, const uint8_t* leaf_valid,
    const float* bp, const float* points, const uint8_t* point_valid,
    const uint8_t* live, float* out, int H, int L, int B, int d, int nl,
    int K, int E, int ls, void* stream) {
  return launch<true>(q, q_proj, r_eff, leaf_lo, leaf_hi, leaf_valid, bp,
                      points, point_valid, live, out, H, L, B, d, nl, K, E,
                      ls, stream);
}

extern "C" const char* range_rerank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
