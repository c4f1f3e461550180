// flash_attention: exact softmax attention by online softmax, never holding
// the (sq, sk) score matrix.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _kernel).
//
// What it computes, per (batch*head bh, query row i < sq):
//   s_ij = scale * (q_i . k_j) over the keys j < sk, skipping j > i when
//   causal (top-left aligned); running max m, sum l and accumulator acc in
//   f32: m' = max(m, max_j s_ij), alpha = exp(m - m'), p_ij = exp(s_ij - m'),
//   l = l * alpha + sum_j p_ij, acc = acc * alpha + sum_j p_ij v_j;
//   out_i = acc / max(l, 1e-30), rounded once to the input dtype (f32 or
//   bf16).  Any dh >= 1; the TPU kernel's (8, 128) padding of sq, sk and dh
//   is gone: every path masks the ragged edges itself.
//
// Three paths behind one wrapper (kernels/flash_attention.py picks one from
// the shape with a plain rule, `path`):
//
// 1. Split-key decode (sq <= 8, f32 or bf16, dh <= 4,096).  What bounds it:
//    bytes.  Each key and value row is read once, 2 * sk * dh * bytes a
//    head (2.15 GB at bh = 64, sk = 32,768, dh = 128 in f32: 0.64 ms at
//    3.35 TB/s), against 4 * sq * sk * dh operations.  One block per
//    (bh, 64-row query tile) would give bh blocks, each streaming a whole
//    head alone (64 blocks on 132 SMs at decode).  So the grid is
//    (bh, key split, feature chunk): ~1,024 blocks of 8 warps, each warp a
//    contiguous run of keys.  A warp reads its keys with 16-byte loads (one
//    key row per group of G lanes, 32 / G keys side by side, kU keys ahead
//    in flight), sums each score over its group with shuffles and keeps
//    its own (m, l, acc) per query row in registers; the sq <= 8 rows of
//    q * scale (widened to f32) sit in shared memory.  The block merges its
//    warps' partials in warp order through shared memory and writes one
//    partial (m, l, acc) per split in f32 to scratch the wrapper allocates;
//    a second launch merges a row's partials in split order and rounds
//    once.  Past one chunk of G * kVec features (128 in f32, 256 in
//    bf16) a feature-chunk grid axis splits the V columns; each chunk
//    recomputes the scores over all of dh, so m and l agree in every chunk.
//
// 2. bf16 prefill on the tensor cores (sq > 8, bf16, dh <= 256).  What
//    bounds it: operations, 4 * sq * sk * dh a head (halved when causal),
//    plus half again for the split of P below: 6.7 ms at 32,768 causal
//    tokens, 16 heads, dh = 128 at 989 TFLOP/s.  The FlashAttention-2 shape
//    with mma.sync.m16n8k16 (bf16 in, f32 accumulate): a block of 4 warps
//    takes 128 query rows, two 16-row tiles a warp, so that each K and V
//    fragment read from shared memory feeds two row tiles' products (64
//    rows, one tile a warp, at dh = 256, for registers).  The Q tile sits
//    in shared memory; key and value tiles of kN keys (64; 32 at dh = 256)
//    are double-buffered with 16-byte cp.async copies; fragments load with
//    ldmatrix (.trans for V).  Rows are padded by 16 bytes, so the 8 rows
//    one ldmatrix phase reads fall in 8 different bank groups.  S = Q K^T
//    accumulates in f32 and is scaled after the product (q stays exact in
//    bf16).  The online softmax runs on the C fragment in base 2 (exp2f):
//    row max over the 4-lane quad with shuffles, the row sum kept per lane
//    and reduced at the end.  The C fragment of S becomes the A fragment
//    of P V with no trip through shared memory.  P goes in as two bf16
//    terms, P_hi = bf16(p) and P_lo = bf16(p - P_hi), with O += P_hi V +
//    P_lo V: one bf16 rounding of p (2^-9 relative) would break the
//    one-rounding tolerance at long context; two terms leave 2^-17.  A
//    causal block stops after its last row's key tile and masks only the
//    tiles that cross its diagonal or the end of sk; blocks start with the
//    longest query tiles.  dh is zero-padded in shared memory to an
//    instance of 64, 128 or 256 features.
//
// 3. CUDA-core prefill (f32, and bf16 at dh > 256).  What bounds it:
//    operations on the fp32 FMA units (65.6 ms at the prefill widths in
//    f32).  One block of 256 threads per (bh, tile of kBQ = 64 query rows)
//    and, past dh = 128, per chunk of 128 output features (a second grid
//    axis).  q * scale and each key tile (kBK = 64 keys) are staged
//    feature-major in shared memory, v row-major for the block's output
//    features, in f32 (bf16 widened once, at staging).  Up to dh = 128 q
//    is staged once and each key tile whole; past it (a kWide instance, so
//    that the narrow one keeps its registers and speed) q and k go 128
//    features at a time within each key tile, and each score still sums
//    over all of dh in feature order, so every output chunk sees the same
//    m and l.  Thread (ty, tx) =
//    (t / 16, t % 16) owns rows 4 ty .. 4 ty + 3: a 4 x 4 register tile of
//    scores (columns 4 tx ..) and a 4 x 8 tile of the accumulator
//    (features 8 tx ..).  Row max and sum reduce over the 16 lanes of a
//    half-warp with shuffles.  The probabilities go through shared memory
//    (key-major) to the P.V product.  Shared memory: 120 KB at dh >= 128
//    (one block an SM), above the 48 KB default through
//    cudaFuncSetAttribute.  Its tensor-core redesign (3xTF32) is later
//    work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr size_t kMaxSmem = 232448;          // 227 KB a block on an H100
constexpr float kInf = __builtin_huge_valf();

__device__ inline float load_f(const float* p) { return *p; }
__device__ inline float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ inline void store_f(float* p, float x) { *p = x; }
__device__ inline void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// 1. Split-key decode
// ---------------------------------------------------------------------------

namespace decode {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// kVec elements of a row from p, widened to f32: one 16-byte load when
// kVec * sizeof(T) == 16 (the wrapper checks the alignment), else scalar.
template <int kVec, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[kVec]) {
  if constexpr (kVec == 4 && sizeof(T) == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (kVec == 8 && sizeof(T) == 2) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[2 * e] = __uint_as_float(w[e] << 16);
      x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) x[e] = load_f(p + e);
  }
}

// Rows kR >= sq of q; kVec features a lane a load; G lanes a key.
template <typename T, int kVec, int kR>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q,       // (bh, sq, dh)
    const T* __restrict__ k,       // (bh, sk, dh)
    const T* __restrict__ v,       // (bh, sk, dh)
    float* __restrict__ part_ml,   // (bh, P, sq, 2): m, l of each part
    float* __restrict__ part_acc,  // (bh, P, sq, dh)
    int sq, int sk, int dh, int causal, float scale, int keys_per_split,
    int G) {
  constexpr int kU = kR >= 8 ? 2 : 4;        // keys in flight a lane group
  extern __shared__ float q_s[];             // (kR, dq) q * scale, f32
  const int width = G * kVec;                // features one pass covers
  const int passes = (dh + width - 1) / width;
  const int dq = passes * width;
  const int64_t bh = blockIdx.x;
  const int split = blockIdx.y;
  const int P = gridDim.y;                   // partials of a row: splits
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int gi = lane / G;                   // the key of a group
  const int li = lane - gi * G;              // the lane within the group
  const int groups = 32 / G;

  for (int e = t; e < kR * dq; e += kThreads) {
    const int i = e / dq;
    const int c = e - i * dq;
    q_s[e] = (i < sq && c < dh)
        ? load_f(q + (bh * sq + i) * dh + c) * scale : 0.f;
  }
  __syncthreads();

  // This warp's keys: a contiguous run of its split, cut at the last key
  // any row sees (top-left causal: row i sees keys j <= i < sq).
  const int k_end = causal ? min(sk, sq) : sk;
  const int per_warp = (keys_per_split + kWarps - 1) / kWarps;
  const int ws = split * keys_per_split + warp * per_warp;
  const int w1 = min(k_end, min((split + 1) * keys_per_split,
                                ws + per_warp));
  const T* kb = k + bh * sk * dh;
  const T* vb = v + bh * sk * dh;
  const int cv = blockIdx.z * width + li * kVec;   // this lane's V features
  const bool v_ok = cv < dh;

  float m[kR], l[kR], acc[kR][kVec];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = -kInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;
  }

  for (int j0 = ws; j0 < w1; j0 += kU * groups) {
    float s[kU][kR];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int i = 0; i < kR; ++i) s[u][i] = 0.f;
    for (int r = 0; r < passes; ++r) {
      const int c = r * width + li * kVec;
      if (c >= dh) continue;           // kVec divides dh: whole vectors
      float kv[kU][kVec];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = j0 + u * groups + gi;
        if (j < w1) {
          load_vec<kVec>(kb + static_cast<int64_t>(j) * dh + c, kv[u]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kv[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        float qv[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) qv[e] = q_s[i * dq + c + e];
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int e = 0; e < kVec; ++e) s[u][i] = fmaf(qv[e], kv[u][e], s[u][i]);
      }
    }
    float vv[kU][kVec];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = j0 + u * groups + gi;
      if (j < w1 && v_ok) {
        load_vec<kVec>(vb + static_cast<int64_t>(j) * dh + cv, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) vv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int i = 0; i < kR; ++i)
        for (int o = G >> 1; o > 0; o >>= 1)
          s[u][i] += __shfl_xor_sync(0xffffffffu, s[u][i], o);

    // Online softmax over this group's kU keys, in key order.
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      bool ok[kU];
      float mx = m[i];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = j0 + u * groups + gi;
        ok[u] = j < w1 && !(causal && j > i);
        if (ok[u]) mx = fmaxf(mx, s[u][i]);
      }
      if (mx == -kInf) continue;               // no key of the row here
      const float alpha = expf(m[i] - mx);      // 0 while m is -inf
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (!ok[u]) continue;
        const float p = expf(s[u][i] - mx);
        l[i] += p;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][e] = fmaf(p, vv[u][e], acc[i][e]);
      }
      m[i] = mx;
    }
  }

  // Merge the warp's key groups (lanes G apart), then lanes < G write the
  // warp's partial.  Both lanes of a pair compute the same sums.
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], o);
      const float mm = fmaxf(m[i], mo);
      const float a = m[i] == -kInf ? 0.f : expf(m[i] - mm);
      const float b = mo == -kInf ? 0.f : expf(mo - mm);
      l[i] = l[i] * a + lo * b;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[i][e], o);
        acc[i][e] = acc[i][e] * a + ao * b;
      }
      m[i] = mm;
    }
  }
  // Lanes < G put the warp's partial in shared memory; the block merges
  // its warps' partials in warp order and writes the split's partial.
  const int ws2 = width + 2;                 // acc[width], m, l
  float* mrg = q_s + kR * dq;                // (kWarps, kR, ws2)
  if (gi == 0) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float* r = mrg + (warp * kR + i) * ws2;
#pragma unroll
      for (int e = 0; e < kVec; ++e) r[li * kVec + e] = acc[i][e];
      if (li == 0) {
        r[width] = m[i];
        r[width + 1] = l[i];
      }
    }
  }
  __syncthreads();
  const int64_t part = bh * P + split;
  for (int idx = t; idx < min(kR, sq) * width; idx += kThreads) {
    const int i = idx / width;
    const int f = idx - i * width;
    float mm = -kInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mm = fmaxf(mm, mrg[(w * kR + i) * ws2 + width]);
    float lw = 0.f, aw = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* r = mrg + (w * kR + i) * ws2;
      const float wt = r[width] == -kInf ? 0.f : expf(r[width] - mm);
      lw = fmaf(r[width + 1], wt, lw);
      aw = fmaf(r[f], wt, aw);
    }
    const int64_t row = part * sq + i;
    const int c = blockIdx.z * width + f;
    if (c < dh) part_acc[row * dh + c] = aw;
    if (f == 0 && blockIdx.z == 0) {
      part_ml[2 * row] = mm;
      part_ml[2 * row + 1] = lw;
    }
  }
}

// One block per (bh, row): merge the P partials in order p = 0 .. P-1 and
// round once to the output dtype.
template <typename T>
__global__ void __launch_bounds__(128) combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    T* __restrict__ out, int sq, int dh, int P) {
  const int64_t row = blockIdx.x;            // bh * sq + i
  const int64_t bh = row / sq;
  const int i = static_cast<int>(row - bh * sq);
  const float* ml = part_ml + (bh * P * sq + i) * 2;
  const float* pa = part_acc + (bh * P * sq + i) * dh;
  float mm = -kInf;
  for (int p = 0; p < P; ++p) mm = fmaxf(mm, ml[2 * p * sq]);
  for (int c = threadIdx.x; c < dh; c += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int p = 0; p < P; ++p) {
      const float mp = ml[2 * p * sq];
      if (mp == -kInf) continue;               // a part that saw no key
      const float w = expf(mp - mm);
      l = fmaf(ml[2 * p * sq + 1], w, l);
      a = fmaf(pa[static_cast<int64_t>(p) * sq * dh + c], w, a);
    }
    store_f(out + row * dh + c, a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int kVec, int kR>
cudaError_t launch_rows(const T* q, const T* k, const T* v, float* part_ml,
                        float* part_acc, int bh, int sq, int sk, int dh,
                        int causal, float scale, int n_splits,
                        int keys_per_split, cudaStream_t stream) {
  int G = 1;                                   // lanes a key row
  while (G < 32 && G * kVec < dh) G <<= 1;
  const int width = G * kVec;
  const int chunks = (dh + width - 1) / width;
  const size_t smem = sizeof(float) * kR * (chunks * width
                                            + kWarps * (width + 2));
  const cudaError_t err = allow_smem(split_kernel<T, kVec, kR>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, n_splits, chunks);
  split_kernel<T, kVec, kR><<<grid, kThreads, smem, stream>>>(
      q, k, v, part_ml, part_acc, sq, sk, dh, causal, scale, keys_per_split,
      G);
  return cudaGetLastError();
}

template <typename T, int kVec>
cudaError_t launch_vec(const T* q, const T* k, const T* v, float* part_ml,
                       float* part_acc, int bh, int sq, int sk, int dh,
                       int causal, float scale, int n_splits,
                       int keys_per_split, cudaStream_t stream) {
  if (sq == 1)
    return launch_rows<T, kVec, 1>(q, k, v, part_ml, part_acc, bh, sq, sk, dh,
                                   causal, scale, n_splits, keys_per_split,
                                   stream);
  if (sq <= 4)
    return launch_rows<T, kVec, 4>(q, k, v, part_ml, part_acc, bh, sq, sk, dh,
                                   causal, scale, n_splits, keys_per_split,
                                   stream);
  return launch_rows<T, kVec, 8>(q, k, v, part_ml, part_acc, bh, sq, sk, dh,
                                 causal, scale, n_splits, keys_per_split,
                                 stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* scratch, int bh, int sq, int sk, int dh, int causal,
                   float scale, int n_splits, int keys_per_split, int vec,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int64_t parts = static_cast<int64_t>(bh) * n_splits * sq;
  float* part_ml = scratch;
  float* part_acc = scratch + 2 * parts;
  constexpr int kWide = 16 / sizeof(T);
  const cudaError_t err =
      vec ? launch_vec<T, kWide>(qt, kt, vt, part_ml, part_acc, bh, sq, sk,
                                 dh, causal, scale, n_splits, keys_per_split,
                                 stream)
          : launch_vec<T, 1>(qt, kt, vt, part_ml, part_acc, bh, sq, sk, dh,
                             causal, scale, n_splits, keys_per_split, stream);
  if (err != cudaSuccess) return err;
  combine_kernel<T><<<static_cast<unsigned>(static_cast<int64_t>(bh) * sq),
                      128, 0, stream>>>(part_ml, part_acc,
                                        static_cast<T*>(out), sq, dh,
                                        n_splits);
  return cudaGetLastError();
}

}  // namespace decode

// ---------------------------------------------------------------------------
// 2. bf16 prefill on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------

namespace mma {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <int kD>
struct Tile {
  static constexpr int kM = kD <= 128 ? 2 : 1;     // 16-row tiles a warp
  static constexpr int kBQ = kWarps * 16 * kM;     // query rows a block
  static constexpr int kN = kD >= 256 ? 32 : 64;   // keys a tile
  static constexpr int kS = kD + 8;                // row stride, +16 bytes
  static constexpr size_t kSmem = sizeof(bf16) * (kBQ + 4 * kN) * kS;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// p0, p1 (two neighbouring columns of one row) as the hi and lo bf16 terms.
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(p0);
  const bf16 h1 = __float2bfloat16_rn(p1);
  hi = pack(h0, h1);
  lo = pack(__float2bfloat16_rn(p0 - __bfloat162float(h0)),
            __float2bfloat16_rn(p1 - __bfloat162float(h1)));
}

// Rows [r0, r0 + rows) of a (n_rows, dh) matrix into dst (rows, kS), zero
// past n_rows and dh: 16-byte cp.async copies when dh % 8 == 0 and the
// base is 16-byte aligned, else plain loads and stores.
template <int kD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int r0,
                                      int rows, int n_rows, int dh,
                                      bool aligned) {
  constexpr int kC = kD / 8;
  constexpr int kS = Tile<kD>::kS;
  for (int e = threadIdx.x; e < rows * kC; e += kThreads) {
    const int r = e / kC;
    const int c = (e - r * kC) * 8;
    const int row = r0 + r;
    bf16* d = dst + r * kS + c;
    if (aligned) {
      const bool ok = row < n_rows && c < dh;
      cp_async16(d, ok ? src + static_cast<int64_t>(row) * dh + c : src, ok);
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x)
        d[x] = (row < n_rows && c + x < dh)
                   ? src[static_cast<int64_t>(row) * dh + c + x]
                   : __float2bfloat16(0.f);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads) flash_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int sq, int sk,
    int dh, int causal, float scale, int aligned) {
  constexpr int kM = Tile<kD>::kM;
  constexpr int kBQ = Tile<kD>::kBQ;
  constexpr int kN = Tile<kD>::kN;
  constexpr int kS = Tile<kD>::kS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);    // (kBQ, kS)
  bf16* k_s = q_s + kBQ * kS;                        // 2 x (kN, kS)
  bf16* v_s = k_s + 2 * kN * kS;                     // 2 x (kN, kS)

  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest tiles first
  const bf16* qb = q + bh * sq * dh;
  const bf16* kb = k + bh * sk * dh;
  const bf16* vb = v + bh * sk * dh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;                     // fragment row (and row + 8)
  const int tig = lane & 3;                    // fragment column pair
  const int row0 = q0 + warp * 16 * kM + g;    // row of tile mt: + 16 mt
  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  const int n_tiles = (k_end + kN - 1) / kN;

  stage<kD>(q_s, qb, q0, kBQ, sq, dh, aligned);
  if (n_tiles > 0) {
    stage<kD>(k_s, kb, 0, kN, sk, dh, aligned);
    stage<kD>(v_s, vb, 0, kN, sk, dh, aligned);
  }
  cp_async_commit();

  float o[kM][kD / 8][4];
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = -kInf;
      l[mt][h] = 0.f;
    }
  }

  // ldmatrix row addresses of this lane (see the fragment layouts of
  // mma.m16n8k16): A rows (lane & 7) + 8 * bit 3, columns + 8 * bit 4; B
  // from K: keys (lane & 7) + 8 * bit 4, features + 8 * bit 3; B from V
  // (.trans): keys (lane & 7) + 8 * bit 3, features + 8 * bit 4.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int kb_row = (lane & 7) + (lane >> 4) * 8;
  const int kb_col = ((lane >> 3) & 1) * 8;
  const bf16* qa = q_s + (warp * 16 * kM + a_row) * kS + a_col;
  const float scale2 = scale * 1.4426950408889634f;   // scale * log2(e)

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      stage<kD>(k_s + (buf ^ 1) * kN * kS, kb, (it + 1) * kN, kN, sk, dh,
                aligned);
      stage<kD>(v_s + (buf ^ 1) * kN * kS, vb, (it + 1) * kN, kN, sk, dh,
                aligned);
    }
    cp_async_commit();
    cp_async_wait_one();                       // tile `it` (and Q) landed
    __syncthreads();
    const bf16* ks = k_s + buf * kN * kS;
    const bf16* vs = v_s + buf * kN * kS;
    const int k0 = it * kN;

    // S = Q K^T for this warp's kM x 16 rows x kN keys, f32; each K
    // fragment feeds kM products.
    float s[kM][kN / 8][4];
#pragma unroll
    for (int mt = 0; mt < kM; ++mt)
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[kM][4];
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) ldsm_x4(a[mt], qa + mt * 16 * kS + kk * 16);
#pragma unroll
      for (int nn = 0; nn < kN / 16; ++nn) {
        uint32_t b[4];
        ldsm_x4(b, ks + (nn * 16 + kb_row) * kS + kk * 16 + kb_col);
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) {
          mma16816(s[mt][2 * nn], a[mt], b[0], b[1]);
          mma16816(s[mt][2 * nn + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // Scale, mask (only tiles across the diagonal or past sk), online
    // softmax on the fragment: elements e < 2 are row g, e >= 2 row g + 8.
    // Scores, m and the exponents are kept in base 2 (scale * log2(e)
    // folded into one multiply), so each p is one exp2f.
    const bool edge = k0 + kN > sk || (causal && k0 + kN - 1 > q0);
#pragma unroll
    for (int mt = 0; mt < kM; ++mt) {
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][n][e] * scale2;
          if (edge) {
            const int col = k0 + n * 8 + tig * 2 + (e & 1);
            const int row = row0 + mt * 16 + (e >> 1) * 8;
            if (col >= sk || (causal && col > row)) x = -kInf;
          }
          s[mt][n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        base[h] = mx[h] == -kInf ? 0.f : mx[h];
        const float alpha = exp2f(m[mt][h] - base[h]);   // 0 while m is -inf
        m[mt][h] = mx[h];
        l[mt][h] *= alpha;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          o[mt][n][2 * h] *= alpha;
          o[mt][n][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[mt][n][e] - base[e >> 1]);
          s[mt][n][e] = p;
          l[mt][e >> 1] += p;
        }
    }

    // O += P_hi V + P_lo V; S's C fragments are P's A fragments, and each
    // V fragment feeds 2 * kM products.
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t ph[kM][4], pl[kM][4];
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) {
        split2(s[mt][2 * kk][0], s[mt][2 * kk][1], ph[mt][0], pl[mt][0]);
        split2(s[mt][2 * kk][2], s[mt][2 * kk][3], ph[mt][1], pl[mt][1]);
        split2(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1], ph[mt][2],
               pl[mt][2]);
        split2(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3], ph[mt][3],
               pl[mt][3]);
      }
#pragma unroll
      for (int dd = 0; dd < kD / 16; ++dd) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + (kk * 16 + a_row) * kS + dd * 16 + a_col);
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) {
          mma16816(o[mt][2 * dd], ph[mt], b[0], b[1]);
          mma16816(o[mt][2 * dd], pl[mt], b[0], b[1]);
          mma16816(o[mt][2 * dd + 1], ph[mt], b[2], b[3]);
          mma16816(o[mt][2 * dd + 1], pl[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();                           // buffers free to refill
  }

#pragma unroll
  for (int mt = 0; mt < kM; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[mt][h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      const int row = row0 + mt * 16 + h * 8;
      if (row >= sq) continue;
      const float inv = 1.f / fmaxf(lh, 1e-30f);
      bf16* orow = out + (bh * sq + row) * dh;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + tig * 2 + e;
          if (c < dh) orow[c] = __float2bfloat16(o[mt][n][2 * h + e] * inv);
        }
    }
}

template <int kD>
cudaError_t launch_d(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                     int bh, int sq, int sk, int dh, int causal, float scale,
                     int aligned, cudaStream_t stream) {
  const cudaError_t err = allow_smem(flash_mma_kernel<kD>, Tile<kD>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + Tile<kD>::kBQ - 1) / Tile<kD>::kBQ);
  flash_mma_kernel<kD><<<grid, kThreads, Tile<kD>::kSmem, stream>>>(
      q, k, v, out, sq, sk, dh, causal, scale, aligned);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int sq, int sk, int dh, int causal, float scale,
                   int aligned, cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  bf16* ot = static_cast<bf16*>(out);
  if (dh <= 64)
    return launch_d<64>(qt, kt, vt, ot, bh, sq, sk, dh, causal, scale,
                        aligned, stream);
  if (dh <= 128)
    return launch_d<128>(qt, kt, vt, ot, bh, sq, sk, dh, causal, scale,
                         aligned, stream);
  if (dh <= 256)
    return launch_d<256>(qt, kt, vt, ot, bh, sq, sk, dh, causal, scale,
                         aligned, stream);
  return cudaErrorInvalidValue;
}

}  // namespace mma

// ---------------------------------------------------------------------------
// 3. CUDA-core prefill
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;
constexpr int kTR = 4;          // rows per thread
constexpr int kTC = 4;          // score columns per thread
constexpr int kTD = 8;          // accumulator features per thread
constexpr int kDC = 16 * kTD;   // features staged at once, and per chunk
constexpr int kQS = kBQ + 4;    // row stride of the feature-major q / p tiles
constexpr int kKS = kBK + 4;    // row stride of the feature-major k tile
constexpr float kNegInf = -1e30f;
static_assert(kThreads == (kBQ / kTR) * 16 && kBK == 16 * kTC, "tiling");

// Features staged at once: dh rounded up to 8, at most kDC.
__host__ __device__ inline int staged_dh(int dh) {
  return min((dh + 7) / 8 * 8, kDC);
}

size_t smem_bytes(int dh) {
  const size_t dp = staged_dh(dh);
  return sizeof(float) * (dp * kQS + dp * kKS + kBK * dp + kBK * kQS);
}

// kWide false: dh <= kDC, q staged once for the block and each key tile
// whole; true: q and k staged kDC features at a time within each key tile,
// v for the block's output chunk (blockIdx.y).
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads) flash_simt_kernel(
    const T* __restrict__ q,      // (bh, sq, dh)
    const T* __restrict__ k,      // (bh, sk, dh)
    const T* __restrict__ v,      // (bh, sk, dh)
    T* __restrict__ out,          // (bh, sq, dh)
    int sq, int sk, int dh, int causal, float scale, int n_qtiles) {
  extern __shared__ float smem[];
  const int dp = staged_dh(dh);
  float* q_s = smem;                  // (dp, kQS) q * scale, feature-major
  float* k_s = q_s + dp * kQS;        // (dp, kKS) feature-major
  float* v_s = k_s + dp * kKS;        // (kBK, dp) row-major, output chunk
  float* p_s = v_s + kBK * dp;        // (kBK, kQS) probabilities, key-major

  const int64_t bid = blockIdx.x;
  const int q0 = static_cast<int>(bid % n_qtiles) * kBQ;
  const int64_t bh = bid / n_qtiles;
  const int f0 = kWide ? blockIdx.y * kDC : 0;   // output features from f0
  const T* qb = q + bh * sq * dh;
  const T* kb = k + bh * sk * dh;
  const T* vb = v + bh * sk * dh;
  T* ob = out + bh * sq * dh;
  const int t = threadIdx.x;
  const int ty = t / 16;
  const int tx = t % 16;

  if constexpr (!kWide) {
    for (int e = t; e < kBQ * dp; e += kThreads) {
      const int r = e / dp;
      const int c = e - r * dp;
      q_s[c * kQS + r] = (q0 + r < sq && c < dh)
          ? load_f(qb + static_cast<int64_t>(q0 + r) * dh + c) * scale : 0.f;
    }
  }

  float m[kTR], l[kTR], acc[kTR][kTD];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kTD; ++j) acc[i][j] = 0.f;
  }
  const bool has_cols = tx * kTD < dp;
  const int k_end = causal ? min(sk, q0 + kBQ) : sk;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    // Scores of this thread's 4 rows x 4 keys, summed over all of dh in
    // feature order.
    float s[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += kDC) {
      __syncthreads();                // the last tile's readers are done
      if constexpr (kWide) {
        for (int e = t; e < kBQ * dp; e += kThreads) {
          const int r = e / dp;
          const int c = e - r * dp;
          q_s[c * kQS + r] = (q0 + r < sq && c0 + c < dh)
              ? load_f(qb + static_cast<int64_t>(q0 + r) * dh + c0 + c) * scale
              : 0.f;
        }
      }
      for (int e = t; e < kBK * dp; e += kThreads) {
        const int r = e / dp;
        const int c = e - r * dp;
        const bool row_ok = k0 + r < sk;
        const int64_t off = static_cast<int64_t>(k0 + r) * dh;
        k_s[c * kKS + r] = row_ok && c0 + c < dh ? load_f(kb + off + c0 + c)
                                                  : 0.f;
        if (c0 == 0)
          v_s[r * dp + c] = row_ok && f0 + c < dh ? load_f(vb + off + f0 + c)
                                                   : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < (kWide ? min(kDC, dh - c0) : dh); ++c) {
        const float4 qa = *reinterpret_cast<const float4*>(q_s + c * kQS + ty * kTR);
        const float4 ka = *reinterpret_cast<const float4*>(k_s + c * kKS + tx * kTC);
        const float qr[kTR] = {qa.x, qa.y, qa.z, qa.w};
        const float kr[kTC] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < kTC; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
      }
      if constexpr (!kWide) break;    // one pass holds all of dh
    }

    // Mask, then the online-softmax update of each row.
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int row = q0 + ty * kTR + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int col = k0 + tx * kTC + j;
        if (col >= sk || (causal && col > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kTD; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kTC; ++j)
      *reinterpret_cast<float4*>(p_s + (tx * kTC + j) * kQS + ty * kTR) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P . V for this thread's 4 rows x 8 features of the chunk.
    if (has_cols) {
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 pa = *reinterpret_cast<const float4*>(p_s + kk * kQS + ty * kTR);
        const float4 va = *reinterpret_cast<const float4*>(v_s + kk * dp + tx * kTD);
        const float4 vc = *reinterpret_cast<const float4*>(v_s + kk * dp + tx * kTD + 4);
        const float pr[kTR] = {pa.x, pa.y, pa.z, pa.w};
        const float vr[kTD] = {va.x, va.y, va.z, va.w, vc.x, vc.y, vc.z, vc.w};
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < kTD; ++j) acc[i][j] = fmaf(pr[i], vr[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int row = q0 + ty * kTR + i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kTD; ++j) {
      const int c = f0 + tx * kTD + j;
      if (c < dh) store_f(ob + static_cast<int64_t>(row) * dh + c, acc[i][j] / den);
    }
  }
}

template <typename T, bool kWide>
cudaError_t launch_w(const void* q, const void* k, const void* v, void* out,
                     int bh, int sq, int sk, int dh, int causal, float scale,
                     cudaStream_t stream) {
  const int n_qtiles = (sq + kBQ - 1) / kBQ;
  const int64_t blocks = static_cast<int64_t>(bh) * n_qtiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(dh);
  const cudaError_t err = allow_smem(flash_simt_kernel<T, kWide>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), (dh + kDC - 1) / kDC);
  flash_simt_kernel<T, kWide><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, dh, causal,
      scale, n_qtiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int sq, int sk, int dh, int causal, float scale,
                   cudaStream_t stream) {
  return dh <= kDC ? launch_w<T, false>(q, k, v, out, bh, sq, sk, dh, causal,
                                        scale, stream)
                   : launch_w<T, true>(q, k, v, out, bh, sq, sk, dh, causal,
                                       scale, stream);
}

}  // namespace simt

// Grid axes y and z hold at most 65,535 blocks: query tiles (tensor-core
// path), key splits and feature chunks.
bool bad_grid(int sq, int dh) {
  return (sq + 63) / 64 > 65535 || dh < 1 || (dh + 127) / 128 > 65535;
}

}  // namespace

// The split-key decode path: q (bh, sq, dh), k/v (bh, sk, dh), out
// (bh, sq, dh), contiguous, of one dtype (bf16 != 0: bfloat16, else
// float32); 1 <= sq <= 8.  scratch holds bh * n_splits * sq * (dh + 2)
// floats; keys [s * keys_per_split, (s + 1) * keys_per_split) go to split
// s.  vec != 0: dh is a multiple of 16 bytes' elements and every base
// pointer 16-byte aligned.  Two launches: the splits, then the combine.
extern "C" int flash_attention_decode_launch(
    const void* q, const void* k, const void* v, void* out, float* scratch,
    int bh, int sq, int sk, int dh, int causal, float scale, int bf16,
    int n_splits, int keys_per_split, int vec, void* stream) {
  if (sq < 1 || sq > 8 || n_splits < 1 || n_splits > 65535 ||
      keys_per_split < 1 || bad_grid(sq, dh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? decode::launch<__nv_bfloat16>(q, k, v, out, scratch, bh, sq, sk,
                                           dh, causal, scale, n_splits,
                                           keys_per_split, vec, s)
           : decode::launch<float>(q, k, v, out, scratch, bh, sq, sk, dh,
                                   causal, scale, n_splits, keys_per_split,
                                   vec, s);
  return static_cast<int>(err);
}

// The prefill paths: tensor_cores != 0 runs the bf16 mma.sync kernel
// (bf16 only, dh <= 256; aligned != 0: dh % 8 == 0 and 16-byte aligned
// bases, for cp.async), else the CUDA-core kernel (any dtype, any dh).
extern "C" int flash_attention_prefill_launch(
    const void* q, const void* k, const void* v, void* out, int bh, int sq,
    int sk, int dh, int causal, float scale, int bf16, int tensor_cores,
    int aligned, void* stream) {
  if (bad_grid(sq, dh) || (tensor_cores && (!bf16 || dh > 256)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || sq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tensor_cores)
    err = mma::launch(q, k, v, out, bh, sq, sk, dh, causal, scale, aligned, s);
  else if (bf16)
    err = simt::launch<__nv_bfloat16>(q, k, v, out, bh, sq, sk, dh, causal,
                                      scale, s);
  else
    err = simt::launch<float>(q, k, v, out, bh, sq, sk, dh, causal, scale, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
