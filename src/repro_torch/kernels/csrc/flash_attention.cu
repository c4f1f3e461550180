// flash_attention: exact softmax attention by online softmax, never holding
// the (sq, sk) score matrix.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _kernel).
//
// What it computes, per (batch*head bh, query row i < sq):
//   s_ij = (scale * q_i) . k_j over the key tiles j = 0, kBK, ..., with
//   s_ij = -1e30 where j >= sk or (causal and j > i) (top-left aligned);
//   running max m, sum l and accumulator acc in f32:
//     m' = max(m, max_j s_ij), alpha = exp(m - m'), p_ij = exp(s_ij - m'),
//     l = l * alpha + sum_j p_ij, acc = acc * alpha + sum_j p_ij v_j;
//   out_i = acc / max(l, 1e-30), cast to the input dtype (f32 or bf16).
// The TPU kernel's sequential k grid axis is the loop over key tiles inside
// the block; its (8, 128) padding of sq, sk and dh is gone: the block masks
// the ragged edges itself (rows past sq are not written, keys past sk get
// -1e30 and zero values, features past dh are zero).  A causal block stops
// at its last row's position: a tile past it is fully masked, and after the
// first tile (key 0 is always visible) such a tile changes nothing.
//
// What bounds it on an H100: operations, 4 * sq * sk * dh a head (halved
// when causal).  As built, the fp32 FMAs on the CUDA cores: both products
// run there in full f32, also for bf16 inputs (tensor cores through
// mma.sync / wgmma and TMA loads are later work), so a bf16 call stays far
// from the 989 TFLOP/s tensor-core bound.
//
// Design: one block of 256 threads per (bh, tile of kBQ = 64 query rows).
// q * scale sits feature-major in shared memory for the whole block; each
// key tile (kBK = 64 keys) is staged as k feature-major and v row-major, in
// f32 (bf16 widened once, at staging).  Thread (ty, tx) = (t / 16, t % 16)
// owns rows 4 ty .. 4 ty + 3: a 4 x 4 register tile of scores (columns
// 4 tx ..) and a 4 x 8 tile of the accumulator (features 8 tx ..).  Row max
// and sum reduce over the 16 lanes of a half-warp with shuffles.  The
// probabilities go through shared memory (key-major) to the P.V product.
// Shared memory: 120 KB at dh = 128 (so one block an SM), above the 48 KB
// default through cudaFuncSetAttribute.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;
constexpr int kTR = 4;          // rows per thread
constexpr int kTC = 4;          // score columns per thread
constexpr int kTD = 8;          // accumulator features per thread
constexpr int kMaxDh = 16 * kTD;
constexpr int kQS = kBQ + 4;    // row stride of the feature-major q / p tiles
constexpr int kKS = kBK + 4;    // row stride of the feature-major k tile
constexpr float kNegInf = -1e30f;
static_assert(kThreads == (kBQ / kTR) * 16 && kBK == 16 * kTC, "tiling");

__host__ __device__ inline int padded_dh(int dh) { return (dh + 7) / 8 * 8; }

size_t smem_bytes(int dh) {
  const size_t dp = padded_dh(dh);
  return sizeof(float) * (dp * kQS + dp * kKS + kBK * dp + kBK * kQS);
}

__device__ inline float load_f(const float* p) { return *p; }
__device__ inline float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ inline void store_f(float* p, float x) { *p = x; }
__device__ inline void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,      // (bh, sq, dh)
    const T* __restrict__ k,      // (bh, sk, dh)
    const T* __restrict__ v,      // (bh, sk, dh)
    T* __restrict__ out,          // (bh, sq, dh)
    int sq, int sk, int dh, int causal, float scale, int n_qtiles) {
  extern __shared__ float smem[];
  const int dp = padded_dh(dh);
  float* q_s = smem;                  // (dp, kQS) q * scale, feature-major
  float* k_s = q_s + dp * kQS;        // (dp, kKS) feature-major
  float* v_s = k_s + dp * kKS;        // (kBK, dp) row-major
  float* p_s = v_s + kBK * dp;        // (kBK, kQS) probabilities, key-major

  const int64_t bid = blockIdx.x;
  const int q0 = static_cast<int>(bid % n_qtiles) * kBQ;
  const int64_t bh = bid / n_qtiles;
  const T* qb = q + bh * sq * dh;
  const T* kb = k + bh * sk * dh;
  const T* vb = v + bh * sk * dh;
  T* ob = out + bh * sq * dh;
  const int t = threadIdx.x;
  const int ty = t / 16;
  const int tx = t % 16;

  for (int e = t; e < kBQ * dp; e += kThreads) {
    const int r = e / dp;
    const int c = e - r * dp;
    q_s[c * kQS + r] = (q0 + r < sq && c < dh)
        ? load_f(qb + static_cast<int64_t>(q0 + r) * dh + c) * scale : 0.f;
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
    __syncthreads();                  // the last tile's readers are done
    for (int e = t; e < kBK * dp; e += kThreads) {
      const int r = e / dp;
      const int c = e - r * dp;
      const bool ok = k0 + r < sk && c < dh;
      const int64_t off = static_cast<int64_t>(k0 + r) * dh + c;
      k_s[c * kKS + r] = ok ? load_f(kb + off) : 0.f;
      v_s[r * dp + c] = ok ? load_f(vb + off) : 0.f;
    }
    __syncthreads();

    // Scores of this thread's 4 rows x 4 keys.
    float s[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < dh; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + c * kQS + ty * kTR);
      const float4 ka = *reinterpret_cast<const float4*>(k_s + c * kKS + tx * kTC);
      const float qr[kTR] = {qa.x, qa.y, qa.z, qa.w};
      const float kr[kTC] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
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

    // acc += P . V for this thread's 4 rows x 8 features.
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
      const int c = tx * kTD + j;
      if (c < dh) store_f(ob + static_cast<int64_t>(row) * dh + c, acc[i][j] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int dh, int causal, float scale,
           cudaStream_t stream) {
  const int n_qtiles = (sq + kBQ - 1) / kBQ;
  const int64_t blocks = static_cast<int64_t>(bh) * n_qtiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = smem_bytes(dh);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_attention_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, dh, causal,
      scale, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (bh, sq, dh), k/v (bh, sk, dh), out (bh, sq, dh), all contiguous and of
// one dtype (bf16 != 0: bfloat16, else float32); 1 <= dh <= 128.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int sq, int sk, int dh, int causal,
                                      float scale, int bf16, void* stream) {
  if (dh < 1 || dh > kMaxDh) return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || sq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, out, bh, sq, sk, dh, causal,
                                      scale, s)
              : launch<float>(q, k, v, out, bh, sq, sk, dh, causal, scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
