// l2_rerank: exact Euclidean distances between query rows and candidate
// rows, per group.
//
// Replaces the TPU kernel src/repro/kernels/l2_rerank.py:l2_rerank (body
// _kernel), which the reference's vmap engine runs once per query lane
// under jax.vmap (b = 1); here the lanes are the group axis of one launch.
//
// What it computes: q (G, b, d), c (G, m, d), f32 or bf16 (upcast to f32)
// -> out (G, b, m) f32, out[g, i, j] = sqrt(max(|q_i|^2 - 2 q_i.c_j +
// |c_j|^2, 0)), the TPU kernel's form.
//
// What bounds it on an H100: memory.  On the vmap path (b = 1, m = L*M*ls
// = 2,048 candidates of d = 128 per lane) each candidate byte takes part in
// 2 FLOPs of q.c plus 2 of c.c: a GEMV per lane, ~0.5 FLOP per byte, far
// below the fp32 ridge (~20 FLOP/byte), so the bound is reading c once.
//
// Design: one block per (group, query, tile of kC = 64 candidates), the
// query fastest in the linear block index so the blocks that share a
// candidate tile run together and find it in L2.  The block holds its query
// row (as f32) and |q|^2 in shared memory.  Each warp takes R = 4 candidate
// rows at a time and streams them with 16-byte loads (4 f32 or 8 bf16 a
// lane, when d and the base addresses allow; else coalesced 4- or 2-byte
// loads), all R rows' loads issued before any arithmetic.  A lane
// accumulates c.c and q.c in fp32 on the CUDA cores (no TF32, no tensor
// cores: this is bandwidth work and the T2 test best <= c*r reads these
// distances), then a butterfly of shuffles sums the lanes.  Every caller
// of the port sends b = 1; a larger b runs as b query rows of this GEMV.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kC = 64;          // candidates per block
constexpr int kR = 4;           // candidate rows per warp step

__device__ inline float to_f(float v) { return v; }
__device__ inline float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// N consecutive elements at p as floats: one 16-byte load when N fills it.
template <int N>
__device__ inline void load_row(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) out[u] = __ldg(p + u);
  }
}

template <int N>
__device__ inline void load_row(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(h[u]);
      out[2 * u] = f.x;
      out[2 * u + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) out[u] = __bfloat162float(p[u]);
  }
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) l2_rerank_kernel(
    const T* __restrict__ q,       // (G, b, d)
    const T* __restrict__ c,       // (G, m, d)
    float* __restrict__ out,       // (G, b, m)
    int b, int m, int d, int64_t n_ctiles) {
  extern __shared__ float smem[];
  float* q_s = smem;                        // (d,)
  float* qq_s = q_s + d;                    // (1,)

  const int64_t bid = blockIdx.x;
  const int i = static_cast<int>(bid % b);
  const int64_t ct = (bid / b) % n_ctiles;
  const int64_t g = bid / (static_cast<int64_t>(b) * n_ctiles);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  const T* qg = q + (g * b + i) * d;
  for (int e = t; e < d; e += kThreads) q_s[e] = to_f(qg[e]);
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int e = lane; e < d; e += 32) s = fmaf(q_s[e], q_s[e], s);
    s = warp_sum(s);
    if (lane == 0) qq_s[0] = s;
  }
  __syncthreads();
  const float qq = qq_s[0];

  const T* cg = c + g * m * d;
  float* og = out + (g * b + i) * static_cast<int64_t>(m);
  const int64_t j_end = min(static_cast<int64_t>(m), (ct + 1) * kC);
  for (int64_t j0 = ct * kC + warp * kR; j0 < j_end; j0 += kWarps * kR) {
    float cc[kR], qc[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) cc[r] = qc[r] = 0.f;
    for (int e0 = lane * N; e0 < d; e0 += 32 * N) {
      float v[kR][N];
#pragma unroll
      for (int r = 0; r < kR; ++r) {         // every row's load in flight
        if (j0 + r < j_end) {
          load_row<N>(cg + (j0 + r) * d + e0, v[r]);
        } else {
#pragma unroll
          for (int u = 0; u < N; ++u) v[r][u] = 0.f;
        }
      }
      float qv[N];
#pragma unroll
      for (int u = 0; u < N; ++u) qv[u] = q_s[e0 + u];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int u = 0; u < N; ++u) {
          cc[r] = fmaf(v[r][u], v[r][u], cc[r]);
          qc[r] = fmaf(qv[u], v[r][u], qc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float ccr = warp_sum(cc[r]);
      const float qcr = warp_sum(qc[r]);
      if (lane == 0 && j0 + r < j_end) {
        og[j0 + r] = sqrtf(fmaxf(qq - 2.f * qcr + ccr, 0.f));
      }
    }
  }
}

template <typename T, int N>
int launch(const void* q, const void* c, float* out, int G, int b, int m,
           int d, cudaStream_t stream) {
  const int64_t n_ctiles = (static_cast<int64_t>(m) + kC - 1) / kC;
  const int64_t blocks = static_cast<int64_t>(G) * b * n_ctiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = sizeof(float) * (static_cast<size_t>(d) + 1);
  auto kernel = l2_rerank_kernel<T, N>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(c), out, b, m, d,
      n_ctiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: inputs are __nv_bfloat16, else float.  vec: d and both base
// addresses allow 16-byte row loads.
extern "C" int l2_rerank_launch(const void* q, const void* c, float* out,
                                int G, int b, int m, int d, int bf16, int vec,
                                void* stream) {
  if (static_cast<int64_t>(G) * b * m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return vec ? launch<__nv_bfloat16, 8>(q, c, out, G, b, m, d, s)
               : launch<__nv_bfloat16, 1>(q, c, out, G, b, m, d, s);
  }
  return vec ? launch<float, 4>(q, c, out, G, b, m, d, s)
             : launch<float, 1>(q, c, out, G, b, m, d, s);
}

extern "C" const char* l2_rerank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
