// Shared pieces of the hop-1 kernels (hop1_fwd.cu, hop1_bwd.cu): grid loads
// in float32 or bfloat16, and the register-tiled product of a block of rows
// with one or two weight matrices staged through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hop1 {

constexpr int kThreads = 256;
constexpr int kRM = 8;                // rows per thread in rows x W
constexpr int kAlign = 8;             // row tiles are multiples of this
constexpr int kMaxD = 512;
constexpr float kMaskedScore = -1e9f; // the reference's masked logit
constexpr size_t kSmemLimit = 232448;        // shared memory a block may use
constexpr size_t kSmemTarget = 113 * 1024;   // two blocks per SM

// Widths both kernels take: D <= 512, a multiple of 8, D / h a multiple of 4.
inline bool widths_ok(int D, int h) {
  return h >= 1 && D <= kMaxD && D % kAlign == 0 && D % h == 0 && (D / h) % 4 == 0;
}

// 4 consecutive grid elements as float32 (16-byte or 8-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  __nv_bfloat162 v[2];
  *reinterpret_cast<uint2*>(v) = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(v[0]), b = __bfloat1622float2(v[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// weight rows per staged chunk: 2 weights x kc x N <= 2048 floats
__host__ __device__ constexpr int chunk_rows(int N) {
  return N <= 128 ? 8 : N <= 256 ? 4 : 2;
}

// Load chunk rows [d0, d0 + kc) of NW weights of row length N (float4s, <= 2
// per thread).
template <int NW>
__device__ __forceinline__ void stage_load(float4 (&r)[2], const float* w0,
                                           const float* w1, int N, int kc, int d0) {
  const int n4 = kc * N / 4;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i = threadIdx.x + s * kThreads;
    if (i < NW * n4) {
      const float* w = (i < n4 ? w0 : w1) + (size_t)d0 * N;
      r[s] = __ldg(reinterpret_cast<const float4*>(w) + i % n4);
    }
  }
}

template <int NW>
__device__ __forceinline__ void stage_store(const float4 (&r)[2], float* buf,
                                            int N, int kc) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i = threadIdx.x + s * kThreads;
    if (i < NW * kc * N / 4) reinterpret_cast<float4*>(buf)[i] = r[s];
  }
}

// acc[m][i][j] += sum_d a_t[d * lda + r0 + i] * W_m[d][c + j] over d < K, for
// W_0 = w0, W_1 = w1 (K x N, row-major).  Every thread of the block calls it
// (it stages the weights through w_s, 2 x NW x kc x N floats); only `active`
// threads accumulate.  a_t holds the rows transposed (K x lda), lda and r0
// multiples of 4.
template <int NW>
__device__ __forceinline__ void rows_times_w(const float* __restrict__ a_t, int lda,
                                             int r0, bool active,
                                             const float* __restrict__ w0,
                                             const float* __restrict__ w1, int K,
                                             int N, float* __restrict__ w_s, int c,
                                             float (&acc)[NW][kRM][2]) {
  const int kc = chunk_rows(N);
  const int nchunk = K / kc;
  float4 st[2];
  stage_load<NW>(st, w0, w1, N, kc, 0);
  for (int ci = 0; ci < nchunk; ++ci) {
    float* buf = w_s + (ci & 1) * (NW * kc * N);
    stage_store<NW>(st, buf, N, kc);
    __syncthreads();
    if (ci + 1 < nchunk) stage_load<NW>(st, w0, w1, N, kc, (ci + 1) * kc);
    if (active) {
#pragma unroll 2
      for (int dd = 0; dd < kc; ++dd) {
        const float* ar = a_t + (ci * kc + dd) * lda + r0;
        const float4 a0 = *reinterpret_cast<const float4*>(ar);
        const float4 a1 = *reinterpret_cast<const float4*>(ar + 4);
        const float av[kRM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int m = 0; m < NW; ++m) {
          const float2 w2 = *reinterpret_cast<const float2*>(buf + (m * kc + dd) * N + c);
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            acc[m][i][0] = fmaf(av[i], w2.x, acc[m][i][0]);
            acc[m][i][1] = fmaf(av[i], w2.y, acc[m][i][1]);
          }
        }
      }
    }
  }
  __syncthreads();   // w_s is free again
}

// Load rows [t0, t0 + nt) of kv[b, g] (row stride kv_st) transposed into
// kv_t (D x tk), rows fastest so the stores hit distinct banks.
template <typename TKV>
__device__ __forceinline__ void load_rows_t(const TKV* __restrict__ kv_bg,
                                            long long kv_st, int t0, int nt, int D,
                                            int tk, float* __restrict__ kv_t) {
  const int nd4 = D / 4;
  for (int i = threadIdx.x; i < nt * nd4; i += kThreads) {
    const int r = i % nt, d = i / nt * 4;
    const float4 v = load4(kv_bg + (long long)(t0 + r) * kv_st + d);
    kv_t[d * tk + r] = v.x;
    kv_t[(d + 1) * tk + r] = v.y;
    kv_t[(d + 2) * tk + r] = v.z;
    kv_t[(d + 3) * tk + r] = v.w;
  }
}

}  // namespace hop1
