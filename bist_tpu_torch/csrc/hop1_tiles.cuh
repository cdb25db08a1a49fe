// Shared pieces of the hop-1 kernels (hop1_fwd.cu, hop1_bwd.cu): the head
// layout at any width, grid loads in float32 or bfloat16, and the
// register-tiled product of a block of rows with one or two weight matrices
// staged through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hop1 {

constexpr int kThreads = 256;
constexpr int kRM = 8;                // rows per thread in rows x W
constexpr int kAlign = 8;             // row tiles are multiples of this
constexpr int kMaxN = 512;            // weight columns one staged product covers
constexpr float kMaskedScore = -1e9f; // the reference's masked logit
constexpr size_t kSmemLimit = 232448;        // shared memory a block may use
constexpr size_t kSmemTarget = 113 * 1024;   // two blocks per SM

// The kernels take any D with D % h == 0.  Their tiles hold whole 4-column
// vectors of one head, so a head's d_k columns are padded with zeros to dkp,
// the next multiple of 4: the padded head layout is Dp = h * dkp wide.  The
// wrappers (ops/bist_kernels.py) hand over q, the weights and the biases in
// that layout, zero-padded (Wk, Wv: D x Dp; Wo: Dp x Do, its columns padded
// to Do, the next multiple of 4 of D), which leaves every score and every
// true output column as it is; the grid, x and the outputs keep width D.
struct Widths {
  int dk, dkp, Dp, Do;
};

__host__ __device__ inline Widths widths(int D, int h) {
  Widths w;
  w.dk = D / h;
  w.dkp = (w.dk + 3) / 4 * 4;
  w.Dp = h * w.dkp;
  w.Do = (D + 3) / 4 * 4;
  return w;
}

inline bool widths_ok(int D, int h) { return h >= 1 && D >= 1 && D % h == 0; }

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

// weight rows per staged chunk of N <= kMaxN columns: 2 weights x kc x N <= 1024
__host__ __device__ constexpr int chunk_rows(int N) {
  return N <= 128 ? 8 : N <= 256 ? 4 : 2;
}

// Floats the weight stage of rows_times_w takes: two buffers of NW weights'
// chunks, for products of at most N columns.
__host__ __device__ inline int stage_floats(int NW, int N) {
  N = N < kMaxN ? N : kMaxN;
  N = (N + 3) / 4 * 4;
  return 2 * NW * chunk_rows(N) * N;
}

// Load chunk rows [d0, d0 + kc) of NW weights (rows of stride ld, N columns
// from the pointers on; rows at or past K are zeros), float4s, <= 2 per thread.
template <int NW>
__device__ __forceinline__ void stage_load(float4 (&r)[2], const float* w0,
                                           const float* w1, int ld, int N, int kc,
                                           int d0, int K) {
  const int n4 = kc * N / 4, r4 = N / 4;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i = threadIdx.x + s * kThreads;
    if (i < NW * n4) {
      const int j = i < n4 ? i : i - n4;
      const int row = d0 + j / r4;
      r[s] = row < K ? __ldg(reinterpret_cast<const float4*>(
                           (i < n4 ? w0 : w1) + (size_t)row * ld) + j % r4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
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
// W_0 = w0, W_1 = w1 (K x N blocks of row-major matrices of row stride ld;
// ld, N and the pointers multiples of 4 floats, N <= kMaxN).  Every thread
// of the block calls it (it stages the weights through w_s,
// stage_floats(NW, N) floats); only `active` threads accumulate.  a_t holds
// the rows transposed (K x lda), lda and r0 multiples of 4.
template <int NW>
__device__ __forceinline__ void rows_times_w(const float* __restrict__ a_t, int lda,
                                             int r0, bool active,
                                             const float* __restrict__ w0,
                                             const float* __restrict__ w1, int ld,
                                             int K, int N, float* __restrict__ w_s,
                                             int c, float (&acc)[NW][kRM][2]) {
  const int kc = chunk_rows(N);
  const int nchunk = (K + kc - 1) / kc;
  float4 st[2];
  stage_load<NW>(st, w0, w1, ld, N, kc, 0, K);
  for (int ci = 0; ci < nchunk; ++ci) {
    float* buf = w_s + (ci & 1) * (NW * kc * N);
    stage_store<NW>(st, buf, N, kc);
    __syncthreads();
    if (ci + 1 < nchunk) stage_load<NW>(st, w0, w1, ld, N, kc, (ci + 1) * kc, K);
    if (active) {
      const int nd = min(kc, K - ci * kc);     // a_t has no rows past K
#pragma unroll 2
      for (int dd = 0; dd < nd; ++dd) {
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
// kv_t (D x tk).  With `vec` (rows of whole, aligned 4-element vectors) rows
// go fastest, so the stores hit distinct banks; else one element a thread,
// columns fastest, so the reads coalesce.
template <typename TKV>
__device__ __forceinline__ void load_rows_t(const TKV* __restrict__ kv_bg,
                                            long long kv_st, int t0, int nt, int D,
                                            int tk, float* __restrict__ kv_t, bool vec) {
  if (vec) {
    const int nd4 = D / 4;
    for (int i = threadIdx.x; i < nt * nd4; i += kThreads) {
      const int r = i % nt, d = i / nt * 4;
      const float4 v = load4(kv_bg + (long long)(t0 + r) * kv_st + d);
      kv_t[d * tk + r] = v.x;
      kv_t[(d + 1) * tk + r] = v.y;
      kv_t[(d + 2) * tk + r] = v.z;
      kv_t[(d + 3) * tk + r] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < nt * D; i += kThreads) {
      const int r = i / D, d = i % D;
      kv_t[d * tk + r] = to_float(kv_bg[(long long)(t0 + r) * kv_st + d]);
    }
  }
}

// Whether kv's rows are whole, aligned 4-element vectors (the 16-byte and
// 8-byte loads of the kernels); else they load one element at a time.
template <typename TKV>
inline bool rows_vec4(const TKV* kv, long long kv_sb, long long kv_sg, long long kv_st,
                      int D) {
  return D % 4 == 0 && kv_sb % 4 == 0 && kv_sg % 4 == 0 && kv_st % 4 == 0 &&
         reinterpret_cast<size_t>(kv) % (4 * sizeof(TKV)) == 0;
}

}  // namespace hop1
