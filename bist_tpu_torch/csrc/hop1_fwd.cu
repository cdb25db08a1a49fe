// Fused BiST hop-1 forward for Hopper (sm_90a): float32 arithmetic, the grid
// (kv) in float32 or bfloat16 (a bfloat16 model's video grid), the query
// state, the weights and the output in float32.
//
// Replaces the Pallas TPU kernel `_hop1_kernel`, launched by
// `bist_hop1_fused` (bist_tpu/ops/bist_kernels.py:63-214, pallas_call at
// l.197).  For every (batch b, group g) cell it computes
//
//     k = kv[b,g] Wk + bk,   v = kv[b,g] Wv + bv                (Lk, D)
//     per head: softmax(q_h k_hᵀ / √d_k, -1e9 on masked columns) v_h
//     out[b,g] = x[b] + concat_heads(...) Wo + bo                 (Lq, D)
//
// with the projected K/V and the (h, Lq, Lk) scores kept in shared memory:
// only kv is read from device memory and only `out` is written.
//
// What bounds it on the H100: at the flagship t2s launch (B=64, G=16,
// Lq=32, Lk=40, D=128, h=8) it reads ~21 MB and writes ~17 MB (12 us at
// 3.35 TB/s) but does ~4.4 GFLOP, three fifths of it the K/V projection
// (66 us at the 67 TFLOP/s float32 rate outside the tensor cores).  So it is
// bound by operations, and the design feeds the FMA units from shared
// memory: in the row-block x weight products (the K/V projection and Wo) a
// thread owns 8 rows x 2 adjacent columns of each output; the 8 rows of the
// activations are stored transposed, so two 16-byte broadcast loads bring
// them, and the weights pass through shared memory in chunks of rows,
// loaded once per kv tile for all rows (register double-buffered, one
// barrier per chunk).  The tensor cores stay unused: TF32 would break the
// 2e-4 agreement with the float32 plain version.
//
// Design: one block of 256 threads per (b, g, chunk of up to 32 query rows).
// The block loops over kv tiles of `tk` rows (`hop1_plan` sizes qc and tk
// from D so that shared memory fits at any D <= 512) and keeps an online
// softmax per
// (row, head): running max m, running sum l and the unnormalised f32
// accumulator.  On the last tile it normalises, applies Wo + bo and adds x.
// Per-row data (q, scores, accumulator) is laid out row-fastest and K is
// stored transposed, so in the two attention products a thread owns a small
// register tile fed by 16-byte loads: 4 rows x 2 kv columns of one head's
// scores (a float4 of q and a float2 of k per step of d_k) and 4 rows x 4
// columns of p·v (a float4 of p and one of v per kv row), with the threads of
// a warp on consecutive row groups of one head.  Columns past Lk are never
// visited, so a row whose columns are all masked gets uniform attention over
// the true Lk (as the plain version does; the Pallas kernel also counted its
// padding columns there).
//
// For training (`hop1_trainable`) it also writes the residuals the backward
// kernel (hop1_bwd.cu) reads: concat, the normalised accumulator before Wo,
// and per (row, head) lse = m + log(l).  The evaluation path passes null
// pointers and skips those writes.  The row-block x weight product, the grid
// loads and the width rule are shared with hop1_bwd.cu (hop1_tiles.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <initializer_list>

#include "hop1_tiles.cuh"

namespace {

using namespace hop1;

template <typename TKV>
__global__ void __launch_bounds__(kThreads, 2)
hop1_fwd_kernel(const float* __restrict__ x, const float* __restrict__ q,
                const TKV* __restrict__ kv, long long kv_sb, long long kv_sg,
                long long kv_st, const int* __restrict__ mask,
                const float* __restrict__ wk, const float* __restrict__ bk,
                const float* __restrict__ wv, const float* __restrict__ bv,
                const float* __restrict__ wo, const float* __restrict__ bo,
                float* __restrict__ out, float* __restrict__ concat_out,
                float* __restrict__ lse_out, int G, int Lq, int Lk, int D, int h,
                int qc, int tk, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dk = D / h;
  const int qh = qc * h;       // (head, row) pairs, row fastest: hd * qc + i
  const int ng = qc / 4;       // groups of 4 query rows
  // every array is a multiple of 4 floats long, so each starts 16-byte aligned
  float* w_s = smem;                          // 2 x 2 x kc x D weight chunks
  float* kv_t = w_s + 4 * chunk_rows(D) * D;  // D x tk  kv tile, transposed
  float* acc_t = kv_t + D * tk;               // D x qc  accumulator (concat)
  float* v_s = acc_t + D * qc;                // tk x D
  float* k_t = v_s + tk * D;                  // D x tk  K, transposed
  float* q_t = k_t + D * tk;                  // D x qc  query, transposed
  float* p_t = q_t + D * qc;                  // tk x qh scores / probabilities
  float* m_s = p_t + tk * qh;                 // qh running max
  float* l_s = m_s + qh;                      // qh running sum
  float* a_s = l_s + qh;                      // qh rescale of the current tile

  const int tid = threadIdx.x;
  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int q0 = blockIdx.y * qc;
  const int nq = min(qc, Lq - q0);
  const int ncp = D / 2;                      // column pairs
  const int nd4 = D / 4;                      // float4s per row

  // rows fastest, so the transposed shared-memory stores hit distinct banks
  for (int i = tid; i < qc * nd4; i += kThreads) {
    const int r = i % qc, d = i / qc * 4;
    const float4 v = r < nq ? *reinterpret_cast<const float4*>(
                                  q + ((size_t)b * Lq + q0 + r) * D + d)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    q_t[d * qc + r] = v.x;
    q_t[(d + 1) * qc + r] = v.y;
    q_t[(d + 2) * qc + r] = v.z;
    q_t[(d + 3) * qc + r] = v.w;
  }
  for (int i = tid; i < qc * D; i += kThreads) acc_t[i] = 0.f;
  for (int i = tid; i < qh; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  const TKV* kv_bg = kv + b * kv_sb + g * kv_sg;
  const int* mask_b = mask ? mask + (size_t)b * Lk : nullptr;

  for (int t0 = 0; t0 < Lk; t0 += tk) {
    const int nt = min(tk, Lk - t0);
    __syncthreads();   // the previous tile's readers are done
    load_rows_t(kv_bg, kv_st, t0, nt, D, tk, kv_t);
    __syncthreads();

    // K and V projections of the tile's rows, in groups of 8 rows (rows >= nt
    // of the last group come from stale shared memory and are never read).
    const int n_proj = (nt + kRM - 1) / kRM * ncp;
    for (int base = 0; base < n_proj; base += kThreads) {
      const int item = base + tid;
      const bool active = item < n_proj;
      const int c = item % ncp * 2, r0 = item / ncp * kRM;
      float acc[2][kRM][2] = {};
      rows_times_w<2>(kv_t, tk, r0, active, wk, wv, D, D, w_s, c, acc);
      if (active) {
        const float2 bk2 = *reinterpret_cast<const float2*>(bk + c);
        const float2 bv2 = *reinterpret_cast<const float2*>(bv + c);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float bj = j ? bk2.y : bk2.x;
          float4* kt = reinterpret_cast<float4*>(k_t + (c + j) * tk + r0);
          kt[0] = make_float4(acc[0][0][j] + bj, acc[0][1][j] + bj,
                              acc[0][2][j] + bj, acc[0][3][j] + bj);
          kt[1] = make_float4(acc[0][4][j] + bj, acc[0][5][j] + bj,
                              acc[0][6][j] + bj, acc[0][7][j] + bj);
        }
#pragma unroll
        for (int i = 0; i < kRM; ++i)
          *reinterpret_cast<float2*>(v_s + (r0 + i) * D + c) =
              make_float2(acc[1][i][0] + bv2.x, acc[1][i][1] + bv2.y);
      }
    }
    __syncthreads();

    // Scores: a thread owns 4 rows x 2 kv columns of one head.
    const int ntp = (nt + 1) / 2;
    for (int item = tid; item < ng * ntp * h; item += kThreads) {
      const int i0 = item % ng * 4;
      const int tp = item / ng % ntp * 2;
      const int hd = item / (ng * ntp);
      const float* qr = q_t + hd * dk * qc + i0;
      const float* kr = k_t + hd * dk * tk + tp;
      float s[4][2] = {};
#pragma unroll 4
      for (int e = 0; e < dk; ++e) {
        const float4 q4 = *reinterpret_cast<const float4*>(qr + e * qc);
        const float2 k2 = *reinterpret_cast<const float2*>(kr + e * tk);
        const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][0] = fmaf(qv[i], k2.x, s[i][0]);
          s[i][1] = fmaf(qv[i], k2.y, s[i][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = tp + j;
        if (t < nt) {
          const bool valid = mask_b == nullptr || mask_b[t0 + t] != 0;
          *reinterpret_cast<float4*>(p_t + t * qh + hd * qc + i0) =
              valid ? make_float4(s[0][j] * scale, s[1][j] * scale,
                                  s[2][j] * scale, s[3][j] * scale)
                    : make_float4(kMaskedScore, kMaskedScore, kMaskedScore,
                                  kMaskedScore);
        }
      }
    }
    __syncthreads();

    // Online softmax update per (head, row).
    for (int ih = tid; ih < qh; ih += kThreads) {
      const float m_old = m_s[ih];
      float mx = m_old;
      for (int t = 0; t < nt; ++t) mx = fmaxf(mx, p_t[t * qh + ih]);
      float sum = 0.f;
      for (int t = 0; t < nt; ++t) {
        const float p = expf(p_t[t * qh + ih] - mx);
        p_t[t * qh + ih] = p;
        sum += p;
      }
      const float alpha = expf(m_old - mx);   // 0 on the first tile
      l_s[ih] = l_s[ih] * alpha + sum;
      m_s[ih] = mx;
      a_s[ih] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p v: a thread owns 4 rows x 4 columns of one head.
    for (int item = tid; item < ng * nd4; item += kThreads) {
      const int i0 = item % ng * 4, c0 = item / ng * 4;
      const int ih0 = c0 / dk * qc + i0;
      const float4 al = *reinterpret_cast<const float4*>(a_s + ih0);
      float a[4][4];   // [column][row]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(acc_t + (c0 + j) * qc + i0);
        a[j][0] = v.x * al.x;
        a[j][1] = v.y * al.y;
        a[j][2] = v.z * al.z;
        a[j][3] = v.w * al.w;
      }
#pragma unroll 4
      for (int t = 0; t < nt; ++t) {
        const float4 p4 = *reinterpret_cast<const float4*>(p_t + t * qh + ih0);
        const float4 v4 = *reinterpret_cast<const float4*>(v_s + t * D + c0);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) a[j][i] = fmaf(pv[i], vv[j], a[j][i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(acc_t + (c0 + j) * qc + i0) =
            make_float4(a[j][0], a[j][1], a[j][2], a[j][3]);
    }
  }
  __syncthreads();

  // concat = acc / l, in place.
  for (int item = tid; item < qc * D; item += kThreads) {
    const int i = item % qc, c = item / qc;
    acc_t[item] /= l_s[c / dk * qc + i];
  }
  __syncthreads();

  // Training residuals: concat (the rows of acc_t) and per-head lse = m +
  // log(l), the log-sum-exp of the scores as the softmax saw them (-1e9 on
  // masked columns).  A thread writes 4 columns of one row.
  if (concat_out != nullptr) {
    const size_t row0 = ((size_t)b * G + g) * Lq + q0;
    for (int item = tid; item < qc * nd4; item += kThreads) {
      const int i = item % qc, c = item / qc * 4;
      if (i < nq)
        *reinterpret_cast<float4*>(concat_out + (row0 + i) * D + c) =
            make_float4(acc_t[c * qc + i], acc_t[(c + 1) * qc + i],
                        acc_t[(c + 2) * qc + i], acc_t[(c + 3) * qc + i]);
    }
    for (int ih = tid; ih < qh; ih += kThreads) {
      const int i = ih % qc, hd = ih / qc;
      if (i < nq) lse_out[(row0 + i) * h + hd] = m_s[ih] + logf(l_s[ih]);
    }
  }

  // out = x + (concat Wo + bo).
  const int n_out = qc / kRM * ncp;
  for (int base = 0; base < n_out; base += kThreads) {
    const int item = base + tid;
    const bool active = item < n_out;
    const int c = item % ncp * 2, r0 = item / ncp * kRM;
    float acc[1][kRM][2] = {};
    rows_times_w<1>(acc_t, qc, r0, active, wo, wo, D, D, w_s, c, acc);
    if (active) {
      const float2 bo2 = *reinterpret_cast<const float2*>(bo + c);
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        if (r0 + i < nq) {
          const int row = q0 + r0 + i;
          const float2 x2 =
              *reinterpret_cast<const float2*>(x + ((size_t)b * Lq + row) * D + c);
          *reinterpret_cast<float2*>(out + (((size_t)b * G + g) * Lq + row) * D + c) =
              make_float2(x2.x + (acc[0][i][0] + bo2.x), x2.y + (acc[0][i][1] + bo2.y));
        }
      }
    }
  }
}

size_t smem_bytes(int qc, int tk, int D, int h) {
  const size_t floats = 4 * (size_t)chunk_rows(D) * D + 3 * (size_t)D * tk +
                        2 * (size_t)D * qc + (size_t)tk * qc * h + 3 * (size_t)qc * h;
  return floats * sizeof(float);
}

// Tile plan: the most query rows per block (a multiple of 8, at most 32) and
// then the largest kv tile (a multiple of 8, at most 64) that fit two blocks
// per SM, else one.  False for widths the kernel does not take.
bool hop1_plan(int Lq, int Lk, int D, int h, int* qc, int* tk, size_t* smem) {
  if (!widths_ok(D, h)) return false;
  const int tk_max = std::min(64, (Lk + kAlign - 1) / kAlign * kAlign);
  for (int c = std::min(32, (Lq + kAlign - 1) / kAlign * kAlign); c > 0; c -= kAlign)
    for (size_t limit : {kSmemTarget, kSmemLimit})
      for (int t = tk_max; t > 0; t -= kAlign)
        if (smem_bytes(c, t, D, h) <= limit) {
          *qc = c;
          *tk = t;
          *smem = smem_bytes(c, t, D, h);
          return true;
        }
  return false;
}

template <typename TKV>
int launch(const float* x, const float* q, const TKV* kv, long long kv_sb,
           long long kv_sg, long long kv_st, const int* mask, const float* wk,
           const float* bk, const float* wv, const float* bv, const float* wo,
           const float* bo, float* out, float* concat, float* lse, int B, int G,
           int Lq, int Lk, int D, int h, float scale, cudaStream_t stream) {
  int qc, tk;
  size_t smem;
  if (!hop1_plan(Lq, Lk, D, h, &qc, &tk, &smem)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hop1_fwd_kernel<TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(B * G), (unsigned)((Lq + qc - 1) / qc));
  hop1_fwd_kernel<TKV><<<grid, kThreads, smem, stream>>>(
      x, q, kv, kv_sb, kv_sg, kv_st, mask, wk, bk, wv, bv, wo, bo, out, concat,
      lse, G, Lq, Lk, D, h, qc, tk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code of the launch (0 = ok), or
// cudaErrorInvalidValue for widths the kernel does not take (D > 512, D not
// a multiple of 8, D / h not a multiple of 4).  kv is float32, or bfloat16
// when kv_bf16 is set; its strides are in elements.  concat (B, G, Lq, D)
// and lse (B, G, Lq, h) are the training residuals: both null, or both
// written.
int bist_hop1_fwd(const float* x, const float* q, const void* kv, int kv_bf16,
                  long long kv_sb, long long kv_sg, long long kv_st,
                  const int* mask, const float* wk, const float* bk,
                  const float* wv, const float* bv, const float* wo,
                  const float* bo, float* out, float* concat, float* lse, int B,
                  int G, int Lq, int Lk, int D, int h, float scale, void* stream) {
  if (kv_sb % 4 != 0 || kv_sg % 4 != 0 || kv_st % 4 != 0 || B < 1 || G < 1 ||
      Lq < 1 || Lk < 1 || (concat == nullptr) != (lse == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_bf16)
    return launch(x, q, static_cast<const __nv_bfloat16*>(kv), kv_sb, kv_sg, kv_st,
                  mask, wk, bk, wv, bv, wo, bo, out, concat, lse, B, G, Lq, Lk, D, h,
                  scale, s);
  return launch(x, q, static_cast<const float*>(kv), kv_sb, kv_sg, kv_st, mask,
                wk, bk, wv, bv, wo, bo, out, concat, lse, B, G, Lq, Lk, D, h, scale, s);
}

}  // extern "C"
