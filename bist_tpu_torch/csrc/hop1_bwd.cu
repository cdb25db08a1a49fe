// BiST hop-1 backward for Hopper (sm_90a): float32 arithmetic, the grid (kv)
// and its gradient in float32 or bfloat16, everything else in float32.
//
// Replaces the Pallas TPU kernel `_hop1_bwd_kernel`, launched by
// `_hop1_bwd_pallas` (bist_tpu/ops/bist_kernels.py:243-392, pallas_call at
// l.381).  Given the forward's residuals (concat's upstream gradient d_concat
// = g Woᵀ, the per-head row statistic Dh = Σ d_concat ⊙ concat and the per-head
// log-sum-exp lse that hop1_fwd.cu writes) it computes, for every (batch b,
// group g) cell and head,
//
//     k = kv Wk + bk,  v = kv Wv + bv                 (recomputed, Lk x D)
//     p  = exp(s - lse),  s = q kᵀ / √d_k            (-1e9 on masked columns)
//     dp = d_concat vᵀ,   ds = p (dp - Dh) / √d_k     (0 on masked columns)
//     dq = Σ_g ds k,  dk = dsᵀ q,  dv = pᵀ d_concat,  dkv = dk Wkᵀ + dv Wvᵀ
//     dWk = Σ kvᵀ dk,  dWv = Σ kvᵀ dv,  dbk = Σ dk,  dbv = Σ dv
//
// with the semantics of autograd through the plain version (`hop1_plain`): a
// batch row whose columns are all masked attends uniformly (p = 1/Lk at every
// column < Lk, which the saved lse, -1e9 + log Lk rounded to -1e9 in float32,
// cannot say), and gets ds = 0 everywhere, as `jnp.where` / `torch.where`
// gives; the Pallas kernel applies ds at masked columns too and also counts
// its padding columns on such a row.
//
// What bounds it on the H100: at the flagship t2s launch (B=32, G=16, Lq=32,
// Lk=40, D=128, h=8) it moves ~31 MB (9 us at 3.35 TB/s) and does ~4.9
// GFLOP (73 us at the 67 TFLOP/s float32 rate outside the tensor cores),
// four fifths of it the three D x D products per kv row (the K/V recompute,
// dkv and dW).  So it is bound by operations; like hop1_fwd.cu it runs on
// the FMA units, since TF32 would break the 2e-4 agreement.
//
// Design, three passes with no float atomics, so the gradients are the same
// from run to run:
//   1. hop1_bwd_kernel, one block of 256 threads per (b, g).  It loops over kv
//      tiles of tk rows (hop1_bwd_plan sizes tk and the query chunk qc from D
//      so shared memory fits at any D <= 512); per tile it recomputes k and v
//      with the register-tiled product of hop1_tiles.cuh, then loops over
//      query chunks: p, dv += pᵀ d_concat, ds (in place of p), dq and
//      dk += dsᵀ q, all in shared memory.  At the end of a tile it writes the
//      tile's dk and dv rows to a workspace and dkv = [dk | dv] [Wkᵀ ; Wvᵀ]
//      (one product with a 2D-deep contraction).  dq's partial per (b, g)
//      goes to the workspace too (the block owns its rows, so later kv tiles
//      add to them in place).
//   2. hop1_bwd_dw_kernel: dWk, dWv = kvᵀ [dk, dv] over all B·G·Lk rows, in
//      64 x 64 output tiles, the rows cut into a fixed number of chunks (one
//      partial each, enough blocks to fill the card); dbk, dbv ride along.
//   3. sum_middle_kernel: the partials summed in a fixed order (dq over g,
//      the weight gradients over the row chunks).
// A simple first version: one block per SM at the flagship width, and
// scalar shared-memory loads where a product's operands are laid out for
// another phase.

#include <math.h>

#include <algorithm>

#include "hop1_tiles.cuh"

namespace {

using namespace hop1;

constexpr int kDwTile = 64;            // dW output tile: 64 x 64, 4 x 4 a thread
constexpr int kDwRows = 16;            // grid rows staged per step of pass 2
constexpr int kDwBlocksTarget = 2 * 132;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename TKV>
__global__ void __launch_bounds__(kThreads)
hop1_bwd_kernel(const float* __restrict__ q, const TKV* __restrict__ kv,
                long long kv_sb, long long kv_sg, long long kv_st,
                const int* __restrict__ mask, const float* __restrict__ dcc,
                const float* __restrict__ dh, const float* __restrict__ lse,
                const float* __restrict__ wk, const float* __restrict__ bk,
                const float* __restrict__ wv, const float* __restrict__ bv,
                const float* __restrict__ wkv_t, TKV* __restrict__ dkv,
                float* __restrict__ dq_part, float* __restrict__ dk_rows,
                float* __restrict__ dv_rows, int G, int Lq, int Lk, int D, int h,
                int qc, int tk, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dk = D / h;
  // every array is a multiple of 4 floats long, so each starts 16-byte aligned
  float* w_s = smem;                          // weight chunks
  float* kv_t = w_s + 4 * chunk_rows(D) * D;  // D x tk  kv tile, transposed
  float* k_t = kv_t + D * tk;                 // D x tk  K, transposed
  float* v_t = k_t + D * tk;                  // D x tk  V, transposed
  float* dk_t = v_t + D * tk;                 // D x tk  dK, transposed; dV follows,
  float* dv_t = dk_t + D * tk;                // D x tk  so [dk | dv]ᵀ is 2D x tk
  float* q_t = dv_t + D * tk;                 // D x qc  query chunk, transposed
  float* dcc_t = q_t + D * qc;                // D x qc  d_concat chunk, transposed
  float* p_s = dcc_t + D * qc;                // h x qc x tk: p, then ds
  float* lse_s = p_s + h * qc * tk;           // h x qc
  float* dh_s = lse_s + h * qc;               // h x qc

  const int tid = threadIdx.x;
  const int bg = blockIdx.x;
  const int b = bg / G, g = bg % G;
  const int nd4 = D / 4, ncp = D / 2, ng = qc / 4;
  const TKV* kv_bg = kv + b * kv_sb + g * kv_sg;
  const int* mask_b = mask ? mask + (size_t)b * Lk : nullptr;

  int any_valid = mask_b == nullptr;
  if (mask_b != nullptr)
    for (int t = tid; t < Lk; t += kThreads) any_valid |= mask_b[t] != 0;
  const bool uniform = !__syncthreads_or(any_valid);   // a fully masked row
  const float inv_lk = 1.f / Lk;

  for (int t0 = 0; t0 < Lk; t0 += tk) {
    const int nt = min(tk, Lk - t0);
    const int nt4 = (nt + 3) / 4 * 4;         // columns the 4-wide tiles touch
    __syncthreads();   // the previous tile's readers are done
    load_rows_t(kv_bg, kv_st, t0, nt, D, tk, kv_t);
    // rows past the tile's end project to the biases: finite, and multiplied
    // only by zeros below
    for (int i = tid; i < (tk - nt) * D; i += kThreads)
      kv_t[i / (tk - nt) * tk + nt + i % (tk - nt)] = 0.f;
    for (int i = tid; i < 2 * D * tk; i += kThreads) dk_t[i] = 0.f;
    __syncthreads();

    // K and V of the tile's rows, both transposed.
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
          const float bkj = j ? bk2.y : bk2.x, bvj = j ? bv2.y : bv2.x;
          float4* kt = reinterpret_cast<float4*>(k_t + (c + j) * tk + r0);
          float4* vt = reinterpret_cast<float4*>(v_t + (c + j) * tk + r0);
          kt[0] = make_float4(acc[0][0][j] + bkj, acc[0][1][j] + bkj,
                              acc[0][2][j] + bkj, acc[0][3][j] + bkj);
          kt[1] = make_float4(acc[0][4][j] + bkj, acc[0][5][j] + bkj,
                              acc[0][6][j] + bkj, acc[0][7][j] + bkj);
          vt[0] = make_float4(acc[1][0][j] + bvj, acc[1][1][j] + bvj,
                              acc[1][2][j] + bvj, acc[1][3][j] + bvj);
          vt[1] = make_float4(acc[1][4][j] + bvj, acc[1][5][j] + bvj,
                              acc[1][6][j] + bvj, acc[1][7][j] + bvj);
        }
      }
    }
    __syncthreads();

    for (int q0 = 0; q0 < Lq; q0 += qc) {
      const int nq = min(qc, Lq - q0);
      // the chunk's q and d_concat rows transposed (zeros past Lq), lse, Dh
      for (int i = tid; i < qc * nd4; i += kThreads) {
        const int r = i % qc, d = i / qc * 4;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c4 = a;
        if (r < nq) {
          a = *reinterpret_cast<const float4*>(q + ((size_t)b * Lq + q0 + r) * D + d);
          c4 = *reinterpret_cast<const float4*>(dcc + ((size_t)bg * Lq + q0 + r) * D + d);
        }
        q_t[d * qc + r] = a.x;
        q_t[(d + 1) * qc + r] = a.y;
        q_t[(d + 2) * qc + r] = a.z;
        q_t[(d + 3) * qc + r] = a.w;
        dcc_t[d * qc + r] = c4.x;
        dcc_t[(d + 1) * qc + r] = c4.y;
        dcc_t[(d + 2) * qc + r] = c4.z;
        dcc_t[(d + 3) * qc + r] = c4.w;
      }
      for (int i = tid; i < qc * h; i += kThreads) {
        const int r = i % qc, hd = i / qc;
        const size_t at = ((size_t)bg * Lq + q0 + r) * h + hd;
        lse_s[i] = r < nq ? lse[at] : 0.f;
        dh_s[i] = r < nq ? dh[at] : 0.f;
      }
      __syncthreads();

      // p: a thread owns 4 rows x 2 kv columns of one head (0 past nt, nq).
      const int ntp = nt4 / 2;
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
          const bool valid = t < nt && (mask_b == nullptr || mask_b[t0 + t] != 0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ih = hd * qc + i0 + i;
            float p = 0.f;
            if (t < nt && i0 + i < nq)
              p = uniform ? inv_lk : valid ? expf(s[i][j] * scale - lse_s[ih]) : 0.f;
            p_s[ih * tk + t] = p;
          }
        }
      }
      __syncthreads();

      // dv += pᵀ d_concat: a thread owns 4 kv rows x 4 columns of one head.
      const int ntg = nt4 / 4;
      for (int item = tid; item < ntg * nd4; item += kThreads) {
        const int tl = item % ntg * 4, c0 = item / ntg * 4;
        const int hd = c0 / dk;
        float a[4][4] = {};   // [column][kv row]
        for (int i = 0; i < nq; ++i) {
          const float4 p4 = *reinterpret_cast<const float4*>(p_s + (hd * qc + i) * tk + tl);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float d = dcc_t[(c0 + j) * qc + i];
#pragma unroll
            for (int t = 0; t < 4; ++t) a[j][t] = fmaf(pv[t], d, a[j][t]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float4* o = reinterpret_cast<float4*>(dv_t + (c0 + j) * tk + tl);
          const float4 v = *o;
          *o = make_float4(v.x + a[j][0], v.y + a[j][1], v.z + a[j][2], v.w + a[j][3]);
        }
      }
      __syncthreads();

      // dp = d_concat vᵀ and ds = p (dp - Dh) scale, written over p.
      for (int item = tid; item < ng * ntp * h; item += kThreads) {
        const int i0 = item % ng * 4;
        const int tp = item / ng % ntp * 2;
        const int hd = item / (ng * ntp);
        const float* cr = dcc_t + hd * dk * qc + i0;
        const float* vr = v_t + hd * dk * tk + tp;
        float dp[4][2] = {};
#pragma unroll 4
        for (int e = 0; e < dk; ++e) {
          const float4 c4 = *reinterpret_cast<const float4*>(cr + e * qc);
          const float2 v2 = *reinterpret_cast<const float2*>(vr + e * tk);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dp[i][0] = fmaf(cv[i], v2.x, dp[i][0]);
            dp[i][1] = fmaf(cv[i], v2.y, dp[i][1]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = tp + j;
          const bool valid = !uniform && t < nt &&
                             (mask_b == nullptr || mask_b[t0 + t] != 0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ih = hd * qc + i0 + i;
            float* ps = p_s + ih * tk + t;
            *ps = valid ? *ps * (dp[i][j] - dh_s[ih]) * scale : 0.f;
          }
        }
      }
      __syncthreads();

      // dq (4 rows x 4 columns a thread, added to the block's partial in
      // device memory) and dk += dsᵀ q (4 kv rows x 4 columns a thread).
      const int n_dq = ng * nd4, n_dk = ntg * nd4;
      for (int item = tid; item < n_dq + n_dk; item += kThreads) {
        if (item < n_dq) {
          const int i0 = item % ng * 4, c0 = item / ng * 4;
          const int hd = c0 / dk;
          float a[4][4] = {};   // [row][column]
          for (int t = 0; t < nt4; t += 4) {     // ds is 0 at columns >= nt
            float ds[4][4], kk[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 v = *reinterpret_cast<const float4*>(
                  p_s + (hd * qc + i0 + i) * tk + t);
              ds[i][0] = v.x; ds[i][1] = v.y; ds[i][2] = v.z; ds[i][3] = v.w;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 v = *reinterpret_cast<const float4*>(k_t + (c0 + j) * tk + t);
              kk[j][0] = v.x; kk[j][1] = v.y; kk[j][2] = v.z; kk[j][3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int u = 0; u < 4; ++u) a[i][j] = fmaf(ds[i][u], kk[j][u], a[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i0 + i < nq) {
              float4* o = reinterpret_cast<float4*>(
                  dq_part + ((size_t)bg * Lq + q0 + i0 + i) * D + c0);
              float4 v = make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
              if (t0 > 0) {
                const float4 old = *o;
                v = make_float4(old.x + v.x, old.y + v.y, old.z + v.z, old.w + v.w);
              }
              *o = v;
            }
          }
        } else {
          const int it = item - n_dq;
          const int tl = it % ntg * 4, c0 = it / ntg * 4;
          const int hd = c0 / dk;
          float a[4][4] = {};   // [column][kv row]
          for (int i = 0; i < nq; ++i) {
            const float4 d4 = *reinterpret_cast<const float4*>(p_s + (hd * qc + i) * tk + tl);
            const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float qv = q_t[(c0 + j) * qc + i];
#pragma unroll
              for (int t = 0; t < 4; ++t) a[j][t] = fmaf(dv4[t], qv, a[j][t]);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float4* o = reinterpret_cast<float4*>(dk_t + (c0 + j) * tk + tl);
            const float4 v = *o;
            *o = make_float4(v.x + a[j][0], v.y + a[j][1], v.z + a[j][2], v.w + a[j][3]);
          }
        }
      }
      __syncthreads();
    }

    // The tile's dk and dv rows, for the weight gradients of pass 2.
    const size_t row0 = (size_t)bg * Lk + t0;
    for (int i = tid; i < nt * D; i += kThreads) {
      const int t = i / D, c = i % D;
      dk_rows[(row0 + t) * D + c] = dk_t[c * tk + t];
      dv_rows[(row0 + t) * D + c] = dv_t[c * tk + t];
    }

    // dkv = [dk | dv] [Wkᵀ ; Wvᵀ]: a thread owns 8 rows x 2 columns.
    const int n_out = (nt + kRM - 1) / kRM * ncp;
    for (int base = 0; base < n_out; base += kThreads) {
      const int item = base + tid;
      const bool active = item < n_out;
      const int c = item % ncp * 2, r0 = item / ncp * kRM;
      float acc[1][kRM][2] = {};
      rows_times_w<1>(dk_t, tk, r0, active, wkv_t, wkv_t, 2 * D, D, w_s, c, acc);
      if (active) {
#pragma unroll
        for (int i = 0; i < kRM; ++i)
          if (r0 + i < nt) store2(dkv + (row0 + r0 + i) * D + c, acc[0][i][0], acc[0][i][1]);
      }
    }
  }
}

// Pass 2: part[chunk] = (kvᵀ dk, kvᵀ dv, Σ dk, Σ dv) over the chunk's rows.
template <typename TKV>
__global__ void __launch_bounds__(kThreads)
hop1_bwd_dw_kernel(const TKV* __restrict__ kv, long long kv_sb, long long kv_sg,
                   long long kv_st, const float* __restrict__ dk_rows,
                   const float* __restrict__ dv_rows, float* __restrict__ part,
                   int G, int Lk, int D, long long nrows, long long chunk) {
  __shared__ __align__(16) float a_s[kDwRows][kDwTile];
  __shared__ __align__(16) float b_s[kDwRows][kDwTile];
  const int nT = (D + kDwTile - 1) / kDwTile;
  const int m = blockIdx.x / (nT * nT);          // 0: dWk, 1: dWv
  const int i0 = blockIdx.x / nT % nT * kDwTile;
  const int j0 = blockIdx.x % nT * kDwTile;
  const float* d_rows = m ? dv_rows : dk_rows;
  const long long r_begin = blockIdx.y * chunk;
  const long long r_end = min(nrows, r_begin + chunk);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool bias = i0 == 0 && tid < kDwTile;
  float acc[4][4] = {};
  float bsum = 0.f;
  for (long long r0 = r_begin; r0 < r_end; r0 += kDwRows) {
    for (int e = tid; e < kDwRows * kDwTile; e += kThreads) {
      const int rr = e / kDwTile, cc = e % kDwTile;
      const long long r = r0 + rr;
      float a = 0.f, d = 0.f;
      if (r < r_end) {
        const long long bgi = r / Lk;
        const long long t = r % Lk;
        const long long bi = bgi / G, gi = bgi % G;
        if (i0 + cc < D) a = to_float(kv[bi * kv_sb + gi * kv_sg + t * kv_st + i0 + cc]);
        if (j0 + cc < D) d = d_rows[r * D + j0 + cc];
      }
      a_s[rr][cc] = a;
      b_s[rr][cc] = d;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kDwRows; ++rr) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[rr][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[rr][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bw[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
      if (bias) bsum += b_s[rr][tid];
    }
    __syncthreads();
  }
  float* out = part + blockIdx.y * (2 * (size_t)D * D + 2 * (size_t)D);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row >= D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx * 4 + j;
      if (col < D) out[(size_t)m * D * D + (size_t)row * D + col] = acc[i][j];
    }
  }
  if (bias && j0 + tid < D) out[2 * (size_t)D * D + (size_t)m * D + j0 + tid] = bsum;
}

// Pass 3: out[o, j] = Σ_k in[o, k, j] for k = 0 .. n-1, in that order.
__global__ void sum_middle_kernel(const float* __restrict__ in, float* __restrict__ out,
                                  long long outer, int n, long long inner) {
  const long long total = outer * inner;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long o = idx / inner, j = idx % inner;
    const float* p = in + o * n * inner + j;
    float s = 0.f;
    for (int k = 0; k < n; ++k) s += p[k * inner];
    out[idx] = s;
  }
}

int sum_middle(const float* in, float* out, long long outer, int n, long long inner,
               cudaStream_t stream) {
  const long long total = outer * inner;
  const int blocks = (int)std::min<long long>((total + kThreads - 1) / kThreads, 132 * 8);
  sum_middle_kernel<<<blocks, kThreads, 0, stream>>>(in, out, outer, n, inner);
  return (int)cudaGetLastError();
}

size_t bwd_smem_bytes(int qc, int tk, int D, int h) {
  const size_t floats = 4 * (size_t)chunk_rows(D) * D + 5 * (size_t)D * tk +
                        2 * (size_t)D * qc + (size_t)h * qc * tk + 2 * (size_t)qc * h;
  return floats * sizeof(float);
}

// Tile plan: the largest kv tile (a multiple of 8, at most 64) and then the
// most query rows per chunk (a multiple of 8, at most 32) that fit one block
// per SM.  False for widths the kernel does not take.
bool hop1_bwd_plan(int Lq, int Lk, int D, int h, int* qc, int* tk, size_t* smem) {
  if (!widths_ok(D, h)) return false;
  const int tk_max = std::min(64, (Lk + kAlign - 1) / kAlign * kAlign);
  const int qc_max = std::min(32, (Lq + kAlign - 1) / kAlign * kAlign);
  for (int t = tk_max; t > 0; t -= kAlign)
    for (int c = qc_max; c > 0; c -= kAlign)
      if (bwd_smem_bytes(c, t, D, h) <= kSmemLimit) {
        *qc = c;
        *tk = t;
        *smem = bwd_smem_bytes(c, t, D, h);
        return true;
      }
  return false;
}

int dw_tiles(int D) {
  const int n = (D + kDwTile - 1) / kDwTile;
  return 2 * n * n;
}

// Row chunks of pass 2: enough blocks to fill the card twice, at least 128
// rows a chunk.
int dw_chunks(long long nrows, int D) {
  const long long p = std::min<long long>((kDwBlocksTarget + dw_tiles(D) - 1) / dw_tiles(D),
                                          (nrows + 127) / 128);
  return (int)std::max<long long>(1, p);
}

long long workspace_floats(int B, int G, int Lq, int Lk, int D) {
  const long long nrows = (long long)B * G * Lk;
  return (long long)B * G * Lq * D + 2 * nrows * D +
         (long long)dw_chunks(nrows, D) * (2LL * D * D + 2LL * D);
}

template <typename TKV>
int launch(const float* q, const TKV* kv, long long kv_sb, long long kv_sg,
           long long kv_st, const int* mask, const float* dcc, const float* dh,
           const float* lse, const float* wk, const float* bk, const float* wv,
           const float* bv, const float* wkv_t, TKV* dkv, float* dq, float* wgrad,
           float* ws, int B, int G, int Lq, int Lk, int D, int h, float scale,
           cudaStream_t stream) {
  int qc, tk;
  size_t smem;
  if (!hop1_bwd_plan(Lq, Lk, D, h, &qc, &tk, &smem)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hop1_bwd_kernel<TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long nrows = (long long)B * G * Lk;
  float* dq_part = ws;
  float* dk_rows = dq_part + (size_t)B * G * Lq * D;
  float* dv_rows = dk_rows + (size_t)nrows * D;
  float* part = dv_rows + (size_t)nrows * D;
  hop1_bwd_kernel<TKV><<<B * G, kThreads, smem, stream>>>(
      q, kv, kv_sb, kv_sg, kv_st, mask, dcc, dh, lse, wk, bk, wv, bv, wkv_t, dkv,
      dq_part, dk_rows, dv_rows, G, Lq, Lk, D, h, qc, tk, scale);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int chunks = dw_chunks(nrows, D);
  hop1_bwd_dw_kernel<TKV><<<dim3(dw_tiles(D), chunks), kThreads, 0, stream>>>(
      kv, kv_sb, kv_sg, kv_st, dk_rows, dv_rows, part, G, Lk, D, nrows,
      (nrows + chunks - 1) / chunks);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  rc = sum_middle(dq_part, dq, B, G, (long long)Lq * D, stream);
  if (rc != 0) return rc;
  return sum_middle(part, wgrad, 1, chunks, 2LL * D * D + 2LL * D, stream);
}

}  // namespace

extern "C" {

// Floats of device workspace `bist_hop1_bwd` needs for these shapes.
long long bist_hop1_bwd_workspace(int B, int G, int Lq, int Lk, int D) {
  return workspace_floats(B, G, Lq, Lk, D);
}

// Launch the three passes on `stream`; returns the CUDA error code of the
// launches (0 = ok), or cudaErrorInvalidValue for widths the kernel does not
// take (those of hop1_fwd.cu).  kv is float32, or bfloat16 when kv_bf16 is
// set (dkv then too); its strides are in elements.  q (B, Lq, D), d_concat
// (B, G, Lq, D), dh and lse (B, G, Lq, h), wkv_t = [Wkᵀ ; Wvᵀ] (2D, D); dkv
// (B, G, Lk, D) contiguous, dq (B, Lq, D), wgrad = [dWk, dWv, dbk, dbv]
// (2D² + 2D floats); ws holds bist_hop1_bwd_workspace floats.
int bist_hop1_bwd(const float* q, const void* kv, int kv_bf16, long long kv_sb,
                  long long kv_sg, long long kv_st, const int* mask,
                  const float* dcc, const float* dh, const float* lse,
                  const float* wk, const float* bk, const float* wv,
                  const float* bv, const float* wkv_t, void* dkv, float* dq,
                  float* wgrad, float* ws, int B, int G, int Lq, int Lk, int D,
                  int h, float scale, void* stream) {
  if (kv_sb % 4 != 0 || kv_sg % 4 != 0 || kv_st % 4 != 0 || B < 1 || G < 1 ||
      Lq < 1 || Lk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_bf16)
    return launch(q, static_cast<const __nv_bfloat16*>(kv), kv_sb, kv_sg, kv_st, mask,
                  dcc, dh, lse, wk, bk, wv, bv, wkv_t, static_cast<__nv_bfloat16*>(dkv),
                  dq, wgrad, ws, B, G, Lq, Lk, D, h, scale, s);
  return launch(q, static_cast<const float*>(kv), kv_sb, kv_sg, kv_st, mask, dcc, dh,
                lse, wk, bk, wv, bv, wkv_t, static_cast<float*>(dkv), dq, wgrad, ws, B,
                G, Lq, Lk, D, h, scale, s);
}

}  // extern "C"
