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
// from run to run; any D with D % h == 0, heads held 4-column padded
// (hop1_tiles.cuh), grids of any alignment:
//   1. hop1_bwd_kernel, one block of 256 threads per (b, g).  It takes the
//      heads in groups (hop1_bwd_plan: as few as shared memory allows, one
//      at the flagship width) and, per group, loops over kv tiles of tk rows
//      (the plan sizes tk and the query chunk qc so shared memory fits);
//      per tile it recomputes the group's columns of k and v with the
//      register-tiled product of hop1_tiles.cuh, then loops over query
//      chunks: p, dv += pᵀ d_concat, ds (in place of p), dq and dk += dsᵀ q,
//      all in shared memory.  At the end of a tile it writes the tile's dk
//      and dv rows to a workspace and, with one group, dkv = [dk | dv] [Wkᵀ
//      ; Wvᵀ] (one product with a 2D-deep contraction).  dq's partial per
//      (b, g) goes to the workspace too (the block owns its rows, so later
//      kv tiles add to them in place).
//   1b. hop1_bwd_dkv_kernel, with several groups only: dkv from the dk and
//      dv rows of the workspace, 64 x 64 output tiles.
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

// Floats of the weight stage: the projection's two weights over a group's
// columns, or (one head group) [Wkᵀ ; Wvᵀ] over the output columns.
__host__ __device__ inline int bwd_stage_floats(int Ng, int Do) {
  const int a = stage_floats(2, Ng), b = stage_floats(1, Do);
  return a > b ? a : b;
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16(a); }

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
                int qc, int tk, int hg, int kv_vec, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Widths W = widths(D, h);
  const int dk = W.dk, dkp = W.dkp, Dp = W.Dp, Do = W.Do;
  const int Ng = hg * dkp;                    // columns of a full head group
  const bool one_group = hg >= h;
  // every array is a multiple of 4 floats long, so each starts 16-byte aligned
  float* w_s = smem;                          // weight chunks
  float* kv_t = w_s + bwd_stage_floats(Ng, one_group ? Do : 4);  // D x tk kv tile
  float* k_t = kv_t + D * tk;                 // ncol x tk  K, transposed
  float* v_t = k_t + Ng * tk;                 // ncol x tk  V, transposed
  float* dk_t = v_t + Ng * tk;                // ncol x tk  dK, transposed; dV follows,
  float* dv_t = dk_t + Ng * tk;               // ncol x tk  so [dk | dv]ᵀ is 2 ncol x tk
  float* q_t = dv_t + Ng * tk;                // ncol x qc  query chunk, transposed
  float* dcc_t = q_t + Ng * qc;               // ncol x qc  d_concat chunk, transposed
  float* p_s = dcc_t + Ng * qc;               // nh x qc x tk: p, then ds
  float* lse_s = p_s + hg * qc * tk;          // nh x qc
  float* dh_s = lse_s + hg * qc;              // nh x qc

  const int tid = threadIdx.x;
  const int bg = blockIdx.x;
  const int b = bg / G, g = bg % G;
  const int ng = qc / 4;
  const TKV* kv_bg = kv + b * kv_sb + g * kv_sg;
  const int* mask_b = mask ? mask + (size_t)b * Lk : nullptr;

  int any_valid = mask_b == nullptr;
  if (mask_b != nullptr)
    for (int t = tid; t < Lk; t += kThreads) any_valid |= mask_b[t] != 0;
  const bool uniform = !__syncthreads_or(any_valid);   // a fully masked row
  const float inv_lk = 1.f / Lk;

  // Head groups one after the other: heads [hd0, hd0 + nh), columns
  // [cg, cg + ncol) of the padded layout.
  for (int hd0 = 0; hd0 < h; hd0 += hg) {
    const int nh = min(hg, h - hd0);
    const int ncol = nh * dkp, cg = hd0 * dkp, nc4 = ncol / 4;
    for (int t0 = 0; t0 < Lk; t0 += tk) {
      const int nt = min(tk, Lk - t0);
      const int nt4 = (nt + 3) / 4 * 4;       // columns the 4-wide tiles touch
      __syncthreads();   // the previous tile's readers are done
      load_rows_t(kv_bg, kv_st, t0, nt, D, tk, kv_t, kv_vec != 0);
      // rows past the tile's end project to the biases: finite, and multiplied
      // only by zeros below
      for (int i = tid; i < (tk - nt) * D; i += kThreads)
        kv_t[i / (tk - nt) * tk + nt + i % (tk - nt)] = 0.f;
      for (int i = tid; i < 2 * Ng * tk; i += kThreads) dk_t[i] = 0.f;
      __syncthreads();

      // K and V of the group's columns for the tile's rows, both transposed,
      // kMaxN columns at a time.
      for (int cb = 0; cb < ncol; cb += kMaxN) {
        const int nb = min(kMaxN, ncol - cb), ncp = nb / 2;
        const int n_proj = (nt + kRM - 1) / kRM * ncp;
        for (int base = 0; base < n_proj; base += kThreads) {
          const int item = base + tid;
          const bool active = item < n_proj;
          const int c = item % ncp * 2, r0 = item / ncp * kRM;
          float acc[2][kRM][2] = {};
          rows_times_w<2>(kv_t, tk, r0, active, wk + cg + cb, wv + cg + cb, Dp, D, nb,
                          w_s, c, acc);
          if (active) {
            const int cc = cb + c;
            const float2 bk2 = *reinterpret_cast<const float2*>(bk + cg + cc);
            const float2 bv2 = *reinterpret_cast<const float2*>(bv + cg + cc);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float bkj = j ? bk2.y : bk2.x, bvj = j ? bv2.y : bv2.x;
              float4* kt = reinterpret_cast<float4*>(k_t + (cc + j) * tk + r0);
              float4* vt = reinterpret_cast<float4*>(v_t + (cc + j) * tk + r0);
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
      }
      __syncthreads();

      for (int q0 = 0; q0 < Lq; q0 += qc) {
        const int nq = min(qc, Lq - q0);
        // the chunk's q and d_concat columns transposed (zeros past Lq), lse, Dh
        for (int i = tid; i < qc * nc4; i += kThreads) {
          const int r = i % qc, d = i / qc * 4;
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c4 = a;
          if (r < nq) {
            a = *reinterpret_cast<const float4*>(q + ((size_t)b * Lq + q0 + r) * Dp + cg + d);
            c4 = *reinterpret_cast<const float4*>(dcc + ((size_t)bg * Lq + q0 + r) * Dp + cg + d);
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
        for (int i = tid; i < qc * nh; i += kThreads) {
          const int r = i % qc, hd = i / qc;
          const size_t at = ((size_t)bg * Lq + q0 + r) * h + hd0 + hd;
          lse_s[i] = r < nq ? lse[at] : 0.f;
          dh_s[i] = r < nq ? dh[at] : 0.f;
        }
        __syncthreads();

        // p: a thread owns 4 rows x 2 kv columns of one head (0 past nt, nq).
        const int ntp = nt4 / 2;
        for (int item = tid; item < ng * ntp * nh; item += kThreads) {
          const int i0 = item % ng * 4;
          const int tp = item / ng % ntp * 2;
          const int hd = item / (ng * ntp);
          const float* qr = q_t + hd * dkp * qc + i0;
          const float* kr = k_t + hd * dkp * tk + tp;
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
        for (int item = tid; item < ntg * nc4; item += kThreads) {
          const int tl = item % ntg * 4, c0 = item / ntg * 4;
          const int hd = c0 / dkp;
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
        for (int item = tid; item < ng * ntp * nh; item += kThreads) {
          const int i0 = item % ng * 4;
          const int tp = item / ng % ntp * 2;
          const int hd = item / (ng * ntp);
          const float* cr = dcc_t + hd * dkp * qc + i0;
          const float* vr = v_t + hd * dkp * tk + tp;
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
        const int n_dq = ng * nc4, n_dk = ntg * nc4;
        for (int item = tid; item < n_dq + n_dk; item += kThreads) {
          if (item < n_dq) {
            const int i0 = item % ng * 4, c0 = item / ng * 4;
            const int hd = c0 / dkp;
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
                    dq_part + ((size_t)bg * Lq + q0 + i0 + i) * Dp + cg + c0);
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
            const int hd = c0 / dkp;
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

      // The tile's dk and dv rows of the group, for the weight gradients of
      // pass 2 (and dkv, pass 1b, when there are several groups).
      const size_t row0 = (size_t)bg * Lk + t0;
      for (int i = tid; i < nt * ncol; i += kThreads) {
        const int t = i / ncol, c = i % ncol;
        dk_rows[(row0 + t) * Dp + cg + c] = dk_t[c * tk + t];
        dv_rows[(row0 + t) * Dp + cg + c] = dv_t[c * tk + t];
      }

      // With one head group: dkv = [dk | dv] [Wkᵀ ; Wvᵀ] here, a thread owns
      // 8 rows x 2 columns, kMaxN columns at a time.
      if (one_group) {
        for (int ob = 0; ob < Do; ob += kMaxN) {
          const int nb = min(kMaxN, Do - ob), ncp = nb / 2;
          const int n_out = (nt + kRM - 1) / kRM * ncp;
          for (int base = 0; base < n_out; base += kThreads) {
            const int item = base + tid;
            const bool active = item < n_out;
            const int c = item % ncp * 2, r0 = item / ncp * kRM;
            float acc[1][kRM][2] = {};
            rows_times_w<1>(dk_t, tk, r0, active, wkv_t + ob, wkv_t + ob, Do, 2 * Dp, nb,
                            w_s, c, acc);
            if (active) {
              const int col = ob + c;
#pragma unroll
              for (int i = 0; i < kRM; ++i) {
                if (r0 + i >= nt) continue;
                TKV* o = dkv + (row0 + r0 + i) * D + col;
                if (D % 2 == 0 && col < D) store2(o, acc[0][i][0], acc[0][i][1]);
                else {
                  if (col < D) store1(o, acc[0][i][0]);
                  if (col + 1 < D) store1(o + 1, acc[0][i][1]);
                }
              }
            }
          }
        }
      }
    }
  }
}

// Pass 1b, with several head groups: dkv = [dk_rows | dv_rows] [Wkᵀ ; Wvᵀ]
// over all rows, 64 x 64 output tiles, 4 x 4 a thread.
template <typename TKV>
__global__ void __launch_bounds__(kThreads)
hop1_bwd_dkv_kernel(const float* __restrict__ dk_rows, const float* __restrict__ dv_rows,
                    const float* __restrict__ wkv_t, TKV* __restrict__ dkv,
                    long long nrows, int D, int Dp, int Do) {
  __shared__ __align__(16) float a_s[kDwRows][kDwTile];
  __shared__ __align__(16) float b_s[kDwRows][kDwTile];
  const long long r0 = (long long)blockIdx.y * kDwTile;
  const int c0 = blockIdx.x * kDwTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < 2 * Dp; k0 += kDwRows) {
    for (int e = tid; e < kDwRows * kDwTile; e += kThreads) {
      const int kk = e / kDwTile, rr = e % kDwTile;
      const int k = k0 + kk;
      const long long r = r0 + rr;
      float a = 0.f, w = 0.f;
      if (k < 2 * Dp) {
        if (r < nrows) a = k < Dp ? dk_rows[r * Dp + k] : dv_rows[r * Dp + k - Dp];
        if (c0 + rr < Do) w = wkv_t[(size_t)k * Do + c0 + rr];
      }
      a_s[kk][rr] = a;
      b_s[kk][rr] = w;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kDwRows; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bw[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + ty * 4 + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx * 4 + j;
      if (col < D) store1(dkv + r * D + col, acc[i][j]);
    }
  }
}

// Pass 2: part[chunk] = (kvᵀ dk, kvᵀ dv, Σ dk, Σ dv) over the chunk's rows
// (D x Dp each, Σ Dp each; dk and dv rows of stride Dp).
template <typename TKV>
__global__ void __launch_bounds__(kThreads)
hop1_bwd_dw_kernel(const TKV* __restrict__ kv, long long kv_sb, long long kv_sg,
                   long long kv_st, const float* __restrict__ dk_rows,
                   const float* __restrict__ dv_rows, float* __restrict__ part,
                   int G, int Lk, int D, int Dp, long long nrows, long long chunk) {
  __shared__ __align__(16) float a_s[kDwRows][kDwTile];
  __shared__ __align__(16) float b_s[kDwRows][kDwTile];
  const int nI = (D + kDwTile - 1) / kDwTile, nJ = (Dp + kDwTile - 1) / kDwTile;
  const int m = blockIdx.x / (nI * nJ);          // 0: dWk, 1: dWv
  const int i0 = blockIdx.x / nJ % nI * kDwTile;
  const int j0 = blockIdx.x % nJ * kDwTile;
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
        if (j0 + cc < Dp) d = d_rows[r * Dp + j0 + cc];
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
  float* out = part + blockIdx.y * (2 * (size_t)D * Dp + 2 * (size_t)Dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row >= D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx * 4 + j;
      if (col < Dp) out[(size_t)m * D * Dp + (size_t)row * Dp + col] = acc[i][j];
    }
  }
  if (bias && j0 + tid < Dp) out[2 * (size_t)D * Dp + (size_t)m * Dp + j0 + tid] = bsum;
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

size_t bwd_smem_bytes(int qc, int tk, int hg, int D, int h) {
  const Widths W = widths(D, h);
  const size_t Ng = (size_t)hg * W.dkp;
  const size_t floats = bwd_stage_floats((int)Ng, hg >= h ? W.Do : 4) + (size_t)D * tk +
                        4 * Ng * tk + 2 * Ng * qc + (size_t)hg * qc * tk +
                        2 * (size_t)qc * hg;
  return floats * sizeof(float);
}

// Tile plan: the fewest head groups, then the largest kv tile (a multiple of
// 8, at most 64) and then the most query rows per chunk (a multiple of 8,
// at most 32) that fit one block per SM.  False where even one head with 8
// query and 8 kv rows does not fit shared memory.
bool hop1_bwd_plan(int Lq, int Lk, int D, int h, int* qc, int* tk, int* hg, size_t* smem) {
  if (!widths_ok(D, h)) return false;
  const int tk_max = std::min(64, (Lk + kAlign - 1) / kAlign * kAlign);
  const int qc_max = std::min(32, (Lq + kAlign - 1) / kAlign * kAlign);
  for (int n = 1; n <= h; ++n) {
    const int g = (h + n - 1) / n;
    if (n > 1 && g == (h + n - 2) / (n - 1)) continue;   // the same group size
    for (int t = tk_max; t > 0; t -= kAlign)
      for (int c = qc_max; c > 0; c -= kAlign)
        if (bwd_smem_bytes(c, t, g, D, h) <= kSmemLimit) {
          *qc = c;
          *tk = t;
          *hg = g;
          *smem = bwd_smem_bytes(c, t, g, D, h);
          return true;
        }
  }
  return false;
}

int dw_tiles(int D, int Dp) {
  return 2 * ((D + kDwTile - 1) / kDwTile) * ((Dp + kDwTile - 1) / kDwTile);
}

// Row chunks of pass 2: enough blocks to fill the card twice, at least 128
// rows a chunk.
int dw_chunks(long long nrows, int D, int Dp) {
  const int tiles = dw_tiles(D, Dp);
  const long long p = std::min<long long>((kDwBlocksTarget + tiles - 1) / tiles,
                                          (nrows + 127) / 128);
  return (int)std::max<long long>(1, p);
}

long long workspace_floats(int B, int G, int Lq, int Lk, int D, int h) {
  const int Dp = widths(D, h).Dp;
  const long long nrows = (long long)B * G * Lk;
  return (long long)B * G * Lq * Dp + 2 * nrows * Dp +
         (long long)dw_chunks(nrows, D, Dp) * (2LL * D * Dp + 2LL * Dp);
}

template <typename TKV>
int launch(const float* q, const TKV* kv, long long kv_sb, long long kv_sg,
           long long kv_st, const int* mask, const float* dcc, const float* dh,
           const float* lse, const float* wk, const float* bk, const float* wv,
           const float* bv, const float* wkv_t, TKV* dkv, float* dq, float* wgrad,
           float* ws, int B, int G, int Lq, int Lk, int D, int h, float scale,
           cudaStream_t stream) {
  int qc, tk, hg;
  size_t smem;
  if (!hop1_bwd_plan(Lq, Lk, D, h, &qc, &tk, &hg, &smem)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hop1_bwd_kernel<TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Widths W = widths(D, h);
  const int Dp = W.Dp;
  const long long nrows = (long long)B * G * Lk;
  float* dq_part = ws;
  float* dk_rows = dq_part + (size_t)B * G * Lq * Dp;
  float* dv_rows = dk_rows + (size_t)nrows * Dp;
  float* part = dv_rows + (size_t)nrows * Dp;
  hop1_bwd_kernel<TKV><<<B * G, kThreads, smem, stream>>>(
      q, kv, kv_sb, kv_sg, kv_st, mask, dcc, dh, lse, wk, bk, wv, bv, wkv_t, dkv,
      dq_part, dk_rows, dv_rows, G, Lq, Lk, D, h, qc, tk, hg,
      (int)rows_vec4(kv, kv_sb, kv_sg, kv_st, D), scale);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  if (hg < h) {
    const dim3 grid((unsigned)((W.Do + kDwTile - 1) / kDwTile),
                    (unsigned)((nrows + kDwTile - 1) / kDwTile));
    hop1_bwd_dkv_kernel<TKV><<<grid, kThreads, 0, stream>>>(dk_rows, dv_rows, wkv_t, dkv,
                                                           nrows, D, Dp, W.Do);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const int chunks = dw_chunks(nrows, D, Dp);
  hop1_bwd_dw_kernel<TKV><<<dim3(dw_tiles(D, Dp), chunks), kThreads, 0, stream>>>(
      kv, kv_sb, kv_sg, kv_st, dk_rows, dv_rows, part, G, Lk, D, Dp, nrows,
      (nrows + chunks - 1) / chunks);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  rc = sum_middle(dq_part, dq, B, G, (long long)Lq * Dp, stream);
  if (rc != 0) return rc;
  return sum_middle(part, wgrad, 1, chunks, 2LL * D * Dp + 2LL * Dp, stream);
}

}  // namespace

extern "C" {

// Floats of device workspace `bist_hop1_bwd` needs for these shapes.
long long bist_hop1_bwd_workspace(int B, int G, int Lq, int Lk, int D, int h) {
  return workspace_floats(B, G, Lq, Lk, D, h);
}

// Launch the passes on `stream`; returns the CUDA error code of the launches
// (0 = ok), or cudaErrorInvalidValue for widths the kernel does not take
// (those of hop1_fwd.cu).  kv is float32, or bfloat16 when kv_bf16 is set
// (dkv then too), of any alignment; its strides are in elements.  The
// padded head layout of hop1_tiles.cuh: q (B, Lq, Dp), d_concat (B, G, Lq,
// Dp), dh and lse (B, G, Lq, h), wk, wv (D, Dp), bk, bv (Dp), wkv_t = [Wkᵀ ;
// Wvᵀ] (2Dp, Do); dkv (B, G, Lk, D) contiguous, dq (B, Lq, Dp), wgrad =
// [dWk, dWv (D, Dp), dbk, dbv (Dp)]; ws holds bist_hop1_bwd_workspace floats.
int bist_hop1_bwd(const float* q, const void* kv, int kv_bf16, long long kv_sb,
                  long long kv_sg, long long kv_st, const int* mask,
                  const float* dcc, const float* dh, const float* lse,
                  const float* wk, const float* bk, const float* wv,
                  const float* bv, const float* wkv_t, void* dkv, float* dq,
                  float* wgrad, float* ws, int B, int G, int Lq, int Lk, int D,
                  int h, float scale, void* stream) {
  if (B < 1 || G < 1 || Lq < 1 || Lk < 1) return (int)cudaErrorInvalidValue;
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
