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
// only kv is read from device memory and only `out` is written.  For
// training (`hop1_trainable`) it also writes the residuals the backward
// kernel (hop1_bwd.cu) reads: concat, the normalised attention output
// before Wo, and per (row, head) lse = m + log(l); the evaluation path
// passes null pointers and skips those writes.  A row whose columns are all
// masked attends uniformly over the true Lk (as the plain version does; the
// Pallas kernel also counted its padding columns there): no column at or
// past Lk is ever part of a softmax.
//
// Two kernels, chosen by shape before any launch (`hop1_variant`, exported
// as bist_hop1_fwd_variant):
//
// "whole" (hop1_fwd_whole_kernel), for D 64 or 128, a head width d_k a
// multiple of 8 up to 32 and Lk <= 64: the main path's widths
// (flagship t2s B64 G16 Lq32 Lk40 D128 h8, s2t B64 G40 Lq32 Lk16).  Its
// ~4.4 GFLOP at t2s are 85 % weight products (K/V projection 2.7, Wo 1.1,
// attention 0.7), so it is bound by operations, and every product goes to
// the tensor cores:
//   - one block of 8 warps per (b, chunk of <= 32 query rows, 1 group; 2
//     groups of the same b when Lk <= 16) holds the groups' whole kv sets
//     (their rows stacked, padded with zero rows to 16-row tiles), so Wk
//     and Wv pass through shared memory once per block (once per 2 groups at
//     s2t) and every warp is busy: warp w owns columns [w·D/4, (w+1)·D/4) of
//     [K | V] for every row tile;
//   - [kv] x [Wk | Wv], q kᵀ, p v and concat x Wo run as mma.sync m16n8k8
//     TF32 in the 3xTF32 split (hop1_mma.cuh), float32 accumulators in
//     registers: one TF32 pass would be off by ~1e-3 from float32, three
//     keep it.  Where the tile count allows, a step's fragments all load
//     ahead of its products, so that a stretch of code without a branch
//     holds at least 4 independent chains of MMAs (a chain of dependent
//     MMAs issues one every ~24 cycles, independent ones every ~6);
//   - attention: one warp per (group, head) over both 16-row query tiles
//     (when that leaves no warp idle, heads are up to 16 wide and Lk <=
//     40: registers), so that each K and V fragment serves two independent
//     chains; else one per (group, 16 query rows, head).  The scores stay
//     in the MMA's D fragment, the softmax (exact in one pass, base 2)
//     reduces a row over the 4 threads of a quad, the mask is a bit set a
//     thread builds once, and the D fragment is p's A fragment once V's
//     rows are read in the order 0, 2, 4, 6, 1, 3, 5, 7; columns past Lk
//     get p = 0;
//   - the weights stream from L2 through two-stage rings filled by 16-byte
//     cp.async (one barrier per stage, the next chunk in flight during the
//     current one's products): [Wk | Wv] in chunks of kChunk = 32 rows, Wo
//     of kWoChunk = 16; kv (16 bytes a thread in float32, 8 in bfloat16),
//     q, the mask and, behind Wo's first chunk, x come the same way.  Rows
//     are padded (kv, K, V, q, concat: D + 4 floats; [Wk | Wv]: 2D + 8; Wo:
//     D + 8) so that every fragment load hits 32 distinct banks;
//   - shared memory (whole_layout): during the projection the [Wk | Wv]
//     ring (2·32·(2D+8) floats) and the kv tile (rows·(D+4)); after it q
//     (qc·(D+4), in the ring stage that the last chunk leaves free, loaded
//     during that chunk; x's rows once attention is done), concat
//     (groups·qc·(D+4)), K and V (rows·(D+4) each) and the Wo ring
//     (2·16·(D+8)); then the mask's Lk flags.  At the flagship t2s and s2t
//     102,144 bytes: two blocks an SM, 128 registers a thread at most.
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and
// bist_tpu_torch.tools.hop1_probe, PERF.md): the tensor cores as mma.sync
// drives them, a TF32 m16n8k8 every 6.2 cycles on an SM sub-partition (24
// along a dependent chain), ~70 % of the data sheet's TF32 rate, which
// needs wgmma.  A t2s block runs 4,608 MMAs in the projection (40 kv rows
// padded to 48), 960 in attention and 1,536 in Wo: ~43 us of the launch's
// ~0.12 ms of device time at that rate.  A projection with the kv rows as
// the MMA's 8-wide dimension (no padding, 17 % fewer MMAs) ran slower: its
// row tiles split the products into stretches of 2 dependent chains.
//
// "tiled" (hop1_fwd_tiles_kernel): every other width, any D with D % h ==
// 0 (and every grid "whole" cannot copy in 16-byte pieces).  One block of
// 256 threads per (b, g, chunk of up to 32 query rows) takes the heads in
// groups (`hop1_plan`: as few as shared memory allows, one at the main
// path's widths and at D = 1024, h = 8) and, for each group, loops over kv
// tiles of `tk` rows with an online softmax per (row, head): running max m,
// running sum l and the unnormalised f32 accumulator; after the last tile it
// normalises and adds the group's rows of Wo (with x + bo for the first
// group) to out.  Heads are held 4-column padded (hop1_tiles.cuh), so any
// d_k works with zero columns; grids whose rows are not aligned 4-element
// vectors load one element at a time.  Shared memory holds one kv tile (D x
// tk) and one head group's q, K, V and accumulator, so it grows with D only
// through the kv tile.  Its products are FMAs from shared memory: in the
// row-block x weight products a thread owns 8 rows x 2 adjacent columns
// (rows_times_w, hop1_tiles.cuh, shared with hop1_bwd.cu), the weights
// staged through registers once per kv tile; in the attention products a
// thread owns 4 rows x 2 kv columns of one head's scores and 4 rows x 4
// columns of p·v, with K stored transposed.  Above the flagship width its kv
// tiles shrink and the weights stream once per tile (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <initializer_list>

#include "hop1_mma.cuh"
#include "hop1_tiles.cuh"

namespace {

using namespace hop1;

// ---------------------------------------------------------------------------
// "tiled": head groups, kv tiles with an online softmax, FMAs from shared
// memory; any D with D % h == 0 (hop1_tiles.cuh: the padded head layout).

// Floats of the weight stage: the projection's two weights over a group's
// columns, or Wo over the output columns.
__host__ __device__ inline int fwd_stage_floats(int Ng, int Do) {
  const int a = stage_floats(2, Ng), b = stage_floats(1, Do);
  return a > b ? a : b;
}

template <typename TKV>
__global__ void __launch_bounds__(kThreads, 2)
hop1_fwd_tiles_kernel(const float* __restrict__ x, const float* __restrict__ q,
                const TKV* __restrict__ kv, long long kv_sb, long long kv_sg,
                long long kv_st, const int* __restrict__ mask,
                const float* __restrict__ wk, const float* __restrict__ bk,
                const float* __restrict__ wv, const float* __restrict__ bv,
                const float* __restrict__ wo, const float* __restrict__ bo,
                float* __restrict__ out, float* __restrict__ concat_out,
                float* __restrict__ lse_out, int G, int Lq, int Lk, int D, int h,
                int qc, int tk, int hg, int kv_vec, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Widths W = widths(D, h);
  const int dk = W.dk, dkp = W.dkp, Dp = W.Dp, Do = W.Do;
  const int Ng = hg * dkp;     // columns of a full head group
  const int ng = qc / 4;       // groups of 4 query rows
  // every array is a multiple of 4 floats long, so each starts 16-byte aligned
  float* w_s = smem;                          // weight chunks
  float* kv_t = w_s + fwd_stage_floats(Ng, Do);  // D x tk  kv tile, transposed
  float* acc_t = kv_t + D * tk;               // Ng x qc  accumulator (concat)
  float* v_s = acc_t + Ng * qc;               // tk x ncol
  float* k_t = v_s + tk * Ng;                 // ncol x tk  K, transposed
  float* q_t = k_t + Ng * tk;                 // ncol x qc  query, transposed
  float* p_t = q_t + Ng * qc;                 // tk x qh scores / probabilities
  float* m_s = p_t + tk * qc * hg;            // qh running max
  float* l_s = m_s + qc * hg;                 // qh running sum
  float* a_s = l_s + qc * hg;                 // qh rescale of the current tile

  const int tid = threadIdx.x;
  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int q0 = blockIdx.y * qc;
  const int nq = min(qc, Lq - q0);
  const TKV* kv_bg = kv + b * kv_sb + g * kv_sg;
  const int* mask_b = mask ? mask + (size_t)b * Lk : nullptr;

  // Head groups one after the other: heads [hd0, hd0 + nh), columns
  // [cg, cg + ncol) of the padded layout.  Each adds its concat Wo rows to out.
  for (int hd0 = 0; hd0 < h; hd0 += hg) {
    const int nh = min(hg, h - hd0);
    const int ncol = nh * dkp, cg = hd0 * dkp;
    const int qh = qc * nh;      // (head, row) pairs, row fastest: hd * qc + i
    const int nc4 = ncol / 4;
    __syncthreads();   // the previous group's readers are done
    // rows fastest, so the transposed shared-memory stores hit distinct banks
    for (int i = tid; i < qc * nc4; i += kThreads) {
      const int r = i % qc, d = i / qc * 4;
      const float4 v = r < nq ? *reinterpret_cast<const float4*>(
                                    q + ((size_t)b * Lq + q0 + r) * Dp + cg + d)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      q_t[d * qc + r] = v.x;
      q_t[(d + 1) * qc + r] = v.y;
      q_t[(d + 2) * qc + r] = v.z;
      q_t[(d + 3) * qc + r] = v.w;
    }
    for (int i = tid; i < qc * ncol; i += kThreads) acc_t[i] = 0.f;
    for (int i = tid; i < qh; i += kThreads) {
      m_s[i] = -INFINITY;
      l_s[i] = 0.f;
    }

    for (int t0 = 0; t0 < Lk; t0 += tk) {
      const int nt = min(tk, Lk - t0);
      __syncthreads();   // the previous tile's readers are done
      load_rows_t(kv_bg, kv_st, t0, nt, D, tk, kv_t, kv_vec != 0);
      __syncthreads();

      // K and V of the group's columns for the tile's rows, in groups of 8
      // rows (rows >= nt of the last group come from stale shared memory and
      // are never read), kMaxN columns at a time.
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
              const float bj = j ? bk2.y : bk2.x;
              float4* kt = reinterpret_cast<float4*>(k_t + (cc + j) * tk + r0);
              kt[0] = make_float4(acc[0][0][j] + bj, acc[0][1][j] + bj,
                                  acc[0][2][j] + bj, acc[0][3][j] + bj);
              kt[1] = make_float4(acc[0][4][j] + bj, acc[0][5][j] + bj,
                                  acc[0][6][j] + bj, acc[0][7][j] + bj);
            }
#pragma unroll
            for (int i = 0; i < kRM; ++i)
              *reinterpret_cast<float2*>(v_s + (r0 + i) * ncol + cc) =
                  make_float2(acc[1][i][0] + bv2.x, acc[1][i][1] + bv2.y);
          }
        }
      }
      __syncthreads();

      // Scores: a thread owns 4 rows x 2 kv columns of one head.
      const int ntp = (nt + 1) / 2;
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
      for (int item = tid; item < ng * nc4; item += kThreads) {
        const int i0 = item % ng * 4, c0 = item / ng * 4;
        const int ih0 = c0 / dkp * qc + i0;
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
          const float4 v4 = *reinterpret_cast<const float4*>(v_s + t * ncol + c0);
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
    for (int item = tid; item < qc * ncol; item += kThreads) {
      const int i = item % qc, c = item / qc;
      acc_t[item] /= l_s[c / dkp * qc + i];
    }
    __syncthreads();

    // Training residuals: concat (the rows of acc_t, in the padded layout) and
    // per-head lse = m + log(l), the log-sum-exp of the scores as the softmax
    // saw them (-1e9 on masked columns).  A thread writes 4 columns of one row.
    if (concat_out != nullptr) {
      const size_t row0 = ((size_t)b * G + g) * Lq + q0;
      for (int item = tid; item < qc * nc4; item += kThreads) {
        const int i = item % qc, c = item / qc * 4;
        if (i < nq)
          *reinterpret_cast<float4*>(concat_out + (row0 + i) * Dp + cg + c) =
              make_float4(acc_t[c * qc + i], acc_t[(c + 1) * qc + i],
                          acc_t[(c + 2) * qc + i], acc_t[(c + 3) * qc + i]);
      }
      for (int ih = tid; ih < qh; ih += kThreads) {
        const int i = ih % qc, hd = ih / qc;
        if (i < nq) lse_out[(row0 + i) * h + hd0 + hd] = m_s[ih] + logf(l_s[ih]);
      }
    }

    // out = x + (concat Wo + bo), the group's rows of Wo at a time, kMaxN of
    // its columns at a time; the first group writes x + bo + its share, the
    // others add theirs (each thread to the elements it wrote).
    for (int ob = 0; ob < Do; ob += kMaxN) {
      const int nb = min(kMaxN, Do - ob), ncp = nb / 2;
      const int n_out = qc / kRM * ncp;
      for (int base = 0; base < n_out; base += kThreads) {
        const int item = base + tid;
        const bool active = item < n_out;
        const int c = item % ncp * 2, r0 = item / ncp * kRM;
        float acc[1][kRM][2] = {};
        const float* wo_g = wo + (size_t)cg * Do + ob;
        rows_times_w<1>(acc_t, qc, r0, active, wo_g, wo_g, Do, ncol, nb, w_s, c, acc);
        if (active) {
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            if (r0 + i >= nq) continue;
            const int row = q0 + r0 + i;
            float* o = out + (((size_t)b * G + g) * Lq + row) * D;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = ob + c + j;
              if (col < D)
                o[col] = hd0 == 0 ? x[((size_t)b * Lq + row) * D + col] +
                                        (acc[0][i][j] + bo[col])
                                  : o[col] + acc[0][i][j];
            }
          }
        }
      }
    }
  }
}

size_t smem_bytes(int qc, int tk, int hg, int D, int h) {
  const Widths W = widths(D, h);
  const size_t Ng = (size_t)hg * W.dkp;
  const size_t floats = fwd_stage_floats((int)Ng, W.Do) + (size_t)D * tk + 3 * Ng * tk +
                        2 * Ng * qc + (size_t)tk * qc * hg + 3 * (size_t)qc * hg;
  return floats * sizeof(float);
}

// Tile plan: the fewest head groups, then the most query rows per block (a
// multiple of 8, at most 32) and then the largest kv tile (a multiple of 8,
// at most 64) that fit two blocks per SM, else one.  False where even one
// head with 8 query and 8 kv rows does not fit shared memory.
bool hop1_plan(int Lq, int Lk, int D, int h, int* qc, int* tk, int* hg, size_t* smem) {
  if (!widths_ok(D, h)) return false;
  const int tk_max = std::min(64, (Lk + kAlign - 1) / kAlign * kAlign);
  const int qc_max = std::min(32, (Lq + kAlign - 1) / kAlign * kAlign);
  for (int n = 1; n <= h; ++n) {
    const int g = (h + n - 1) / n;
    if (n > 1 && g == (h + n - 2) / (n - 1)) continue;   // the same group size
    for (int c = qc_max; c > 0; c -= kAlign)
      for (size_t limit : {kSmemTarget, kSmemLimit})
        for (int t = tk_max; t > 0; t -= kAlign)
          if (smem_bytes(c, t, g, D, h) <= limit) {
            *qc = c;
            *tk = t;
            *hg = g;
            *smem = smem_bytes(c, t, g, D, h);
            return true;
          }
  }
  return false;
}

// ---------------------------------------------------------------------------
// "whole": all kv rows of a group (or of several groups of one batch row)
// in one tile, every product on the tensor cores.

// Phase boundaries of the whole kernel (0 prologue, 1 projection, 2 drain,
// 3 bias, 4 attention, 5 concat, 6 Wo, 7 end): nothing in the port's build;
// bist_tpu_torch.tools.hop1_probe builds a copy that records clock64() there.
#ifndef HOP1_MARK
#define HOP1_MARK(k)
#endif

constexpr int kChunk = 32;       // [Wk | Wv] rows per ring stage
constexpr int kWoChunk = 16;     // Wo rows per ring stage
constexpr int kWholeMaxRows = 64;  // kv rows a block projects
constexpr int kWholeThreads = 256;
constexpr int kWarps = kWholeThreads / 32;

// Shared-memory plan of the whole kernel, in floats (every offset a multiple
// of 4, so every array starts 16-byte aligned).  Both weight rings have two
// stages.  During the projection: the [Wk | Wv] ring (stage 0 at 0, stage 1
// after it) and the kv tile.  After it: q (at 0, inside ring stage 0, which
// the last weight chunk leaves free), concat, K, V and the Wo ring.  The
// mask's column flags come last.
struct WholeLayout {
  int qc;      // query rows a block takes: 16 or 32
  int mt;      // 16-row tiles of the projected kv rows
  int ldkv;    // row stride of the kv tile, in grid elements
  int ldw, ldo, ld;  // [Wk | Wv] and Wo ring rows; K, V, q, concat rows
  int kv_off, acc_off, k_off, v_off, wo_off, mask_off, floats;
};

// kv rows the projection must cover: group j's rows start at j·Lk, and its
// attention reads whole 8-row tiles from there.
__host__ __device__ inline int whole_rows(int ng, int Lk) {
  return (ng - 1) * Lk + (Lk + 7) / 8 * 8;
}

__host__ __device__ inline WholeLayout whole_layout(int Lq, int Lk, int D, int ng,
                                                    int kv_bytes) {
  WholeLayout s;
  s.qc = Lq <= 16 ? 16 : 32;
  s.mt = (whole_rows(ng, Lk) + 15) / 16;
  const int rows = 16 * s.mt;
  s.ldkv = kv_bytes == 4 ? D + 4 : D + 8;  // 4 words (mod 32): A fragments
  s.ldw = 2 * D + 8;                       // 8 words (mod 32): B fragments
  s.ldo = D + 8;
  s.ld = D + 4;
  s.kv_off = 2 * kChunk * s.ldw;
  const int during = s.kv_off + (rows * s.ldkv * kv_bytes / 4 + 3) / 4 * 4;
  s.acc_off = s.qc * s.ld;                 // q: qc x ld at 0
  s.k_off = s.acc_off + ng * s.qc * s.ld;
  s.v_off = s.k_off + rows * s.ld;
  s.wo_off = s.v_off + rows * s.ld;
  const int after = s.wo_off + 2 * kWoChunk * s.ldo;
  s.mask_off = during > after ? during : after;   // Lk column flags (int)
  s.floats = s.mask_off + kWholeMaxRows;
  return s;
}

// Issue chunk c of [Wk | Wv] (rows c·kChunk.., 2D floats each) into buf.
template <int D>
__device__ __forceinline__ void issue_wkv(float* buf, const float* __restrict__ wk,
                                          const float* __restrict__ wv, int c, int ldw) {
  constexpr int n4 = D / 4;
  for (int i = threadIdx.x; i < kChunk * 2 * n4; i += kWholeThreads) {
    const int r = i / (2 * n4), f = i % (2 * n4);
    const size_t row = (size_t)(c * kChunk + r) * D;
    cp_async16(buf + r * ldw + 4 * f, f < n4 ? wk + row + 4 * f : wv + row + 4 * (f - n4));
  }
}

// Issue chunk c of Wo (rows c·kWoChunk.., D floats each) into buf.
template <int D>
__device__ __forceinline__ void issue_wo(float* buf, const float* __restrict__ wo, int c,
                                         int ldo) {
  constexpr int n4 = D / 4;
  for (int i = threadIdx.x; i < kWoChunk * n4; i += kWholeThreads) {
    const int r = i / n4, f = i % n4;
    cp_async16(buf + r * ldo + 4 * f, wo + (size_t)(c * kWoChunk + r) * D + 4 * f);
  }
}

// Issue the kv rows of groups g0 .. g0 + ng - 1 (group j's row t to row
// j·Lk + t of kv_s) and zero the rows after them up to `rows`.
template <typename TKV, int D>
__device__ __forceinline__ void issue_kv(TKV* kv_s, int ldkv, const TKV* __restrict__ kv_b,
                                         long long kv_sg, long long kv_st, int Lk, int ng,
                                         int rows) {
  constexpr int n4 = D / 4;
  for (int i = threadIdx.x; i < rows * n4; i += kWholeThreads) {
    const int r = i / n4, e = i % n4 * 4;
    TKV* dst = kv_s + r * ldkv + e;
    const TKV* src = kv_b + (r / Lk) * kv_sg + (r % Lk) * kv_st + e;
    if (sizeof(TKV) == 4) {
      if (r < ng * Lk)
        cp_async16(dst, src);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      if (r < ng * Lk)
        cp_async8(dst, src);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
    }
  }
}

// Issue query rows q0 .. q0 + nq - 1 of batch row b into q_s and zero the
// rest up to qc.
template <int D>
__device__ __forceinline__ void issue_q(float* q_s, int ld, const float* __restrict__ q_b,
                                        int nq, int qc) {
  constexpr int n4 = D / 4;
  for (int i = threadIdx.x; i < qc * n4; i += kWholeThreads) {
    const int r = i / n4, e = i % n4 * 4;
    if (r < nq)
      cp_async16(q_s + r * ld + e, q_b + (size_t)r * D + e);
    else
      *reinterpret_cast<float4*>(q_s + r * ld + e) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One attention task of the whole kernel: kQT tiles of 16 query rows (from
// tile mi0) x one head of one group, in one warp.  Scores q kᵀ and p v are
// m16n8k8 3xTF32 products whose operands come from shared memory (q, K, V)
// or registers (p, as the scores' D fragment); each K and V fragment serves
// the kQT query tiles, whose products are independent chains.  The softmax
// runs on the D fragment, a row spread over the 4 threads of a quad; bit
// 2n + e of `valid` / `inside` says whether this thread's score column
// n·8 + 2·ft + e is unmasked / inside Lk.  Writes the head's columns of
// concat to acc (row-major) and, for training, lse = m + log(l).
template <int kMaxNT, int kDk8, int kQT>
__device__ __forceinline__ void attention_task(
    const float* q_s, const float* k_s, const float* v_s, float* acc, int ld, int mi0,
    int hd, int dk, int r0, int Lk, uint32_t valid, uint32_t inside, float scale,
    float* lse_row, int h, int nq, int fg, int ft) {
  const int ntk = (Lk + 7) / 8;          // 8-column tiles of the scores
  const int nd = dk / 8;                 // 8-column tiles of the head
  float s[kQT][kMaxNT][4];
#pragma unroll
  for (int i = 0; i < kQT; ++i)
#pragma unroll
    for (int n = 0; n < kMaxNT; ++n) s[i][n][0] = s[i][n][1] = s[i][n][2] = s[i][n][3] = 0.f;
  for (int ks = 0; ks < nd; ++ks) {
    uint32_t ah[kQT][4], al[kQT][4];
#pragma unroll
    for (int i = 0; i < kQT; ++i)
      load_a_rows(q_s + (mi0 + i) * 16 * ld + hd * dk + ks * 8, ld, fg, ft, ah[i], al[i]);
#pragma unroll
    for (int n = 0; n < kMaxNT; ++n) {
      if (n < ntk) {
        uint32_t bh[2], bl[2];
        load_b_t(k_s + (r0 + n * 8) * ld + hd * dk + ks * 8, ld, fg, ft, bh, bl);
#pragma unroll
        for (int i = 0; i < kQT; ++i) mma_3xtf32<false>(s[i][n], ah[i], al[i], bh, bl);
      }
    }
  }
  // scale (to base 2) and mask; columns past Lk take no part (exp2(-inf) = 0)
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;
  float mx[kQT][2], sum[kQT][2];
#pragma unroll
  for (int i = 0; i < kQT; ++i) {
    mx[i][0] = mx[i][1] = -INFINITY;
    sum[i][0] = sum[i][1] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < kMaxNT; ++n) {
    if (n < ntk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t bit = 1u << (2 * n + (e & 1));
#pragma unroll
        for (int i = 0; i < kQT; ++i) {
          s[i][n][e] = (valid & bit) ? s[i][n][e] * scale2
                                     : ((inside & bit) ? kMaskedScore * kLog2e : -INFINITY);
          mx[i][e >> 1] = fmaxf(mx[i][e >> 1], s[i][n][e]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kQT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[i][r] = fmaxf(mx[i][r], __shfl_xor_sync(0xffffffffu, mx[i][r], 1));
      mx[i][r] = fmaxf(mx[i][r], __shfl_xor_sync(0xffffffffu, mx[i][r], 2));
    }
#pragma unroll
  for (int n = 0; n < kMaxNT; ++n) {
    if (n < ntk) {
#pragma unroll
      for (int i = 0; i < kQT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][n][e] = exp2f(s[i][n][e] - mx[i][e >> 1]);
          sum[i][e >> 1] += s[i][n][e];
        }
    }
  }
  float inv[kQT][2];
#pragma unroll
  for (int i = 0; i < kQT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[i][r] += __shfl_xor_sync(0xffffffffu, sum[i][r], 1);
      sum[i][r] += __shfl_xor_sync(0xffffffffu, sum[i][r], 2);
      const int row = (mi0 + i) * 16 + r * 8 + fg;
      if (lse_row != nullptr && ft == 0 && row < nq)
        lse_row[(size_t)row * h + hd] = (mx[i][r] + log2f(sum[i][r])) * 0.6931471805599453f;
      inv[i][r] = 1.f / sum[i][r];
    }
  // p v: the scores' tile n is k-step n, its columns 2t, 2t + 1 are k = t,
  // t + 4, and V's rows are taken in that order
  float o[kQT][kDk8][4];
#pragma unroll
  for (int i = 0; i < kQT; ++i)
#pragma unroll
    for (int c = 0; c < kDk8; ++c) o[i][c][0] = o[i][c][1] = o[i][c][2] = o[i][c][3] = 0.f;
#pragma unroll
  for (int n = 0; n < kMaxNT; ++n) {
    if (n < ntk) {
      uint32_t ah[kQT][4], al[kQT][4];
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        split_tf32(s[i][n][0] * inv[i][0], ah[i][0], al[i][0]);
        split_tf32(s[i][n][2] * inv[i][1], ah[i][1], al[i][1]);
        split_tf32(s[i][n][1] * inv[i][0], ah[i][2], al[i][2]);
        split_tf32(s[i][n][3] * inv[i][1], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int c = 0; c < kDk8; ++c) {
        if (c < nd) {
          uint32_t bh[2], bl[2];
          load_b_pairs(v_s + (r0 + n * 8) * ld + hd * dk + c * 8, ld, fg, ft, bh, bl);
#pragma unroll
          for (int i = 0; i < kQT; ++i) mma_3xtf32<false>(o[i][c], ah[i], al[i], bh, bl);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kQT; ++i)
#pragma unroll
    for (int c = 0; c < kDk8; ++c) {
      if (c < nd) {
        float* dst = acc + ((mi0 + i) * 16 + fg) * ld + hd * dk + c * 8 + 2 * ft;
        *reinterpret_cast<float2*>(dst) = make_float2(o[i][c][0], o[i][c][1]);
        *reinterpret_cast<float2*>(dst + 8 * ld) = make_float2(o[i][c][2], o[i][c][3]);
      }
    }
}

// NT: D / 32; kMT: most 16-row tiles of projected kv rows; kG: most groups
// a block takes (see whole_short); kDk8: most 8-column tiles of a head.
template <typename TKV, int NT, int kMT, int kG, int kDk8>
__global__ void __launch_bounds__(kWholeThreads, 2)
hop1_fwd_whole_kernel(const float* __restrict__ x, const float* __restrict__ q,
                      const TKV* __restrict__ kv, long long kv_sb, long long kv_sg,
                      long long kv_st, const int* __restrict__ mask,
                      const float* __restrict__ wk, const float* __restrict__ bk,
                      const float* __restrict__ wv, const float* __restrict__ bv,
                      const float* __restrict__ wo, const float* __restrict__ bo,
                      float* __restrict__ out, float* __restrict__ concat_out,
                      float* __restrict__ lse_out, int G, int Lq, int Lk, int h,
                      int ng_max, float scale) {
  constexpr int D = 32 * NT;
  constexpr int nchunk = D / kChunk;
  constexpr int nwo = D / kWoChunk;
  constexpr int kNTW = (8 * NT + kWarps - 1) / kWarps;   // n-tiles of [K | V] a warp
  constexpr bool kExact = sizeof(TKV) == 2;   // bfloat16 is exact in TF32
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const WholeLayout L = whole_layout(Lq, Lk, D, ng_max, sizeof(TKV));
  const int dk = D / h, qc = L.qc, ld = L.ld;
  const int stage = kChunk * L.ldw;                    // [Wk | Wv] ring stage
  float* ring = smem;
  TKV* kv_s = reinterpret_cast<TKV*>(smem + L.kv_off); // rows x ldkv
  float* q_s = smem;                                   // qc x ld
  float* acc_s = smem + L.acc_off;                     // ng x qc x ld: concat
  float* k_s = smem + L.k_off;                         // rows x ld
  float* v_s = smem + L.v_off;                         // rows x ld
  float* wo_ring = smem + L.wo_off;
  int* valid_s = reinterpret_cast<int*>(smem + L.mask_off);   // Lk column flags

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4;              // fragment coordinates
  const int gblocks = (G + ng_max - 1) / ng_max;
  const int b = blockIdx.x / gblocks;
  const int g0 = blockIdx.x % gblocks * ng_max;
  const int ng = min(ng_max, G - g0);
  const int q0 = blockIdx.y * qc;
  const int nq = min(qc, Lq - q0);
  const int* mask_b = mask ? mask + (size_t)b * Lk : nullptr;

  HOP1_MARK(0);
  // Copy group 0: the kv rows, the mask and weight chunk 0.  Chunk c lies
  // in ring stage (c + nchunk) % 2, so that the last one is in stage 1.
  issue_kv<TKV, D>(kv_s, L.ldkv, kv + b * kv_sb + g0 * kv_sg, kv_sg, kv_st, Lk, ng,
                   16 * L.mt);
  for (int t = tid; t < Lk; t += kWholeThreads) {
    if (mask_b != nullptr)
      cp_async4(valid_s + t, mask_b + t);
    else
      valid_s[t] = 1;
  }
  issue_wkv<D>(ring + nchunk % 2 * stage, wk, wv, 0, L.ldw);
  cp_async_commit();

  HOP1_MARK(1);
  // [K | V] = kv [Wk | Wv]: warp w owns n-tiles [w·kNTW, (w+1)·kNTW) of
  // every 16-row tile (none past 2D).
  const int col0 = warp * kNTW * 8;
  const bool proj = col0 < 2 * D;
  float acc[kMT][kNTW][4] = {};
  for (int c = 0; c < nchunk; ++c) {
    cp_async_wait<0>();
    __syncthreads();   // chunk c landed for all; chunk c - 1's stage is free
    if (c + 1 < nchunk)
      issue_wkv<D>(ring + (c + 1 + nchunk) % 2 * stage, wk, wv, c + 1, L.ldw);
    else   // the query rows, into stage 0
      issue_q<D>(q_s, ld, q + ((size_t)b * Lq + q0) * D, nq, qc);
    cp_async_commit();
    if (!proj) continue;
    const float* wb = ring + (c + nchunk) % 2 * stage;
    const TKV* kvc = kv_s + c * kChunk;   // the chunk's first weight row
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      uint32_t bh[kNTW][2], bl[kNTW][2];
#pragma unroll
      for (int j = 0; j < kNTW; ++j)
        load_b(wb + ks * 8 * L.ldw + col0 + j * 8, L.ldw, fg, ft, bh[j], bl[j]);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < L.mt) {
          uint32_t ah[4], al[4];
          load_a_rows<kExact>(kvc + m * 16 * L.ldkv + ks * 8, L.ldkv, fg, ft, ah, al);
#pragma unroll
          for (int j = 0; j < kNTW; ++j) mma_3xtf32<kExact>(acc[m][j], ah, al, bh[j], bl[j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring and the kv tile are dead; q has landed

  HOP1_MARK(2);
  // Wo's first chunk streams in behind the bias and the attention.
  issue_wo<D>(wo_ring, wo, 0, L.ldo);
  cp_async_commit();

  HOP1_MARK(3);
  // + bias, K and V row-major (rows x ld).  Rows past the groups' get the
  // bias alone and only ever meet p = 0.
  if (proj) {
    const bool is_v = col0 >= D;
    float* dst = is_v ? v_s : k_s;
#pragma unroll
    for (int j = 0; j < kNTW; ++j) {
      const int c = col0 + j * 8 + 2 * ft - (is_v ? D : 0);
      const float2 bias = *reinterpret_cast<const float2*>((is_v ? bv : bk) + c);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < L.mt) {
          const int r = m * 16 + fg;
          *reinterpret_cast<float2*>(dst + r * ld + c) =
              make_float2(acc[m][j][0] + bias.x, acc[m][j][1] + bias.y);
          *reinterpret_cast<float2*>(dst + (r + 8) * ld + c) =
              make_float2(acc[m][j][2] + bias.x, acc[m][j][3] + bias.y);
        }
      }
    }
  }
  // this thread's score columns n·8 + 2·ft + e of a group: bit 2n + e set
  // inside Lk (`inside`) and where unmasked (`valid`)
  constexpr int kNT = 2 * kMT / kG;   // 8-column tiles of one group's scores
  uint32_t valid = 0, inside = 0;
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = n * 8 + 2 * ft + e;
      if (t < Lk) {
        inside |= 1u << (2 * n + e);
        if (valid_s[t] != 0) valid |= 1u << (2 * n + e);
      }
    }
  __syncthreads();

  HOP1_MARK(4);
  // Attention, one warp a task: (group, head) over both 16-row query tiles
  // when that leaves no warp idle and the registers allow (heads up to 16
  // wide, Lk <= 40), else (group, 16-row tile, head).
  const int mq = qc / 16;
  auto lse_row = [&](int j) {
    return lse_out == nullptr ? nullptr : lse_out + (((size_t)b * G + g0 + j) * Lq + q0) * h;
  };
  constexpr int kPairNT = kNT < 5 ? kNT : 5;
  bool paired = false;
  if constexpr (kDk8 == 2) {
    paired = mq == 2 && ng * h >= kWarps && Lk <= 8 * kPairNT;
    for (int task = warp; paired && task < ng * h; task += kWarps) {
      const int j = task / h, hd = task % h;
      attention_task<kPairNT, kDk8, 2>(q_s, k_s, v_s, acc_s + j * qc * ld, ld, 0, hd, dk,
                                       j * Lk, Lk, valid, inside, scale, lse_row(j), h,
                                       nq, fg, ft);
    }
  }
  if (!paired) {
    for (int task = warp; task < ng * mq * h; task += kWarps) {
      const int j = task / (mq * h), mi = task / h % mq, hd = task % h;
      attention_task<kNT, kDk8, 1>(q_s, k_s, v_s, acc_s + j * qc * ld, ld, mi, hd, dk,
                                   j * Lk, Lk, valid, inside, scale, lse_row(j), h, nq,
                                   fg, ft);
    }
  }
  __syncthreads();

  HOP1_MARK(5);
  // Training residual concat: a thread writes 4 columns of one row.
  if (concat_out != nullptr) {
    constexpr int n4 = D / 4;
    for (int item = tid; item < ng * qc * n4; item += kWholeThreads) {
      const int r = item / n4, e = item % n4 * 4;
      const int j = r / qc, i = r % qc;
      if (i < nq)
        *reinterpret_cast<float4*>(concat_out +
                                   (((size_t)b * G + g0 + j) * Lq + q0 + i) * D + e) =
            *reinterpret_cast<const float4*>(acc_s + r * ld + e);
    }
  }

  HOP1_MARK(6);
  // out = x + (concat Wo + bo): warp w owns n-tiles w, w + 8, .. of the D / 8
  // and every 16-row tile of every group's concat.  A step's fragments all
  // load ahead of its products; tiles past the block's (rows clamped,
  // columns clamped) are computed and not stored.
  constexpr int kWoTiles = (D / 8 + kWarps - 1) / kWarps;
  constexpr int kMaxMQ = 2 * kG;
  const int mo = ng * mq;
  float o[kMaxMQ][kWoTiles][4] = {};
  for (int c = 0; c < nwo; ++c) {
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < nwo) issue_wo<D>(wo_ring + (c + 1) % 2 * kWoChunk * L.ldo, wo, c + 1, L.ldo);
    // x's rows for the epilogue, into q_s (dead since the attention), with
    // the next chunk
    if (c == 0) issue_q<D>(q_s, ld, x + ((size_t)b * Lq + q0) * D, nq, qc);
    cp_async_commit();
    const float* wb = wo_ring + c % 2 * kWoChunk * L.ldo;
    const float* ac = acc_s + c * kWoChunk;
#pragma unroll
    for (int ks = 0; ks < kWoChunk / 8; ++ks) {
      uint32_t bh[kWoTiles][2], bl[kWoTiles][2], ah[kMaxMQ][4], al[kMaxMQ][4];
#pragma unroll
      for (int jj = 0; jj < kWoTiles; ++jj)
        load_b(wb + ks * 8 * L.ldo + min(warp + jj * kWarps, D / 8 - 1) * 8, L.ldo, fg, ft,
               bh[jj], bl[jj]);
#pragma unroll
      for (int m = 0; m < kMaxMQ; ++m)
        load_a_rows(ac + min(m, mo - 1) * 16 * ld + ks * 8, ld, fg, ft, ah[m], al[m]);
#pragma unroll
      for (int m = 0; m < kMaxMQ; ++m)
#pragma unroll
        for (int jj = 0; jj < kWoTiles; ++jj)
          mma_3xtf32<false>(o[m][jj], ah[m], al[m], bh[jj], bl[jj]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // x has landed in q_s
#pragma unroll
  for (int jj = 0; jj < kWoTiles; ++jj) {
    const int n = warp + jj * kWarps;
    if (n >= D / 8) continue;
    const int c = n * 8 + 2 * ft;
    const float2 bo2 = *reinterpret_cast<const float2*>(bo + c);
#pragma unroll
    for (int m = 0; m < kMaxMQ; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = m / mq, i = m % mq * 16 + half * 8 + fg;
        if (m < mo && i < nq) {
          const int row = q0 + i;
          const float2 x2 = *reinterpret_cast<const float2*>(q_s + i * ld + c);
          *reinterpret_cast<float2*>(out + (((size_t)b * G + g0 + j) * Lq + row) * D + c) =
              make_float2(x2.x + (o[m][jj][2 * half] + bo2.x),
                          x2.y + (o[m][jj][2 * half + 1] + bo2.y));
        }
      }
    }
  }
  HOP1_MARK(7);
}

// ---------------------------------------------------------------------------
// Variant choice and launch

enum Variant { kVariantNone = 0, kVariantTiled = 1, kVariantWhole = 2 };

// The whole kernel's two instantiations by kv length: "short" (two groups
// of one batch row a block, at most 32 projected rows: Lk <= 16, the s2t
// launch) halves the weight passes; "long" (one group, at most 64 rows: the
// t2s launch) keeps its registers for the 4 row tiles.
bool whole_short(int Lk) { return whole_rows(2, Lk) <= 32; }

int whole_groups(int G, int Lk) { return whole_short(Lk) && G > 1 ? 2 : 1; }

size_t whole_smem(int Lq, int Lk, int D, int G, int kv_bytes) {
  return (size_t)whole_layout(Lq, Lk, D, whole_groups(G, Lk), kv_bytes).floats *
         sizeof(float);
}

// The kernel a launch at these widths takes; decided by shape and by
// whether kv's rows are aligned 4-element vectors ("whole" copies them in
// 16-byte and 8-byte pieces) alone (the float32 grid's shared memory at two
// groups, the most it can need), never by an error.
int hop1_variant(int Lq, int Lk, int D, int h, bool kv_vec) {
  if (!widths_ok(D, h) || Lq < 1 || Lk < 1) return kVariantNone;
  const int dk = D / h;
  if (kv_vec && (D == 64 || D == 128) && dk % 8 == 0 && dk <= 32 &&
      whole_rows(1, Lk) <= kWholeMaxRows &&
      whole_smem(Lq, Lk, D, 2, 4) <= kSmemLimit)
    return kVariantWhole;
  int qc, tk, hg;
  size_t smem;
  return hop1_plan(Lq, Lk, D, h, &qc, &tk, &hg, &smem) ? kVariantTiled : kVariantNone;
}

// The whole kernel's instantiation for a launch: NT = D / 32 (D 128, the
// flagship's width, or 64, scripts/demo_learning.sh's); "long" (one group, up to 4 16-row tiles) or "short" (whole_short: two
// groups, up to 2); heads up to 16 or up to 32 wide.
#define BIST_HOP1_WHOLE_CASES(X)                                                    \
  switch ((D == 128 ? 4 : 0) + (whole_short(Lk) ? 2 : 0) + (D / h > 16 ? 1 : 0)) {  \
    case 0: X(2, 4, 1, 2); break;                                                   \
    case 1: X(2, 4, 1, 4); break;                                                   \
    case 2: X(2, 2, 2, 2); break;                                                   \
    case 3: X(2, 2, 2, 4); break;                                                   \
    case 4: X(4, 4, 1, 2); break;                                                   \
    case 5: X(4, 4, 1, 4); break;                                                   \
    case 6: X(4, 2, 2, 2); break;                                                   \
    default: X(4, 2, 2, 4); break;                                                  \
  }

template <typename TKV>
const void* whole_kernel(int Lk, int D, int h) {
  const void* fn = nullptr;
#define BIST_HOP1_WHOLE_FN(NT, MT, NG, DK8) \
  fn = reinterpret_cast<const void*>(hop1_fwd_whole_kernel<TKV, NT, MT, NG, DK8>)
  BIST_HOP1_WHOLE_CASES(BIST_HOP1_WHOLE_FN)
#undef BIST_HOP1_WHOLE_FN
  return fn;
}

// The kernel, its threads, dynamic shared memory, grid and tile sizes for a
// launch (qc, tk and heads a group for "tiled"; qc, groups a block for "whole").
struct LaunchSpec {
  const void* fn;
  int threads;
  size_t smem;
  dim3 grid;
  int qc, tk, hg;
};

// `variant` is hop1_variant's choice, or the kernel a measurement asks for:
// "tiled" takes every width hop1_variant takes, "whole" only its own.
template <typename TKV>
bool launch_spec(int variant, int B, int G, int Lq, int Lk, int D, int h, bool kv_vec,
                 LaunchSpec* s) {
  const int chosen = hop1_variant(Lq, Lk, D, h, kv_vec);
  if (chosen == kVariantNone || (variant == kVariantWhole && chosen != kVariantWhole))
    return false;
  if (variant == kVariantWhole) {
    const int ng = whole_groups(G, Lk);
    const WholeLayout L = whole_layout(Lq, Lk, D, ng, sizeof(TKV));
    s->fn = whole_kernel<TKV>(Lk, D, h);
    s->threads = kWholeThreads;
    s->smem = (size_t)L.floats * sizeof(float);
    s->qc = L.qc;
    s->tk = ng;
    s->grid = dim3((unsigned)(B * ((G + ng - 1) / ng)), (unsigned)((Lq + L.qc - 1) / L.qc));
    return true;
  }
  if (variant == kVariantTiled &&
      hop1_plan(Lq, Lk, D, h, &s->qc, &s->tk, &s->hg, &s->smem)) {
    s->fn = reinterpret_cast<const void*>(hop1_fwd_tiles_kernel<TKV>);
    s->threads = kThreads;
    s->grid = dim3((unsigned)(B * G), (unsigned)((Lq + s->qc - 1) / s->qc));
    return true;
  }
  return false;
}

template <typename TKV>
int launch(int variant, const float* x, const float* q, const TKV* kv, long long kv_sb,
           long long kv_sg, long long kv_st, const int* mask, const float* wk,
           const float* bk, const float* wv, const float* bv, const float* wo,
           const float* bo, float* out, float* concat, float* lse, int B, int G,
           int Lq, int Lk, int D, int h, float scale, cudaStream_t stream) {
  LaunchSpec s;
  const bool kv_vec = rows_vec4(kv, kv_sb, kv_sg, kv_st, D);
  if (!launch_spec<TKV>(variant, B, G, Lq, Lk, D, h, kv_vec, &s))
    return (int)cudaErrorInvalidValue;
  if (s.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        s.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (s.fn == reinterpret_cast<const void*>(hop1_fwd_tiles_kernel<TKV>)) {
    hop1_fwd_tiles_kernel<TKV><<<s.grid, s.threads, s.smem, stream>>>(
        x, q, kv, kv_sb, kv_sg, kv_st, mask, wk, bk, wv, bv, wo, bo, out, concat,
        lse, G, Lq, Lk, D, h, s.qc, s.tk, s.hg, (int)kv_vec, scale);
  } else {
#define BIST_HOP1_WHOLE(NT, MT, NG, DK8)                                            \
  hop1_fwd_whole_kernel<TKV, NT, MT, NG, DK8><<<s.grid, s.threads, s.smem, stream>>>( \
      x, q, kv, kv_sb, kv_sg, kv_st, mask, wk, bk, wv, bv, wo, bo, out, concat, lse,  \
      G, Lq, Lk, h, s.tk, scale)
    BIST_HOP1_WHOLE_CASES(BIST_HOP1_WHOLE)
#undef BIST_HOP1_WHOLE
  }
  return (int)cudaGetLastError();
}

template <typename TKV>
int resources(int G, int Lq, int Lk, int D, int h, int* info) {
  LaunchSpec s;
  if (!launch_spec<TKV>(hop1_variant(Lq, Lk, D, h, true), 1, G, Lq, Lk, D, h, true, &s))
    return (int)cudaErrorInvalidValue;
  if (s.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        s.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, s.fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, s.fn, s.threads, s.smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = hop1_variant(Lq, Lk, D, h, true);
  info[1] = (int)s.smem;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  info[4] = blocks;
  info[5] = info[0] == kVariantWhole ? s.tk : 1;
  info[6] = info[0] == kVariantWhole ? h : s.hg;
  return 0;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code of the launch (0 = ok), or
// cudaErrorInvalidValue for widths the kernels do not take (D % h != 0, or
// too wide for shared memory even at one head a group and 8 query and kv
// rows: far above any width the model runs).  kv is float32, or bfloat16
// when kv_bf16 is set, of any alignment; its strides are in elements.  q,
// the weights and the biases come in the padded head layout of
// hop1_tiles.cuh (q (B, Lq, Dp); wk, wv (D, Dp); bk, bv (Dp); wo (Dp, Do);
// bo (D)); with d_k a multiple of 4 and D of 4 that is the plain layout.
// concat (B, G, Lq, Dp) and lse (B, G, Lq, h) are the training residuals:
// both null, or both written.
int bist_hop1_fwd_as(int variant, const float* x, const float* q, const void* kv,
                     int kv_bf16, long long kv_sb, long long kv_sg, long long kv_st,
                     const int* mask, const float* wk, const float* bk,
                     const float* wv, const float* bv, const float* wo,
                     const float* bo, float* out, float* concat, float* lse, int B,
                     int G, int Lq, int Lk, int D, int h, float scale, void* stream);

int bist_hop1_fwd(const float* x, const float* q, const void* kv, int kv_bf16,
                  long long kv_sb, long long kv_sg, long long kv_st,
                  const int* mask, const float* wk, const float* bk,
                  const float* wv, const float* bv, const float* wo,
                  const float* bo, float* out, float* concat, float* lse, int B,
                  int G, int Lq, int Lk, int D, int h, float scale, void* stream) {
  const bool vec = kv_bf16 ? rows_vec4(static_cast<const __nv_bfloat16*>(kv), kv_sb,
                                       kv_sg, kv_st, D)
                           : rows_vec4(static_cast<const float*>(kv), kv_sb, kv_sg,
                                       kv_st, D);
  return bist_hop1_fwd_as(hop1_variant(Lq, Lk, D, h, vec), x, q, kv, kv_bf16, kv_sb,
                          kv_sg, kv_st, mask, wk, bk, wv, bv, wo, bo, out, concat, lse,
                          B, G, Lq, Lk, D, h, scale, stream);
}

// bist_hop1_fwd through the named kernel (1 "tiled", 2 "whole"), for
// measurements that hold the two against each other; cudaErrorInvalidValue
// where that kernel does not take the widths.
int bist_hop1_fwd_as(int variant, const float* x, const float* q, const void* kv,
                     int kv_bf16, long long kv_sb, long long kv_sg, long long kv_st,
                     const int* mask, const float* wk, const float* bk,
                     const float* wv, const float* bv, const float* wo,
                     const float* bo, float* out, float* concat, float* lse, int B,
                     int G, int Lq, int Lk, int D, int h, float scale, void* stream) {
  if (B < 1 || G < 1 || Lq < 1 || Lk < 1 || (concat == nullptr) != (lse == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_bf16)
    return launch(variant, x, q, static_cast<const __nv_bfloat16*>(kv), kv_sb, kv_sg,
                  kv_st, mask, wk, bk, wv, bv, wo, bo, out, concat, lse, B, G, Lq, Lk,
                  D, h, scale, s);
  return launch(variant, x, q, static_cast<const float*>(kv), kv_sb, kv_sg, kv_st, mask,
                wk, bk, wv, bv, wo, bo, out, concat, lse, B, G, Lq, Lk, D, h, scale, s);
}

// The kernel bist_hop1_fwd launches at these widths, kv's rows aligned
// 4-element vectors or not (kv_vec): 2 "whole", 1 "tiled", 0 none (it would
// return cudaErrorInvalidValue).
int bist_hop1_fwd_variant(int Lq, int Lk, int D, int h, int kv_vec) {
  return hop1_variant(Lq, Lk, D, h, kv_vec != 0);
}

// What that kernel takes on the current device at G groups (aligned kv
// rows): info[0] variant, [1] dynamic shared memory bytes, [2] registers a
// thread, [3] local memory bytes a thread (spills and stack), [4] resident
// blocks per SM, [5] groups a block, [6] heads a head group.  Returns the
// CUDA error code (cudaErrorInvalidValue for widths the kernels do not take).
int bist_hop1_fwd_resources(int G, int Lq, int Lk, int D, int h, int kv_bf16,
                            int* info) {
  return kv_bf16 ? resources<__nv_bfloat16>(G, Lq, Lk, D, h, info)
                 : resources<float>(G, Lq, Lk, D, h, info);
}

}  // extern "C"
