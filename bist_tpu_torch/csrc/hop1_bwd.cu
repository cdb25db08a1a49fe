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
// GFLOP, four fifths of it the three D x D products per kv row (the K/V
// recompute, dkv and dW).  So it is bound by operations: 73 us at the 67
// TFLOP/s float32 rate outside the tensor cores, 30 us with every product on
// the tensor cores as 3xTF32 (495 TFLOP/s over three passes).
//
// No float atomics anywhere, so the gradients are the same from run to run:
// dq is one partial per (b, g) and dW one partial per fixed chunk of kv
// rows, both summed in a fixed order by sum_middle_kernel.  Three designs
// for the passes that do the work, chosen by shape before any launch
// (`hop1_bwd_variant`, exported as bist_hop1_bwd_variant; the rule of
// hop1_fwd.cu's `hop1_variant`, "wide"'s from one function of both,
// hop1_gemm.cuh's wide_widths):
//
// "whole", for hop1_fwd.cu's "whole" domain (D 64 or 128, a head width d_k
// a multiple of 8 up to 32, Lk <= 64, kv rows of aligned 4-element vectors)
// at any Lq: the training step's widths (flagship t2s B32 G16 Lk40, s2t B32
// G40 Lk16, both at D 128 h 8).  Every product runs as mma.sync m16n8k8 TF32
// in the 3xTF32 split (hop1_mma.cuh; two passes where the operand is a
// bfloat16 grid, exact in TF32), float32 accumulators in registers:
//   1. hop1_bwd_whole_kernel, one block of 8 warps per (b, g), or per two
//      groups of one b when Lk <= 16 (s2t), which halves the weight passes;
//      the groups' kv rows are stacked and padded with zero rows to 16-row
//      tiles.  [K | V] = kv [Wk | Wv] with [Wk | Wv] streamed from L2
//      through a two-stage ring of 32-row chunks filled by 16-byte cp.async
//      (K1's projection).  Then, for each chunk of up to 32 query rows, one
//      warp per (group, head): s = q kᵀ and dp = d_concat vᵀ in the MMA's D
//      fragments (each K and V fragment feeds the two, independent chains),
//      p and ds in registers with the mask as a bit set, dq = ds k with ds's
//      D fragments as its A fragments (as K1's p·v), straight to the
//      workspace; dv += pᵀ d_concat and dk += dsᵀ q need p and ds as the
//      transposed A operand, so each goes through a 16-row staging tile of
//      the warp in shared memory (the simpler of the two ways; reordering
//      the fragments by shuffles is not tried), dk and dv accumulating in
//      shared memory across query tiles and chunks.  Last, the block's dk
//      and dv rows go to the workspace and dkv = [dk | dv] [Wkᵀ ; Wvᵀ] runs
//      with [Wkᵀ ; Wvᵀ] streamed through the same ring.  Rows are padded so
//      that fragment loads hit 32 distinct banks (the B loads of q and
//      d_concat, whose rows are padded for their A loads, hit 2-way).
//   2. hop1_bwd_dw_whole_kernel: dWk, dWv = kvᵀ [dk | dv] as one product, so
//      each staged kv row serves both weights; a block takes 64 columns of
//      kv (rows of dW) and all 2D columns of [dk | dv] over a fixed chunk of
//      rows (at least 256, enough chunks for one block an SM), two cp.async
//      stages of 32 rows, kvᵀ loaded as the transposed A operand; each
//      stage's products start from zero and are added to a float32 total;
//      dbk, dbv ride along in the blocks of column 0.
// In both, the tensor cores add into their accumulator rounding toward
// zero, so a chain of ~50-100 dependent MMAs drifts by ~1e-6 of its size:
// enough, through dp - Dh and the long dW sums, to put dWk and dbk past the
// 2e-4 agreement at the flagship until every product chain was cut at 12
// MMAs (a 32-row weight chunk, a dW stage, a 16-row query tile, dq's even
// and odd score tiles) and its partial added to a float32 total.  Both "whole"
// kernels also split their operands rounding to nearest (hop1_mma.cuh's
// split_tf32_rn: a = hi + lo to ~22 bits, where K1's truncation keeps
// ~20): K2's outputs are long sums (dW over B·G·Lk rows) and cancellations
// (ds = p (dp - Dh); dbk = Σ dk, analytically 0), whose errors scale with
// the operands'.
// What bounds "whole" now (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and
// bist_tpu_torch.tools.hop1_probe, PERF.md): at the flagship t2s launch
// 0.247 ms of device time for a 0.0295 ms 3xTF32 bound, 2.3x below
// "tiled"'s 0.558.  Pass 1 is ~3/4 of it, at one block of 8 warps an SM
// (169 KB of shared memory, up to 241 registers a thread): a t2s block
// takes ~40 us, of which attention ~16, dkv ~10, the projection ~8,
// against ~9 us of tensor-core work at mma.sync's rate.  Two warps a
// sub-partition cannot hide the latency of the short dependent MMA chains
// and of the splits feeding them: removing two of the three passes of
// every product, or the chunk loads, or the weight ring's loads, in
// instrumented copies showed the time to follow the MMA chains and not the
// memory.  Chosen by that measurement: dk and dv over all row tiles in one
// stretch, dq in two chains, the A operands that all warps read (the kv
// tile, [dk | dv]) split once a block.  The next step is more warps an SM
// (ROADMAP).
//
// "wide", for hop1_fwd.cu's "wide" domain (wide_widths: every D that is a
// multiple of 128 from 256 to 1024 at any Lk and D 128 past 64 kv rows,
// d_k 8, 16, 32, 64 or 128, aligned kv rows; bist_tpu's default d_model 512
// with 8 heads, d_model 1024 with 8, and t2s over a video of more than 64
// clips), reading "wide"'s residuals.  "whole"'s one block a group cannot
// hold a group there (at D 512 its K, V, dK and dV are 320 KB at Lk 40),
// and "tiled" recomputes K/V from 2 MB of weights (8 MB at D 1024) in every
// (b, g) block on the FMA units (at D 1024 3.4x slower than the plain
// path).  Three quarters of the work are the three D x D products, so they
// become GEMMs over every kv row of the launch (M =
// B·G·Lk), the weights resident in L2, on hop1_gemm.cuh's tensor-core GEMM
// in K2's setting (splits rounded to nearest, each k-step's three passes
// added to a float32 total: mma_step).  On the caller's stream:
//   1. hop1_bwd_wide_proj_kernel: [K | V] = kv [Wk | Wv] + [bk | bv] into
//      the workspace (M x 2D), kv read through its strides (K1's stage 1);
//   2. hop1_bwd_wide_attn_kernel: one block of 8 warps a (b, g, kv slice,
//      128 columns: 128 / d_k heads), all of Lq in chunks of 32 rows.  A
//      slice is at most 64 of the group's kv rows (4 tiles of 16, the
//      tiles spread evenly over ceil(tiles / 4) slices: one slice up to 64
//      rows), since a block holds at most 4 tiles' K, V and dq shares (189
//      KB); dK and dV of a slice's
//      rows need only the slice and all of Lq, so the slices' blocks share
//      nothing but the query rows they read.  One warp a (head, 16 kv rows)
//      task computes sᵀ, dpᵀ, pᵀ and dsᵀ with kv rows in the MMA's
//      rows, so that dV = pᵀ d_concat and dK = dsᵀ q take the D fragments
//      as A fragments and stay in registers, written over [K | V] in place
//      (the block has read its K and V columns first); dq's share of each
//      kv tile goes through a staging tile of dsᵀ, and the tiles' shares
//      are summed in order into dq's partial per (b, g, slice), which
//      sum_middle adds over g and the slices in a fixed order.  At d_k 128
//      (one head a block) a task is one half of the head's output columns:
//      two warps compute the same sᵀ and dpᵀ over all 128 columns and each
//      writes 64 columns of dV, dK and dq, which holds a thread to d_k 64's
//      accumulators (64 for dq's share, where a whole head would take 128
//      of the 255 registers) and keeps 8 warps busy on 4 kv tiles;
//   3. hop1_bwd_wide_dkv_kernel: dkv = [dK | dV] [Wkᵀ ; Wvᵀ], one GEMM
//      with a 2D-deep contraction, in kv's dtype;
//   4. hop1_bwd_wide_dw_kernel: [dWk | dWv] = kvᵀ [dK | dV] (D x 2D), kvᵀ
//      staged as the transposed A operand, the rows cut into a fixed number
//      of chunks (one partial each) so that the 32 output tiles at D 512
//      fill the SMs; dbk, dbv as float32 column sums of the staged [dK |
//      dV] tiles in blocked order, not on the tensor cores (dbk is
//      analytically 0).
// Every GEMM and the attention kernel run one block of 8 warps an SM; the
// GEMMs tile D in 128s (at D 1024 dkv contracts over 2D = 2048 rows, and a
// dW chunk has 128 output tiles and an 8.4 MB partial).
// What bounds it: operations.  At the reference width's train step (t2s
// B32 G16 Lq32 Lk40 D512) the three GEMMs are 3 x 21.5 GFLOP and the
// bound is 0.41 ms at 495/3 TFLOP/s; it takes ~1.8 ms of device time, its
// GEMMs at ~110-140 TFLOP/s of TF32 passes (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py, PERF.md).
//
// "tiled", every other width: any D with D % h == 0, heads held 4-column
// padded (hop1_tiles.cuh), grids of any alignment, on the FMA units:
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
//      partial each, enough blocks to fill the card; within a chunk a
//      three-level sum of 16-row steps); dbk, dbv ride along.
// All three end with
//   3. sum_middle_kernel: the partials summed in a fixed order (dq over g,
//      the weight gradients over the row chunks).

#include <math.h>

#include <algorithm>

#include "hop1_gemm.cuh"
#include "hop1_mma.cuh"
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
// (D x Dp each, Σ Dp each; dk and dv rows of stride Dp).  A chunk holds
// thousands of rows (6,827 at D 512 and B·G·Lk = 20,480), and one float32
// sum a row at a time drifts from float32's blocked sums by ~7e-4 there:
// each 16-row step is summed apart, 16 steps into a middle sum, and those
// into the chunk's, so that no sum takes more than 16 terms of its level.
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
  float acc[4][4] = {}, mid[4][4] = {};
  float bsum = 0.f, bmid = 0.f;
  int steps = 0;
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
    float step[4][4] = {};
    float bstep = 0.f;
#pragma unroll 4
    for (int rr = 0; rr < kDwRows; ++rr) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[rr][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[rr][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bw[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) step[i][j] = fmaf(av[i], bw[j], step[i][j]);
      if (bias) bstep += b_s[rr][tid];
    }
    const bool flush = ++steps % 16 == 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mid[i][j] += step[i][j];
        if (flush) {
          acc[i][j] += mid[i][j];
          mid[i][j] = 0.f;
        }
      }
    bmid += bstep;
    if (flush) {
      bsum += bmid;
      bmid = 0.f;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += mid[i][j];
  bsum += bmid;
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

// Pass 3: out[o, j] = Σ_k in[o, k, j] for k = 0 .. n-1, in that order, with
// Kahan's compensation, so that the sum errs by about an ulp of the result
// whatever n ("wide"'s dW adds ~40 chunk partials of up to ~300 at the
// reference width's train step).
__global__ void sum_middle_kernel(const float* __restrict__ in, float* __restrict__ out,
                                  long long outer, int n, long long inner) {
  const long long total = outer * inner;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long o = idx / inner, j = idx % inner;
    const float* p = in + o * n * inner + j;
    float s = 0.f, c = 0.f;
    for (int k = 0; k < n; ++k) {
      const float y = p[k * inner] - c, t = s + y;
      c = (t - s) - y;
      s = t;
    }
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

long long tiled_workspace_floats(int B, int G, int Lq, int Lk, int D, int h) {
  const int Dp = widths(D, h).Dp;
  const long long nrows = (long long)B * G * Lk;
  return (long long)B * G * Lq * Dp + 2 * nrows * Dp +
         (long long)dw_chunks(nrows, D, Dp) * (2LL * D * Dp + 2LL * Dp);
}

template <typename TKV>
int launch_tiled(const float* q, const TKV* kv, long long kv_sb, long long kv_sg,
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

// ---------------------------------------------------------------------------
// "whole": all kv rows of a group (of two groups of one batch row at Lk <=
// 16) in one block, every product on the tensor cores as 3xTF32.

enum Variant { kVariantNone = 0, kVariantTiled = 1, kVariantWhole = 2, kVariantWide = 3 };

// Phase boundaries of the whole pass 1 (0 prologue, 1 projection, 2 bias,
// 3 attention, 4 rows out and the split of [dk | dv], 5 dkv, 6 dkv's store,
// 7 end): nothing in the port's build; bist_tpu_torch.tools.hop1_probe
// builds a copy that records clock64() there.
#ifndef HOP1_BWD_MARK
#define HOP1_BWD_MARK(k)
#endif

constexpr int kWChunk = 32;        // weight rows per ring stage
constexpr int kWholeMaxLk = 64;    // kv rows of one group "whole" takes
constexpr int kWarps = kThreads / 32;
constexpr int kDwRowsW = 32;       // grid rows per stage of the whole dW pass
constexpr int kDwColsW = 64;       // kv columns (dW rows) a whole dW block takes
constexpr int kDwMinRows = 256;    // fewest rows in a chunk of the whole dW pass
constexpr int kDwWholeBlocks = 132;  // one block on each SM of the H100
constexpr int kDwThreads = 512;      // 16 warps a whole dW block

// Shared-memory plan of the whole pass 1, in floats (every offset a multiple
// of 4, so every array starts 16-byte aligned).  Three phases reuse the
// region at 0: the projection (the [Wk | Wv] ring of two kWChunk-row stages,
// then the kv tile and, for a float32 grid, its low TF32 halves), the
// attention backward (K, V, the query chunk, each group's d_concat chunk,
// lse, Dh, and each warp's 16-row staging tile of p and ds) and dkv (the
// [Wkᵀ ; Wvᵀ] ring, then [dk | dv]'s low halves).  The dk and dv
// accumulators (later [dk | dv]'s high halves) and the mask's column flags
// follow.  The A operands every warp reads (the kv tile, [dk | dv]) are
// split once a block instead of once a warp.
struct BwdLayout {
  int qc;      // query rows a chunk: 16 or 32
  int mt;      // 16-row tiles of the block's kv rows
  int mtg;     // 16-row tiles of one group's kv rows
  int ldkv, ldw, ldt, ld, ldp;   // rows: kv tile, [Wk | Wv], [Wkᵀ ; Wvᵀ], the rest, p / ds
  int kv_off, kv_lo_off, v_off, q_off, dcc_off, lse_off, dh_off, p_off, split_off, dk_off,
      dv_off, mask_off, floats;
};

// kv rows the block's tiles cover: group j's rows start at j·Lk and its
// 16-row tiles reach j·Lk + ceil16(Lk).
__host__ __device__ inline int bwd_rows(int ng, int Lk) {
  return (ng - 1) * Lk + (Lk + 15) / 16 * 16;
}

__host__ __device__ inline BwdLayout bwd_layout(int Lq, int Lk, int D, int h, int ng,
                                                int kv_bytes) {
  BwdLayout s;
  s.qc = Lq <= 16 ? 16 : 32;
  s.mt = (bwd_rows(ng, Lk) + 15) / 16;
  s.mtg = (Lk + 15) / 16;
  const int rows = 16 * s.mt;
  const int hq = (ng * s.qc * h + 3) / 4 * 4;
  s.ldkv = kv_bytes == 4 ? D + 4 : D + 8;   // 4 words (mod 32): A fragments
  s.ldw = 2 * D + 8;                        // 8 words (mod 32): B fragments
  s.ldt = D + 8;
  s.ld = D + 4;
  s.ldp = 16 * s.mtg + 8;                   // 8 or 24 words (mod 32): pᵀ fragments
  s.kv_off = 2 * kWChunk * s.ldw;
  s.kv_lo_off = s.kv_off + (rows * s.ldkv * kv_bytes / 4 + 3) / 4 * 4;
  // a float32 tile's low halves follow it (a bfloat16 tile has none)
  const int proj = kv_bytes == 4 ? s.kv_lo_off + rows * s.ldkv : s.kv_lo_off;
  s.v_off = rows * s.ld;                    // K at 0
  s.q_off = 2 * rows * s.ld;
  s.dcc_off = s.q_off + s.qc * s.ld;
  s.lse_off = s.dcc_off + ng * s.qc * s.ld;
  s.dh_off = s.lse_off + hq;
  s.p_off = s.dh_off + hq;
  const int attn = s.p_off + kWarps * 16 * s.ldp;
  s.split_off = 2 * kWChunk * s.ldt;       // [dk | dv]'s low halves, after the ring
  const int dkv = s.split_off + 2 * rows * s.ld;
  s.dk_off = proj > attn ? (proj > dkv ? proj : dkv) : (attn > dkv ? attn : dkv);
  s.dv_off = s.dk_off + rows * s.ld;
  s.mask_off = s.dv_off + rows * s.ld;
  s.floats = s.mask_off + kWholeMaxLk;
  return s;
}

// A warp's 16-row staging tile (row stride ldp) of score-shaped D fragments:
// 8-column tiles n < ncol8.
template <int kNT>
__device__ __forceinline__ void stage_tiles(float* p_s, int ldp, const float (&x)[kNT][4],
                                            int ncol8, int fg, int ft) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    if (n < ncol8) {
      float* dst = p_s + fg * ldp + n * 8 + 2 * ft;
      *reinterpret_cast<float2*>(dst) = make_float2(x[n][0], x[n][1]);
      *reinterpret_cast<float2*>(dst + 8 * ldp) = make_float2(x[n][2], x[n][3]);
    }
  }
}

// acc (kv rows r0 + .., head columns hc ..) += (the staged 16 x kv tile)ᵀ
// times b (16 query rows, row stride ld) over one query tile, for the
// group's rows below Lk only (a row past them may be the next group's).
// The tile's products start from zero and are added to acc in float32
// (see hop1_bwd_dw_whole_kernel).
template <int kMTG, int kDk8>
__device__ __forceinline__ void add_tile_t_product(float* acc_s, const float* p_s,
                                                   const float* b_s, int ld, int ldp, int r0,
                                                   int hc, int nd, int Lk, int mtg, int fg,
                                                   int ft) {
  // every row tile's products in one branch-free stretch (tiles past the
  // group's multiply zeros): kMTG x kDk8 independent chains
  float a[kMTG][kDk8][4];
#pragma unroll
  for (int m = 0; m < kMTG; ++m)
#pragma unroll
    for (int c = 0; c < kDk8; ++c) a[m][c][0] = a[m][c][1] = a[m][c][2] = a[m][c][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t ah[kMTG][4], al[kMTG][4], bh[kDk8][2], bl[kDk8][2];
#pragma unroll
    for (int m = 0; m < kMTG; ++m) {
      if (m < mtg) {
        load_a_cols<false, true>(p_s + ks * 8 * ldp + m * 16, ldp, fg, ft, ah[m], al[m]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) ah[m][i] = al[m][i] = 0u;
      }
    }
#pragma unroll
    for (int c = 0; c < kDk8; ++c) {
      if (c < nd) {
        load_b<true>(b_s + ks * 8 * ld + hc + c * 8, ld, fg, ft, bh[c], bl[c]);
      } else {
        bh[c][0] = bh[c][1] = bl[c][0] = bl[c][1] = 0u;
      }
    }
#pragma unroll
    for (int m = 0; m < kMTG; ++m)
#pragma unroll
      for (int c = 0; c < kDk8; ++c) mma_3xtf32<false>(a[m][c], ah[m], al[m], bh[c], bl[c]);
  }
#pragma unroll
  for (int m = 0; m < kMTG; ++m) {
    const int ra = m * 16 + fg, rb = ra + 8;
#pragma unroll
    for (int c = 0; c < kDk8; ++c) {
      if (m < mtg && c < nd) {
        float2* dst = reinterpret_cast<float2*>(acc_s + (r0 + ra) * ld + hc + c * 8 + 2 * ft);
        float2* dst8 = reinterpret_cast<float2*>(acc_s + (r0 + rb) * ld + hc + c * 8 + 2 * ft);
        if (ra < Lk) *dst = make_float2(dst->x + a[m][c][0], dst->y + a[m][c][1]);
        if (rb < Lk) *dst8 = make_float2(dst8->x + a[m][c][2], dst8->y + a[m][c][3]);
      }
    }
  }
}

// One attention-backward task of the whole kernel, in one warp: 16 query
// rows (tile mi of the chunk) x one head of one group.  s = q kᵀ and dp =
// d_concat vᵀ stay in MMA D fragments (each K and V fragment serves the two
// products: independent chains); p and ds replace them in registers, with
// the mask as bit sets (bit 2n + e: this thread's score column n·8 + 2·ft
// + e is unmasked / inside Lk).  dq = ds k takes ds's D fragments as its A
// fragments (k's rows in pairs) and goes straight to the group's dq
// partial; dv += pᵀ d_concat and dk += dsᵀ q read p, then ds, through the
// warp's staging tile as transposed A fragments.
template <int kNT, int kMTG, int kDk8>
__device__ __forceinline__ void bwd_task(
    const float* q_s, const float* c_s, const float* k_s, const float* v_s, float* dk_s,
    float* dv_s, float* p_s, const float* lse_g, const float* dh_g, float* dq_g, int ld,
    int ldp, int mi, int hd, int dk, int h, int D, int r0, int Lk, int nq, uint32_t valid,
    uint32_t inside, bool uniform, float scale, int fg, int ft) {
  const int ntk = (Lk + 7) / 8;          // 8-column tiles of the scores
  const int mtg = (Lk + 15) / 16;        // 16-row tiles of the group's kv rows
  const int nd = dk / 8;                 // 8-column tiles of the head
  const int qr = mi * 16, hc = hd * dk;
  float s[kNT][4], dp[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  for (int ks = 0; ks < nd; ++ks) {
    uint32_t qh[4], ql[4], ch[4], cl[4];
    load_a_rows<false, true>(q_s + qr * ld + hc + ks * 8, ld, fg, ft, qh, ql);
    load_a_rows<false, true>(c_s + qr * ld + hc + ks * 8, ld, fg, ft, ch, cl);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n < ntk) {
        uint32_t kh[2], kl[2], vh[2], vl[2];
        load_b_t<true>(k_s + (r0 + n * 8) * ld + hc + ks * 8, ld, fg, ft, kh, kl);
        load_b_t<true>(v_s + (r0 + n * 8) * ld + hc + ks * 8, ld, fg, ft, vh, vl);
        mma_3xtf32<false>(s[n], qh, ql, kh, kl);
        mma_3xtf32<false>(dp[n], ch, cl, vh, vl);
      }
    }
  }
  // p = exp(s·scale - lse), ds = p (dp - Dh) scale; both 0 past the chunk's
  // rows, at masked columns and past Lk; a fully masked batch row attends
  // uniformly (p = 1/Lk) and gets ds = 0 (autograd through hop1_plain)
  const int row0 = qr + fg, row1 = row0 + 8;
  const bool in[2] = {row0 < nq, row1 < nq};
  const float lse_r[2] = {lse_g[row0 * h + hd], lse_g[row1 * h + hd]};
  const float dh_r[2] = {dh_g[row0 * h + hd], dh_g[row1 * h + hd]};
  const float inv_lk = 1.f / Lk;
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t bit = 1u << (2 * n + (e & 1));
      const int r = e >> 1;
      float p = 0.f, d = 0.f;
      if (in[r] && (inside & bit)) {
        if (uniform) {
          p = inv_lk;
        } else if (valid & bit) {
          p = expf(s[n][e] * scale - lse_r[r]);
          d = p * (dp[n][e] - dh_r[r]) * scale;
        }
      }
      s[n][e] = p;
      dp[n][e] = d;
    }
  // dq = ds k, the even and the odd score tiles in chains of their own
  float o[2][kDk8][4];
#pragma unroll
  for (int c = 0; c < kDk8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[0][c][e] = o[1][c][e] = 0.f;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    if (n < ntk) {
      uint32_t ah[4], al[4];
      d_as_a<true>(dp[n], ah, al);
#pragma unroll
      for (int c = 0; c < kDk8; ++c) {
        if (c < nd) {
          uint32_t bh[2], bl[2];
          load_b_pairs<true>(k_s + (r0 + n * 8) * ld + hc + c * 8, ld, fg, ft, bh, bl);
          mma_3xtf32<false>(o[n & 1][c], ah, al, bh, bl);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kDk8; ++c) {
    if (c < nd) {
      float* dst = dq_g + (size_t)row0 * D + hc + c * 8 + 2 * ft;
      if (in[0])
        *reinterpret_cast<float2*>(dst) =
            make_float2(o[0][c][0] + o[1][c][0], o[0][c][1] + o[1][c][1]);
      if (in[1])
        *reinterpret_cast<float2*>(dst + 8 * D) =
            make_float2(o[0][c][2] + o[1][c][2], o[0][c][3] + o[1][c][3]);
    }
  }
  // dv += pᵀ d_concat, then dk += dsᵀ q
  stage_tiles<kNT>(p_s, ldp, s, 2 * mtg, fg, ft);
  __syncwarp();
  add_tile_t_product<kMTG, kDk8>(dv_s, p_s, c_s + qr * ld, ld, ldp, r0, hc, nd, Lk, mtg, fg,
                                 ft);
  __syncwarp();
  stage_tiles<kNT>(p_s, ldp, dp, 2 * mtg, fg, ft);
  __syncwarp();
  add_tile_t_product<kMTG, kDk8>(dk_s, p_s, q_s + qr * ld, ld, ldp, r0, hc, nd, Lk, mtg, fg,
                                 ft);
  __syncwarp();
}

// Pass 1 "whole".  NT: D / 32; kMT: most 16-row tiles of the block's kv
// rows; kG: most groups a block takes (2 at Lk <= 16); kDk8: most 8-column
// tiles of a head.  One block of 8 warps per (b, group or pair of groups):
//   1. [K | V] = kv [Wk | Wv] + [bk | bv], warp w owning n-tiles [w·NT,
//      (w+1)·NT) of every row tile, [Wk | Wv] streamed through the ring;
//   2. per chunk of <= 32 query rows: q, d_concat, lse and Dh in, then one
//      warp per (group, head) runs bwd_task over the chunk's 16-row tiles
//      (dk, dv accumulate in shared memory across tiles and chunks; dq's
//      partial of the (b, g) goes to the workspace);
//   3. the dk and dv rows to the workspace (for the dW pass), and dkv = [dk
//      | dv] [Wkᵀ ; Wvᵀ], [Wkᵀ ; Wvᵀ] streamed through the ring, warp w
//      owning n-tiles w, w + 8, .. of every row tile.
template <typename TKV, int NT, int kMT, int kG, int kDk8>
__global__ void __launch_bounds__(kThreads, 1)
hop1_bwd_whole_kernel(const float* __restrict__ q, const TKV* __restrict__ kv,
                      long long kv_sb, long long kv_sg, long long kv_st,
                      const int* __restrict__ mask, const float* __restrict__ dcc,
                      const float* __restrict__ dh, const float* __restrict__ lse,
                      const float* __restrict__ wk, const float* __restrict__ bk,
                      const float* __restrict__ wv, const float* __restrict__ bv,
                      const float* __restrict__ wkv_t, TKV* __restrict__ dkv,
                      float* __restrict__ dq_part, float* __restrict__ dkv_rows, int G,
                      int Lq, int Lk, int h, int ng_max, float scale) {
  constexpr int D = 32 * NT;
  constexpr int nchunk = D / kWChunk;        // [Wk | Wv] chunks
  constexpr int nwc = 2 * D / kWChunk;       // [Wkᵀ ; Wvᵀ] chunks
  constexpr int kNTW = NT;                   // [K | V] n-tiles a warp: 2D / 8 over 8 warps
  constexpr int kMTG = kG == 1 ? kMT : 1;    // 16-row tiles of one group
  constexpr int kNT = 2 * kMTG;              // 8-column score tiles of one group
  constexpr int kOT = D / 8 / kWarps;        // dkv n-tiles a warp
  constexpr bool kExact = sizeof(TKV) == 2;  // bfloat16 is exact in TF32
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const BwdLayout L = bwd_layout(Lq, Lk, D, h, ng_max, sizeof(TKV));
  const int dk = D / h, qc = L.qc, ld = L.ld;
  float* ring = smem;
  TKV* kv_s = reinterpret_cast<TKV*>(smem + L.kv_off);
  uint32_t* kv_hi = reinterpret_cast<uint32_t*>(smem + L.kv_off);   // float32 grids
  uint32_t* kv_lo = reinterpret_cast<uint32_t*>(smem + L.kv_lo_off);
  float* k_s = smem;
  float* v_s = smem + L.v_off;
  float* q_s = smem + L.q_off;
  float* c_s = smem + L.dcc_off;
  float* lse_s = smem + L.lse_off;
  float* dh_s = smem + L.dh_off;
  float* dk_s = smem + L.dk_off;
  float* dv_s = smem + L.dv_off;
  int* valid_s = reinterpret_cast<int*>(smem + L.mask_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4;    // fragment coordinates
  const int gblocks = (G + ng_max - 1) / ng_max;
  const int b = blockIdx.x / gblocks;
  const int g0 = blockIdx.x % gblocks * ng_max;
  const int ng = min(ng_max, G - g0);
  const int rows = 16 * L.mt;
  const size_t bg0 = (size_t)b * G + g0;
  const int* mask_b = mask ? mask + (size_t)b * Lk : nullptr;
  float* p_s = smem + L.p_off + warp * 16 * L.ldp;

  HOP1_BWD_MARK(0);
  // The kv rows and weight chunk 0 in flight; the mask flags; dk, dv zeroed.
  issue_kv<TKV, D>(kv_s, L.ldkv, kv + b * kv_sb + g0 * kv_sg, kv_sg, kv_st, Lk, ng, rows);
  issue_wkv<D, kWChunk>(ring, wk, wv, 0, L.ldw);
  cp_async_commit();
  int any_valid = 0;
  for (int t = tid; t < Lk; t += kThreads) {
    const int v = mask_b == nullptr || mask_b[t] != 0;
    valid_s[t] = v;
    any_valid |= v;
  }
  for (int i = tid; i < 2 * rows * ld; i += kThreads) dk_s[i] = 0.f;   // dv_s follows
  const bool uniform = !__syncthreads_or(any_valid);   // a fully masked batch row

  HOP1_BWD_MARK(1);
  // 1. [K | V] = kv [Wk | Wv]
  const int col0 = warp * kNTW * 8;
  float acc[kMT][kNTW][4] = {};
  for (int c = 0; c < nchunk; ++c) {
    float part[kMT][kNTW][4] = {};   // the chunk's products, added to acc below
    cp_async_wait<0>();
    __syncthreads();   // chunk c landed for all; chunk c - 1's stage is free
    if (c + 1 < nchunk) {
      issue_wkv<D, kWChunk>(ring + (c + 1) % 2 * kWChunk * L.ldw, wk, wv, c + 1, L.ldw);
      cp_async_commit();
    }
    if (!kExact && c == 0) {
      // the float32 kv tile into its TF32 halves, once for all warps
      for (int i = tid; i < rows * L.ldkv; i += kThreads) {
        uint32_t hi, lo;
        split_tf32_rn(to_float(kv_s[i]), hi, lo);
        kv_hi[i] = hi;
        kv_lo[i] = lo;
      }
      __syncthreads();
    }
    const float* wb = ring + c % 2 * kWChunk * L.ldw;
    const TKV* kvc = kv_s + c * kWChunk;   // the chunk's first weight row
#pragma unroll
    for (int ks = 0; ks < kWChunk / 8; ++ks) {
      uint32_t bh[kNTW][2], bl[kNTW][2];
#pragma unroll
      for (int j = 0; j < kNTW; ++j)
        load_b<true>(wb + ks * 8 * L.ldw + col0 + j * 8, L.ldw, fg, ft, bh[j], bl[j]);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < L.mt) {
          uint32_t ah[4], al[4];
          const int at = m * 16 * L.ldkv + c * kWChunk + ks * 8;
          if (kExact)
            load_a_rows<true>(kvc + m * 16 * L.ldkv + ks * 8, L.ldkv, fg, ft, ah, al);
          else
            load_a_split(kv_hi + at, kv_lo + at, L.ldkv, fg, ft, ah, al);
#pragma unroll
          for (int j = 0; j < kNTW; ++j) mma_3xtf32<kExact>(part[m][j], ah, al, bh[j], bl[j]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < kNTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] += part[m][j][e];
  }
  __syncthreads();   // the ring and the kv tile are dead
  HOP1_BWD_MARK(2);
  {
    // + bias, K and V row-major (rows past the groups' get the bias alone
    // and only ever meet p = ds = 0)
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

  // 2. The attention backward, query chunk by query chunk.
  HOP1_BWD_MARK(3);
  const int mq = qc / 16;
  for (int q0 = 0; q0 < Lq; q0 += qc) {
    const int nq = min(qc, Lq - q0);
    __syncthreads();   // K and V stored; the previous chunk's readers are done
    issue_rows<D>(q_s, ld, q + ((size_t)b * Lq + q0) * D, D, nq, qc);
    for (int j = 0; j < ng; ++j)
      issue_rows<D>(c_s + j * qc * ld, ld, dcc + ((bg0 + j) * Lq + q0) * D, D, nq, qc);
    cp_async_commit();
    for (int i = tid; i < ng * qc * h; i += kThreads) {
      const int j = i / (qc * h), r = i / h % qc, hd = i % h;
      const size_t at = ((bg0 + j) * Lq + q0 + r) * h + hd;
      lse_s[i] = r < nq ? lse[at] : 0.f;
      dh_s[i] = r < nq ? dh[at] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int task = warp; task < ng * h; task += kWarps) {
      const int j = task / h, hd = task % h;
      for (int mi = 0; mi < mq; ++mi)
        bwd_task<kNT, kMTG, kDk8>(q_s, c_s + j * qc * ld, k_s, v_s, dk_s, dv_s, p_s,
                                  lse_s + j * qc * h, dh_s + j * qc * h,
                                  dq_part + ((bg0 + j) * Lq + q0) * D, ld, L.ldp, mi, hd,
                                  dk, h, D, j * Lk, Lk, nq, valid, inside, uniform, scale,
                                  fg, ft);
    }
  }
  __syncthreads();   // dk and dv complete; the attention region is dead
  HOP1_BWD_MARK(4);

  // 3. The dk and dv rows for the dW pass, and dkv = [dk | dv] [Wkᵀ ; Wvᵀ].
  issue_w<D, kWChunk>(ring, wkv_t, D, 0, L.ldt);
  cp_async_commit();
  {
    constexpr int n4 = D / 4;
    float* out = dkv_rows + bg0 * Lk * 2 * D;
    for (int i = tid; i < ng * Lk * 2 * n4; i += kThreads) {
      const int r = i / (2 * n4), f = i % (2 * n4);
      const float* src = f < n4 ? dk_s + r * ld + 4 * f : dv_s + r * ld + 4 * (f - n4);
      *reinterpret_cast<float4*>(out + (size_t)r * 2 * D + 4 * f) =
          *reinterpret_cast<const float4*>(src);
    }
  }
  __syncthreads();   // the rows are out: [dk | dv] into TF32 halves, once for all warps
  uint32_t* dkv_hi = reinterpret_cast<uint32_t*>(dk_s);   // dv_s follows dk_s
  uint32_t* dkv_lo = reinterpret_cast<uint32_t*>(smem + L.split_off);
  for (int i = tid; i < 2 * rows * ld; i += kThreads) {
    uint32_t hi, lo;
    split_tf32_rn(dk_s[i], hi, lo);
    dkv_hi[i] = hi;
    dkv_lo[i] = lo;
  }
  float o[kMT][kOT][4] = {};
  HOP1_BWD_MARK(5);
  for (int c = 0; c < nwc; ++c) {
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < nwc) {
      issue_w<D, kWChunk>(ring + (c + 1) % 2 * kWChunk * L.ldt, wkv_t, D, c + 1, L.ldt);
      cp_async_commit();
    }
    const float* wb = ring + c % 2 * kWChunk * L.ldt;
    const int a0 = c * kWChunk < D ? c * kWChunk : rows * ld + (c * kWChunk - D);
    float part[kMT][kOT][4] = {};
#pragma unroll
    for (int ks = 0; ks < kWChunk / 8; ++ks) {
      uint32_t bh[kOT][2], bl[kOT][2];
#pragma unroll
      for (int jj = 0; jj < kOT; ++jj)
        load_b<true>(wb + ks * 8 * L.ldt + (warp + jj * kWarps) * 8, L.ldt, fg, ft, bh[jj], bl[jj]);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < L.mt) {
          uint32_t ah[4], al[4];
          const int at = a0 + m * 16 * ld + ks * 8;
          load_a_split(dkv_hi + at, dkv_lo + at, ld, fg, ft, ah, al);
#pragma unroll
          for (int jj = 0; jj < kOT; ++jj) mma_3xtf32<false>(part[m][jj], ah, al, bh[jj], bl[jj]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int jj = 0; jj < kOT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[m][jj][e] += part[m][jj][e];
  }
  HOP1_BWD_MARK(6);
#pragma unroll
  for (int jj = 0; jj < kOT; ++jj) {
    const int col = (warp + jj * kWarps) * 8 + 2 * ft;
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      if (m < L.mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m * 16 + half * 8 + fg;
          if (r < ng * Lk)
            store2(dkv + (bg0 * Lk + r) * D + col, o[m][jj][2 * half],
                   o[m][jj][2 * half + 1]);
        }
      }
    }
  }
  HOP1_BWD_MARK(7);
}

// Issue one stage of the whole dW pass: rows r0 .. r0 + kDwRowsW - 1 (zeros
// at or past r_end) of the grid's columns i0 .. i0 + kDwColsW - 1 into kv_s
// and of [dk | dv] into d_s.
template <typename TKV, int D>
__device__ __forceinline__ void issue_dw_stage(TKV* kv_s, float* d_s,
                                               const TKV* __restrict__ kv, long long kv_sb,
                                               long long kv_sg, long long kv_st,
                                               const float* __restrict__ dkv_rows, int G,
                                               int Lk, int i0, int r0, int r_end) {
  constexpr int ldk = kDwColsW + 8, ldd = 2 * D + 8;
  constexpr int nk = kDwColsW / 4, nd = 2 * D / 4;
  for (int i = threadIdx.x; i < kDwRowsW * (nk + nd); i += kDwThreads) {
    const int rr = i / (nk + nd), f = i % (nk + nd);
    const int r = r0 + rr;
    if (f < nk) {
      TKV* dst = kv_s + rr * ldk + 4 * f;
      if (r < r_end) {
        const int bgi = r / Lk, t = r % Lk;
        const TKV* src = kv + (bgi / G) * kv_sb + (bgi % G) * kv_sg + t * kv_st + i0 + 4 * f;
        if (sizeof(TKV) == 4)
          cp_async16(dst, src);
        else
          cp_async8(dst, src);
      } else if (sizeof(TKV) == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
      }
    } else {
      float* dst = d_s + rr * ldd + 4 * (f - nk);
      if (r < r_end)
        cp_async16(dst, dkv_rows + (size_t)r * 2 * D + 4 * (f - nk));
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Pass 2 "whole": part[chunk] = (kvᵀ dk, kvᵀ dv, Σ dk, Σ dv) over the chunk's
// rows as one product kvᵀ [dk | dv] (D x 2D), so each staged kv row serves
// both weights.  A block takes kDwColsW columns of kv (rows of dW) and all
// 2D columns of [dk | dv], two stages of kDwRowsW rows through cp.async;
// kvᵀ is the A operand (loaded transposed), warp w owns row tiles 2·(w / 8)
// and the next, and n-tiles [(w % 8)·kNW, (w % 8 + 1)·kNW).  Each stage's
// products start from zero and are added to a float32 total (the file's
// header: the tensor cores' accumulation).  Blocks of column 0 also sum the
// bias gradients.
template <typename TKV, int NT>
__global__ void __launch_bounds__(kDwThreads, 1)
hop1_bwd_dw_whole_kernel(const TKV* __restrict__ kv, long long kv_sb, long long kv_sg,
                         long long kv_st, const float* __restrict__ dkv_rows,
                         float* __restrict__ part, int G, int Lk, int nrows, int chunk) {
  constexpr int D = 32 * NT, N = 2 * D;
  constexpr int kNW = N / 8 / 8;             // n-tiles a warp
  constexpr int ldk = kDwColsW + 8, ldd = N + 8;
  constexpr int kv_floats = kDwRowsW * ldk * (int)sizeof(TKV) / 4;
  constexpr bool kExact = sizeof(TKV) == 2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4;
  const int mh = warp / 8 * 2, wn = warp % 8 * kNW;   // first row tile, first n-tile
  const int i0 = blockIdx.x * kDwColsW;
  const int r_begin = blockIdx.y * chunk, r_end = min(nrows, r_begin + chunk);
  const bool bias = blockIdx.x == 0 && tid < N;
  auto kv_of = [&](int s) { return reinterpret_cast<TKV*>(smem + s * kv_floats); };
  auto d_of = [&](int s) { return smem + 2 * kv_floats + s * kDwRowsW * ldd; };
  float total[2][kNW][4] = {};
  float bsum = 0.f;
  issue_dw_stage<TKV, D>(kv_of(0), d_of(0), kv, kv_sb, kv_sg, kv_st, dkv_rows, G, Lk, i0,
                         r_begin, r_end);
  cp_async_commit();
  int s = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += kDwRowsW, s ^= 1) {
    cp_async_wait<0>();
    __syncthreads();   // stage s landed for all; stage s ^ 1 is free
    if (r0 + kDwRowsW < r_end) {
      issue_dw_stage<TKV, D>(kv_of(s ^ 1), d_of(s ^ 1), kv, kv_sb, kv_sg, kv_st, dkv_rows, G,
                             Lk, i0, r0 + kDwRowsW, r_end);
      cp_async_commit();
    }
    const TKV* ka = kv_of(s);
    const float* db = d_of(s);
    float acc[2][kNW][4] = {};
#pragma unroll
    for (int ks = 0; ks < kDwRowsW / 8; ++ks) {
      uint32_t bh[kNW][2], bl[kNW][2];
#pragma unroll
      for (int jj = 0; jj < kNW; ++jj)
        load_b<true>(db + ks * 8 * ldd + (wn + jj) * 8, ldd, fg, ft, bh[jj], bl[jj]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint32_t ah[4], al[4];
        load_a_cols<kExact, true>(ka + ks * 8 * ldk + (mh + m) * 16, ldk, fg, ft, ah, al);
#pragma unroll
        for (int jj = 0; jj < kNW; ++jj) mma_3xtf32<kExact>(acc[m][jj], ah, al, bh[jj], bl[jj]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int jj = 0; jj < kNW; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[m][jj][e] += acc[m][jj][e];
    if (bias)
      for (int rr = 0; rr < kDwRowsW; ++rr) bsum += db[rr * ldd + tid];
  }
  float* out = part + (size_t)blockIdx.y * (2 * D * D + 2 * D);
#pragma unroll
  for (int jj = 0; jj < kNW; ++jj) {
    const int n = (wn + jj) * 8 + 2 * ft;
    float* o = out + (n >= D ? D * D : 0) + n % D;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(o + (size_t)(i0 + (mh + m) * 16 + half * 8 + fg) * D) =
            make_float2(total[m][jj][2 * half], total[m][jj][2 * half + 1]);
  }
  if (bias) out[2 * D * D + tid] = bsum;
}

// ---------------------------------------------------------------------------
// "wide": wide_widths' D (a multiple of 128 from 256 to 1024, and 128 past
// 64 kv rows) in four kernels and the fixed-order sums, the three D x D
// products as GEMMs over every kv row of the launch (hop1_gemm.cuh in K2's
// setting: splits rounded to nearest, chains of one k-step).

constexpr int kWideBwdThreads = 256;   // an attention-backward block: 8 warps
constexpr int kWideQc = 32;            // query rows a chunk of it
constexpr int kWideDwRows = 512;       // kv rows a chunk of the dW pass

// Stage 1: [K | V] = kv [Wk | Wv] + [bk | bv] into the workspace.
template <typename TKV>
__global__ void __launch_bounds__(kWideThreads, 1)
hop1_bwd_wide_proj_kernel(const TKV* __restrict__ kv, long long kv_sb, long long kv_sg,
                          long long kv_st, const float* __restrict__ wk,
                          const float* __restrict__ bk, const float* __restrict__ wv,
                          const float* __restrict__ bv, float* __restrict__ kvp, int G,
                          int Lk, int D, int M) {
  wide_proj<TKV, true>(kv, kv_sb, kv_sg, kv_st, wk, bk, wv, bv, kvp, G, Lk, D, M);
}

// A group's kv rows are cut into slices of at most kWideSliceTiles 16-row
// tiles (64 rows), one attention-backward block each: S = ceil(tiles /
// kWideSliceTiles) slices, the tiles spread evenly (13 tiles: 4 + 3 + 3 +
// 3).  Up to 64 kv rows S = 1, the whole group in one block.  The slice
// size is K2's own, set by the block's shared memory (wide_bwd_attn_floats,
// checked below), not by K1's kWideMaxLk.
constexpr int kWideSliceTiles = 4;

__host__ __device__ inline int wide_slices(int Lk) {
  return ((Lk + 15) / 16 + kWideSliceTiles - 1) / kWideSliceTiles;
}

// The first 16-row tile of slice s of a group (s = wide_slices(Lk): the
// tile past the last).
__host__ __device__ inline int wide_slice_tile(int Lk, int s) {
  const int mt = (Lk + 15) / 16, S = wide_slices(Lk), extra = mt % S;
  return s * (mt / S) + (s < extra ? s : extra);
}

// Floats of an attention-backward block's shared memory for a slice of mt
// 16-row tiles: K and V (16·mt x ld each), the query chunk's q and
// d_concat (kWideQc x ld each), the dq partials of the mt kv tiles (mt x
// kWideQc x ld) and each warp's 16-row staging tile of dsᵀ.
__host__ __device__ constexpr int wide_bwd_attn_slice_floats(int mt) {
  return (2 * 16 * mt + 2 * kWideQc + mt * kWideQc) * (kWideCols + 4) +
         kWideBwdThreads / 32 * 16 * (kWideQc + 8);
}
static_assert(wide_bwd_attn_slice_floats(kWideSliceTiles) * sizeof(float) <= kSmemLimit,
              "a full slice of K2 \"wide\"'s attention backward exceeds a block's shared memory");

// The same at Lk kv rows: its largest slice, ceil(tiles / S) tiles.
__host__ __device__ inline int wide_bwd_attn_floats(int Lk) {
  const int S = wide_slices(Lk);
  return wide_bwd_attn_slice_floats(((Lk + 15) / 16 + S - 1) / S);
}

// o = (the 16 x kWideQc tile a, as D fragments: kv rows x query rows) times
// b (kWideQc query rows of a head's kDk8 8-column tiles, row stride ld):
// the D fragments serve as A fragments (k = query rows 2t and 2t + 1 of
// each 8-column tile), b's rows read in load_b_pairs' order.
template <int kNQ, int kDk8>
__device__ __forceinline__ void tile_t_times(const float (&a)[kNQ][4], const float* b_s, int ld,
                                             int fg, int ft, float (&o)[kDk8][4]) {
#pragma unroll
  for (int c = 0; c < kDk8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
#pragma unroll
  for (int n = 0; n < kNQ; ++n) {
    uint32_t ah[4], al[4];
    d_as_a<true>(a[n], ah, al);
#pragma unroll
    for (int c = 0; c < kDk8; ++c) {
      uint32_t bh[2], bl[2];
      load_b_pairs<true>(b_s + n * 8 * ld + c * 8, ld, fg, ft, bh, bl);
      mma_step<false>(o[c], ah, al, bh, bl);
    }
  }
}

// A task's kv rows of dK or dV (o: kv rows t0, t0 + 8 x the head's columns
// from `out`, row stride 2D): stored at the first query chunk, added to the
// stored value at later ones; rows at or past Lk are the next group's
// (`inside` false).
template <int kDk8>
__device__ __forceinline__ void store_rows(float* out, int D, int t0, const bool (&inside)[2],
                                           bool add, const float (&o)[kDk8][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!inside[r]) continue;
    float* row = out + (size_t)(t0 + 8 * r) * 2 * D;
#pragma unroll
    for (int c = 0; c < kDk8; ++c) {
      float2* dst = reinterpret_cast<float2*>(row + c * 8);
      float2 v = make_float2(o[c][2 * r], o[c][2 * r + 1]);
      if (add) {
        const float2 was = *dst;
        v = make_float2(was.x + v.x, was.y + v.y);
      }
      *dst = v;
    }
  }
}

// Stage 2: the attention backward of one (b, g), one slice of its kv rows
// (wide_slices: all of them up to 64) and kWideCols columns (hg = kWideCols
// / d_k heads), all of Lq in chunks of kWideQc query rows.  The slice's K
// and V come from the workspace (rows past Lk zeroed to the next 16).  One
// warp a (head, 16-row kv tile m of the slice) task computes the transposed
// products, kv rows in the MMA's rows and query rows in its columns:
//   sᵀ = K_m qᵀ and dpᵀ = V_m d_concatᵀ (every product of the kernel a
//   3xTF32 chain of one k-step: mma_step);
//   pᵀ and dsᵀ in registers (the mask as the flags of the thread's two kv
//   rows, lse and Dh as its query columns');
//   dV_m = pᵀ d_concat and dK_m = dsᵀ q (tile_t_times), written over the
//   block's K and V columns of the workspace (the block read them into
//   shared memory before any write; a later chunk adds to them);
//   dq's share of the tile, ds K_m, with dsᵀ through the warp's staging tile
//   as the transposed A operand, into the block's partial of tile m.
// Then the tiles' partials are summed in order into the (b, g, slice)
// partial of dq.  dK and dV of a slice's rows need only that slice and all
// of Lq, and slices are disjoint: no two tasks or blocks write one element,
// no atomics.  The mask row, p = 1/Lk of a fully masked batch row, lse and
// Dh are the group's whole ones.  The semantics of autograd through
// hop1_plain, as bwd_task's.  kDk8 = d_k / 8.  Past d_k 64 a task writes
// one half of its head's columns (kParts tasks a head and kv tile, the same
// sᵀ and dpᵀ in each): a thread holds at most 8 8-column output tiles.
template <int kDk8>
__global__ void __launch_bounds__(kWideBwdThreads, 1)
hop1_bwd_wide_attn_kernel(const float* __restrict__ q, float* kvp, const int* __restrict__ mask,
                          const float* __restrict__ dcc, const float* __restrict__ dh,
                          const float* __restrict__ lse, float* __restrict__ dq_part, int G,
                          int Lq, int Lk, int D, int h, float scale) {
  constexpr int ld = kWideCols + 4;      // 4 words (mod 32): A and B fragments
  constexpr int ldst = kWideQc + 8;      // 8 words (mod 32): transposed A fragments
  constexpr int dk = 8 * kDk8, hg = kWideCols / dk;
  constexpr int kNQ = kWideQc / 8;       // 8-column tiles of sᵀ (query rows)
  constexpr int kMQ = kWideQc / 16;      // 16-row query tiles of dq
  constexpr int kDo8 = kDk8 < 8 ? kDk8 : 8;   // 8-column output tiles a task
  constexpr int kParts = kDk8 / kDo8;         // tasks a (head, kv tile)
  constexpr int kWarpsB = kWideBwdThreads / 32;
  extern __shared__ float4 smem4[];
  const int S = wide_slices(Lk);
  const int bg = blockIdx.x / S, sl = blockIdx.x % S, b = bg / G, cg = blockIdx.y * kWideCols;
  const int m0 = wide_slice_tile(Lk, sl), mt = wide_slice_tile(Lk, sl + 1) - m0;
  const int t_base = 16 * m0, rows = 16 * mt;
  const int nk = min(Lk - t_base, rows);   // the slice's kv rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4;
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + rows * ld;
  float* q_s = v_s + rows * ld;
  float* c_s = q_s + kWideQc * ld;
  float* dq_s = c_s + kWideQc * ld;
  float* st_s = dq_s + mt * kWideQc * ld + warp * 16 * ldst;
  // the slice's rows of K's columns; V's at + D
  float* kb = kvp + ((size_t)bg * Lk + t_base) * 2 * D + cg;
  issue_rows<kWideCols, kWideBwdThreads>(k_s, ld, kb, 2 * D, nk, rows);
  issue_rows<kWideCols, kWideBwdThreads>(v_s, ld, kb + D, 2 * D, nk, rows);
  cp_async_commit();
  const int* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * Lk;
  int any_valid = mask_b == nullptr;
  if (mask_b != nullptr)
    for (int t = tid; t < Lk; t += kWideBwdThreads) any_valid |= mask_b[t] != 0;
  const bool uniform = !__syncthreads_or(any_valid);   // a fully masked batch row
  const float inv_lk = 1.f / Lk;

  for (int q0 = 0; q0 < Lq; q0 += kWideQc) {
    const int nq = min(kWideQc, Lq - q0);
    __syncthreads();   // the previous chunk's readers of q_s, c_s and dq_s are done
    issue_rows<kWideCols, kWideBwdThreads>(q_s, ld, q + ((size_t)b * Lq + q0) * D + cg, D, nq,
                                           kWideQc);
    issue_rows<kWideCols, kWideBwdThreads>(c_s, ld, dcc + ((size_t)bg * Lq + q0) * D + cg, D,
                                           nq, kWideQc);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();   // K and V (at the first chunk), q and d_concat landed
    for (int task = warp; task < hg * mt * kParts; task += kWarpsB) {
      const int hd = task / (mt * kParts), m = task / kParts % mt, part = task % kParts;
      const int hc = hd * dk, head = cg / dk + hd;
      const int oc = hc + part * 8 * kDo8;   // the task's first output column
      const float* km = k_s + m * 16 * ld + hc;
      const float* vm = v_s + m * 16 * ld + hc;
      // sᵀ and dpᵀ: kv rows m·16 + fg (+ 8), query rows n·8 + 2·ft (+ 1)
      float s[kNQ][4], dp[kNQ][4];
#pragma unroll
      for (int n = 0; n < kNQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // d_k 128's 16 k-steps 4 at a time: unrolled whole, the loop spilled
      // at the 255 registers (ptxas: 238 registers and no spill this way,
      // and faster on the H100)
#pragma unroll (kDk8 > 8 ? 4 : kDk8)
      for (int ks = 0; ks < kDk8; ++ks) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        load_a_rows<false, true>(km + ks * 8, ld, fg, ft, kh, kl);
        load_a_rows<false, true>(vm + ks * 8, ld, fg, ft, vh, vl);
#pragma unroll
        for (int n = 0; n < kNQ; ++n) {
          uint32_t qh[2], ql[2], ch[2], cl[2];
          load_b_t<true>(q_s + n * 8 * ld + hc + ks * 8, ld, fg, ft, qh, ql);
          load_b_t<true>(c_s + n * 8 * ld + hc + ks * 8, ld, fg, ft, ch, cl);
          mma_step<false>(s[n], kh, kl, qh, ql);
          mma_step<false>(dp[n], vh, vl, ch, cl);
        }
      }
      // pᵀ = exp(s·scale - lse) and dsᵀ = pᵀ (dpᵀ - Dh) scale, both 0 past
      // Lk, past the chunk's rows and at masked kv rows; a fully masked
      // batch row attends uniformly (p = 1/Lk) and gets ds = 0
      const int t0 = m * 16 + fg;   // the slice's row; the group's t_base + t0
      bool inside[2], valid[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + 8 * r;
        inside[r] = t < nk;
        valid[r] = inside[r] && (mask_b == nullptr || mask_b[t_base + t] != 0);
      }
#pragma unroll
      for (int n = 0; n < kNQ; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = n * 8 + 2 * ft + e;
          const bool in = i < nq;
          const size_t at = ((size_t)bg * Lq + q0 + (in ? i : 0)) * h + head;
          const float lse_i = in ? lse[at] : 0.f, dh_i = in ? dh[at] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p = 0.f, d = 0.f;
            if (in && inside[r]) {
              if (uniform) {
                p = inv_lk;
              } else if (valid[r]) {
                p = expf(s[n][2 * r + e] * scale - lse_i);
                d = p * (dp[n][2 * r + e] - dh_i) * scale;
              }
            }
            s[n][2 * r + e] = p;
            dp[n][2 * r + e] = d;
          }
        }
      {
        // the task's columns of dV_m = pᵀ d_concat and dK_m = dsᵀ q into
        // the workspace
        float o[kDo8][4];
        tile_t_times<kNQ, kDo8>(s, c_s + oc, ld, fg, ft, o);
        store_rows<kDo8>(kb + D + oc + 2 * ft, D, t0, inside, q0 > 0, o);
        tile_t_times<kNQ, kDo8>(dp, q_s + oc, ld, fg, ft, o);
        store_rows<kDo8>(kb + oc + 2 * ft, D, t0, inside, q0 > 0, o);
      }
      // the task's columns of dq's share of kv tile m: ds K_m, ds through
      // the staging tile (dsᵀ: kv rows x query rows) as the transposed A
      // operand
#pragma unroll
      for (int n = 0; n < kNQ; ++n) {
        float* dst = st_s + fg * ldst + n * 8 + 2 * ft;
        *reinterpret_cast<float2*>(dst) = make_float2(dp[n][0], dp[n][1]);
        *reinterpret_cast<float2*>(dst + 8 * ldst) = make_float2(dp[n][2], dp[n][3]);
      }
      __syncwarp();
      float o[kMQ][kDo8][4];
#pragma unroll
      for (int mi = 0; mi < kMQ; ++mi)
#pragma unroll
        for (int c = 0; c < kDo8; ++c)
          o[mi][c][0] = o[mi][c][1] = o[mi][c][2] = o[mi][c][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t ah[kMQ][4], al[kMQ][4];
#pragma unroll
        for (int mi = 0; mi < kMQ; ++mi)
          load_a_cols<false, true>(st_s + ks * 8 * ldst + mi * 16, ldst, fg, ft, ah[mi],
                                   al[mi]);
#pragma unroll
        for (int c = 0; c < kDo8; ++c) {
          uint32_t bh[2], bl[2];
          load_b<true>(km + ks * 8 * ld + (oc - hc) + c * 8, ld, fg, ft, bh, bl);
#pragma unroll
          for (int mi = 0; mi < kMQ; ++mi) mma_step<false>(o[mi][c], ah[mi], al[mi], bh, bl);
        }
      }
      __syncwarp();   // the staging tile is free for the warp's next task
#pragma unroll
      for (int mi = 0; mi < kMQ; ++mi)
#pragma unroll
        for (int c = 0; c < kDo8; ++c) {
          float* dst = dq_s + (m * kWideQc + mi * 16 + fg) * ld + oc + c * 8 + 2 * ft;
          *reinterpret_cast<float2*>(dst) = make_float2(o[mi][c][0], o[mi][c][1]);
          *reinterpret_cast<float2*>(dst + 8 * ld) = make_float2(o[mi][c][2], o[mi][c][3]);
        }
    }
    __syncthreads();
    // the chunk's rows of the (b, g, slice) partial of dq: the kv tiles' in
    // order
    constexpr int n4 = kWideCols / 4;
    float* dq_o = dq_part + ((size_t)blockIdx.x * Lq + q0) * D + cg;
    for (int i = tid; i < nq * n4; i += kWideBwdThreads) {
      const int r = i / n4, e = i % n4 * 4;
      float4 a = *reinterpret_cast<const float4*>(dq_s + r * ld + e);
      for (int m = 1; m < mt; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(dq_s + (m * kWideQc + r) * ld + e);
        a = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
      }
      *reinterpret_cast<float4*>(dq_o + (size_t)r * D + e) = a;
    }
  }
}

// Stage 3: dkv = [dK | dV] [Wkᵀ ; Wvᵀ] over the M kv rows (one GEMM with a
// 2D-deep contraction), in kv's dtype, contiguous (M x D).
template <typename TKV>
__global__ void __launch_bounds__(kWideThreads, 1)
hop1_bwd_wide_dkv_kernel(const float* __restrict__ dkvp, const float* __restrict__ wkv_t,
                         TKV* __restrict__ dkv, int D, int M) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  long long* rows_s = reinterpret_cast<long long*>(smem + GemmLayout<float>::rows_off);
  const int nt = D / kGN;
  const int n0 = blockIdx.x % nt * kGN, m0 = blockIdx.x / nt * kGM;
  for (int r = threadIdx.x; r < kGM; r += kWideThreads)
    rows_s[r] = m0 + r < M ? (long long)(m0 + r) * 2 * D : -1;
  __syncthreads();
  float acc[4][4][4] = {};
  wide_gemm<float, false, true>(dkvp, rows_s, wkv_t + n0, D, 2 * D, smem, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int fg = lane / 4, ft = lane % 4, wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm * 64 + m * 16 + half * 8 + fg;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store2(dkv + (size_t)r * D + n0 + wn * 32 + j * 8 + 2 * ft, acc[m][j][2 * half],
               acc[m][j][2 * half + 1]);
    }
}

// Stage 4: part[chunk] = ([dWk | dWv] = kvᵀ [dK | dV], Σ dK, Σ dV) over a
// chunk of kWideDwRows kv rows: one GEMM (D x 2D, contracting over the
// rows), kvᵀ staged as the transposed A operand from the grid's rows
// (through kv's strides).  The blocks of kv column tile 0 also sum [dK |
// dV]'s columns in float32 from the staged tiles (dbk, dbv; not on the
// tensor cores: dbk is analytically 0), a stage's 32 rows apart.
template <typename TKV>
__global__ void __launch_bounds__(kWideThreads, 1)
hop1_bwd_wide_dw_kernel(const TKV* __restrict__ kv, long long kv_sb, long long kv_sg,
                        long long kv_st, const float* __restrict__ dkvp,
                        float* __restrict__ part, int G, int Lk, int D, int M) {
  using L = GemmLayout<TKV, true>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int nt = 2 * D / kGN;
  const int n0 = blockIdx.x % nt * kGN;    // columns of [dK | dV]
  const int i0 = blockIdx.x / nt * kGM;    // kv columns: rows of dW
  const int r_begin = blockIdx.y * kWideDwRows, r_end = min(M, r_begin + kWideDwRows);
  auto issue = [&](float* st, int c) {
    TKV* as = reinterpret_cast<TKV*>(st);
    float* bs = st + L::a_floats;
    const int r0 = r_begin + c * kGK;
    for (int i = tid; i < kGK * kGM / 4; i += kWideThreads) {
      const int rr = i / (kGM / 4), e = i % (kGM / 4) * 4, r = r0 + rr;
      TKV* dst = as + rr * L::lda + e;
      if (r < r_end) {
        const int bgi = r / Lk;
        const TKV* src = kv + (bgi / G) * kv_sb + (bgi % G) * kv_sg + (r % Lk) * kv_st + i0 + e;
        if (sizeof(TKV) == 4)
          cp_async16(dst, src);
        else
          cp_async8(dst, src);
      } else if (sizeof(TKV) == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
      }
    }
    for (int i = tid; i < kGK * kGN / 4; i += kWideThreads) {
      const int rr = i / (kGN / 4), e = i % (kGN / 4) * 4, r = r0 + rr;
      float* dst = bs + rr * L::ldb + e;
      if (r < r_end)
        cp_async16(dst, dkvp + (size_t)r * 2 * D + n0 + e);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  const bool bias = i0 == 0 && tid < kGN;
  float bsum = 0.f;
  auto sum_bias = [&](const float* st) {
    if (!bias) return;
    const float* bs = st + L::a_floats;
    float bstep = 0.f;
    for (int rr = 0; rr < kGK; ++rr) bstep += bs[rr * L::ldb + tid];
    bsum += bstep;
  };
  float acc[4][4][4] = {};
  gemm_loop<TKV, sizeof(TKV) == 2, true, true>((r_end - r_begin + kGK - 1) / kGK, smem, issue,
                                               sum_bias, acc);
  const int warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4, wm = warp / 4, wn = warp % 4;
  float* out = part + (size_t)blockIdx.y * (2 * (size_t)D * D + 2 * D);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + 2 * ft;
    float* o = out + (n >= D ? (size_t)D * D : 0) + n % D;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(o + (size_t)(i0 + wm * 64 + m * 16 + half * 8 + fg) * D) =
            make_float2(acc[m][j][2 * half], acc[m][j][2 * half + 1]);
  }
  if (bias) out[2 * (size_t)D * D + n0 + tid] = bsum;
}

// Chunks of the wide dW pass, kWideDwRows kv rows each: a block's float32
// total then adds 64 k-steps, whose sums stay ~sqrt(512)× a term, and the
// compensated sum_middle adds the chunks (40 at the reference width's train
// step; 32 output tiles each at D 512, enough blocks for every SM).
int wide_dw_chunks(int M) { return (M + kWideDwRows - 1) / kWideDwRows; }

// The attention-backward kernel for head width d_k (8, 16, 32, 64 or 128);
// null for any other d_k (hop1_bwd_variant never gives "wide" one).
const void* wide_bwd_attn_kernel(int dk) {
  switch (dk) {
    case 8: return reinterpret_cast<const void*>(hop1_bwd_wide_attn_kernel<1>);
    case 16: return reinterpret_cast<const void*>(hop1_bwd_wide_attn_kernel<2>);
    case 32: return reinterpret_cast<const void*>(hop1_bwd_wide_attn_kernel<4>);
    case 64: return reinterpret_cast<const void*>(hop1_bwd_wide_attn_kernel<8>);
    case 128: return reinterpret_cast<const void*>(hop1_bwd_wide_attn_kernel<16>);
    default: return nullptr;
  }
}

// Floats of "wide"'s workspace: [K | V], overwritten in place by [dK | dV]
// (M x 2D), dq's partial per (b, g, kv slice) (B·G·S·Lq x D) and the dW
// partials.
long long wide_workspace_floats(int B, int G, int Lq, int Lk, int D) {
  const int M = B * G * Lk;
  return (long long)M * 2 * D + (long long)B * G * wide_slices(Lk) * Lq * D +
         (long long)wide_dw_chunks(M) * (2LL * D * D + 2LL * D);
}

// The "wide" kernels in launch order (the projection, the attention
// backward, dkv, dW) with their threads and dynamic shared memory.
template <typename TKV>
void wide_kernels(int Lk, int D, int h, const void** fn, int* threads, size_t* smem) {
  fn[0] = reinterpret_cast<const void*>(hop1_bwd_wide_proj_kernel<TKV>);
  fn[1] = wide_bwd_attn_kernel(D / h);
  fn[2] = reinterpret_cast<const void*>(hop1_bwd_wide_dkv_kernel<TKV>);
  fn[3] = reinterpret_cast<const void*>(hop1_bwd_wide_dw_kernel<TKV>);
  smem[0] = GemmLayout<TKV>::bytes;
  smem[1] = (size_t)wide_bwd_attn_floats(Lk) * sizeof(float);
  smem[2] = GemmLayout<float>::bytes;
  smem[3] = GemmLayout<TKV, true>::bytes;
  threads[0] = threads[2] = threads[3] = kWideThreads;
  threads[1] = kWideBwdThreads;
}

// ---------------------------------------------------------------------------
// Variant choice and launch

// Groups a whole block takes: two of one batch row at Lk <= 16 (the s2t
// launch), which halves the weight passes; else one.
int bwd_groups(int G, int Lk) { return Lk <= 16 && G > 1 ? 2 : 1; }

size_t bwd_whole_smem(int Lq, int Lk, int D, int h, int ng, int kv_bytes) {
  return (size_t)bwd_layout(Lq, Lk, D, h, ng, kv_bytes).floats * sizeof(float);
}

size_t dw_whole_smem(int D, int kv_bytes) {
  return (size_t)2 * (kDwRowsW * (kDwColsW + 8) * kv_bytes / 4 + kDwRowsW * (2 * D + 8)) *
         sizeof(float);
}

// Rows a chunk of the whole dW pass takes (a multiple of kDwRowsW): enough
// chunks for one block on each SM with its D / kDwColsW column blocks, at
// least kDwMinRows rows each.
int dw_whole_chunk_rows(int nrows, int D) {
  const int tiles = D / kDwColsW;
  const int want = std::max(1, std::min((kDwWholeBlocks + tiles - 1) / tiles,
                                        (nrows + kDwMinRows - 1) / kDwMinRows));
  const int rows = (nrows + want - 1) / want;
  return (rows + kDwRowsW - 1) / kDwRowsW * kDwRowsW;
}

int dw_whole_chunks(int nrows, int D) {
  const int c = dw_whole_chunk_rows(nrows, D);
  return (nrows + c - 1) / c;
}

// The kernel a launch at these widths takes, from the shape and from
// whether kv's rows are aligned 4-element vectors (kv_vec: "whole" and
// "wide" copy them in 16-byte and 8-byte pieces) alone, never from an
// error: "whole" has hop1_fwd.cu's "whole" domain (D 64 or 128, d_k a
// multiple of 8 up to 32, Lk <= 64, aligned rows) at any Lq, "wide"
// hop1_fwd.cu's "wide" domain, from the one rule of both (wide_widths: D a
// multiple of 128 from 256 to kWideMaxD at any Lk and D 128 past
// kWideMaxLk kv rows, d_k 8, 16, 32, 64 or 128, aligned rows; past 4
// 16-row tiles a group's kv rows split over blocks, wide_slices); "tiled"
// every other width it plans (D above 1024, d_k 24, 48, 96, 15, 65, ...,
// D 64 past 64 kv rows, misaligned grids).  Every variant reads every
// forward's residuals: one layout, concat (B, G, Lq, D) and lse (B, G, Lq,
// h), a fully masked row's lse -1e9 (its -1e9 + log Lk in float32).
int hop1_bwd_variant(int Lq, int Lk, int D, int h, bool kv_vec) {
  if (!widths_ok(D, h) || Lq < 1 || Lk < 1) return kVariantNone;
  const int dk = D / h;
  if (kv_vec && (D == 64 || D == 128) && dk % 8 == 0 && dk <= 32 && Lk <= kWholeMaxLk &&
      bwd_whole_smem(Lq, Lk, D, h, bwd_groups(2, Lk), 4) <= kSmemLimit)
    return kVariantWhole;
  if (wide_widths(Lk, D, dk, kv_vec)) return kVariantWide;
  int qc, tk, hg;
  size_t smem;
  return hop1_bwd_plan(Lq, Lk, D, h, &qc, &tk, &hg, &smem) ? kVariantTiled : kVariantNone;
}

long long workspace_floats(int B, int G, int Lq, int Lk, int D, int h) {
  const long long tiled = tiled_workspace_floats(B, G, Lq, Lk, D, h);
  if (hop1_bwd_variant(Lq, Lk, D, h, true) == kVariantWide)
    return std::max(tiled, wide_workspace_floats(B, G, Lq, Lk, D));
  if (D != 64 && D != 128) return tiled;
  const long long nrows = (long long)B * G * Lk;
  const long long whole = (long long)B * G * Lq * D + 2 * nrows * D +
                          (long long)dw_whole_chunks((int)nrows, D) * (2LL * D * D + 2LL * D);
  return std::max(tiled, whole);
}

// The whole pass-1 kernel's instantiation: NT = D / 32 (D 128, the
// flagship's, or 64); "long" (one group, up to 4 16-row tiles) or "short"
// (two groups of one batch row at Lk <= 16, up to 2 tiles); heads up to 16
// or up to 32 wide.
#define BIST_HOP1_BWD_WHOLE_CASES(X)                                           \
  switch ((D == 128 ? 4 : 0) + (Lk <= 16 ? 2 : 0) + (D / h > 16 ? 1 : 0)) {    \
    case 0: X(2, 4, 1, 2); break;                                              \
    case 1: X(2, 4, 1, 4); break;                                              \
    case 2: X(2, 2, 2, 2); break;                                              \
    case 3: X(2, 2, 2, 4); break;                                              \
    case 4: X(4, 4, 1, 2); break;                                              \
    case 5: X(4, 4, 1, 4); break;                                              \
    case 6: X(4, 2, 2, 2); break;                                              \
    default: X(4, 2, 2, 4); break;                                             \
  }

template <typename TKV>
const void* whole_kernel(int Lk, int D, int h) {
  const void* fn = nullptr;
#define BIST_HOP1_BWD_WHOLE_FN(NT, MT, NG, DK8) \
  fn = reinterpret_cast<const void*>(hop1_bwd_whole_kernel<TKV, NT, MT, NG, DK8>)
  BIST_HOP1_BWD_WHOLE_CASES(BIST_HOP1_BWD_WHOLE_FN)
#undef BIST_HOP1_BWD_WHOLE_FN
  return fn;
}

template <typename TKV>
const void* dw_whole_kernel(int D) {
  return D == 128 ? reinterpret_cast<const void*>(hop1_bwd_dw_whole_kernel<TKV, 4>)
                  : reinterpret_cast<const void*>(hop1_bwd_dw_whole_kernel<TKV, 2>);
}

int set_smem(const void* fn, size_t smem) {
  return smem > 48 * 1024 ? (int)cudaFuncSetAttribute(
                                fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                          : 0;
}

template <typename TKV>
int launch_whole(const float* q, const TKV* kv, long long kv_sb, long long kv_sg,
                 long long kv_st, const int* mask, const float* dcc, const float* dh,
                 const float* lse, const float* wk, const float* bk, const float* wv,
                 const float* bv, const float* wkv_t, TKV* dkv, float* dq, float* wgrad,
                 float* ws, int B, int G, int Lq, int Lk, int D, int h, float scale,
                 cudaStream_t stream) {
  const int ng = bwd_groups(G, Lk);
  const size_t smem = bwd_whole_smem(Lq, Lk, D, h, ng, sizeof(TKV));
  int rc = set_smem(whole_kernel<TKV>(Lk, D, h), smem);
  if (rc != 0) return rc;
  const int nrows = B * G * Lk;
  float* dq_part = ws;
  float* rows = dq_part + (size_t)B * G * Lq * D;
  float* part = rows + (size_t)nrows * 2 * D;
  const dim3 grid((unsigned)(B * ((G + ng - 1) / ng)));
#define BIST_HOP1_BWD_WHOLE(NT, MT, NG, DK8)                                             \
  hop1_bwd_whole_kernel<TKV, NT, MT, NG, DK8><<<grid, kThreads, smem, stream>>>(           \
      q, kv, kv_sb, kv_sg, kv_st, mask, dcc, dh, lse, wk, bk, wv, bv, wkv_t, dkv, dq_part, \
      rows, G, Lq, Lk, h, ng, scale)
  BIST_HOP1_BWD_WHOLE_CASES(BIST_HOP1_BWD_WHOLE)
#undef BIST_HOP1_BWD_WHOLE
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int chunk = dw_whole_chunk_rows(nrows, D);
  const int chunks = (nrows + chunk - 1) / chunk;
  const size_t dsmem = dw_whole_smem(D, sizeof(TKV));
  rc = set_smem(dw_whole_kernel<TKV>(D), dsmem);
  if (rc != 0) return rc;
  const dim3 dgrid((unsigned)(D / kDwColsW), (unsigned)chunks);
  if (D == 128)
    hop1_bwd_dw_whole_kernel<TKV, 4><<<dgrid, kDwThreads, dsmem, stream>>>(
        kv, kv_sb, kv_sg, kv_st, rows, part, G, Lk, nrows, chunk);
  else
    hop1_bwd_dw_whole_kernel<TKV, 2><<<dgrid, kDwThreads, dsmem, stream>>>(
        kv, kv_sb, kv_sg, kv_st, rows, part, G, Lk, nrows, chunk);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  rc = sum_middle(dq_part, dq, B, G, (long long)Lq * D, stream);
  if (rc != 0) return rc;
  return sum_middle(part, wgrad, 1, chunks, 2LL * D * D + 2LL * D, stream);
}

// The "wide" kernels in order on `stream`, then the fixed-order sums; ws
// holds wide_workspace_floats floats.
template <typename TKV>
int launch_wide(const float* q, const TKV* kv, long long kv_sb, long long kv_sg,
                long long kv_st, const int* mask, const float* dcc, const float* dh,
                const float* lse, const float* wk, const float* bk, const float* wv,
                const float* bv, const float* wkv_t, TKV* dkv, float* dq, float* wgrad,
                float* ws, int B, int G, int Lq, int Lk, int D, int h, float scale,
                cudaStream_t stream) {
  const void* fn[4];
  int threads[4];
  size_t smem[4];
  wide_kernels<TKV>(Lk, D, h, fn, threads, smem);
  if (fn[1] == nullptr) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i) {
    const int rc = set_smem(fn[i], smem[i]);
    if (rc != 0) return rc;
  }
  const int M = B * G * Lk, mtiles = (M + kGM - 1) / kGM, S = wide_slices(Lk);
  float* kvp = ws;
  float* dq_part = kvp + (size_t)M * 2 * D;
  float* part = dq_part + (size_t)B * G * S * Lq * D;
  hop1_bwd_wide_proj_kernel<TKV><<<(2 * D / kGN) * mtiles, kWideThreads, smem[0], stream>>>(
      kv, kv_sb, kv_sg, kv_st, wk, bk, wv, bv, kvp, G, Lk, D, M);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  void* attn_args[] = {&q, &kvp, &mask, &dcc, &dh, &lse, &dq_part, &G, &Lq, &Lk, &D, &h, &scale};
  rc = (int)cudaLaunchKernel(fn[1], dim3((unsigned)(B * G * S), (unsigned)(D / kWideCols)),
                             dim3(kWideBwdThreads), attn_args, smem[1], stream);
  if (rc != 0) return rc;
  hop1_bwd_wide_dkv_kernel<TKV><<<(D / kGN) * mtiles, kWideThreads, smem[2], stream>>>(
      kvp, wkv_t, dkv, D, M);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int chunks = wide_dw_chunks(M);
  hop1_bwd_wide_dw_kernel<TKV><<<dim3((unsigned)((D / kGM) * (2 * D / kGN)), (unsigned)chunks),
                                 kWideThreads, smem[3], stream>>>(kv, kv_sb, kv_sg, kv_st, kvp,
                                                                  part, G, Lk, D, M);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  rc = sum_middle(dq_part, dq, B, G * S, (long long)Lq * D, stream);
  if (rc != 0) return rc;
  return sum_middle(part, wgrad, 1, chunks, 2LL * D * D + 2LL * D, stream);
}

// `variant` is hop1_bwd_variant's choice, or the kernel a measurement asks
// for: "tiled" takes every width hop1_bwd_variant takes, "whole" and "wide"
// only their own.
template <typename TKV>
int launch(int variant, const float* q, const TKV* kv, long long kv_sb, long long kv_sg,
           long long kv_st, const int* mask, const float* dcc, const float* dh,
           const float* lse, const float* wk, const float* bk, const float* wv,
           const float* bv, const float* wkv_t, TKV* dkv, float* dq, float* wgrad,
           float* ws, int B, int G, int Lq, int Lk, int D, int h, float scale,
           cudaStream_t stream) {
  const int chosen = hop1_bwd_variant(Lq, Lk, D, h, rows_vec4(kv, kv_sb, kv_sg, kv_st, D));
  if (chosen == kVariantNone || (variant == kVariantWhole && chosen != kVariantWhole) ||
      (variant == kVariantWide && chosen != kVariantWide))
    return (int)cudaErrorInvalidValue;
  if (variant == kVariantWide)
    return launch_wide(q, kv, kv_sb, kv_sg, kv_st, mask, dcc, dh, lse, wk, bk, wv, bv, wkv_t,
                       dkv, dq, wgrad, ws, B, G, Lq, Lk, D, h, scale, stream);
  if (variant == kVariantWhole)
    return launch_whole(q, kv, kv_sb, kv_sg, kv_st, mask, dcc, dh, lse, wk, bk, wv, bv,
                        wkv_t, dkv, dq, wgrad, ws, B, G, Lq, Lk, D, h, scale, stream);
  if (variant == kVariantTiled)
    return launch_tiled(q, kv, kv_sb, kv_sg, kv_st, mask, dcc, dh, lse, wk, bk, wv, bv,
                        wkv_t, dkv, dq, wgrad, ws, B, G, Lq, Lk, D, h, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// info[0 .. 3]: dynamic shared memory bytes, registers and local memory
// bytes a thread, resident blocks per SM of `fn` launched with `threads`
// and `smem`.
int kernel_resources(const void* fn, int threads, size_t smem, int* info) {
  int rc = set_smem(fn, smem);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = (int)smem;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = blocks;
  return 0;
}

template <typename TKV>
int resources(int G, int Lq, int Lk, int D, int h, int* info) {
  const int variant = hop1_bwd_variant(Lq, Lk, D, h, true);
  for (int i = 0; i < 25; ++i) info[i] = 0;
  info[0] = variant;
  if (variant == kVariantWide) {
    // each kernel's at [9 + 4·s]; pass 1 the attention kernel's, dW its own
    const void* fn[4];
    int threads[4];
    size_t smem[4];
    wide_kernels<TKV>(Lk, D, h, fn, threads, smem);
    for (int i = 0; i < 4; ++i) {
      const int rc = kernel_resources(fn[i], threads[i], smem[i], info + 9 + 4 * i);
      if (rc != 0) return rc;
    }
    for (int k = 0; k < 4; ++k) {
      info[1 + k] = info[13 + k];
      info[5 + k] = info[21 + k];
    }
    return 0;
  }
  if (variant == kVariantWhole) {
    const int rc = kernel_resources(
        whole_kernel<TKV>(Lk, D, h), kThreads,
        bwd_whole_smem(Lq, Lk, D, h, bwd_groups(G, Lk), sizeof(TKV)), info + 1);
    return rc != 0 ? rc
                   : kernel_resources(dw_whole_kernel<TKV>(D), kDwThreads,
                                      dw_whole_smem(D, sizeof(TKV)), info + 5);
  }
  int qc, tk, hg;
  size_t smem;
  if (variant != kVariantTiled || !hop1_bwd_plan(Lq, Lk, D, h, &qc, &tk, &hg, &smem))
    return (int)cudaErrorInvalidValue;
  const int rc = kernel_resources(reinterpret_cast<const void*>(hop1_bwd_kernel<TKV>),
                                  kThreads, smem, info + 1);
  return rc != 0 ? rc
                 : kernel_resources(reinterpret_cast<const void*>(hop1_bwd_dw_kernel<TKV>),
                                    kThreads, 0, info + 5);
}

}  // namespace

extern "C" {

// Floats of device workspace `bist_hop1_bwd` needs for these shapes (any
// kernel that takes them).
long long bist_hop1_bwd_workspace(int B, int G, int Lq, int Lk, int D, int h) {
  return workspace_floats(B, G, Lq, Lk, D, h);
}

int bist_hop1_bwd_as(int variant, const float* q, const void* kv, int kv_bf16,
                     long long kv_sb, long long kv_sg, long long kv_st, const int* mask,
                     const float* dcc, const float* dh, const float* lse, const float* wk,
                     const float* bk, const float* wv, const float* bv,
                     const float* wkv_t, void* dkv, float* dq, float* wgrad, float* ws,
                     int B, int G, int Lq, int Lk, int D, int h, float scale, void* stream);

// Launch the passes on `stream`; returns the CUDA error code of the launches
// (0 = ok), or cudaErrorInvalidValue for widths the kernels do not take
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
  const bool vec = kv_bf16 ? rows_vec4(static_cast<const __nv_bfloat16*>(kv), kv_sb, kv_sg,
                                       kv_st, D)
                           : rows_vec4(static_cast<const float*>(kv), kv_sb, kv_sg, kv_st, D);
  return bist_hop1_bwd_as(hop1_bwd_variant(Lq, Lk, D, h, vec), q, kv, kv_bf16, kv_sb, kv_sg,
                          kv_st, mask, dcc, dh, lse, wk, bk, wv, bv, wkv_t, dkv, dq, wgrad,
                          ws, B, G, Lq, Lk, D, h, scale, stream);
}

// bist_hop1_bwd through the named kernel (1 "tiled", 2 "whole", 3 "wide"),
// for measurements that hold them against each other; cudaErrorInvalidValue
// where that kernel does not take the widths.
int bist_hop1_bwd_as(int variant, const float* q, const void* kv, int kv_bf16,
                     long long kv_sb, long long kv_sg, long long kv_st, const int* mask,
                     const float* dcc, const float* dh, const float* lse, const float* wk,
                     const float* bk, const float* wv, const float* bv,
                     const float* wkv_t, void* dkv, float* dq, float* wgrad, float* ws,
                     int B, int G, int Lq, int Lk, int D, int h, float scale, void* stream) {
  if (B < 1 || G < 1 || Lq < 1 || Lk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_bf16)
    return launch(variant, q, static_cast<const __nv_bfloat16*>(kv), kv_sb, kv_sg, kv_st,
                  mask, dcc, dh, lse, wk, bk, wv, bv, wkv_t,
                  static_cast<__nv_bfloat16*>(dkv), dq, wgrad, ws, B, G, Lq, Lk, D, h, scale,
                  s);
  return launch(variant, q, static_cast<const float*>(kv), kv_sb, kv_sg, kv_st, mask, dcc,
                dh, lse, wk, bk, wv, bv, wkv_t, static_cast<float*>(dkv), dq, wgrad, ws, B,
                G, Lq, Lk, D, h, scale, s);
}

// The kernel bist_hop1_bwd launches at these widths, kv's rows aligned
// 4-element vectors or not (kv_vec): 3 "wide", 2 "whole", 1 "tiled", 0 none
// (it would return cudaErrorInvalidValue).
int bist_hop1_bwd_variant(int Lq, int Lk, int D, int h, int kv_vec) {
  return hop1_bwd_variant(Lq, Lk, D, h, kv_vec != 0);
}

// What that kernel takes on the current device at G groups (aligned kv
// rows): info[0] variant; pass 1 ([1] dynamic shared memory bytes, [2]
// registers a thread, [3] local memory bytes a thread (spills and stack),
// [4] resident blocks per SM); the dW pass, the same in [5] .. [8]; for
// "wide" (pass 1 its attention kernel) each of its four kernels' at [9 +
// 4·s] (s 0 projection, 1 attention, 2 dkv, 3 dW); info holds 25 ints.
// Returns the CUDA error code (cudaErrorInvalidValue for widths the kernels
// do not take).
int bist_hop1_bwd_resources(int G, int Lq, int Lk, int D, int h, int kv_bf16, int* info) {
  return kv_bf16 ? resources<__nv_bfloat16>(G, Lq, Lk, D, h, info)
                 : resources<float>(G, Lq, Lk, D, h, info);
}

}  // extern "C"
