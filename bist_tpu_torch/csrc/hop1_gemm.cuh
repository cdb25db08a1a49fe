// The tensor-core GEMM of the "wide" hop-1 kernels (D a multiple of 128): K1's
// projection and Wo products (hop1_fwd.cu) and K2's projection, dkv and dW
// products (hop1_bwd.cu), each over every row of a launch.  A block of 8
// warps takes a 128 x 128 output tile, its operands streamed through a
// three-stage cp.async ring of 32 contraction rows; every product is an
// m16n8k8 3xTF32 MMA (hop1_mma.cuh; two passes where A is a bfloat16 grid,
// exact in TF32).
//
// Two settings of one loop.  K1's (kPrecise false) splits its operands by
// truncation and runs each accumulator as one chain of K/8 MMAs, as it did
// before K2 shared the loop.  K2's (kPrecise true) splits them rounding to
// nearest (split_tf32_rn) and runs each k-step (8 contraction rows) as a
// chain of its own (hop1_mma.cuh's mma_step), for K2's long sums and
// cancellations: 4 FADDs a 3 MMAs, no registers beyond K1's.
#pragma once

#include "hop1_mma.cuh"

namespace hop1 {

constexpr int kWideThreads = 256;      // a GEMM block: 8 warps, 2 (rows) x 4 (columns)
constexpr int kGM = 128, kGN = 128;    // a GEMM block's tile
constexpr int kGK = 32;                // contraction rows a ring stage
constexpr int kGStages = 3;            // cp.async ring stages
constexpr int kWideCols = 128;         // head columns an attention block of K1 or K2
// kv rows of a group K1 "wide"'s attention kernel holds whole (past it, K1
// streams them in kv tiles); K1 and K2 "wide" take D 128 only past it.
// K2's slices of a group's kv rows have their own size (hop1_bwd.cu,
// kWideSliceTiles).
constexpr int kWideMaxLk = 64;
// widest D "wide" takes: the widths its cases on the card cover (phase 2 of
// chip_smoke.py); the GEMMs take any multiple of kGN
constexpr int kWideMaxD = 1024;

// The widths K1 "wide" (hop1_fwd.cu's hop1_variant) and K2 "wide"
// (hop1_bwd.cu's hop1_bwd_variant) take, one rule for both so that the
// backward's domain is the forward's: every D that is a multiple of
// kWideCols from 256 to kWideMaxD at any Lk, and D kWideCols past
// kWideMaxLk kv rows, with a head width dk a multiple of 8 that divides
// kWideCols (8, 16, 32, 64, 128: whole heads in the 128-column attention
// blocks, one instantiation each) and kv rows of aligned 4-element vectors
// (kv_vec: the kernels copy them in 16-byte and 8-byte pieces).  Each
// variant function tests its own "whole" rule first; the two never overlap
// with this one (they take D 64/128 up to kWideMaxLk kv rows).
inline bool wide_widths(int Lk, int D, int dk, bool kv_vec) {
  return kv_vec && dk % 8 == 0 && kWideCols % dk == 0 &&
         ((D % kWideCols == 0 && D >= 2 * kWideCols && D <= kWideMaxD) ||
          (D == kWideCols && Lk > kWideMaxLk));
}

// Shared memory of a GEMM block, in floats: kGStages stages of an A tile and
// a W tile, then the A tile's kGM row offsets (long long).  The A tile is
// kGM x kGK in TA, rows padded to 4 words (mod 32) for A fragments, or with
// kTransA (A given transposed, kvᵀ in K2's dW) kGK x kGM, rows padded to 8
// words (mod 32) for transposed A fragments; the W tile kGK x kGN, rows
// padded to 8 words (mod 32) for B fragments.
template <typename TA, bool kTransA = false>
struct GemmLayout {
  static constexpr int lda =                 // in TA elements
      kTransA ? kGM + 8 : (sizeof(TA) == 4 ? kGK + 4 : kGK + 8);
  static constexpr int a_floats = (kTransA ? kGK : kGM) * lda * (int)sizeof(TA) / 4;
  static constexpr int ldb = kGN + 8;
  static constexpr int stage = a_floats + kGK * ldb;
  static constexpr int rows_off = kGStages * stage;
  static constexpr size_t bytes = (size_t)rows_off * sizeof(float) + kGM * sizeof(long long);
};

// acc += this warp's 64 x 32 piece of the block's A W over nk stages of kGK
// contraction rows.  issue(stage, c) issues stage c's A tile (TA, at the
// stage's start) and W tile (at a_floats) by cp.async, zeros past the
// operands' ends; after(stage) runs between a stage's products and the
// next stage's barrier (K2's bias sums).  A warp's step loads the 4 W
// fragments, then per 16-row tile one A fragment for 4 independent
// accumulator chains.
template <typename TA, bool kExactA, bool kPrecise, bool kTransA, typename Issue,
          typename After>
__device__ __forceinline__ void gemm_loop(int nk, float* smem, Issue issue, After after,
                                          float (&acc)[4][4][4]) {
  using L = GemmLayout<TA, kTransA>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  for (int c = 0; c < kGStages - 1; ++c) {
    if (c < nk) issue(smem + c * L::stage, c);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();   // chunk c landed for all; chunk c - 1's stage is free
    if (c + kGStages - 1 < nk)
      issue(smem + (c + kGStages - 1) % kGStages * L::stage, c + kGStages - 1);
    cp_async_commit();
    const float* st = smem + c % kGStages * L::stage;
    const TA* as = reinterpret_cast<const TA*>(st);
    const float* bs = st + L::a_floats + wn * 32;
#pragma unroll
    for (int ks = 0; ks < kGK / 8; ++ks) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load_b<kPrecise>(bs + ks * 8 * L::ldb + j * 8, L::ldb, fg, ft, bh[j], bl[j]);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t ah[4], al[4];
        if constexpr (kTransA)
          load_a_cols<kExactA, kPrecise>(as + ks * 8 * L::lda + wm * 64 + m * 16, L::lda, fg,
                                         ft, ah, al);
        else
          load_a_rows<kExactA, kPrecise>(as + (wm * 64 + m * 16) * L::lda + ks * 8, L::lda,
                                         fg, ft, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kPrecise)
            mma_step<kExactA>(acc[m][j], ah, al, bh[j], bl[j]);
          else
            mma_3xtf32<kExactA>(acc[m][j], ah, al, bh[j], bl[j]);
        }
      }
    }
    after(st);
  }
  cp_async_wait<0>();
}

// acc += this warp's piece of A[m0 .., :K] W[:K, :kGN]: A's kGM rows by
// their element offsets from `a` (rows_s, the row-offset table; -1 for a
// row past the matrix, read as zeros), W row-major (row stride ldw) from
// its tile's first column, K a multiple of kGK.
template <typename TA, bool kExactA, bool kPrecise = false>
__device__ __forceinline__ void wide_gemm(const TA* __restrict__ a, const long long* rows_s,
                                          const float* __restrict__ w, int ldw, int K,
                                          float* smem, float (&acc)[4][4][4]) {
  using L = GemmLayout<TA>;
  auto issue = [&](float* st, int c) {
    TA* as = reinterpret_cast<TA*>(st);
    for (int i = threadIdx.x; i < kGM * kGK / 4; i += kWideThreads) {
      const int r = i / (kGK / 4), e = i % (kGK / 4) * 4;
      TA* dst = as + r * L::lda + e;
      const long long off = rows_s[r];
      if (sizeof(TA) == 4) {
        if (off >= 0)
          cp_async16(dst, a + off + c * kGK + e);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        if (off >= 0)
          cp_async8(dst, a + off + c * kGK + e);
        else
          *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
      }
    }
    issue_w<kGN, kGK, kWideThreads>(st + L::a_floats, w, ldw, c, L::ldb);
  };
  gemm_loop<TA, kExactA, kPrecise, false>(K / kGK, smem, issue, [](const float*) {}, acc);
}

// [K | V] = kv [Wk | Wv] + [bk | bv] over a launch's M = B·G·Lk kv rows
// (row r is kv[b, g, t] with r = (b·G + g)·Lk + t, read through kv's
// strides by the row-offset table), into kvp (M x 2D, row-major): the body
// of K1's and K2's projection kernels.  Block i takes column tile i % (2D /
// kGN) of row tile i / (2D / kGN): the blocks resident together share their
// kv rows in L2, and the weights (2 MB at D 512) stay there.
template <typename TKV, bool kPrecise>
__device__ __forceinline__ void wide_proj(const TKV* __restrict__ kv, long long kv_sb,
                                          long long kv_sg, long long kv_st,
                                          const float* __restrict__ wk,
                                          const float* __restrict__ bk,
                                          const float* __restrict__ wv,
                                          const float* __restrict__ bv,
                                          float* __restrict__ kvp, int G, int Lk, int D, int M) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  long long* rows_s = reinterpret_cast<long long*>(smem + GemmLayout<TKV>::rows_off);
  const int nt = 2 * D / kGN;
  const int n0 = blockIdx.x % nt * kGN, m0 = blockIdx.x / nt * kGM;
  for (int r = threadIdx.x; r < kGM; r += kWideThreads) {
    const int row = m0 + r, bg = row / Lk;
    rows_s[r] = row < M ? bg / G * kv_sb + bg % G * kv_sg + row % Lk * kv_st : -1;
  }
  __syncthreads();
  const bool is_v = n0 >= D;
  const int c0 = n0 - (is_v ? D : 0);   // the tile's first column of Wk or Wv
  float acc[4][4][4] = {};
  wide_gemm<TKV, sizeof(TKV) == 2, kPrecise>(kv, rows_s, (is_v ? wv : wk) + c0, D, D, smem,
                                             acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int fg = lane / 4, ft = lane % 4, wm = warp / 4, wn = warp % 4;
  const float* bias = (is_v ? bv : bk) + c0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = wn * 32 + j * 8 + 2 * ft;
    const float2 b2 = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm * 64 + m * 16 + half * 8 + fg;
        if (r < M)
          *reinterpret_cast<float2*>(kvp + (size_t)r * 2 * D + n0 + c) =
              make_float2(acc[m][j][2 * half] + b2.x, acc[m][j][2 * half + 1] + b2.y);
      }
  }
}

}  // namespace hop1
