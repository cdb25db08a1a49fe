// Streaming-softmax attention forward for Hopper (sm_90a): q, k, v and the
// output in float32 or bfloat16, the arithmetic in float32.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, launched by
// `flash_attention` (bist_tpu/ops/flash_attention.py:43-148, pallas_call at
// l.133):
//
//     out[g] = softmax(q[g] k[g]ᵀ · scale, -1e9 where mask[g] == 0) v[g]
//
// for q (G, Lq, d), k/v (G, Lk, d), an optional kv-validity mask (G, Lk),
// without materialising the (G, Lq, Lk) scores.  The TPU kernel padded d to
// the 128-lane width in device memory; here any head dim is read and
// written as it is, at any alignment.
//
// What bounds it on the H100: in the regime `mha` sends here (kv >= 32768,
// e.g. G=128 rows of heads, Lq=32, Lk=32768, d=64) it must read K and V once
// (2.17 GB with the mask: 0.647 ms at 3.35 TB/s) and does 4·G·Lq·Lk·d = 34
// GFLOP: 0.51 ms at the 67 TFLOP/s float32 rate outside the tensor cores,
// 0.21 ms as 3xTF32 on them (three passes at 495 TFLOP/s dense TF32; H100
// SXM data sheet).  So it is bound by bytes once the products run on the
// tensor cores and the next kv tiles' loads overlap this tile's products.
// The design, one kernel (flash_fwd_mma_kernel) for every head dim:
//   * a block owns a group g, a tile of up to 64 query rows (16-row tiles,
//     the M of an m16n8k8 product), one split of the kv axis and, above
//     head dim 1024, one block of up to 1024 output columns; with few
//     blocks the kv axis is split across blocks, into as many splits as one
//     wave of resident blocks holds (`bist_flash_plan`, from the block's
//     occupancy), and flash_merge_kernel merges the splits' (max, sum,
//     accumulator) partials;
//   * q's tile is staged in shared memory once (up to d 128 split into its
//     TF32 halves; a bfloat16 q is exact in TF32 and has no low half);
//   * K and V stream through a ring of 2-4 slots filled by cp.async, one kv
//     tile of K, then of V, a slot each; a slot is refilled right after the
//     barrier that frees it, so the next tiles are in flight while this
//     tile's products run (one barrier per slot consumed);
//   * every product is an m16n8k8 TF32 tensor-core product in 3xTF32 (the
//     operands split into TF32 halves, hop1_mma.cuh), with one pass for
//     q kᵀ on a bfloat16 grid (both operands exact in TF32) and two for p v
//     (V exact); q's and K's fragments come by ldmatrix;
//   * up to d 128 ("kv split") each of a query tile's 4 warps scores its own
//     rows of every kv tile against all of d, keeps its own online softmax
//     (row max and sum by quad shuffles) and feeds p from the scores'
//     fragments straight into p v over all the head's columns; the warps
//     merge once, at the end.  Above d 128 ("column split", where a warp
//     cannot hold the whole output row) the warps split d's k-steps of
//     q kᵀ, the partial scores meet in shared memory, one warp per 8 kv
//     rows writes p and its rows' (max, sum) there, and each warp takes
//     p v for its own 64 output columns.  Up to d 1024 no row is scored
//     twice and no block reads K or V twice;
//   * above d 1024 ("column blocks", where q's tile and a K tile no longer
//     fit in shared memory together) the output columns go to blocks of up
//     to 1024, one a thread block: each scores its rows against all of d,
//     K streamed in column chunks of the same width through the ring and q
//     read from device memory (L1), and takes p v for its own columns.  So
//     the scores are computed once per 1024 output columns;
//   * each kv tile's p v accumulates in a fresh fragment that is added to
//     the float32 accumulator as acc·α + tile, and q kᵀ in fresh fragments
//     of at most 8 k-steps: the tensor cores' accumulation rounds toward
//     zero, and chains over 32768 kv rows would compound it.
//
// Columns past Lk are never scored, so a row whose columns are all masked
// gets uniform attention over the true Lk, as the plain version does (the
// Pallas kernel also counted its padding there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hop1_mma.cuh"

namespace {

constexpr float kMaskedScore = -1e9f;

// Parts a measurement build leaves out (tools/flash_probe.py compiles this
// file with FLASH_PROBE set; the port's build leaves it 0): 1 q kᵀ's
// products, 2 p v's, 4 the K/V loads, 8 ex2.approx (exp2f in its place).
// A part is skipped at run time (`a.Lq >= 0` is true but unknown to the
// compiler), so that the rest keeps its registers and instructions.
#ifndef FLASH_PROBE
#define FLASH_PROBE 0
#endif

int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ---------------------------------------------------------------------------
// the kernel

namespace mma {

using hop1::cp_async16;
using hop1::cp_async4;
using hop1::cp_async8;
using hop1::cp_async_commit;
using hop1::split_tf32;

constexpr int kMaxThreads = 512;
constexpr int kBlockD = 1024;      // output columns a block, at most
constexpr int kMaxKvSplitD = 128;  // the widest head of the kv-split mode
constexpr int kTiles = 4;          // 8-row kv tiles a column-split tile holds, at most
constexpr int kChain = 8;          // k-steps of q kᵀ summed in one fresh fragment
constexpr int kColTiles = 8;       // output tiles a column-split warp takes, at most
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kSmemLimit = 232448;       // shared memory a block may use
constexpr size_t kSmemTwo = 113 * 1024;     // two blocks an SM

// A block's tiles and its shared memory (byte offsets).  A block owns 16·mt
// query rows, wc warps to each 16-row query tile, and streams K and V in
// tiles of bn kv rows through a ring of `slots` slots (a tile of K with its
// mask values, or of V; rows `ld` elements apart).  Three modes:
//   * kv split (d <= 128): warp w of a query tile takes kv rows 8·ns·w ..
//     of every tile, scores them against all of d, keeps its own softmax
//     and its own p v over all the head's columns (in registers, cw tiles
//     of 8 columns), and the warps merge once, at the end, through the
//     ring's bytes (rows ldo apart).  q is staged split into its TF32
//     halves (float32), reused for every kv tile.
//   * column split (d > 128, where a warp cannot hold all of d): warp w
//     scores every kv row of the tile against its share of d's k-steps;
//     the partial scores (rows lds apart) are summed by the warp that owns
//     each 8-row kv tile, which writes p (rows ldp apart) and its rows'
//     (max, sum); then warp w takes p v for its slice of at most cw output
//     tiles.  q is staged as float32 values and split when loaded.
//   * column blocks (d > 1024): the column split, in ncb blocks of nkb
//     8-column tiles, one a thread block.  K streams in column chunks of
//     the same nkb tiles (a kv tile's ncb chunks, then the block's own
//     columns of V); q is not staged (ldq 0) but read from device memory.
// Strides: ldq and a float32 ld are 4 modulo 8, a bfloat16 ld 8 modulo 16,
// ldp, lds and ldo 8 modulo 16 (bn >= 16), so that the fragment loads of
// q, K (kᵀ, by ldmatrix), V (row pairs), the partial scores and p meet no
// bank conflict.
struct Plan {
  int kvsplit;   // the mode
  int mt;        // 16-row query tiles a block
  int wc;        // warps a query tile (kv split 4; column split 4 to 16)
  int bn;        // kv rows a tile
  int ns;        // kv split: 8-row kv tiles a warp scores (bn = 8 ns wc)
  int slots;     // ring slots
  int qsplit;    // q staged as TF32 halves
  int cw;        // most output tiles a warp (the accumulator's template size)
  int nkb;       // 8-column tiles a column block (all of d below column blocks)
  int ncb;       // column blocks (1 below d 1024)
  int ldq, ld, ldp, lds, ldo;
  size_t off_qlo, off_ring, slot_bytes, off_mask, off_p, off_sp, off_stats, smem;
  __host__ __device__ int threads() const { return 32 * mt * wc; }
};

size_t r16(size_t b) { return (b + 15) / 16 * 16; }

void layout(Plan& p, int esize) {
  const size_t bm = 16 * p.mt, warps = p.threads() / 32;
  p.ldp = p.lds = p.bn + 8;
  p.ldo = p.cw * 8 + 8;
  p.off_qlo = r16(bm * p.ldq * 4);
  p.off_ring = p.off_qlo * (p.qsplit ? 2 : 1);
  p.off_mask = r16((size_t)p.bn * p.ld * esize);
  p.slot_bytes = p.off_mask + r16((size_t)p.bn * 4);
  p.off_p = p.off_ring + p.slot_bytes * p.slots;
  if (p.kvsplit) {
    p.off_sp = p.off_stats = p.off_p;
    p.smem = std::max(p.off_p, p.off_ring + warps * 16 * (p.ldo + 2) * 4);
    return;
  }
  p.off_sp = p.off_p + r16(bm * p.ldp * 4);
  p.off_stats = p.off_sp + r16(warps * 16 * p.lds * 4);
  p.smem = p.off_stats + 2 * (size_t)(p.bn / 8) * bm * 4;
}

// The plan of a launch at these widths.  Preferred, in order: kv split,
// two blocks an SM, then 64 kv rows a tile before 32; column split (and
// blocks), 32 kv rows a tile (every kv tile a warp's), then two blocks an
// SM, then 16 and 8 rows; 4 ring slots before 3 (column split: then 2);
// the most query tiles a block.
bool plan(int Lq, int d, bool bf16, Plan* out) {
  const int nk = cdiv(d, 8);                  // 8-column tiles of the head
  if (Lq < 1 || d < 1) return false;
  Plan p{};
  p.kvsplit = nk * 8 <= kMaxKvSplitD;
  // column blocks of equal width, each at most kBlockD columns, none empty
  p.nkb = cdiv(nk, cdiv(nk, kBlockD / 8));
  p.ncb = cdiv(nk, p.nkb);
  // column split: a warp for every 8 output tiles, at least 4 a query tile
  p.wc = p.kvsplit ? 4 : std::max(4, cdiv(p.nkb, kColTiles));
  p.qsplit = p.kvsplit && !bf16;
  // the accumulator's size, as instantiated: all the head's tiles (kv split:
  // 2, 4, 8, 16), or a warp's slice of them (column split: 8)
  p.cw = p.kvsplit ? (nk <= 2 ? 2 : nk <= 4 ? 4 : nk <= 8 ? 8 : 16) : kColTiles;
  const int esize = bf16 ? 2 : 4;
  p.ldq = p.ncb > 1 ? 0 : nk * 8 + 4;
  p.ld = bf16 ? (p.nkb % 2 ? p.nkb * 8 : p.nkb * 8 + 8) : p.nkb * 8 + 4;
  auto fits = [&](int bn, int slots, size_t budget) {
    p.bn = bn;
    p.slots = slots;
    p.ns = p.kvsplit ? bn / (8 * p.wc) : 1;
    layout(p, esize);
    return p.smem <= budget;
  };
  for (int mt = std::min(cdiv(Lq, 16), kMaxThreads / (32 * p.wc)); mt >= 1; --mt) {
    p.mt = mt;
    if (p.kvsplit) {
      for (size_t budget : {kSmemTwo, kSmemLimit})
        for (int bn : {64, 32})
          for (int slots = 4; slots >= 3; --slots)
            if (fits(bn, slots, budget)) return *out = p, true;
      continue;
    }
    for (int bn : {32, 16, 8})
      for (size_t budget : {kSmemTwo, kSmemLimit})
        for (int slots = 4; slots >= 2; --slots)
          if (fits(bn, slots, budget)) return *out = p, true;
  }
  return false;
}

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const int* mask;
  T* out;
  float* m_part;
  float* l_part;
  float* acc_part;
  int Lq, Lk, d, chunk;
  int copy;          // bytes a cp.async moves (16, 8, 4), 0: element loads
  float scale2;      // scale · log2(e): the softmax runs in base 2
  Plan p;
};

// B fragment of kᵀ from K's rows (w_t[n * ld + k]), split into TF32 halves;
// kExact: a bfloat16 grid, exact in TF32, no low half.
template <bool kExact, typename T>
__device__ __forceinline__ void frag_kt(const T* w_t, int ld, int g, int t,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float x[2] = {hop1::to_float(w_t[g * ld + t]), hop1::to_float(w_t[g * ld + t + 4])};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kExact) {
      hi[i] = __float_as_uint(x[i]);
      lo[i] = 0u;
    } else {
      split_tf32(x[i], hi[i], lo[i]);
    }
  }
}

// B fragment of V (w[k * ld + n]) with its k rows in the order 0, 2, 4, 6,
// 1, 3, 5, 7: p's A fragment then takes columns 2t, 2t + 1 as k = t, t + 4,
// one 8-byte load a row (hop1::load_b_pairs for T).
template <bool kExact, typename T>
__device__ __forceinline__ void frag_v(const T* w, int ld, int g, int t, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const float x[2] = {hop1::to_float(w[2 * t * ld + g]), hop1::to_float(w[(2 * t + 1) * ld + g])};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kExact) {
      hi[i] = __float_as_uint(x[i]);
      lo[i] = 0u;
    } else {
      split_tf32(x[i], hi[i], lo[i]);
    }
  }
}

// nt rows of w elements, sd apart from src, into rows ld elements apart.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int nt, int w, int sd, int ld,
                                          int copy, int tid, int nthreads) {
  if (copy == 0) {   // a bfloat16 grid of odd rows or odd address: no cp.async
    for (int i = tid; i < nt * w; i += nthreads) {
      const int r = i / w, e = i - r * w;
      dst[r * ld + e] = src[(size_t)r * sd + e];
    }
    return;
  }
  const int per = copy / (int)sizeof(T);      // elements a copy
  const int cpr = w / per;                    // copies a row
  for (int i = tid; i < nt * cpr; i += nthreads) {
    const int r = i / cpr, e = (i - r * cpr) * per;
    T* dp = dst + r * ld + e;
    const T* sp = src + (size_t)r * sd + e;
    if (copy == 16)
      cp_async16(dp, sp);
    else if (copy == 8)
      cp_async8(dp, sp);
    else
      cp_async4(dp, sp);
  }
}

// Wait until at most slots - 2 groups of this thread's copies are in flight.
__device__ __forceinline__ void wait_ring(int slots) {
  if (slots >= 4)
    hop1::cp_async_wait<2>();
  else if (slots == 3)
    hop1::cp_async_wait<1>();
  else
    hop1::cp_async_wait<0>();
}

// d += a b in 3xTF32 with the small terms in an accumulator of their own
// (lo), so that the passes form two independent chains; kExactA/B as in
// hop1::mma_3xtf32_ab.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma_split(float (&hi)[4], float (&lo)[4],
                                          const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                          const uint32_t (&b_hi)[2], const uint32_t (&b_lo)[2]) {
  if (!kExactA) hop1::mma_tf32(lo, a_lo, b_hi);
  if (!kExactB) hop1::mma_tf32(lo, a_hi, b_lo);
  hop1::mma_tf32(hi, a_hi, b_hi);
}

// ldmatrix: four (two) 8x8 tiles of 16-bit values from shared memory, the
// rows of tile i addressed by lanes 8i .. 8i + 7 (16-byte aligned).  Read
// as 32-bit values a tile is 8 rows of 4, and lane 4g + t gets value
// (g, t): the layout of the m16n8k8 TF32 fragments.
__device__ __forceinline__ void ldsm_x4(const void* row, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hop1::smem_u32(row)));
}

__device__ __forceinline__ void ldsm_x2(const void* row, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(hop1::smem_u32(row)));
}

// q's A fragment at k-step ks by ldmatrix, `qa` the lane's row offset
// (rows lr + 8(lm & 1), columns 4(lm >> 1) for lane 8lm + lr): staged split
// (kSplit), exact (a bfloat16 q) or split here.
template <bool kExact, bool kSplit>
__device__ __forceinline__ void ldsm_q(const uint32_t* qh, const uint32_t* ql, int qa, int ks,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  ldsm_x4(qh + qa + ks * 8, hi);
  if (kSplit) {
    ldsm_x4(ql + qa + ks * 8, lo);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kExact)
        lo[i] = 0u;
      else
        split_tf32(__uint_as_float(hi[i]), hi[i], lo[i]);
    }
  }
}

// B fragments of kᵀ for kv tiles n and n + 1 (x4; n alone: x2), float32 K,
// by ldmatrix, `row` the lane's address (kv row 8(lm >> 1) + lr, column
// 4(lm & 1) of the k-step), split into TF32 halves.
template <int kN>
__device__ __forceinline__ void ldsm_kt(const float* row, uint32_t (&hi)[kN][2],
                                        uint32_t (&lo)[kN][2]) {
  uint32_t r[2 * kN];
  if constexpr (kN == 2)
    ldsm_x4(row, r);
  else
    ldsm_x2(row, r);
#pragma unroll
  for (int i = 0; i < 2 * kN; ++i) split_tf32(__uint_as_float(r[i]), hi[i / 2][i % 2], lo[i / 2][i % 2]);
}

// 2^x by the SFU alone (ex2.approx, relative error ~2^-22; subnormal results
// flush to 0), in place of exp2f's extra range handling: p and the softmax
// rescales are products of it, far from float32's subnormals.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
#if FLASH_PROBE & 8
  y = exp2f(x);
#else
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
#endif
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Partial attention of (g, query tile of 16·mt rows, kv split; column
// block): with one split the normalised output, otherwise the split's
// running max (natural log), sum and unnormalised accumulator.  kKvSplit:
// the mode (Plan); kNS: kv split, 8-row kv tiles a warp scores; kCW: most
// 8-column output tiles a warp; kBlocks: column blocks.  Output tiles past
// the warp's are computed on a repeated tile and dropped, so that no loop
// of products branches.
template <typename T, bool kKvSplit, int kNS, int kCW, bool kBlocks>
__global__ void __launch_bounds__(kMaxThreads)
flash_fwd_mma_kernel(const Args<T> a) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool kQSplit = kKvSplit && !kExact;
  constexpr int kGroup = kCW < 4 ? kCW : 4;       // output tiles p v takes at once
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& P = a.p;
  const int bm = 16 * P.mt, bn = P.bn, slots = P.slots, ldk = P.ld, ldq = P.ldq,
            d = a.d, Lq = a.Lq, Lk = a.Lk;
  const uint32_t* q_hi = reinterpret_cast<const uint32_t*>(smem);
  const uint32_t* q_lo = reinterpret_cast<const uint32_t*>(smem + P.off_qlo);
  unsigned char* ring = smem + P.off_ring;

  const int g = kBlocks ? blockIdx.x / P.ncb : blockIdx.x;
  const int cb = kBlocks ? blockIdx.x - g * P.ncb : 0;   // column block
  const int q0 = blockIdx.y * bm;
  const int nq = min(bm, Lq - q0);
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int k_begin = split * a.chunk;
  const int k_end = min(Lk, k_begin + a.chunk);
  const int ntiles = (k_end - k_begin + bn - 1) / bn;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rt = warp / P.wc, cw = warp % P.wc;   // query tile; warp within it
  const int fg = lane >> 2, ft = lane & 3;        // fragment row, column pair
  const int r0 = rt * 16 + fg;                    // the lane's rows r0, r0 + 8
  // the lane's ldmatrix rows (lane 8lm + lr): q's A fragment (rows lr +
  // 8(lm & 1), columns 4(lm >> 1)), K's B fragments (kv rows 8(lm >> 1) +
  // lr, columns 4(lm & 1))
  const int lr = lane & 7, lm = lane >> 3;
  const int qa = (lr + 8 * (lm & 1)) * ldq + 4 * (lm >> 1);
  const int kt = (8 * (lm >> 1) + lr) * ldk + 4 * (lm & 1);
  const int nk = (d + 7) / 8;                     // k-steps; output tiles
  const int nkc = kBlocks ? P.ncb : 1;            // K's column chunks a kv tile
  const int ipt = nkc + 1;                        // ring items a kv tile
  // the block's output tiles, from output column col0
  const int nko = kBlocks ? min(P.nkb, nk - cb * P.nkb) : nk;
  const int col0 = kBlocks ? cb * P.nkb * 8 : 0;
  // the warp's output tiles: all (kv split), or a slice from c0
  const int ncw = kKvSplit ? nk : (nko + P.wc - 1) / P.wc;
  const int c0 = kKvSplit ? 0 : cw * ncw;
  const int nc = min(ncw, nko - c0);
  const T* kg = a.k + (size_t)g * Lk * d;
  const T* vg = a.v + (size_t)g * Lk * d;
  const int* mg = a.mask ? a.mask + (size_t)g * Lk : nullptr;

  // The ring's slots this split fills start at 0, and cp.async never writes
  // a K column past d (read by the padded k-step against q's zeros) or a
  // row past a partial tile's end (read by p v against p = 0): both hold 0
  // or earlier, finite values.
  {
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int n16 = (int)(P.slot_bytes * min(slots, ipt * ntiles) / 16);
    for (int i = tid; i < n16; i += nthreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();   // the zeros are in before cp.async fills the slots

  // ring item j, into slot j % slots: of kv tile j / ipt, K's column chunk
  // j % ipt (< nkc; the last with the mask values) or the block's columns of
  // V; one commit group each, empty past the split
  auto slot_at = [&](int j) { return ring + (size_t)(j % slots) * P.slot_bytes; };
  auto issue = [&](int j) {
    const int tile = j / ipt, sub = j - tile * ipt;
    if (tile < ntiles) {
      const int t0 = k_begin + tile * bn;
      const int nt = min(bn, k_end - t0);
      unsigned char* slot = slot_at(j);
      const int e0 = kBlocks ? (sub < nkc ? sub : cb) * P.nkb * 8 : 0;
      const int w = kBlocks ? min(P.nkb * 8, d - e0) : d;
      if (!((FLASH_PROBE & 4) && a.Lq >= 0))
        copy_rows(reinterpret_cast<T*>(slot), (sub < nkc ? kg : vg) + (size_t)t0 * d + e0, nt,
                  w, d, ldk, a.copy, tid, nthreads);
      if (sub == nkc - 1 && mg != nullptr) {
        int* mask_s = reinterpret_cast<int*>(slot + P.off_mask);
        for (int t = tid; t < nt; t += nthreads) cp_async4(mask_s + t, mg + t0 + t);
      }
    }
    cp_async_commit();
  };
  for (int j = 0; j < slots - 1; ++j) issue(j);
  // q's tile, staged while the first K/V tiles are in flight (the first kv
  // tile's barrier makes it visible)
  {
    uint32_t* qh = reinterpret_cast<uint32_t*>(smem);
    uint32_t* ql = reinterpret_cast<uint32_t*>(smem + P.off_qlo);
    for (int i = tid; i < bm * ldq; i += nthreads) {
      const int r = i / ldq, e = i - r * ldq;
      const float x = r < nq && e < d ? ld(a.q + ((size_t)g * Lq + q0 + r) * d + e) : 0.f;
      if (kQSplit)
        split_tf32(x, qh[i], ql[i]);
      else
        qh[i] = __float_as_uint(x);
    }
  }

  const float masked2 = kMaskedScore * kLog2e;
  // scale (to base 2) and mask a score of kv column `col` of the tile
  auto mask_score = [&](float x, int col, int nt, const int* valid_s) {
    const bool inside = col < nt;
    const bool valid = inside && (mg == nullptr || valid_s[col] != 0);
    return valid ? x * a.scale2 : inside ? masked2 : -INFINITY;
  };
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[kCW][4];
#pragma unroll
  for (int c = 0; c < kCW; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  // acc[cg..] = acc·α + p v over output tiles cg.. of the warp (past nc:
  // its last one again), for kv rows 8n.. of v_s, n < nsteps, with p's A
  // fragment from `a_frag(n, ah, al)`
  auto pv_group = [&](int cg, int nsteps, const T* v_s, const float (&alpha)[2], auto a_frag) {
    float o[kGroup][4];
#pragma unroll
    for (int c = 0; c < kGroup; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
    const int nrun = (FLASH_PROBE & 2) && a.Lq >= 0 ? 0 : nsteps;
    for (int n = 0; n < nrun; ++n) {
      uint32_t ah[4], al[4];
      a_frag(n, ah, al);
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        if (cg + c < kCW) {
          const int tile = c0 + min(cg + c, nc - 1);
          uint32_t bh[2], bl[2];
          frag_v<kExact>(v_s + (size_t)n * 8 * ldk + tile * 8, ldk, fg, ft, bh, bl);
          hop1::mma_3xtf32_ab<false, kExact>(o[c], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kGroup; ++c)
      if (cg + c < kCW)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[cg + c][e] = fmaf(acc[cg + c][e], alpha[e >> 1], o[c][e]);
  };

  // q's A fragment at k-step ks from device memory (column blocks)
  auto q_global = [&](int ks, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 8 * (i & 1), e = ks * 8 + ft + 4 * (i >> 1);
      const float x = r < nq && e < d ? ld(a.q + ((size_t)g * Lq + q0 + r) * d + e) : 0.f;
      if (kExact) {
        hi[i] = __float_as_uint(x);
        lo[i] = 0u;
      } else {
        split_tf32(x, hi[i], lo[i]);
      }
    }
  };

  for (int t = 0; t < ntiles; ++t) {
    const int t0 = k_begin + t * bn;
    const int nt = min(bn, k_end - t0);
    const int base = ipt * t;   // the tile's first ring item
    wait_ring(slots);
    __syncthreads();   // K of tile t (its first column chunk) has landed; tile t - 1's
                       // p v is done
    issue(base + slots - 1);
    const T* k_s = reinterpret_cast<const T*>(slot_at(base));
    const int* valid_s = reinterpret_cast<const int*>(slot_at(base + nkc - 1) + P.off_mask);
    const T* v_s = reinterpret_cast<const T*>(slot_at(base + nkc));
    const uint32_t* qh = q_hi + rt * 16 * ldq;
    const uint32_t* ql = q_lo + rt * 16 * ldq;

    if constexpr (kKvSplit) {
      // ---- S = q kᵀ for the warp's 8·kNS kv rows over all of d, chains
      // of kChain k-steps summed in float32
      const T* kw = k_s + (size_t)cw * kNS * 8 * ldk;
      float s[kNS][4];
#pragma unroll
      for (int n = 0; n < kNS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      auto chain = [&](int k0, int k1, auto unrolled) {
        float c[kNS][4], cl[kNS][4];
#pragma unroll
        for (int n = 0; n < kNS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[n][e] = cl[n][e] = 0.f;
        auto step = [&](int ks) {
          uint32_t ah[4], al[4], bh[kNS][2], bl[kNS][2];
          ldsm_q<kExact, kQSplit>(qh, ql, qa, ks, ah, al);
          if constexpr (kExact) {
#pragma unroll
            for (int n = 0; n < kNS; ++n)
              frag_kt<true>(kw + (size_t)n * 8 * ldk + ks * 8, ldk, fg, ft, bh[n], bl[n]);
          } else {
            ldsm_kt<kNS>(kw + kt + ks * 8, bh, bl);
          }
#pragma unroll
          for (int n = 0; n < kNS; ++n)
            mma_split<kExact, kExact>(c[n], cl[n], ah, al, bh[n], bl[n]);
        };
        if (decltype(unrolled)::value) {
#pragma unroll
          for (int kk = 0; kk < kChain; ++kk) step(k0 + kk);
        } else {
          for (int ks = k0; ks < k1; ++ks) step(ks);
        }
#pragma unroll
        for (int n = 0; n < kNS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += c[n][e] + cl[n][e];
      };
      int k0 = (FLASH_PROBE & 1) && a.Lq >= 0 ? nk : 0;
      for (; k0 + kChain <= nk; k0 += kChain) chain(k0, k0 + kChain, std::true_type());
      if (k0 < nk) chain(k0, nk, std::false_type());

      // ---- the warp's own online softmax over its kv rows
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = mask_score(s[n][e], (cw * kNS + n) * 8 + 2 * ft + (e & 1), nt, valid_s);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m = fmaxf(m_run[h], quad_max(mx[h]));
        // m is -inf while no kv row of the warp has been inside the split
        alpha[h] = m == -INFINITY ? 1.f : exp2_sfu(m_run[h] - m);
        mx[h] = m_run[h] = m;
      }
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float m = mx[e >> 1];
          s[n][e] = m == -INFINITY ? 0.f : exp2_sfu(s[n][e] - m);
          sum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = fmaf(l_run[h], alpha[h], quad_sum(sum[h]));
      wait_ring(slots);
      __syncthreads();   // V of tile t has landed
      issue(base + nkc + slots - 1);
      // p's A fragment straight from the scores' D fragment
      const T* vw = v_s + (size_t)cw * kNS * 8 * ldk;
#pragma unroll
      for (int cg = 0; cg < kCW; cg += kGroup)
        pv_group(cg, kNS, vw, alpha, [&](int n, uint32_t(&ah)[4], uint32_t(&al)[4]) {
#pragma unroll
          for (int i = 0; i < kNS; ++i)
            if (i == n) hop1::d_as_a(s[i], ah, al);
        });
    } else {
      // ---- S = q kᵀ: warp cw's share of d's k-steps for every kv row of
      // the tile, to shared memory
      const int nb = bn / 8;                          // 8-row kv tiles (<= kTiles)
      float* p_s = reinterpret_cast<float*>(smem + P.off_p);        // bm x ldp
      float* sp_s = reinterpret_cast<float*>(smem + P.off_sp);      // warps x 16 x lds
      float* m_s = reinterpret_cast<float*>(smem + P.off_stats);    // nb x bm
      float* l_s = m_s + nb * bm;
      const int ldp = P.ldp, lds = P.lds;
      {
        // column chunk kc of K (column blocks: one slot each, the first
        // already in), warp cw's share of its k-steps, summed into sc
        const int nkw = (P.nkb + P.wc - 1) / P.wc;
        float sc[kTiles][4];
#pragma unroll
        for (int n = 0; n < kTiles; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        for (int kc = 0; kc < nkc; ++kc) {
          const T* kcs = k_s;
          if (kBlocks && kc > 0) {
            wait_ring(slots);
            __syncthreads();   // K's column chunk kc has landed
            issue(base + kc + slots - 1);
            kcs = reinterpret_cast<const T*>(slot_at(base + kc));
          }
          const int kb = cw * nkw;
          const int ke = (FLASH_PROBE & 1) && a.Lq >= 0
                             ? kb
                             : min(kBlocks ? min(P.nkb, nk - kc * P.nkb) : nk, kb + nkw);
          float c[kTiles][4], cl[kTiles][4];
#pragma unroll
          for (int n = 0; n < kTiles; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[n][e] = cl[n][e] = 0.f;
#pragma unroll 2
          for (int ks = kb; ks < ke; ++ks) {
            uint32_t ah[4], al[4], bh[kTiles][2], bl[kTiles][2];
            if constexpr (kBlocks)
              q_global(kc * P.nkb + ks, ah, al);
            else
              ldsm_q<kExact, false>(qh, ql, qa, ks, ah, al);
#pragma unroll
            for (int n = 0; n < kTiles; n += 2) {
              // kv tiles n, n + 1 (past the tile's: its last again)
              if constexpr (kExact) {
#pragma unroll
                for (int i = 0; i < 2; ++i)
                  frag_kt<true>(kcs + (size_t)min(n + i, nb - 1) * 8 * ldk + ks * 8, ldk, fg,
                                ft, bh[n + i], bl[n + i]);
              } else {
                const int row = min(n + (lm >> 1), nb - 1) * 8 + lr;
                uint32_t h2[2][2], l2[2][2];
                ldsm_kt<2>(kcs + row * ldk + 4 * (lm & 1) + ks * 8, h2, l2);
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                  for (int j = 0; j < 2; ++j) bh[n + i][j] = h2[i][j], bl[n + i][j] = l2[i][j];
              }
            }
#pragma unroll
            for (int n = 0; n < kTiles; ++n)
              mma_split<kExact, kExact>(c[n], cl[n], ah, al, bh[n], bl[n]);
          }
#pragma unroll
          for (int n = 0; n < kTiles; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] += c[n][e] + cl[n][e];
        }
        float* spw = sp_s + (warp * 16 + fg) * lds + 2 * ft;
#pragma unroll
        for (int n = 0; n < kTiles; ++n) {
          if (n < nb) {
            *reinterpret_cast<float2*>(spw + n * 8) = make_float2(sc[n][0], sc[n][1]);
            *reinterpret_cast<float2*>(spw + 8 * lds + n * 8) = make_float2(sc[n][2], sc[n][3]);
          }
        }
      }
      __syncthreads();   // the partial scores are in
      // ---- warp cw < nb: the scores of kv rows 8cw.. summed, p and the
      // rows' (max, sum) over them to shared memory
      if (cw < nb) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        for (int w = 0; w < P.wc; ++w) {
          const float* spw = sp_s + ((rt * P.wc + w) * 16 + fg) * lds + cw * 8 + 2 * ft;
          const float2 x = *reinterpret_cast<const float2*>(spw);
          const float2 y = *reinterpret_cast<const float2*>(spw + 8 * lds);
          s[0] += x.x, s[1] += x.y, s[2] += y.x, s[3] += y.y;
        }
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[e] = mask_score(s[e], cw * 8 + 2 * ft + (e & 1), nt, valid_s);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[e]);
        }
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float m = mx[e >> 1];
          s[e] = m == -INFINITY ? 0.f : exp2_sfu(s[e] - m);
          sum[e >> 1] += s[e];
        }
        float* pd = p_s + r0 * ldp + cw * 8 + 2 * ft;
        *reinterpret_cast<float2*>(pd) = make_float2(s[0], s[1]);
        *reinterpret_cast<float2*>(pd + 8 * ldp) = make_float2(s[2], s[3]);
        sum[0] = quad_sum(sum[0]);
        sum[1] = quad_sum(sum[1]);
        if (ft == 0) {
          m_s[cw * bm + r0] = mx[0];
          m_s[cw * bm + r0 + 8] = mx[1];
          l_s[cw * bm + r0] = sum[0];
          l_s[cw * bm + r0 + 8] = sum[1];
        }
      }
      wait_ring(slots);
      __syncthreads();   // V of tile t has landed; p and the row pieces are in
      issue(base + nkc + slots - 1);

      // ---- the running max and sum; acc = acc·α + p v over the warp's columns
      float alpha[2], m_new[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = m_run[h];
        for (int n = 0; n < nb; ++n) m = fmaxf(m, m_s[n * bm + r0 + 8 * h]);
        alpha[h] = exp2_sfu(m_run[h] - m);   // 0 on the first tile (m is finite: the
                                          // tile has a kv row)
        float l = 0.f;
        for (int n = 0; n < nb; ++n) {
          const float mn = m_s[n * bm + r0 + 8 * h];
          if (mn != -INFINITY) l = fmaf(l_s[n * bm + r0 + 8 * h], exp2_sfu(mn - m), l);
        }
        l_run[h] = fmaf(l_run[h], alpha[h], l);
        m_run[h] = m_new[h] = m;
      }
      // p's A fragment from shared memory, rescaled from its kv tile's max
      auto p_frag = [&](int n, uint32_t(&ah)[4], uint32_t(&al)[4]) {
        float f[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mn = m_s[n * bm + r0 + 8 * h];
          f[h] = mn == -INFINITY ? 0.f : exp2_sfu(mn - m_new[h]);
        }
        const float2 x = *reinterpret_cast<const float2*>(p_s + r0 * ldp + n * 8 + 2 * ft);
        const float2 y = *reinterpret_cast<const float2*>(p_s + (r0 + 8) * ldp + n * 8 + 2 * ft);
        split_tf32(x.x * f[0], ah[0], al[0]);
        split_tf32(y.x * f[1], ah[1], al[1]);
        split_tf32(x.y * f[0], ah[2], al[2]);
        split_tf32(y.y * f[1], ah[3], al[3]);
      };
#pragma unroll
      for (int cg = 0; cg < kCW; cg += kGroup) pv_group(cg, nb, v_s, alpha, p_frag);
    }
  }
  hop1::cp_async_wait<0>();   // the empty groups past the split

  if constexpr (kKvSplit) {
    // ---- merge the warps of each query tile through the ring's bytes
    const int nwarps = nthreads >> 5, ldo = P.ldo;
    float* o_s = reinterpret_cast<float*>(ring);          // nwarps x 16 x ldo
    float* ml_s = o_s + nwarps * 16 * ldo;                // nwarps x (16 max, 16 sum)
    __syncthreads();   // every warp is past its last read of the ring
#pragma unroll
    for (int c = 0; c < kCW; ++c) {
      if (c < nk) {
        float* od = o_s + (warp * 16 + fg) * ldo + c * 8 + 2 * ft;
        *reinterpret_cast<float2*>(od) = make_float2(acc[c][0], acc[c][1]);
        *reinterpret_cast<float2*>(od + 8 * ldo) = make_float2(acc[c][2], acc[c][3]);
      }
    }
    if (ft == 0) {
      ml_s[warp * 32 + fg] = m_run[0];
      ml_s[warp * 32 + fg + 8] = m_run[1];
      ml_s[warp * 32 + 16 + fg] = l_run[0];
      ml_s[warp * 32 + 16 + fg + 8] = l_run[1];
    }
    __syncthreads();
    for (int i = tid; i < nq * d; i += nthreads) {
      const int r = i / d, col = i - r * d;
      const int w0 = r / 16 * P.wc, rr = r % 16;
      float m = -INFINITY;
      for (int w = w0; w < w0 + P.wc; ++w) m = fmaxf(m, ml_s[w * 32 + rr]);
      float l = 0.f, x = 0.f;
      for (int w = w0; w < w0 + P.wc; ++w) {
        const float mw = ml_s[w * 32 + rr];
        const float f = mw == -INFINITY ? 0.f : exp2_sfu(mw - m);
        l = fmaf(ml_s[w * 32 + 16 + rr], f, l);
        x = fmaf(o_s[(w * 16 + rr) * ldo + col], f, x);
      }
      const size_t part = ((size_t)g * nsplit + split) * Lq + q0 + r;
      if (nsplit == 1) {
        st(a.out + ((size_t)g * Lq + q0 + r) * d + col, x / l);
      } else {
        a.acc_part[part * d + col] = x;
        if (col == 0) {
          a.m_part[part] = m * kLn2;
          a.l_part[part] = l;
        }
      }
    }
    return;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= nq) continue;
    const size_t qrow = (size_t)g * Lq + q0 + r;
    const size_t part = ((size_t)g * nsplit + split) * Lq + q0 + r;
    if (nsplit > 1 && cb == 0 && cw == 0 && ft == 0) {
      a.m_part[part] = m_run[h] * kLn2;
      a.l_part[part] = l_run[h];
    }
    const float inv = 1.f / l_run[h];
#pragma unroll
    for (int c = 0; c < kCW; ++c) {
      if (c >= nc) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + (c0 + c) * 8 + 2 * ft + e;
        if (col >= d) continue;
        const float x = acc[c][2 * h + e];
        if (nsplit == 1)
          st(a.out + qrow * d + col, x * inv);
        else
          a.acc_part[part * d + col] = x;
      }
    }
  }
}

template <typename T>
const void* kernel(const Plan& p) {
#define BIST_FLASH_MMA(KV, NS, CW, BLK)                                          \
  if (p.kvsplit == KV && (!KV || p.ns == NS) && p.cw == CW && (p.ncb > 1) == BLK) \
    return reinterpret_cast<const void*>(flash_fwd_mma_kernel<T, KV, NS, CW, BLK>);
  BIST_FLASH_MMA(true, 1, 2, false) BIST_FLASH_MMA(true, 1, 4, false)
  BIST_FLASH_MMA(true, 1, 8, false) BIST_FLASH_MMA(true, 1, 16, false)
  BIST_FLASH_MMA(true, 2, 2, false) BIST_FLASH_MMA(true, 2, 4, false)
  BIST_FLASH_MMA(true, 2, 8, false) BIST_FLASH_MMA(true, 2, 16, false)
  BIST_FLASH_MMA(false, 1, kColTiles, false) BIST_FLASH_MMA(false, 1, kColTiles, true)
#undef BIST_FLASH_MMA
  return nullptr;
}

}  // namespace mma

// Merge the kv splits: one thread per output element.
template <typename T>
__global__ void flash_merge_kernel(const float* __restrict__ m_part,
                                   const float* __restrict__ l_part,
                                   const float* __restrict__ acc_part,
                                   T* __restrict__ out, int G, int Lq, int d,
                                   int nsplit) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)G * Lq * d) return;
  const int e = (int)(idx % d);
  const size_t gr = idx / d;                   // g * Lq + row
  const size_t g = gr / Lq, r = gr % Lq;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, m_part[(g * nsplit + s) * Lq + r]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t part = (g * nsplit + s) * Lq + r;
    const float w = expf(m_part[part] - mx);
    den = fmaf(l_part[part], w, den);
    num = fmaf(acc_part[part * d + e], w, num);
  }
  st(out + idx, num / den);
}

template <typename T>
int merge(const float* m_part, const float* l_part, const float* acc_part, T* out, int G,
          int Lq, int d, int nsplit, cudaStream_t stream) {
  const size_t n = (size_t)G * Lq * d;
  flash_merge_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      m_part, l_part, acc_part, out, G, Lq, d, nsplit);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the host side

// What a launch takes: its plan, kernel, block, shared memory, kv tile (the
// split's multiple), query rows a block and column blocks.
struct Spec {
  const void* fn;
  int threads;
  size_t smem;
  int tile, bm, ncb;
  mma::Plan plan;
};

template <typename T>
bool spec(int Lq, int d, Spec* s) {
  if (!mma::plan(Lq, d, std::is_same<T, __nv_bfloat16>::value, &s->plan)) return false;
  s->bm = 16 * s->plan.mt;
  s->ncb = s->plan.ncb;
  s->fn = mma::kernel<T>(s->plan);
  s->threads = s->plan.threads();
  s->smem = s->plan.smem;
  s->tile = s->plan.bn;
  return s->fn != nullptr;
}

// Allow `fn` `smem` bytes of dynamic shared memory (once per kernel and size).
cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static const void* fns[64];
  static size_t sizes[64];
  static int n = 0;
  int i = 0;
  while (i < n && fns[i] != fn) ++i;
  if (i < n && sizes[i] >= smem) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (i == n && n < 64) fns[n++] = fn;
  if (i < n) sizes[i] = smem;
  return cudaSuccess;
}

// Resident blocks an SM of `s`'s kernel on the current device.
cudaError_t occupancy(const Spec& s, int* blocks) {
  cudaError_t e = allow_smem(s.fn, s.smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, s.fn, s.threads, s.smem);
}

// The kv split of a launch: as many splits as one wave of resident blocks
// holds (blocks x splits <= resident blocks on the card, from the block's
// occupancy), each at least two kv tiles, a multiple of the kv tile, none
// empty.
int plan_split(const Spec& s, int G, int Lq, int Lk, int* chunk, int* nsplit) {
  int dev, sms, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = occupancy(s, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)G * s.ncb * cdiv(Lq, s.bm);
  const long long resident = std::max(1LL, (long long)per_sm * sms);
  const long long n = std::max(1LL, std::min(resident / blocks, (long long)cdiv(Lk, 2 * s.tile)));
  *chunk = cdiv(cdiv(Lk, (int)n), s.tile) * s.tile;
  *nsplit = cdiv(Lk, *chunk);
  return 0;
}

// bytes a cp.async moves: the widest that divides a row and both grids'
// addresses (0: a bfloat16 grid of odd rows or addresses)
int copy_width(const void* k, const void* v, int d, int esize) {
  const size_t row = (size_t)d * esize;
  for (int w : {16, 8, 4})
    if (row % w == 0 && reinterpret_cast<size_t>(k) % w == 0 &&
        reinterpret_cast<size_t>(v) % w == 0)
      return w;
  return 0;
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* mask, T* out, float* m_part,
           float* l_part, float* acc_part, int G, int Lq, int Lk, int d, int chunk, int nsplit,
           float scale, cudaStream_t stream) {
  Spec s;
  if (!spec<T>(Lq, d, &s) || chunk % s.tile) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(s.fn, s.smem);
  if (e != cudaSuccess) return (int)e;
  mma::Args<T> args{q, k, v, mask, out, m_part, l_part, acc_part, Lq, Lk, d, chunk,
                    copy_width(k, v, d, (int)sizeof(T)), scale * mma::kLog2e, s.plan};
  void* params[] = {&args};
  const dim3 grid((unsigned)(G * s.ncb), (unsigned)cdiv(Lq, s.bm), (unsigned)nsplit);
  e = cudaLaunchKernel(s.fn, grid, dim3((unsigned)s.threads), params, s.smem, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  return merge(m_part, l_part, acc_part, out, G, Lq, d, nsplit, stream);
}

template <typename T>
int resources(int G, int Lq, int Lk, int d, int* info) {
  Spec s;
  if (!spec<T>(Lq, d, &s)) return (int)cudaErrorInvalidValue;
  int chunk = 0, nsplit = 0, blocks = 0;
  int rc = plan_split(s, G, Lq, Lk, &chunk, &nsplit);
  if (rc != 0) return rc;
  cudaError_t e = occupancy(s, &blocks);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, s.fn);
  if (e != cudaSuccess) return (int)e;
  const int out[] = {s.plan.kvsplit, (int)s.smem, attr.numRegs, (int)attr.localSizeBytes,
                     blocks, s.threads, s.tile, s.bm, s.plan.slots, s.plan.qsplit, s.ncb,
                     chunk, nsplit};
  std::copy(out, out + 13, info);
  return 0;
}

}  // namespace

extern "C" {

// The kv split of a launch on the current device: writes the kv length of
// each split (a multiple of the kernel's kv tile) and the number of splits;
// returns a CUDA error code (cudaErrorInvalidValue for an empty shape).  q,
// k, v are float32, or bfloat16 when bf16 is set.
int bist_flash_plan(int G, int Lq, int Lk, int d, int bf16, int* chunk, int* nsplit) {
  if (G < 1 || Lk < 1) return (int)cudaErrorInvalidValue;
  Spec s;
  const bool ok = bf16 ? spec<__nv_bfloat16>(Lq, d, &s) : spec<float>(Lq, d, &s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return plan_split(s, G, Lq, Lk, chunk, nsplit);
}

// Launch on `stream`; returns the CUDA error code of the launch (0 = ok).
// q, k, v and out are float32, or bfloat16 when bf16 is set.  With nsplit >
// 1, m_part/l_part (G, nsplit, Lq) and acc_part (G, nsplit, Lq, d) are the
// caller's float32 scratch; chunk and nsplit are bist_flash_plan's.
int bist_flash_fwd(const void* q, const void* k, const void* v, const int* mask, void* out,
                   float* m_part, float* l_part, float* acc_part, int bf16, int G, int Lq,
                   int Lk, int d, int chunk, int nsplit, float scale, void* stream) {
  if (G < 1 || Lq < 1 || Lk < 1 || d < 1 || nsplit < 1 || chunk < 1 ||
      (long long)chunk * nsplit < Lk || (long long)chunk * (nsplit - 1) >= Lk ||
      (nsplit > 1 && (m_part == nullptr || l_part == nullptr || acc_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out),
                  m_part, l_part, acc_part, G, Lq, Lk, d, chunk, nsplit, scale, s);
  return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), mask, static_cast<float*>(out), m_part, l_part,
                acc_part, G, Lq, Lk, d, chunk, nsplit, scale, s);
}

// What a launch takes on the current device: info[0] the mode (1 kv split,
// 0 column split), [1] dynamic shared memory bytes, [2] registers a thread,
// [3] local memory bytes a thread (spills, stack), [4] resident blocks an
// SM, [5] threads a block, [6] kv rows a tile, [7] query rows a block, [8]
// ring slots, [9] q staged split, [10] column blocks, [11] kv rows a split,
// [12] splits.  Returns the CUDA error code.
int bist_flash_resources(int G, int Lq, int Lk, int d, int bf16, int* info) {
  return bf16 ? resources<__nv_bfloat16>(G, Lq, Lk, d, info)
              : resources<float>(G, Lq, Lk, d, info);
}

}  // extern "C"
