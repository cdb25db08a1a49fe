// Tensor-core and asynchronous-copy pieces of the whole-tile hop-1 kernels
// (hop1_fwd.cu, hop1_bwd.cu): 16- and 8-byte cp.async copies into shared
// memory, the 3xTF32 split of float32 operands and the m16n8k8 TF32
// tensor-core product with its fragment loads.
//
// 3xTF32: a float32 value a is split into hi = a with its low 13 mantissa
// bits cleared (a TF32 value: 10 explicit mantissa bits) and lo = a - hi
// (exact in float32) with the same 13 bits cleared, so that a = hi + lo to
// about 20 bits.  a·b is then lo_a·hi_b + hi_a·lo_b + hi_a·hi_b (the small
// terms first; lo_a·lo_b, below float32's precision, is left out), three
// tensor-core passes that keep float32 accuracy, where one pass on hi_a·hi_b
// alone is off by ~1e-3 at the flagship projection.  The split clears bits
// (round toward zero, as CUTLASS's fast 3xTF32) instead of rounding to
// nearest with cvt.rna.tf32: on the H100 a split by cvt.rna takes 11.9
// cycles a warp on one SM sub-partition against 5.9 for the masks (loop
// overhead included; bist_tpu_torch.tools.hop1_probe), and either way the
// product agrees with float32's to ~1e-6.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hop1_tiles.cuh"

namespace hop1 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, past L1; both 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 8 bytes from global to shared memory (.cg takes only 16); 8-byte aligned.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes from global to shared memory; 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr uint32_t kTf32Mask = 0xffffe000u;   // sign, exponent, 10 mantissa bits

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32Mask;
}

// The same split with both halves rounded to nearest (ties away from zero)
// by an integer add before the mask: a = hi + lo to ~22 bits instead of ~20,
// for K2's long sums and cancellations (hop1_bwd.cu).
__device__ __forceinline__ void split_tf32_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & kTf32Mask;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & kTf32Mask;
}

template <bool kRn>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kRn)
    split_tf32_rn(x, hi, lo);
  else
    split_tf32(x, hi, lo);
}

// d += a b on one m16n8k8 tile: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32; with kExactA (a bfloat16 grid, exact in TF32) a's low
// half is 0 and its pass is skipped.
template <bool kExactA>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  if (!kExactA) mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// Fragment coordinates of lane l: g = l / 4 (row of A, column of B and D),
// t = l % 4.  A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B: b0 (t, g), b1 (t + 4, g); D: d0, d1 (g, 2t + {0, 1}), d2, d3 (g + 8, ...).

// A fragment of a row-major tile a[row * ld + k], split into TF32 halves
// (kRn: rounded to nearest); kExact: the values are TF32 already (a
// bfloat16 grid), the low halves are 0 and not computed.
template <bool kExact = false, bool kRn = false, typename T>
__device__ __forceinline__ void load_a_rows(const T* a, int ld, int g, int t,
                                            uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {to_float(a[g * ld + t]), to_float(a[(g + 8) * ld + t]),
                      to_float(a[g * ld + t + 4]), to_float(a[(g + 8) * ld + t + 4])};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kExact) {
      hi[i] = __float_as_uint(v[i]);
      lo[i] = 0u;
    } else {
      split<kRn>(v[i], hi[i], lo[i]);
    }
  }
}

// A fragment of a tile stored k-major, a_t[k * ld + row] (a transposed
// operand: pᵀ and dsᵀ, kvᵀ in hop1_bwd.cu), split as load_a_rows does.
template <bool kExact = false, bool kRn = false, typename T>
__device__ __forceinline__ void load_a_cols(const T* a_t, int ld, int g, int t,
                                            uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {to_float(a_t[t * ld + g]), to_float(a_t[t * ld + g + 8]),
                      to_float(a_t[(t + 4) * ld + g]), to_float(a_t[(t + 4) * ld + g + 8])};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kExact) {
      hi[i] = __float_as_uint(v[i]);
      lo[i] = 0u;
    } else {
      split<kRn>(v[i], hi[i], lo[i]);
    }
  }
}

// A fragment of a row-major tile whose values were split once into TF32
// halves stored apart (hi_s, lo_s, the same layout): for an operand that
// every warp of a block reads.
__device__ __forceinline__ void load_a_split(const uint32_t* hi_s, const uint32_t* lo_s,
                                             int ld, int g, int t, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const int at[4] = {g * ld + t, (g + 8) * ld + t, g * ld + t + 4, (g + 8) * ld + t + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = hi_s[at[i]];
    lo[i] = lo_s[at[i]];
  }
}

// A fragment from the D fragment of an 8-column tile (columns 2t, 2t + 1 as
// k = t, t + 4; the B operand's k rows then go in the order of load_b_pairs).
template <bool kRn = false>
__device__ __forceinline__ void d_as_a(const float (&d)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split<kRn>(d[0], hi[0], lo[0]);
  split<kRn>(d[2], hi[1], lo[1]);
  split<kRn>(d[1], hi[2], lo[2]);
  split<kRn>(d[3], hi[3], lo[3]);
}

// B fragment of a row-major tile w[k * ld + n] (the weights).
template <bool kRn = false>
__device__ __forceinline__ void load_b(const float* w, int ld, int g, int t,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split<kRn>(w[t * ld + g], hi[0], lo[0]);
  split<kRn>(w[(t + 4) * ld + g], hi[1], lo[1]);
}

// B fragment of a tile stored n-major, w_t[n * ld + k] (K for q kᵀ).
template <bool kRn = false>
__device__ __forceinline__ void load_b_t(const float* w_t, int ld, int g, int t,
                                         uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split<kRn>(w_t[g * ld + t], hi[0], lo[0]);
  split<kRn>(w_t[g * ld + t + 4], hi[1], lo[1]);
}

// B fragment of a row-major tile w[k * ld + n] whose k rows are taken in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (V for p v: so that the D fragment of the
// scores, columns 2t and 2t + 1, serves as p's A fragment, k = t and t + 4).
template <bool kRn = false>
__device__ __forceinline__ void load_b_pairs(const float* w, int ld, int g, int t,
                                             uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split<kRn>(w[2 * t * ld + g], hi[0], lo[0]);
  split<kRn>(w[(2 * t + 1) * ld + g], hi[1], lo[1]);
}

}  // namespace hop1
