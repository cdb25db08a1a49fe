// Tensor-core and asynchronous-copy pieces of the whole-tile hop-1 forward
// (hop1_fwd.cu): 16- and 8-byte cp.async copies into shared memory, the
// 3xTF32 split of float32 operands and the m16n8k8 TF32 tensor-core product
// with its fragment loads.
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

// A fragment of a row-major tile a[row * ld + k], split into TF32 halves;
// kExact: the values are TF32 already (a bfloat16 grid), the low halves are
// 0 and not computed.
template <bool kExact = false, typename T>
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
      split_tf32(v[i], hi[i], lo[i]);
    }
  }
}

// B fragment of a row-major tile w[k * ld + n] (the weights).
__device__ __forceinline__ void load_b(const float* w, int ld, int g, int t,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(w[t * ld + g], hi[0], lo[0]);
  split_tf32(w[(t + 4) * ld + g], hi[1], lo[1]);
}

// B fragment of a tile stored n-major, w_t[n * ld + k] (K for q kᵀ).
__device__ __forceinline__ void load_b_t(const float* w_t, int ld, int g, int t,
                                         uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(w_t[g * ld + t], hi[0], lo[0]);
  split_tf32(w_t[g * ld + t + 4], hi[1], lo[1]);
}

// B fragment of a row-major tile w[k * ld + n] whose k rows are taken in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (V for p v: so that the D fragment of the
// scores, columns 2t and 2t + 1, serves as p's A fragment, k = t and t + 4).
__device__ __forceinline__ void load_b_pairs(const float* w, int ld, int g, int t,
                                             uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(w[2 * t * ld + g], hi[0], lo[0]);
  split_tf32(w[(2 * t + 1) * ld + g], hi[1], lo[1]);
}

}  // namespace hop1
