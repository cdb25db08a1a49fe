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
// the 128-lane width in device memory; here any head dim is read and written
// as it is.  Up to d = 256 shared memory and registers are sized for the next
// of 16, 32, 64, 128, 256 (a template parameter), the padding held at 0.
// Above it a wide kernel (flash_fwd_wide_kernel) takes the output columns in
// blocks of 256, one block of columns a thread block (each scores the rows
// again), and the score contraction in chunks of 256 columns of q and K, so
// its shared memory does not grow with d.  Rows that are not aligned
// 4-element vectors load one element at a time.
//
// What bounds it on the H100: in the regime `mha` sends here (kv >= 32768,
// e.g. G=128 rows of heads, Lq=32, Lk=32768, d=64) it must read K and V once
// (2.1 GB, 0.65 ms at 3.35 TB/s) and does 4·G·Lq·Lk·d = 34 GFLOP (0.51 ms at
// the 67 TFLOP/s float32 rate outside the tensor cores): bound by bytes, with
// the arithmetic close behind.  The design reads every K/V element from
// device memory once and keeps the card full:
//
//   * a block owns a group g, a tile of up to 32 query rows (all of them for
//     Lq <= 32) and one split of the kv axis; with few (g, row-tile) pairs
//     the kv axis is split across blocks (`bist_flash_plan` picks the split
//     count from the SM count) and a second, small kernel merges the splits'
//     (max, sum, accumulator) partials;
//   * the block streams its split through shared memory in tiles of 64 kv
//     rows (32 above d=64) and keeps the online-softmax state and accumulator
//     of its rows in registers;
//   * a warp owns up to 4 query rows and scores them together: lane j scores
//     kv rows j, j+32 of the tile for all 4 rows, so each K element read from
//     shared memory (padded row stride: distinct banks) feeds 4 FMAs, and
//     each V element of the p·v product likewise; the 4 rows' q and p values
//     sit side by side and arrive in one 16-byte load.
//
// Columns past Lk are never scored, so a row whose columns are all masked
// gets uniform attention over the true Lk, as the plain version does (the
// Pallas kernel also counted its padding there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kRows = 4;                       // query rows per warp
constexpr int kMaxRows = kMaxWarps * kRows;    // query rows per block
constexpr int kMaxD = 256;                     // the templated kernel's widest head
constexpr int kWideCols = 256;                 // the wide kernel's column blocks
constexpr int kWideKv = 32;                    // and its kv tile
constexpr float kMaskedScore = -1e9f;

template <int DP>
struct Tile {                                       // DP: padded head dim
  static constexpr int kKv = DP <= 64 ? 64 : 32;    // kv rows per tile
  static constexpr int kStride = DP + 1;            // padded K row stride
  static constexpr int kPerLane = kKv / 32;         // kv rows scored per lane
  static constexpr int kOutPerLane = (DP + 31) / 32; // output columns per lane
};

int padded_dim(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256; }
int kv_tile(int d) { return padded_dim(d) <= 64 ? 64 : 32; }
int col_blocks(int d) { return d <= kMaxD ? 1 : (d + kWideCols - 1) / kWideCols; }
int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 4 consecutive elements as float32 (16-byte or 8-byte aligned)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  __nv_bfloat162 v[2];
  *reinterpret_cast<uint2*>(v) = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(v[0]), b = __bfloat1622float2(v[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Partial attention of (g, query-row tile, kv split).  With one split it
// writes the normalised output; otherwise the split's running max, sum and
// unnormalised accumulator.
template <int DP, typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ m_part,
                 float* __restrict__ l_part, float* __restrict__ acc_part,
                 int Lq, int Lk, int d, int bq, int chunk, int vec, float scale) {
  using TL = Tile<DP>;
  extern __shared__ float smem[];
  const int nwarps = blockDim.x / 32;
  float* k_s = smem;                            // kKv x kStride
  float* v_s = k_s + TL::kKv * TL::kStride;     // kKv x DP
  // q and p hold a warp's 4 rows side by side, so one 16-byte load
  // (broadcast to the warp) fetches an element of all 4 rows
  float* q_s = v_s + TL::kKv * DP;              // nwarps x DP x kRows
  float* p_s = q_s + nwarps * DP * kRows;       // nwarps x kKv x kRows
  int* valid_s = reinterpret_cast<int*>(p_s + nwarps * TL::kKv * kRows);

  const int g = blockIdx.x;
  const int q0 = blockIdx.y * bq;
  const int nq = min(bq, Lq - q0);
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int k_begin = split * chunk;
  const int k_end = min(Lk, k_begin + chunk);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* kg = k + (size_t)g * Lk * d;
  const T* vg = v + (size_t)g * Lk * d;
  const int* mg = mask ? mask + (size_t)g * Lk : nullptr;

  // q columns d..DP-1 and K columns d..DP-1 stay 0, so the padding adds 0 to
  // every score (V's padding columns feed only output columns never written)
  for (int i = threadIdx.x; i < nwarps * DP * kRows; i += blockDim.x) {
    const int r = i % kRows, e = i / kRows % DP, w = i / (kRows * DP);
    const int qr = w + r * nwarps;            // the query row warp w owns
    q_s[i] = qr < nq && e < d ? ld(q + ((size_t)g * Lq + q0 + qr) * d + e) : 0.f;
  }
  if (d < DP)
    for (int i = threadIdx.x; i < TL::kKv * TL::kStride; i += blockDim.x) k_s[i] = 0.f;

  int row[kRows];
  float m[kRows], l[kRows], acc[kRows][TL::kOutPerLane];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    row[r] = warp + r * nwarps;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < TL::kOutPerLane; ++u) acc[r][u] = 0.f;
  }
  const float4* qw = reinterpret_cast<const float4*>(q_s) + warp * DP;
  float* pw = p_s + warp * TL::kKv * kRows;

  for (int t0 = k_begin; t0 < k_end; t0 += TL::kKv) {
    const int nt = min(TL::kKv, k_end - t0);
    __syncthreads();   // the previous tile's readers are done
    const T* kt = kg + (size_t)t0 * d;
    const T* vt = vg + (size_t)t0 * d;
    if (vec) {  // rows of whole, aligned 4-element vectors
      const int d4 = d / 4;
      for (int i = threadIdx.x; i < nt * d4; i += blockDim.x) {
        const int t = i / d4, e = i % d4 * 4;
        const float4 kk = ld4(kt + (size_t)i * 4);
        float* kd = k_s + t * TL::kStride + e;
        kd[0] = kk.x; kd[1] = kk.y; kd[2] = kk.z; kd[3] = kk.w;
        *reinterpret_cast<float4*>(v_s + t * DP + e) = ld4(vt + (size_t)i * 4);
      }
    } else {
      for (int i = threadIdx.x; i < nt * d; i += blockDim.x) {
        const int t = i / d, e = i % d;
        k_s[t * TL::kStride + e] = ld(kt + i);
        v_s[t * DP + e] = ld(vt + i);
      }
    }
    for (int t = threadIdx.x; t < nt; t += blockDim.x)
      valid_s[t] = mg == nullptr || mg[t0 + t] != 0;
    __syncthreads();

    // scores of the warp's rows against kv rows lane, lane + 32, ...
    float s[kRows][TL::kPerLane];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < TL::kPerLane; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < DP; ++e) {
      const float4 q4 = qw[e];
      const float qv[kRows] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int j = 0; j < TL::kPerLane; ++j) {
        const float kv = k_s[(lane + 32 * j) * TL::kStride + e];
#pragma unroll
        for (int r = 0; r < kRows; ++r) s[r][j] = fmaf(qv[r], kv, s[r][j]);
      }
    }
    float alpha[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      alpha[r] = 1.f;
      if (row[r] >= nq) continue;              // uniform across the warp
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TL::kPerLane; ++j) {
        const int t = lane + 32 * j;
        // past the tile: never counted
        s[r][j] = t >= nt ? -INFINITY : valid_s[t] ? s[r][j] * scale : kMaskedScore;
        tmax = fmaxf(tmax, s[r][j]);
      }
      const float m_new = fmaxf(m[r], warp_max(tmax));
      alpha[r] = expf(m[r] - m_new);           // 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < TL::kPerLane; ++j) {
        const float p = lane + 32 * j < nt ? expf(s[r][j] - m_new) : 0.f;
        pw[(lane + 32 * j) * kRows + r] = p;
        psum += p;
      }
      l[r] = l[r] * alpha[r] + warp_sum(psum);
      m[r] = m_new;
    }
    __syncwarp();

    // acc = acc * alpha + p v for the warp's rows; lane owns columns lane + 32u
#pragma unroll
    for (int u = 0; u < TL::kOutPerLane; ++u) {
      const int e = lane + 32 * u;
      if (e < d) {
        float a[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = acc[r][u] * alpha[r];
#pragma unroll 4
        for (int t = 0; t < nt; ++t) {
          const float vv = v_s[t * DP + e];
          const float4 p4 = reinterpret_cast<const float4*>(pw)[t];
          a[0] = fmaf(p4.x, vv, a[0]);
          a[1] = fmaf(p4.y, vv, a[1]);
          a[2] = fmaf(p4.z, vv, a[2]);
          a[3] = fmaf(p4.w, vv, a[3]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][u] = a[r];
      }
    }
    __syncwarp();                              // pw is rewritten next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row[r] >= nq) continue;
    const size_t qrow = (size_t)blockIdx.x * Lq + q0 + row[r];
    const size_t part = ((size_t)blockIdx.x * nsplit + split) * Lq + q0 + row[r];
    if (nsplit > 1 && lane == 0) {
      m_part[part] = m[r];
      l_part[part] = l[r];
    }
#pragma unroll
    for (int u = 0; u < TL::kOutPerLane; ++u) {
      const int e = lane + 32 * u;
      if (e >= d) continue;
      if (nsplit == 1) st(out + qrow * d + e, acc[r][u] / l[r]);
      else acc_part[part * d + e] = acc[r][u];
    }
  }
}

// Partial attention of (g, query-row tile, kv split, block of kWideCols
// output columns) at any head dim: the scores of a kv tile accumulate over
// chunks of kWideCols columns of q and K staged in shared memory, then the
// online softmax and p·v as above for the block's columns of V.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ mask,
                      T* __restrict__ out, float* __restrict__ m_part,
                      float* __restrict__ l_part, float* __restrict__ acc_part,
                      int Lq, int Lk, int d, int bq, int chunk, float scale) {
  constexpr int kStride = kWideCols + 1;
  constexpr int kOut = kWideCols / 32;          // output columns per lane
  extern __shared__ float smem[];
  const int nwarps = blockDim.x / 32;
  float* k_s = smem;                            // kWideKv x kStride
  float* v_s = k_s + kWideKv * kStride;         // kWideKv x kWideCols
  float* q_s = v_s + kWideKv * kWideCols;       // nwarps x kWideCols x kRows
  float* p_s = q_s + nwarps * kWideCols * kRows;  // nwarps x kWideKv x kRows
  int* valid_s = reinterpret_cast<int*>(p_s + nwarps * kWideKv * kRows);

  const int g = blockIdx.x;
  const int q0 = blockIdx.y * bq;
  const int nq = min(bq, Lq - q0);
  const int ncb = (d + kWideCols - 1) / kWideCols;
  const int split = blockIdx.z / ncb, nsplit = gridDim.z / ncb;
  const int c0 = blockIdx.z % ncb * kWideCols;  // the block's output columns
  const int nc = min(kWideCols, d - c0);
  const int k_begin = split * chunk;
  const int k_end = min(Lk, k_begin + chunk);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* kg = k + (size_t)g * Lk * d;
  const T* vg = v + (size_t)g * Lk * d;
  const int* mg = mask ? mask + (size_t)g * Lk : nullptr;

  int row[kRows];
  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    row[r] = warp + r * nwarps;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < kOut; ++u) acc[r][u] = 0.f;
  }
  const float4* qw = reinterpret_cast<const float4*>(q_s) + warp * kWideCols;
  float* pw = p_s + warp * kWideKv * kRows;

  for (int t0 = k_begin; t0 < k_end; t0 += kWideKv) {
    const int nt = min(kWideKv, k_end - t0);
    float s[kRows] = {};
    for (int e0 = 0; e0 < d; e0 += kWideCols) {
      const int ne = min(kWideCols, d - e0);
      __syncthreads();   // the previous chunk's (and tile's) readers are done
      for (int i = threadIdx.x; i < nt * ne; i += blockDim.x) {
        const int t = i / ne, e = i % ne;
        k_s[t * kStride + e] = ld(kg + (size_t)(t0 + t) * d + e0 + e);
      }
      for (int i = threadIdx.x; i < nwarps * ne * kRows; i += blockDim.x) {
        const int r = i % kRows, e = i / kRows % ne, w = i / (kRows * ne);
        const int qr = w + r * nwarps;           // the query row warp w owns
        q_s[(w * kWideCols + e) * kRows + r] =
            qr < nq ? ld(q + ((size_t)g * Lq + q0 + qr) * d + e0 + e) : 0.f;
      }
      if (e0 == 0) {
        for (int i = threadIdx.x; i < nt * nc; i += blockDim.x) {
          const int t = i / nc, e = i % nc;
          v_s[t * kWideCols + e] = ld(vg + (size_t)(t0 + t) * d + c0 + e);
        }
        for (int t = threadIdx.x; t < nt; t += blockDim.x)
          valid_s[t] = mg == nullptr || mg[t0 + t] != 0;
      }
      __syncthreads();
      // lane scores kv row `lane` of the tile for the warp's 4 rows
      if (lane < nt) {
#pragma unroll 4
        for (int e = 0; e < ne; ++e) {
          const float4 q4 = qw[e];
          const float kv = k_s[lane * kStride + e];
          s[0] = fmaf(q4.x, kv, s[0]);
          s[1] = fmaf(q4.y, kv, s[1]);
          s[2] = fmaf(q4.z, kv, s[2]);
          s[3] = fmaf(q4.w, kv, s[3]);
        }
      }
    }
    float alpha[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      alpha[r] = 1.f;
      if (row[r] >= nq) continue;              // uniform across the warp
      // past the tile: never counted
      const float sc = lane >= nt ? -INFINITY : valid_s[lane] ? s[r] * scale : kMaskedScore;
      const float m_new = fmaxf(m[r], warp_max(sc));
      alpha[r] = expf(m[r] - m_new);           // 0 on the first tile
      const float p = lane < nt ? expf(sc - m_new) : 0.f;
      pw[lane * kRows + r] = p;
      l[r] = l[r] * alpha[r] + warp_sum(p);
      m[r] = m_new;
    }
    __syncwarp();

    // acc = acc * alpha + p v for the warp's rows; lane owns columns lane + 32u
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const int e = lane + 32 * u;
      if (e < nc) {
        float a[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = acc[r][u] * alpha[r];
#pragma unroll 4
        for (int t = 0; t < nt; ++t) {
          const float vv = v_s[t * kWideCols + e];
          const float4 p4 = reinterpret_cast<const float4*>(pw)[t];
          a[0] = fmaf(p4.x, vv, a[0]);
          a[1] = fmaf(p4.y, vv, a[1]);
          a[2] = fmaf(p4.z, vv, a[2]);
          a[3] = fmaf(p4.w, vv, a[3]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][u] = a[r];
      }
    }
    __syncwarp();                              // pw is rewritten next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row[r] >= nq) continue;
    const size_t qrow = (size_t)g * Lq + q0 + row[r];
    const size_t part = ((size_t)g * nsplit + split) * Lq + q0 + row[r];
    if (nsplit > 1 && lane == 0 && c0 == 0) {
      m_part[part] = m[r];
      l_part[part] = l[r];
    }
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const int e = lane + 32 * u;
      if (e >= nc) continue;
      if (nsplit == 1) st(out + qrow * d + c0 + e, acc[r][u] / l[r]);
      else acc_part[part * d + c0 + e] = acc[r][u];
    }
  }
}

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

template <typename T>
int launch_wide(const T* q, const T* k, const T* v, const int* mask, T* out,
                float* m_part, float* l_part, float* acc_part, int G, int Lq, int Lk,
                int d, int chunk, int nsplit, float scale, cudaStream_t stream) {
  const int bq = std::min(Lq, kMaxRows);
  const int nwarps = (bq + kRows - 1) / kRows;
  const size_t smem =
      sizeof(float) * ((size_t)kWideKv * (kWideCols + 1) + (size_t)kWideKv * kWideCols +
                       (size_t)nwarps * kWideCols * kRows + (size_t)nwarps * kWideKv * kRows) +
      sizeof(int) * kWideKv;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)G, (unsigned)((Lq + bq - 1) / bq),
                  (unsigned)(nsplit * col_blocks(d)));
  flash_fwd_wide_kernel<T><<<grid, nwarps * 32, smem, stream>>>(
      q, k, v, mask, out, m_part, l_part, acc_part, Lq, Lk, d, bq, chunk, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  return merge(m_part, l_part, acc_part, out, G, Lq, d, nsplit, stream);
}

template <int DP, typename T>
int launch(const T* q, const T* k, const T* v, const int* mask, T* out,
           float* m_part, float* l_part, float* acc_part, int G, int Lq, int Lk,
           int d, int chunk, int nsplit, float scale, cudaStream_t stream) {
  using TL = Tile<DP>;
  const int bq = std::min(Lq, kMaxRows);
  const int nwarps = (bq + kRows - 1) / kRows;
  const size_t smem =
      sizeof(float) * ((size_t)TL::kKv * TL::kStride + (size_t)TL::kKv * DP +
                       (size_t)nwarps * DP * kRows + (size_t)nwarps * TL::kKv * kRows) +
      sizeof(int) * TL::kKv;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<DP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)G, (unsigned)((Lq + bq - 1) / bq), (unsigned)nsplit);
  const int vec = d % 4 == 0 && reinterpret_cast<size_t>(k) % (4 * sizeof(T)) == 0 &&
                  reinterpret_cast<size_t>(v) % (4 * sizeof(T)) == 0;
  flash_fwd_kernel<DP, T><<<grid, nwarps * 32, smem, stream>>>(
      q, k, v, mask, out, m_part, l_part, acc_part, Lq, Lk, d, bq, chunk, vec, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  return merge(m_part, l_part, acc_part, out, G, Lq, d, nsplit, stream);
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, const int* mask,
               void* out, float* m_part, float* l_part, float* acc_part, int G,
               int Lq, int Lk, int d, int chunk, int nsplit, float scale,
               cudaStream_t s) {
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v);
  T* to = static_cast<T*>(out);
  if (d > kMaxD)
    return launch_wide(tq, tk, tv, mask, to, m_part, l_part, acc_part, G, Lq, Lk, d, chunk, nsplit, scale, s);
  switch (padded_dim(d)) {
    case 16: return launch<16>(tq, tk, tv, mask, to, m_part, l_part, acc_part, G, Lq, Lk, d, chunk, nsplit, scale, s);
    case 32: return launch<32>(tq, tk, tv, mask, to, m_part, l_part, acc_part, G, Lq, Lk, d, chunk, nsplit, scale, s);
    case 64: return launch<64>(tq, tk, tv, mask, to, m_part, l_part, acc_part, G, Lq, Lk, d, chunk, nsplit, scale, s);
    case 128: return launch<128>(tq, tk, tv, mask, to, m_part, l_part, acc_part, G, Lq, Lk, d, chunk, nsplit, scale, s);
    default: return launch<256>(tq, tk, tv, mask, to, m_part, l_part, acc_part, G, Lq, Lk, d, chunk, nsplit, scale, s);
  }
}

}  // namespace

extern "C" {

// The kv split of a call on the current device: split the kv axis across
// blocks until about 8 blocks per SM are in flight, keeping at least 4 kv
// tiles per split and no empty split.  Writes the kv length of each split
// (a multiple of the kv tile) and the number of splits; returns a CUDA error
// code (cudaErrorInvalidValue for an empty shape).
int bist_flash_plan(int G, int Lq, int Lk, int d, int* chunk, int* nsplit) {
  if (G < 1 || Lq < 1 || Lk < 1 || d < 1) return (int)cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tile = kv_tile(d);
  const int blocks = G * cdiv(Lq, kMaxRows) * col_blocks(d);
  const int n = std::max(1, std::min(cdiv(8 * sms, blocks), cdiv(Lk, 4 * tile)));
  *chunk = cdiv(cdiv(Lk, n), tile) * tile;
  *nsplit = cdiv(Lk, *chunk);
  return 0;
}

// Launch on `stream`; returns the CUDA error code of the launch (0 = ok).
// q, k, v and out are float32, or bfloat16 when bf16 is set.  With
// nsplit > 1, m_part/l_part (G, nsplit, Lq) and acc_part (G, nsplit, Lq, d)
// are the caller's float32 scratch; chunk and nsplit are bist_flash_plan's.
int bist_flash_fwd(const void* q, const void* k, const void* v, const int* mask,
                   void* out, float* m_part, float* l_part, float* acc_part,
                   int bf16, int G, int Lq, int Lk, int d, int chunk, int nsplit,
                   float scale, void* stream) {
  if (G < 1 || Lq < 1 || Lk < 1 || d < 1 || nsplit < 1 ||
      chunk % kv_tile(d) || (long long)chunk * nsplit < Lk ||
      (long long)chunk * (nsplit - 1) >= Lk ||
      (nsplit > 1 && (m_part == nullptr || l_part == nullptr || acc_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_dim<__nv_bfloat16>(q, k, v, mask, out, m_part, l_part, acc_part,
                                     G, Lq, Lk, d, chunk, nsplit, scale, s);
  return launch_dim<float>(q, k, v, mask, out, m_part, l_part, acc_part, G, Lq, Lk,
                           d, chunk, nsplit, scale, s);
}

}  // extern "C"
