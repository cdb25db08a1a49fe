"""Where the time of K1's and K2's "whole" kernels goes on one NVIDIA GPU,
and what the tensor cores and the TF32 split cost there.

    python -m bist_tpu_torch.tools.hop1_probe

1. It builds a copy of csrc/hop1_fwd.cu whose whole kernel records
   clock64() at its phase marks (`HOP1_MARK` in the source; thread 0 of
   each block of the first query chunk), holds each main-path launch
   against the plain version, times it back to back (CUDA events around 20
   calls, the median of 5 runs) and prints each phase's mean microseconds a
   block at the card's maximum SM clock.
2. The same for K2's whole pass 1 (csrc/hop1_bwd.cu, `HOP1_BWD_MARK`) at
   the training step's two launches, all six gradients held against
   `hop1_bwd_plain`; the device time is that of all of K2's passes.
3. A microbenchmark on all SMs: mma.sync m16n8k8 TF32 throughput, its
   latency along a chain of dependent products, and the cost of the TF32
   split by cvt.rna and by bit mask.

Sources and binaries go under build/hop1_probe/.  Needs nvcc and a card.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np

from bist_tpu_torch.ops import _build

OUT = _build.BUILD_DIR.parent / "hop1_probe"
# the phases between HOP1_MARK(k) and HOP1_MARK(k + 1) in the whole kernel
PHASES = ("prologue", "projection", "drain", "bias", "attention", "concat", "Wo")
MAX_BLOCKS = 8192
# (name, B, G, Lq, Lk, D, h, masked, t2s view, seed, residuals)
CASES = [
    ("t2s", 64, 16, 32, 40, 128, 8, True, True, 1, False),
    ("s2t", 64, 40, 32, 16, 128, 8, False, False, 2, False),
    ("train t2s", 32, 16, 32, 40, 128, 8, True, True, 9, True),
    ("train s2t", 32, 40, 32, 16, 128, 8, False, False, 10, True),
    ("one wave t2s", 8, 16, 32, 40, 128, 8, True, True, 21, False),
]

# the phases between HOP1_BWD_MARK(k) and HOP1_BWD_MARK(k + 1) in K2's whole pass 1
BWD_PHASES = ("prologue", "projection", "bias", "attention", "rows out and split", "dkv",
              "dkv store")
# K2's launches of the flagship train step (name, B, G, Lq, Lk, D, h, masked,
# t2s view, seed)
BWD_CASES = [
    ("train t2s", 32, 16, 32, 40, 128, 8, True, True, 11),
    ("train s2t", 32, 40, 32, 16, 128, 8, False, False, 12),
]

INSTRUMENTED = f"""
__device__ long long g_marks[{MAX_BLOCKS} * 8];
#define HOP1_MARK(k) \\
  if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < {MAX_BLOCKS}) \\
    g_marks[blockIdx.x * 8 + (k)] = clock64()
#include "hop1_fwd.cu"
extern "C" int probe_marks(long long* host, int n) {{
  return (int)cudaMemcpyFromSymbol(host, g_marks, n * 8);
}}
"""

INSTRUMENTED_BWD = f"""
__device__ long long g_marks[{MAX_BLOCKS} * 8];
#define HOP1_BWD_MARK(k) \\
  if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) g_marks[blockIdx.x * 8 + (k)] = clock64()
#include "hop1_bwd.cu"
extern "C" int probe_marks(long long* host, int n) {{
  return (int)cudaMemcpyFromSymbol(host, g_marks, n * 8);
}}
"""

BENCH = r"""
#include <stdio.h>
#include "hop1_mma.cuh"
using namespace hop1;

template <int NCH, int PASSES>
__global__ void mma_loop(float* out, long long* clk, int iters) {
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {4u, threadIdx.x};
  float d[NCH][4] = {};
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int k = 0; k < NCH; ++k)
#pragma unroll
      for (int p = 0; p < PASSES; ++p) mma_tf32(d[k], a, b);
  long long t1 = clock64();
  float s = 0;
#pragma unroll
  for (int k = 0; k < NCH; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}

__global__ void split_loop(float* out, long long* clk, int iters, int by_cvt) {
  float x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = threadIdx.x * 0.37f + k;
  uint32_t acc = 0;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t hi, lo;
      if (by_cvt) {
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x[k]));
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x[k] - __uint_as_float(hi)));
      } else {
        split_tf32(x[k], hi, lo);
      }
      acc ^= hi + lo;
      x[k] += 1.0f;
    }
  long long t1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] = (float)acc;
  if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}

int main() {
  float* out; long long* clk; long long h;
  cudaMalloc(&out, 132 * 512 * 4); cudaMalloc(&clk, 132 * 8);
  const int it = 2048;
#define RUN(launch, per)                                              \
  launch; cudaDeviceSynchronize(); launch;                            \
  cudaMemcpy(&h, clk, 8, cudaMemcpyDeviceToHost); printf("%.2f\n", h / (per));
  printf("mma.sync TF32, independent, 8 warps/SM, cycles per MMA per SM sub-partition: ");
  RUN((mma_loop<8, 1><<<132, 256>>>(out, clk, it)), (double)it * 8 * 8 / 4)
  printf("mma.sync TF32, dependent chain, 1 warp, cycles per MMA: ");
  RUN((mma_loop<1, 3><<<1, 32>>>(out, clk, it)), (double)it * 3)
  printf("TF32 split by cvt.rna, 8 warps/SM, cycles per warp split per sub-partition: ");
  RUN((split_loop<<<132, 256>>>(out, clk, it, 1)), (double)it * 8 * 8 / 4)
  printf("TF32 split by bit mask, 8 warps/SM, cycles per warp split per sub-partition: ");
  RUN((split_loop<<<132, 256>>>(out, clk, it, 0)), (double)it * 8 * 8 / 4)
  return 0;
}
"""


def nvcc(name: str, text: str, shared: bool) -> subprocess.Popen:
    """Start nvcc on `text`, written to OUT/<name>.cu, with the port's flags
    and csrc/ on the include path."""
    src, out = OUT / f"{name}.cu", OUT / (f"{name}.so" if shared else name)
    src.write_text(text)
    flags = [f for f in _build.NVCC_FLAGS
             if shared or f not in ("-shared", "-Xcompiler", "-fPIC")]
    return subprocess.Popen([_build._nvcc(), *flags, "-I", str(_build.SRC_DIR), "-o",
                             str(out), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def device_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one call: CUDA events around `launches` calls back to
    back, over their number; the median of `reps` runs."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def inputs(dev, B, G, Lq, Lk, D, h, masked, t2s_view, seed):
    """Random hop-1 inputs from a numpy seed, batch row 0 fully masked;
    `t2s_view` passes kv as the t2s launch does, with T and S swapped."""
    import torch

    from bist_tpu_torch.models.layers import mha_init

    rng = np.random.default_rng(seed)
    p = {n: {k: t.to(dev) for k, t in w.items()}
         for n, w in mha_init(torch.Generator().manual_seed(seed), h, D).items()}
    x, q = (torch.tensor(rng.standard_normal((B, Lq, D), dtype=np.float32), device=dev)
            for _ in range(2))
    shape = (B, Lk, G, D) if t2s_view else (B, G, Lk, D)
    kv = torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)
    kv = kv.transpose(1, 2) if t2s_view else kv
    mask = None
    if masked:
        m = np.arange(Lk)[None, :] < rng.integers(1, Lk + 1, size=B)[:, None]
        m[0] = False
        mask = torch.tensor(m.astype(np.int32)[:, None, :], device=dev)
    return p, x, q, kv, mask


def main() -> int:
    import torch

    from bist_tpu_torch.ops import bist_kernels as K

    if not torch.cuda.is_available():
        print("hop1_probe needs a CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {"instrumented": nvcc("instrumented", INSTRUMENTED, True),
             "instrumented_bwd": nvcc("instrumented_bwd", INSTRUMENTED_BWD, True),
             "bench": nvcc("bench", BENCH, False)}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"build of {name} failed:\n{log}", file=sys.stderr)
            return 1
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = K.bind_fwd(ctypes.CDLL(str(OUT / "instrumented.so")))
    lib.probe_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for case, B, G, Lq, Lk, D, h, masked, view, seed, res in CASES:
        p, x, q, kv, mask = inputs(dev, B, G, Lq, Lk, D, h, masked, view, seed)
        run = lambda: K._hop1_fused_as("whole", x, q, kv, p, h, mask, res, lib=lib)
        got = run()[0] if res else run()
        want = K.hop1_plain(x, q, kv, p, h, mask)
        if not torch.allclose(got, want, rtol=2e-4, atol=2e-4):
            raise AssertionError(f"{case}: the instrumented kernel differs from the "
                                 f"plain version by {(got - want).abs().max().item():.3e}")
        ms = device_ms(run)
        run()
        torch.cuda.synchronize()
        groups = K.hop1_resources(G, Lq, Lk, D, h)["groups_per_block"]
        blocks = min(MAX_BLOCKS, B * -(-G // groups))
        marks = (ctypes.c_longlong * (blocks * 8))()
        if lib.probe_marks(marks, blocks * 8) != 0:
            raise RuntimeError("probe_marks failed")
        t = np.array(marks, dtype=np.float64).reshape(blocks, 8)
        phases = np.diff(t, axis=1).mean(0) / clock
        print(json.dumps({"case": case, "device_ms": ms,
                          "block_us": dict(zip(PHASES, np.round(phases, 2).tolist())),
                          "block_total_us": round(float(phases.sum()), 2),
                          "max_sm_clock_mhz": clock}), flush=True)
    bwd = K.bind_bwd(ctypes.CDLL(str(OUT / "instrumented_bwd.so")))
    bwd.probe_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for case, B, G, Lq, Lk, D, h, masked, view, seed in BWD_CASES:
        p, x, q, kv, mask = inputs(dev, B, G, Lq, Lk, D, h, masked, view, seed)
        _, concat, lse = K.hop1_plain(x, q, kv, p, h, mask, return_residuals=True)
        g = torch.tensor(np.random.default_rng(seed).standard_normal(
            (B, G, Lq, D), dtype=np.float32), device=dev)
        dcc = (g @ p["wo"]["w"].t()).contiguous()
        dh = (dcc * concat).reshape(B, G, Lq, h, D // h).sum(-1)
        args = (q, kv, mask, dcc, dh, lse, p["wk"]["w"], p["wk"]["b"], p["wv"]["w"],
                p["wv"]["b"], h)
        run = lambda: K._hop1_bwd_as("whole", *args, lib=bwd)
        for n, a, b in zip(("dq", "dkv", "dWk", "dWv", "dbk", "dbv"), run(),
                           K.hop1_bwd_plain(*args)):
            if not torch.allclose(a, b, rtol=2e-4, atol=2e-4):
                raise AssertionError(f"{case} {n}: the instrumented kernel differs from "
                                     f"the plain version by {(a - b).abs().max().item():.3e}")
        ms = device_ms(run)
        run()
        torch.cuda.synchronize()
        blocks = min(MAX_BLOCKS, B * -(-G // (2 if Lk <= 16 and G > 1 else 1)))
        marks = (ctypes.c_longlong * (blocks * 8))()
        if bwd.probe_marks(marks, blocks * 8) != 0:
            raise RuntimeError("probe_marks failed")
        t = np.array(marks, dtype=np.float64).reshape(blocks, 8)
        phases = np.diff(t, axis=1).mean(0) / clock
        print(json.dumps({"case": f"hop1_bwd {case}", "device_ms": ms,
                          "block_us": dict(zip(BWD_PHASES, np.round(phases, 2).tolist())),
                          "block_total_us": round(float(phases.sum()), 2),
                          "max_sm_clock_mhz": clock}), flush=True)
    print(subprocess.run([str(OUT / "bench")], capture_output=True, text=True,
                         check=True).stdout, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
