#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bist_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

  0. the card's name and power limit (nvidia-smi); no CUDA → exit 1;
  1. build the CUDA kernels of bist_tpu_torch/csrc, one nvcc per source, all
     started together (into build/bist_tpu_torch/), with ptxas's report of
     K1's, K2's and K3's kernels (registers, stack and spill bytes) printed;
  2. each kernel against its plain PyTorch version (float32, TF32 off; an
     element passes when |kernel - plain| <= 2e-4 + 2e-4·|plain|, so K2's
     weight gradients, sums over thousands of kv rows, may pass through the
     relative term, and their largest relative error there is printed) at
     the shapes the main path and serving (phase 9) give it, beside the
     plain version, a library
     call where one computes the same function, and the card's bound.
     "ms" is the median of 20 single calls with CUDA events around each
     (the device time plus the wrapper's host work before the launch);
     "device_ms" puts the events around 20 calls made back to back, over
     their number (the median of 5 such runs), so that the host work
     overlaps the device work of the calls before.  K1's and K2's cases
     name the kernel they must run ("whole" or "tiled", the two of
     csrc/hop1_fwd.cu and of csrc/hop1_bwd.cu); their main-path cases also
     check and time "tiled", the kernel that held those widths before
     "whole", at the same inputs.  K1 and K2 also run at widths "whole" does
     not take (D 120, 520 and 1024 with 8 heads).  K3 (one kernel,
     csrc/flash_fwd.cu) at mha's shape in float32 and on a bfloat16 grid,
     one query row at d 16 and head dim 320, each beside one SDPA call by
     both methods;
  3. the main path: the flagship AVSD model (d_model 128, 8 heads, 3/3/3
     blocks, summary caption, pointer generator over query,cap; random
     weights from seed 0) generating for 4 batches of 64 real test turns
     (random features, 8-40 clips of 16 x 2048) by beam search (beam 5,
     maxlen 12, nbest 5, float32 cache).  Kernel launch counts are zeroed
     just before and read just after; hop 1 must have gone through its
     kernel 6 times per batch, every time through "whole".  Then greedy
     decoding of the same batches, counted the same way.  The same batches
     then run with the kernels forced off: every precomputed context tensor
     must agree to 2e-4 and the greedy tokens must be identical;
  4. the flash kernel through models.layers.mha in the regime that sends it
     there (d_model 512, 8 heads, 32 queries, 32768 keys, key-padding mask),
     counts zeroed and read around it, held against the plain path;
  5. the generate CLI on a tiny on-disk dataset (turns from the vendored test
     set, random .npy features, a .conf + .pt from the port's init_model) in
     every decode style: at its defaults (greedy), beam search, beam search
     over an ensemble of two models, sampling, and oracle on the labeled
     turns; each result JSON checked;
  6. the training path: the flagship model without dropout (so hop 1 runs
     K1 with residuals and K2), random weights from seed 0, Noam-Adam with
     warmup 10 over 2 cycled batches of 32 real training turns (random
     features as in 3).  One step's gradients are first held against the
     plain path (force_plain): the loss to 5e-4 relative, each gradient to
     5e-4 + 5e-3·|g| (the key biases', analytically zero, to 5e-4).  Then 30
     steps with the launch counts zeroed before and read after: K1 and K2 6
     times per step each, every time through "whole"; the loss finite and
     lower at the end on the same batch; ms/step (median after the first)
     and examples/s; then 3 steps under torch.profiler for the device time
     per step and the hop-1 kernels' part of it;
  7. the train CLI for one epoch on phase 5's tiny dataset without dropout,
     then the generate CLI from its <model>_best.pt; the CSV headers, the
     artifacts and the result JSON checked;
  8. serving at one geometry: phase 3's model in a Responder (beam 5,
     maxlen 12, float32 cache, batch bucket 64, lengths 32/256/64, 40
     clips of 16 x 2048) answers phase 3's 256 turns (as text, random
     features from numpy seed 0) by `respond` in 4 groups of 64; then the
     same requests as base64 .npy POSTs from 64 client threads released
     together, through a DynamicBatcher (10 ms window, pipeline depth 4)
     under the HTTP server on port 0.  Required: every served answer equal
     to its direct answer (a row's arithmetic does not depend on its
     neighbours at one geometry), no error, fewer batches than requests,
     and K1 6 times per batch, all "whole";
  9. serving at the serve CLI's defaults (batch buckets 8-64, its length
     and time buckets, bfloat16 cache, beam 5, every bucket warmed up): 512
     requests from 64 closed-loop clients by beam search, then 128 greedily
     and 128 with a bfloat16 precompute (K1 on a bfloat16 grid): requests/s,
     latency percentiles, mean batch rows and component seconds, read with
     no profiler; then 128 more of each under torch.profiler (recording the
     device only) for the card's busy share; and the host times of one
     32-row beam-search batch's parts (assembly, the pinned non-blocking
     copy against a plain blocking one, the decode's launches).  No error
     and K1 on "whole" 6 times per batch are required; the rest are
     readings;
 10. the serve CLI as a process of its own on phase 5's model (--port 0,
     the port read from its log): /healthz, /respond with nested-list
     features and with an int8 upload, a 400 without features, /metrics;
     then the evaluate CLI on phase 5's greedy result: seven metrics and
     its .eval.

The last two lines of standard output are one JSON object listing every
kernel ({"kernels": [...]}) and {"ok": true, "device": {...}}; the card's
name and power limit are printed before them.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TEST_JSON = os.path.join(HERE, "dstc7avsd_eval", "data", "test_set4DSTC7-AVSD.json")
TOL = 2e-4
# NVIDIA H100 SXM data sheet at 700 W: float32 outside the tensor cores,
# dense TF32 on the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

# the flagship configuration (the JAX package's __graft_entry__._flagship_cfg)
FLAGSHIP = dict(nb_blocks=3, nb_venc_blocks=3, nb_cenc_blocks=3,
                nb_aenc_blocks=0, d_model=128, att_h=8, dropout=0.2,
                ptr_gen=True, ptr_ft="query,cap", mask_unk=True,
                dec_st_combine="seq", enc_st_combine="none",
                enc_vc_combine="dyn", auto_encoder=True, t2s=True, s2t=True,
                include_caption="summary", separate_caption=True)
# bench.py's static shape: queries <= 32, histories clipped to 256, summary
# captions <= 64, <= 40 clips of (16 regions, 2048 features)
LQ, LH, LC, T_MAX, S, DV = 32, 256, 64, 40, 16, 2048
LA = 32                      # answers of the training batches, clipped
T_BUCKETS = (16, 24, 32, 40)
GEN = dict(maxlen=12, beam=5, penalty=1.0, nbest=5)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call, CUDA events around each call: with the
    device idle before it, the device time plus whatever of the call's host
    work comes before its launch."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_time_ms(fn, launches: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Time of one call made back to back: CUDA events around `launches`
    calls, over their number; the median of `reps` such runs.  A call's host
    work (the wrapper's checks, allocations, the launch) overlaps the device
    work of the calls before it, so this is the device time wherever that
    is the longer of the two."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound(nbytes: float, flops: float = 0.0, tf32x3_flops: float = 0.0,
          tf32x2_flops: float = 0.0):
    """(least time in ms, what bounds it) on the card's published peaks:
    the bytes over the memory rate against the operations, `flops` at the
    float32 rate and the float32 products done on the tensor cores at the
    dense TF32 rate over the passes of their split: three for 3xTF32
    (`tf32x3_flops`), two where one operand is bfloat16, exact in TF32, and
    has no low half (`tf32x2_flops`)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_F32_FLOPS + 3 * tf32x3_flops / PEAK_TF32_FLOPS
             + 2 * tf32x2_flops / PEAK_TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hop1_work(B, G, Lq, Lk, D, masked, kv_bytes=4):
    """Bytes that must move (each input read once, the output written once)
    and the float32 operations of one fused hop-1 call: those of the K/V
    projection, of Wo and of attention (scores and p·v over all heads)."""
    nbytes = 4 * (2 * B * Lq * D + 3 * D * D + 3 * D + B * G * Lq * D) \
        + kv_bytes * B * G * Lk * D + (4 * B * Lk if masked else 0)
    proj_flops = 2 * 2 * B * G * Lk * D * D
    wo_flops = 2 * B * G * Lq * D * D
    attn_flops = 2 * 2 * B * G * Lq * Lk * D
    return nbytes, proj_flops, wo_flops, attn_flops


def hop1_bwd_work(B, G, Lq, Lk, D, h, masked, kv_bytes=4):
    """Bytes that must move and float32 operations of one hop-1 backward
    call (K2): q_proj, kv, d_concat, dh, lse, Wk, bk, Wv, bv (and the mask)
    read once; dq, dkv, dWk, dWv, dbk, dbv written once; the K/V recompute,
    s and dp, dq, dk and dv, dkv and dW.  Returns (bytes, operations, the
    operations of the products with kv as an operand: the K/V recompute
    and dW)."""
    nbytes = 4 * (2 * B * Lq * D + B * G * Lq * D + 2 * B * G * Lq * h
                  + 4 * D * D + 4 * D) + kv_bytes * 2 * B * G * Lk * D \
        + (4 * B * Lk if masked else 0)
    kv_flops = (2 * 2 * B * G * Lk * D * D     # K and V recomputed
                + 2 * 2 * B * G * Lk * D * D)  # dWk, dWv
    flops = (kv_flops
             + 2 * 2 * B * G * Lq * Lk * D     # s and dp over all heads
             + 3 * 2 * B * G * Lq * Lk * D     # dq, dk and dv
             + 2 * 2 * B * G * Lk * D * D)     # dkv = dk Wkᵀ + dv Wvᵀ
    return nbytes, flops, kv_flops


def flash_work(G, Lq, Lk, d, masked, elem_bytes=4):
    """Bytes that must move (q, k, v and the mask read once, the output
    written once) and the float32 operations (q kᵀ and p v) of one K3 call."""
    nbytes = elem_bytes * (2 * G * Lq * d + 2 * G * Lk * d) + (4 * G * Lk if masked else 0)
    return nbytes, 4 * G * Lq * Lk * d


def ptxas_report(log):
    """Per kernel of an `nvcc -Xptxas -v` log: registers, stack and spill
    bytes, named by kernel, grid type and its template arguments: for hop-1
    "whole" width D, 16-row kv tiles, groups a block, head width up to; for
    K3 its mode, 8-row kv tiles a scoring warp and output tiles a warp up
    to."""
    import re

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            kind = re.search(r"\d((?:hop1|flash)_\w*?_kernel)", mangled)
            args = [int(a) for a in re.findall(r"Li(\d+)E", mangled)]
            cur = {"kernel": kind.group(1) if kind else mangled,
                   "kv": "bfloat16" if "bfloat16" in mangled else "float32"}
            if len(args) == 4:
                cur.update(D=32 * args[0], row_tiles=args[1], groups=args[2],
                           dk_max=8 * args[3])
            elif cur["kernel"] == "flash_fwd_mma_kernel" and len(args) == 2:
                kv_split, blocks = re.findall(r"Lb([01])E", mangled)
                cur.update(mode="kv split" if kv_split == "1" else
                           "column blocks" if blocks == "1" else "column split",
                           score_tiles=args[0], out_tiles_max=args[1])
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return rows


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version


def random_mha_params(h, d, seed, device):
    import torch

    from bist_tpu_torch.models.layers import mha_init
    p = mha_init(torch.Generator().manual_seed(seed), h, d)
    return {n: {k: t.to(device) for k, t in w.items()} for n, w in p.items()}


def hop1_inputs(device, B, G, Lq, Lk, D, h, masked, strided_t2s, seed,
                full_row=True):
    """Random hop-1 inputs from a numpy seed; `strided_t2s` passes kv as the
    main path's t2s does, a (B, T, S, D) grid with T and S swapped;
    `full_row` masks batch row 0 entirely."""
    import torch

    rng = np.random.default_rng(seed)
    p = random_mha_params(h, D, seed, device)
    x = torch.tensor(rng.standard_normal((B, Lq, D), dtype=np.float32), device=device)
    q = torch.tensor(rng.standard_normal((B, Lq, D), dtype=np.float32), device=device)
    if strided_t2s:
        grid = rng.standard_normal((B, Lk, G, D), dtype=np.float32)
        kv = torch.tensor(grid, device=device).transpose(1, 2)
    else:
        kv = torch.tensor(rng.standard_normal((B, G, Lk, D), dtype=np.float32),
                          device=device)
    mask = None
    if masked:
        lengths = rng.integers(1, Lk + 1, size=B)
        m = (np.arange(Lk)[None, :] < lengths[:, None]).astype(np.int32)
        if full_row:
            m[0] = 0                               # one fully masked row
        mask = torch.tensor(m[:, None, :], device=device)
    return rng, p, x, q, kv, mask


def assert_agree(what, got, want, rtol=TOL):
    """Max |diff| of a kernel's result against its plain version; raises
    beyond the tolerance (TOL abs + rtol rel, TOL by default)."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=rtol, atol=TOL):
        raise AssertionError(f"{what}: kernel differs from plain version, "
                             f"max |diff| {err:.3e} > {TOL} + {rtol}·|plain|")
    return err


def rel_beyond_atol(got, want):
    """Largest |diff| / |want| over the elements off by more than TOL
    absolute, which pass only through the relative term (0 when none)."""
    diff = (got.float() - want.float()).abs()
    over = diff > TOL
    if not over.any():
        return 0.0
    return (diff[over] / want.float().abs()[over]).max().item()


def check_hop1(device, name, variant, B, G, Lq, Lk, D, h, masked, strided_t2s,
               seed, residuals=False, bf16=False, vs_tiled=False):
    """One K1 case, which must run the named kernel variant; with
    `residuals` the training launch, whose concat and lse are held against
    the plain version's too; with `bf16` a bfloat16 grid.  The bound counts
    every product at the rate "whole" runs it on the tensor cores: 3xTF32,
    or two passes for the projection of a bfloat16 grid; `bound_f32_ms`
    counts every operation at the float32 rate (the bound of the kernels
    before the tensor cores).  With `vs_tiled` the "tiled" kernel is checked
    and timed at the same inputs too."""
    import torch

    from bist_tpu_torch.ops.bist_kernels import (_hop1_fused_as, hop1_fused, hop1_plain,
                                                 hop1_resources)

    _, p, x, q, kv, mask = hop1_inputs(device, B, G, Lq, Lk, D, h, masked,
                                       strided_t2s, seed)
    if bf16:
        kv = kv.to(torch.bfloat16)
    before = dict(hop1_fused.variants)
    got = hop1_fused(x, q, kv, p, h, mask, return_residuals=residuals)
    ran = [v for v, n in hop1_fused.variants.items() if n != before.get(v, 0)]
    want = hop1_plain(x, q, kv, p, h, mask, return_residuals=residuals)
    torch.cuda.synchronize()
    if ran != [variant]:
        raise AssertionError(f"hop1 {name}: ran the {ran} kernel, expected {variant}")
    def agree(got, what):
        if residuals:
            return max(assert_agree(f"{what} {n}", a, b)
                       for n, a, b in zip(("out", "concat", "lse"), got, want))
        return assert_agree(what, got, want)

    err = agree(got, f"hop1 {name}")
    run = lambda: hop1_fused(x, q, kv, p, h, mask, return_residuals=residuals)
    plain = lambda: hop1_plain(x, q, kv, p, h, mask, return_residuals=residuals)
    extra = {}
    if vs_tiled:
        tiled = lambda: _hop1_fused_as("tiled", x, q, kv, p, h, mask, residuals)
        extra = {"tiled_max_abs_err": agree(tiled(), f"hop1 {name} (tiled)"),
                 "tiled_ms": time_ms(tiled), "tiled_device_ms": device_time_ms(tiled)}
    nbytes, proj, wo, attn = hop1_work(B, G, Lq, Lk, D, masked, kv.element_size())
    if residuals:
        nbytes += 4 * B * G * Lq * (D + h)
    if bf16:
        b_ms, b_by = bound(nbytes, tf32x3_flops=wo + attn, tf32x2_flops=proj)
    else:
        b_ms, b_by = bound(nbytes, tf32x3_flops=proj + wo + attn)
    f32_ms, f32_by = bound(nbytes, proj + wo + attn)
    return {"case": name, "shape": dict(B=B, G=G, Lq=Lq, Lk=Lk, D=D, h=h,
                                        masked=masked, residuals=residuals,
                                        kv=str(kv.dtype).replace("torch.", "")),
            "variant": variant, "max_abs_err": err,
            "ms": time_ms(run), "device_ms": device_time_ms(run),
            "plain_ms": time_ms(plain), "plain_device_ms": device_time_ms(plain), **extra,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_f32_ms": f32_ms, "bound_f32_by": f32_by,
            "bytes": nbytes, "flops": proj + wo + attn, "weight_flops": proj + wo,
            "resources": hop1_resources(G, Lq, Lk, D, h, bf16)}


def check_hop1_bwd(device, name, B, G, Lq, Lk, D, h, masked, strided_t2s, seed,
                   full_row=False, *, variant=None, vs_tiled=False, bf16=False):
    """One K2 case: the residuals of the plain forward on random inputs, a
    random upstream gradient, d_concat and Dh as `hop1_trainable`'s glue
    makes them; every gradient held against `hop1_bwd_plain`.  With
    `variant` the case must run that kernel ("whole" or "tiled", the two of
    csrc/hop1_bwd.cu); with `vs_tiled` "tiled" is checked and timed at the
    same inputs too; with `bf16` a bfloat16 grid (dkv then within one
    bfloat16 step).  The bound counts every product at the rate "whole" runs
    it: 3xTF32, two passes for the products with a bfloat16 grid as an
    operand; `bound_f32_ms` counts every operation at the float32 rate (the
    bound of the FMA kernels)."""
    import torch

    from bist_tpu_torch.ops.bist_kernels import (_hop1_bwd_as, hop1_bwd, hop1_bwd_plain,
                                                 hop1_bwd_resources, hop1_plain)

    rng, p, x, q, kv, mask = hop1_inputs(device, B, G, Lq, Lk, D, h, masked,
                                         strided_t2s, seed, full_row)
    if bf16:
        kv = kv.to(torch.bfloat16)
    _, concat, lse = hop1_plain(x, q, kv, p, h, mask, return_residuals=True)
    g = torch.tensor(rng.standard_normal((B, G, Lq, D), dtype=np.float32), device=device)
    dcc = (g @ p["wo"]["w"].t()).contiguous()
    dh = (dcc * concat).reshape(B, G, Lq, h, D // h).sum(-1)
    args = (q, kv, mask, dcc, dh, lse, p["wk"]["w"], p["wk"]["b"], p["wv"]["w"],
            p["wv"]["b"], h)
    before = dict(hop1_bwd.variants)
    got = hop1_bwd(*args)
    ran = [v for v, n in hop1_bwd.variants.items() if n != before.get(v, 0)]
    want = hop1_bwd_plain(*args)
    torch.cuda.synchronize()
    if len(ran) != 1 or variant not in (None, ran[0]):
        raise AssertionError(f"hop1_bwd {name}: ran the {ran} kernel, expected {variant}")
    names = ("dq", "dkv", "dWk", "dWv", "dbk", "dbv")

    def agree(got, what):
        # a bfloat16 dkv: one rounding of the float32 value, and two values a
        # hair apart may round one bfloat16 step (2^-7 relative) apart
        return max(assert_agree(f"hop1_bwd {what} {n}", a, b,
                                rtol=2 ** -7 if bf16 and n == "dkv" else TOL)
                   for n, a, b in zip(names, got, want))

    err = agree(got, name)
    rel = {n: rel_beyond_atol(a, b) for n, a, b in zip(names, got, want)}
    run = lambda: hop1_bwd(*args)
    plain = lambda: hop1_bwd_plain(*args)
    extra = {}
    if vs_tiled:
        tiled = lambda: _hop1_bwd_as("tiled", *args)
        extra = {"tiled_max_abs_err": agree(tiled(), f"{name} (tiled)"),
                 "tiled_ms": time_ms(tiled), "tiled_device_ms": device_time_ms(tiled)}
    nbytes, flops, kv_flops = hop1_bwd_work(B, G, Lq, Lk, D, h, masked, kv.element_size())
    if bf16:
        b_ms, b_by = bound(nbytes, tf32x3_flops=flops - kv_flops, tf32x2_flops=kv_flops)
    else:
        b_ms, b_by = bound(nbytes, tf32x3_flops=flops)
    f32_ms, f32_by = bound(nbytes, flops)
    return {"case": name, "shape": dict(B=B, G=G, Lq=Lq, Lk=Lk, D=D, h=h,
                                        masked=masked, full_row=full_row,
                                        kv=str(kv.dtype).replace("torch.", "")),
            "variant": ran[0], "max_abs_err": err, "max_rel_err_beyond_atol": rel,
            "ms": time_ms(run), "device_ms": device_time_ms(run),
            "plain_ms": time_ms(plain), "plain_device_ms": device_time_ms(plain), **extra,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_f32_ms": f32_ms, "bound_f32_by": f32_by,
            "bytes": nbytes, "flops": flops, "kv_operand_flops": kv_flops,
            "resources": hop1_bwd_resources(G, Lq, Lk, D, h, bf16)}


def check_flash(device, name, G, Lq, Lk, d, masked, seed, *, bf16=False):
    """One K3 case on random inputs (batch row 0 fully masked when
    `masked`); with `bf16` q, k, v and the result are bfloat16 (the result
    within one bfloat16 step of the plain version's).  Beside the plain
    version, one SDPA call on the same inputs by both methods ("library_ms",
    "library_device_ms").  The bound counts the products at the rate the
    kernel runs them, 3xTF32 (two passes on a bfloat16 grid);
    `bound_f32_ms` at the float32 rate outside the tensor cores."""
    import torch
    import torch.nn.functional as F

    from bist_tpu_torch.ops.flash_attention import (attention_plain, flash_attention,
                                                    flash_resources)

    rng = np.random.default_rng(seed)
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.tensor(rng.standard_normal(s, dtype=np.float32), device=device)
               .to(dtype) for s in ((G, Lq, d), (G, Lk, d), (G, Lk, d)))
    mask = None
    if masked:
        lengths = rng.integers(1, Lk + 1, size=G)
        m = (np.arange(Lk)[None, :] < lengths[:, None]).astype(np.int32)
        m[0] = 0                                   # one fully masked row
        mask = torch.tensor(m, device=device)
    before = flash_attention.launches
    got = flash_attention(q, k, v, mask)
    want = attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    if flash_attention.launches != before + 1:
        raise AssertionError(f"flash {name}: the kernel was not launched")
    rtol = 2 ** -7 if bf16 else TOL
    err = assert_agree(f"flash {name}", got, want, rtol)
    run = lambda: flash_attention(q, k, v, mask)
    plain = lambda: attention_plain(q, k, v, mask)
    bool_mask = None if mask is None else (mask != 0)[:, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bool_mask)
    nbytes, flops = flash_work(G, Lq, Lk, d, masked, q.element_size())
    if bf16:
        b_ms, b_by = bound(nbytes, tf32x2_flops=flops)
    else:
        b_ms, b_by = bound(nbytes, tf32x3_flops=flops)
    f32_ms, f32_by = bound(nbytes, flops)
    return {"case": name, "shape": dict(G=G, Lq=Lq, Lk=Lk, d=d, masked=masked,
                                        dtype=str(dtype).replace("torch.", "")),
            "max_abs_err": err,
            "ms": time_ms(run), "device_ms": device_time_ms(run),
            "plain_ms": time_ms(plain), "plain_device_ms": device_time_ms(plain),
            "library_ms": time_ms(sdpa), "library_device_ms": device_time_ms(sdpa),
            "bound_ms": b_ms, "bound_by": b_by, "bound_f32_ms": f32_ms,
            "bound_f32_by": f32_by, "bytes": nbytes, "flops": flops,
            "resources": flash_resources(G, Lq, Lk, d, bf16)}


def phase_kernels(device):
    hop1 = [
        # the main path's two hop-1 launches of each video layer
        check_hop1(device, "t2s", "whole", 64, 16, 32, 40, 128, 8, True, True, 1,
                   vs_tiled=True),
        check_hop1(device, "s2t", "whole", 64, 40, 32, 16, 128, 8, False, False, 2,
                   vs_tiled=True),
        # many kv tiles at the widest D the kernel takes
        check_hop1(device, "multi-tile", "tiled", 4, 8, 32, 600, 512, 8, True, False, 3),
        # the t2s launch of wider models at the main path's batch
        check_hop1(device, "t2s D=256", "tiled", 64, 16, 32, 40, 256, 8, True, True, 7),
        check_hop1(device, "t2s D=512", "tiled", 64, 16, 32, 40, 512, 8, True, True, 8),
        # the training launches (batches of 32), with the residuals
        check_hop1(device, "train t2s", "whole", 32, 16, 32, 40, 128, 8, True, True, 9,
                   True, vs_tiled=True),
        check_hop1(device, "train s2t", "whole", 32, 40, 32, 16, 128, 8, False, False,
                   10, True, vs_tiled=True),
        # shapes that fill no MMA tile (query rows, kv rows), a narrower
        # model, a bfloat16 grid; batch row 0 fully masked in each
        check_hop1(device, "ragged Lq5 Lk37", "whole", 64, 16, 5, 37, 128, 8, True,
                   True, 15),
        check_hop1(device, "ragged Lq12 Lk1", "whole", 64, 40, 12, 1, 128, 8, True,
                   False, 16),
        check_hop1(device, "t2s D=64 h=4", "whole", 64, 16, 32, 40, 64, 4, True, True,
                   17),
        check_hop1(device, "t2s bf16", "whole", 64, 16, 32, 40, 128, 8, True, True, 18,
                   bf16=True),
        # serving at the serve defaults (phase 9): batches of 32, clips
        # bucketed to 48, the precompute on float32 and on bfloat16 grids
        check_hop1(device, "serve t2s", "whole", 32, 16, 32, 48, 128, 8, True, True, 30),
        check_hop1(device, "serve s2t", "whole", 32, 48, 32, 16, 128, 8, False, False, 31),
        check_hop1(device, "serve t2s bf16", "whole", 32, 16, 32, 48, 128, 8, True, True,
                   32, bf16=True),
        check_hop1(device, "serve s2t bf16", "whole", 32, 48, 32, 16, 128, 8, False, False,
                   33, bf16=True),
        # widths "whole" is not built for: d_k 15 (padded to 16 in the
        # kernel), D above 512 with d_k 65, D 1024; a bfloat16 grid
        check_hop1(device, "t2s D=120 h=8", "tiled", 8, 16, 32, 40, 120, 8, True, True,
                   19),
        check_hop1(device, "t2s D=520 h=8", "tiled", 8, 16, 32, 40, 520, 8, True, True,
                   20),
        check_hop1(device, "t2s D=1024 h=8", "tiled", 8, 16, 32, 40, 1024, 8, True, True,
                   21),
        check_hop1(device, "t2s D=120 h=8 bf16", "tiled", 8, 16, 32, 40, 120, 8, True,
                   True, 22, bf16=True),
    ]
    whole = dict(variant="whole", vs_tiled=True)
    hop1_bwd = [
        # the training step's two hop-1 backward launches of each video layer
        check_hop1_bwd(device, "t2s", 32, 16, 32, 40, 128, 8, True, True, 11, **whole),
        check_hop1_bwd(device, "s2t", 32, 40, 32, 16, 128, 8, False, False, 12, **whole),
        check_hop1_bwd(device, "t2s D=512", 8, 16, 32, 40, 512, 8, True, True, 13,
                       variant="tiled"),
        check_hop1_bwd(device, "t2s, a fully masked row", 32, 16, 32, 40, 128, 8,
                       True, True, 14, full_row=True, **whole),
        # a bfloat16 grid; rows that fill no MMA tile (query rows, kv rows)
        check_hop1_bwd(device, "t2s bf16", 32, 16, 32, 40, 128, 8, True, True, 27,
                       bf16=True, **whole),
        check_hop1_bwd(device, "ragged Lq5 Lk37", 32, 16, 5, 37, 128, 8, True, True, 28,
                       full_row=True, **whole),
        # the widths of phase 2's wide K1 cases (D 1024: two head groups)
        check_hop1_bwd(device, "t2s D=120 h=8", 8, 16, 32, 40, 120, 8, True, True, 23,
                       full_row=True, variant="tiled"),
        check_hop1_bwd(device, "t2s D=520 h=8", 8, 16, 32, 40, 520, 8, True, True, 24,
                       full_row=True, variant="tiled"),
        check_hop1_bwd(device, "t2s D=1024 h=8", 8, 16, 32, 40, 1024, 8, True, True, 25,
                       full_row=True, variant="tiled"),
    ]
    flash = [
        # the regime mha sends to the kernel (phase 4's shape), float32 and
        # a bfloat16 grid
        check_flash(device, "mha kv=32768", 128, 32, 32768, 64, True, 4),
        check_flash(device, "mha kv=32768 bf16", 128, 32, 32768, 64, True, 29, bf16=True),
        # one query row a group against short kv rows
        check_flash(device, "short kv, d=16", 4096, 1, 40, 16, True, 5),
        # a wide head (the column split)
        check_flash(device, "kv=32768, d=320", 32, 32, 32768, 320, True, 26),
    ]
    return hop1, hop1_bwd, flash


# ---------------------------------------------------------------------------
# phase 3: the main path


def flagship_cfg(vocab_size, dv=DV, **kw):
    from bist_tpu_torch.config import ModelConfig
    return ModelConfig(vocab_size=vocab_size, ft_sizes=(dv,), **dict(FLAGSHIP, **kw))


def make_batches(data, n_batches, B, seed, answers=False):
    """Host batches of real test turns clipped to LQ/LH/LC, with random
    feature grids of 8..T_MAX clips (zero-padded to the batch's bucket);
    with `answers`, the turns' answers (clipped to LA) as targets."""
    from bist_tpu_torch.data.batching import Batch, bucket_len, pad_to
    from bist_tpu_torch.vocab import SOS

    rng = np.random.default_rng(seed)
    batches = []
    for n in range(n_batches):
        exs = data.examples[n * B:(n + 1) * B]
        clips = rng.integers(8, T_MAX + 1, size=len(exs))
        t_pad = bucket_len(int(clips.max()), T_BUCKETS)
        fts = np.zeros((len(exs), t_pad, S, DV), np.float32)
        for r, t in enumerate(clips):
            fts[r, :t] = rng.standard_normal((t, S, DV), dtype=np.float32)
        trg = trg_y = np.full((len(exs), 1), SOS, np.int32)
        if answers:
            trg = pad_to([e.answer_in[:LA] for e in exs], LA)
            trg_y = pad_to([e.answer_out[:LA] for e in exs], LA)
        batches.append(Batch(
            query=pad_to([e.question[:LQ] for e in exs], LQ),
            his=pad_to([e.history[-LH:] for e in exs], LH),
            cap=pad_to([e.caption[:LC] for e in exs], LC),
            trg=trg, trg_y=trg_y, fts=fts))
    return batches


def ctx_tensors(ctx):
    out = {}
    for n, kv in enumerate(ctx.layer_kv):
        for name, (k, v) in kv.items():
            out[f"layer{n}.{name}.k"], out[f"layer{n}.{name}.v"] = k, v
    for i, src in enumerate(ctx.ptr_src):
        for f in ("enc", "k", "onehot", "mask"):
            out[f"ptr{i}.{f}"] = getattr(src, f)
    for name, m in ctx.masks.items():
        if m is not None:
            out[f"mask.{name}"] = m
    return out


def phase_main_path(device, n_batches=4, B=64):
    """Beam-search and greedy generation at the flagship width; returns a
    summary."""
    import torch

    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.decode.beam import NEG, beam_search, greedy_decode
    from bist_tpu_torch.models.model import init_model, precompute_decode_ctx
    from bist_tpu_torch.ops import dispatch
    from bist_tpu_torch.ops.bist_kernels import hop1_fused
    from bist_tpu_torch.ops.flash_attention import flash_attention
    from bist_tpu_torch.vocab import get_vocabulary

    vocab = get_vocabulary(TEST_JSON, cutoff=3, include_caption="summary")
    cfg = flagship_cfg(len(vocab))
    data = load_avsd(TEST_JSON, vocab, include_caption="summary",
                     separate_caption=True, undisclosed_only=True)
    gcfg = GenerateConfig(**GEN)
    t0 = time.perf_counter()
    host = make_batches(data, n_batches, B, seed=0)
    batches = [to_device(b, device) for b in host]
    params = init_model(0, cfg, device=device)
    log(f"main path: {n_batches} batches of {B}, vocab {len(vocab)}, grids "
        f"{[tuple(b.fts.shape) for b in batches]}, set-up "
        f"{time.perf_counter() - t0:.1f} s")
    beam_search(params, cfg, batches[0], gcfg)          # warm-up
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    sync()
    hop1_fused.launches = flash_attention.launches = 0
    hop1_fused.variants = {}
    t0 = time.perf_counter()
    results = [beam_search(params, cfg, b, gcfg) for b in batches]
    sync()
    seconds = time.perf_counter() - t0
    launches = {"hop1_fwd": hop1_fused.launches,
                "flash_fwd": flash_attention.launches}
    variants = dict(hop1_fused.variants)

    K = gcfg.nbest
    for r in results:
        if tuple(r.tokens.shape) != (B, K, gcfg.maxlen):
            raise AssertionError(f"beam tokens shape {tuple(r.tokens.shape)}")
        best = r.scores[:, 0]
        if not (torch.isfinite(best).all() and (best > NEG / 2).all()
                and (r.lengths[:, 0] >= 1).all()):
            raise AssertionError("beam search left a row without a finite "
                                 "first-best hypothesis")
    want = 6 * n_batches if device.type == "cuda" else 0
    if launches["hop1_fwd"] != want:
        raise AssertionError(f"hop-1 kernel launched {launches['hop1_fwd']} "
                             f"times on the main path, expected {want} "
                             f"(6 per batch)")
    if device.type == "cuda" and variants != {"whole": want}:
        raise AssertionError(f"hop-1 launches on the main path by kernel: "
                             f"{variants}, expected all {want} on \"whole\"")

    # greedy decoding of the same batches (the generate CLI's default style)
    greedy_decode(params, cfg, batches[0], gcfg.maxlen)          # warm-up
    sync()
    hop1_fused.launches = flash_attention.launches = 0
    hop1_fused.variants = {}
    t0 = time.perf_counter()
    greedy = [greedy_decode(params, cfg, b, gcfg.maxlen) for b in batches]
    sync()
    greedy_seconds = time.perf_counter() - t0
    greedy_launches = {"hop1_fwd": hop1_fused.launches,
                       "flash_fwd": flash_attention.launches}
    greedy_variants = dict(hop1_fused.variants)
    for g in greedy:
        if tuple(g.shape) != (B, gcfg.maxlen) or not ((g >= 0) & (g < len(vocab))).all():
            raise AssertionError(f"greedy tokens: shape {tuple(g.shape)} or ids out "
                                 f"of the vocabulary")
    if greedy_launches["hop1_fwd"] != want or (
            device.type == "cuda" and greedy_variants != {"whole": want}):
        raise AssertionError(f"greedy: hop-1 kernel launches {greedy_variants} "
                             f"({greedy_launches['hop1_fwd']}), expected {want} "
                             f"on \"whole\"")

    # the context precompute alone (encode + the BiST stack, where K1 runs)
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        for b in batches:
            precompute_decode_ctx(params, cfg, b)
    sync()
    precompute_seconds = time.perf_counter() - t0

    # the same batches with the kernels forced off
    with dispatch.force_plain():
        plain_results = [beam_search(params, cfg, b, gcfg) for b in batches]
        plain_greedy = [greedy_decode(params, cfg, b, gcfg.maxlen) for b in batches]
    greedy_same = sum(int(torch.equal(a[row], b[row])) for a, b in zip(greedy, plain_greedy)
                      for row in range(B))
    if greedy_same != n_batches * B:
        raise AssertionError(f"greedy: {n_batches * B - greedy_same} rows differ "
                             f"between the kernel path and the plain path")
    worst = 0.0
    for b in batches:
        with torch.no_grad():
            kern = ctx_tensors(precompute_decode_ctx(params, cfg, b))
            with dispatch.force_plain():
                plain = ctx_tensors(precompute_decode_ctx(params, cfg, b))
        for name, t in kern.items():
            t, u = t.float(), plain[name].float()
            worst = max(worst, (t - u).abs().max().item())
            if not torch.allclose(t, u, rtol=TOL, atol=TOL):
                raise AssertionError(f"decode context {name}: kernel path and "
                                     f"plain path differ by "
                                     f"{(t - u).abs().max().item():.3e}")
    same = total = 0
    for r, pr in zip(results, plain_results):
        for row in range(B):
            n = int(r.lengths[row, 0])
            same += int(n == int(pr.lengths[row, 0]) and torch.equal(
                r.tokens[row, 0, :n], pr.tokens[row, 0, :n]))
            total += 1
    return {"batches": n_batches, "batch_size": B,
            "responses_per_s": n_batches * B / seconds, "seconds": seconds,
            "precompute_seconds": precompute_seconds,
            "launches": launches, "hop1_variants": variants,
            "ctx_max_abs_diff": worst,
            "first_best_identical_share": same / total,
            "greedy": {"responses_per_s": n_batches * B / greedy_seconds,
                       "seconds": greedy_seconds, "launches": greedy_launches,
                       "hop1_variants": greedy_variants,
                       "identical_share": greedy_same / (n_batches * B)}}


# ---------------------------------------------------------------------------
# phase 4: the flash kernel through mha


def phase_mha_flash(device, B=16, Lk=32768):
    Lq, d_model, h, seed = 32, 512, 8, 6
    import torch

    from bist_tpu_torch.models.layers import mha
    from bist_tpu_torch.ops import dispatch
    from bist_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(seed)
    p = random_mha_params(h, d_model, seed, device)
    query = torch.tensor(rng.standard_normal((B, Lq, d_model), dtype=np.float32),
                         device=device)
    key = torch.tensor(rng.standard_normal((B, Lk, d_model), dtype=np.float32),
                       device=device)
    lengths = rng.integers(Lk // 2, Lk + 1, size=B)
    mask = torch.tensor((np.arange(Lk)[None, None, :] < lengths[:, None, None])
                        .astype(np.int32), device=device)      # (B, 1, Lk)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with torch.no_grad():
        sync()
        flash_attention.launches = 0
        out = mha(p, h, query, key, key, mask, drop_rate=0.0)
        sync()
        launches = flash_attention.launches
        with dispatch.force_plain():
            ref = mha(p, h, query, key, key, mask, drop_rate=0.0)
    err = (out - ref).abs().max().item()
    want = 1 if device.type == "cuda" else 0
    if launches != want:
        raise AssertionError(f"mha at kv={Lk} launched the flash kernel "
                             f"{launches} times, expected {want}")
    if not torch.allclose(out, ref, rtol=TOL, atol=TOL):
        raise AssertionError(f"mha flash path differs from plain by {err:.3e}")
    return {"launches": launches, "max_abs_err": err,
            "shape": dict(B=B, Lq=Lq, Lk=Lk, d_model=d_model, h=h)}


# ---------------------------------------------------------------------------
# phase 5: the generate CLI


def write_tiny_dataset(root, n_dialogs=6, model_kw=None, dv=DV, s=S, t_max=T_MAX,
                       seed=0):
    """A tiny dataset under `root`: the first dialogs of the vendored test
    set (undisclosed last turns), random (T, s, dv) features per video at
    <root>/resnext_st/<ImageID>.npy, and <root>/mtn.conf + <root>/mtn.pt of
    a randomly initialised model.  Returns the test-set path."""
    import torch

    from bist_tpu_torch.config import TrainConfig, save_conf
    from bist_tpu_torch.models.model import init_model
    from bist_tpu_torch.vocab import get_vocabulary
    from bist_tpu_torch.weights import save_params

    if os.path.isdir(root):
        shutil.rmtree(root)
    os.makedirs(os.path.join(root, "resnext_st"))
    with open(TEST_JSON) as f:
        full = json.load(f)
    tiny = dict(full, dialogs=full["dialogs"][:n_dialogs])
    test_set = os.path.join(root, "test_set.json")
    with open(test_set, "w") as f:
        json.dump(tiny, f)
    rng = np.random.default_rng(seed)
    for d in tiny["dialogs"]:
        t = int(rng.integers(min(8, t_max), t_max + 1))
        np.save(os.path.join(root, "resnext_st", d["image_id"] + ".npy"),
                rng.standard_normal((t, s, dv), dtype=np.float32))
    vocab = get_vocabulary(test_set, cutoff=0, include_caption="summary")
    cfg = flagship_cfg(len(vocab), dv=dv, **(model_kw or {}))
    save_conf(os.path.join(root, "mtn.conf"), vocab, cfg, TrainConfig())
    save_params(os.path.join(root, "mtn.pt"),
                init_model(0, cfg, device=torch.device("cpu")))
    return test_set


def run_generate(root, test_set, args, device):
    """The generate CLI (a process of its own) on `test_set` with the model
    <root>/mtn; returns its result JSON."""
    out = os.path.join(root, "result.json")
    cmd = [sys.executable, "-m", "bist_tpu_torch.cli.generate",
           "--test-set", test_set,
           "--test-path", os.path.join(root, "<FeaType>", "<ImageID>.npy"),
           "--model", os.path.join(root, "mtn"), *args, "--maxlen", "12",
           "--gen-batch-size", "4", "--output", out, "--device", device.type]
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"generate CLI {' '.join(args)} exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    with open(out) as f:
        return json.load(f)


def phase_cli(device, root, n_dialogs=6, model_kw=None, dv=DV, s=S, t_max=T_MAX):
    """The generate CLI in every decode style on a tiny dataset: at its
    defaults (greedy), beam search, an ensemble of two models by beam
    search, sampling, and oracle on the dataset's labeled turns (each
    dialog without its undisclosed last turn); each result JSON checked
    against its input.  Returns the answers by style."""
    import torch

    from bist_tpu_torch.models.model import init_model
    from bist_tpu_torch.config import load_conf
    from bist_tpu_torch.weights import save_params

    test_set = write_tiny_dataset(root, n_dialogs, model_kw, dv, s, t_max)
    _, cfg, _, _ = load_conf(os.path.join(root, "mtn.conf"))
    save_params(os.path.join(root, "mtn2.pt"), init_model(1, cfg, device=torch.device("cpu")))
    with open(test_set) as f:
        orig = json.load(f)
    labeled = dict(orig, dialogs=[dict(d, dialog=d["dialog"][:-1]) for d in orig["dialogs"]])
    labeled_set = os.path.join(root, "labeled_set.json")
    with open(labeled_set, "w") as f:
        json.dump(labeled, f)
    beam = ["--decode-style", "beam_search", "--beam", "5", "--penalty", "1.0",
            "--nbest", "5"]
    runs = {
        "greedy (default)": (test_set, ["--undisclosed-only", "1"]),
        "beam_search": (test_set, beam + ["--undisclosed-only", "1"]),
        "beam_search ensemble of 2": (test_set, beam + [
            "--undisclosed-only", "1", "--ensemble", os.path.join(root, "mtn2")]),
        "sample": (test_set, ["--decode-style", "sample", "--top-k", "20", "--top-p",
                              "0.9", "--temperature", "0.8", "--sample-seed", "3",
                              "--undisclosed-only", "1"]),
        "oracle": (labeled_set, ["--decode-style", "oracle"]),
    }
    answers = {}
    for style, (data, args) in runs.items():
        result = run_generate(root, data, args, device)
        # greedy, sampled and oracle rows are cut at <eos>: on a random model
        # an answer may be empty, as in bist_tpu; beam search ranks only
        # hypotheses of at least one token
        check_result_schema(result, labeled if data == labeled_set else orig,
                            undisclosed=data == test_set,
                            allow_empty=not style.startswith("beam"))
        answers[style] = [t["answer"] for d in result["dialogs"] for t in d["dialog"]]
        if style == "greedy (default)":             # phase 10 scores it
            shutil.copy(os.path.join(root, "result.json"),
                        os.path.join(root, "result_greedy.json"))
    return {"dialogs": len(orig["dialogs"]), "answers": answers,
            "greedy_result": os.path.join(root, "result_greedy.json")}


def check_result_schema(result, orig, undisclosed=True, allow_empty=False):
    """The result JSON: one entry per dialog, same image ids and turns (the
    last turn only for an --undisclosed-only run), each question kept and
    each answer generated (a string, never the placeholder; non-empty
    unless `allow_empty`)."""
    if set(result) != {"dialogs"} or len(result["dialogs"]) != len(orig["dialogs"]):
        raise AssertionError("result JSON: expected one dialog per test dialog")
    for rd, od in zip(result["dialogs"], orig["dialogs"]):
        turns = od["dialog"][-1:] if undisclosed else od["dialog"]
        if rd["image_id"] != od["image_id"] or len(rd["dialog"]) != len(turns):
            raise AssertionError(f"result JSON: bad entry for {od['image_id']}")
        for turn, ot in zip(rd["dialog"], turns):
            if (turn["question"] != ot["question"] or not isinstance(turn["answer"], str)
                    or not (turn["answer"] or allow_empty)
                    or turn["answer"] == "__UNDISCLOSED__"):
                raise AssertionError(f"result JSON: bad answer for {od['image_id']}")


# ---------------------------------------------------------------------------
# phases 6 and 7: the training path and the train CLI


def phase_train(device, kernel_cases=(), steps=30, B=32, warmup=10, model_kw=None):
    """Noam-Adam steps of the flagship model without dropout (hop 1 through
    K1 with residuals and K2) over 2 cycled batches of B real training
    turns; returns a summary.  One step's gradients are first held against
    the plain path (force_plain)."""
    import torch

    from bist_tpu_torch.config import TrainConfig
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.models.model import forward_logprobs
    from bist_tpu_torch.ops import dispatch
    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.train.losses import compute_losses
    from bist_tpu_torch.train.loop import create_train_state, make_train_step
    from bist_tpu_torch.vocab import get_vocabulary
    from bist_tpu_torch.weights import tree_leaves

    vocab = get_vocabulary(TEST_JSON, cutoff=3, include_caption="summary")
    cfg = flagship_cfg(len(vocab), **dict(model_kw or {}, dropout=0.0,
                                          attn_dropout=0.0))
    data = load_avsd(TEST_JSON, vocab, include_caption="summary",
                     separate_caption=True)
    tcfg = TrainConfig(warmup_steps=warmup)
    batches = [to_device(b, device) for b in
               make_batches(data, 2, B, seed=1, answers=True)]
    state, tx = create_train_state(0, cfg, tcfg, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    # one step's gradients, kernels against the plain path
    def loss_grads():
        logp, ft = forward_logprobs(state.params, cfg, batches[0])
        loss, _ = compute_losses(logp, ft, state.params["embed"]["lut"], cfg,
                                 batches[0], tcfg.smoothing)
        return loss, torch.autograd.grad(loss, tree_leaves(state.params),
                                         allow_unused=True)

    before = hop1_fused.launches, hop1_bwd.launches
    loss_k, grads_k = loss_grads()
    sync()
    check_launches = (hop1_fused.launches - before[0], hop1_bwd.launches - before[1])
    if device.type == "cuda" and check_launches != (6, 6):
        raise AssertionError(f"gradient check: K1, K2 launched {check_launches} "
                             f"times, expected 6 each")
    with dispatch.force_plain():
        loss_p, grads_p = loss_grads()
    names = leaf_names(state.params)
    grad_err, grad_max = 0.0, 0.0
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if loss_rel > 5e-4:
        raise AssertionError(f"train loss: kernel path {loss_k.item()} vs plain "
                             f"{loss_p.item()}")
    for name, a, b in zip(names, grads_k, grads_p):
        if (a is None) != (b is None):
            raise AssertionError(f"gradient {name}: reached on one path only")
        if a is None:
            continue
        rtol = 0.0 if name.endswith("wk.b") else 5e-3   # wk.b: zero, residue
        err = (a - b).abs().max().item()
        grad_err = max(grad_err, err)
        grad_max = max(grad_max, b.abs().max().item())
        if not torch.allclose(a, b, rtol=rtol, atol=5e-4):
            raise AssertionError(f"gradient {name}: kernel path and plain path "
                                 f"differ by {err:.3e}")

    step = make_train_step(cfg, tcfg, tx)
    sync()
    hop1_fused.launches = hop1_bwd.launches = 0
    hop1_fused.variants, hop1_bwd.variants = {}, {}
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batches[i % 2], None)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches = {"hop1_fwd": hop1_fused.launches, "hop1_bwd": hop1_bwd.launches}
    variants = dict(hop1_fused.variants)
    bwd_variants = dict(hop1_bwd.variants)
    want = 6 * steps if device.type == "cuda" else 0
    if launches != {"hop1_fwd": want, "hop1_bwd": want}:
        raise AssertionError(f"training launched {launches} in {steps} steps, "
                             f"expected {want} each (6 per step)")
    if device.type == "cuda" and (variants, bwd_variants) != ({"whole": want},
                                                              {"whole": want}):
        raise AssertionError(f"training's K1, K2 launches by kernel: {variants}, "
                             f"{bwd_variants}, expected all {want} on \"whole\"")
    first, last = losses[0], losses[-2 if steps % 2 == 0 else -1]
    if not (all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"training loss did not fall on batch 0: {losses}")
    ms = statistics.median(times[1:]) * 1e3 if steps > 1 else times[0] * 1e3
    by_name = {c["case"]: c["ms"] for c in kernel_cases}
    per_layer = [by_name.get(k) for k in ("train t2s", "train s2t", "bwd t2s", "bwd s2t")]
    kernel_ms = 3 * sum(per_layer) if all(v is not None for v in per_layer) else None
    profile = profile_steps(step, state, batches, 3, sync) if device.type == "cuda" \
        else None
    return {"steps": steps, "batch_size": B, "ms_per_step": ms,
            "profile": profile,
            "examples_per_s": B / ms * 1e3, "first_step_ms": times[0] * 1e3,
            "launches": launches, "hop1_variants": variants,
            "hop1_bwd_variants": bwd_variants, "loss_first": first, "loss_last_same_batch": last,
            "grad_check": {"loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
                           "loss_rel_diff": loss_rel, "max_abs_diff": grad_err,
                           "max_abs_grad": grad_max,
                           "launches": check_launches},
            "kernel_ms_per_step_from_phase2": kernel_ms,
            "kernel_share_of_step": None if kernel_ms is None else kernel_ms / ms}


def profile_steps(step, state, batches, n, sync):
    """Device time of n train steps from torch.profiler: per step, all
    kernels and the hop-1 kernels (K1, K2's passes), those also by kernel;
    None when the profiler records no device time."""
    import re

    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            state, _ = step(state, batches[i % 2], None)
        sync()
    dev = lambda e: getattr(e, "self_device_time_total", 0.0) or 0.0
    # kernels only: a CPU op also carries the device time of what it launched
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev(e) > 0]
    if not events:
        return None
    total = sum(dev(e) for e in events) / 1e3 / n
    hop1_by_kernel = {}
    for e in events:
        name = re.search(r"(hop1_\w+|sum_middle)_kernel", e.key)
        if name:
            k = name.group(1)
            hop1_by_kernel[k] = hop1_by_kernel.get(k, 0.0) + dev(e) / 1e3 / n
    top = sorted(events, key=dev, reverse=True)[:8]
    return {"device_ms_per_step": total,
            "hop1_kernels_ms_per_step": sum(hop1_by_kernel.values()),
            "hop1_kernels_by_name_ms_per_step": hop1_by_kernel,
            "top_kernels_ms_per_step": {e.key[:80]: dev(e) / 1e3 / n for e in top}}


def leaf_names(tree, prefix=""):
    """Dotted names of a parameter tree's leaves, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]




def phase_train_cli(device, root, n_dialogs=6, model_kw=None, dv=DV, s=S,
                    t_max=T_MAX):
    """The train CLI for one epoch on phase 5's tiny dataset (no dropout),
    then the generate CLI from its best checkpoint; checks the artifacts."""
    test_set = write_tiny_dataset(root, n_dialogs, model_kw, dv, s, t_max)
    cfg = flagship_cfg(1, dv=dv, **(model_kw or {}))
    model = os.path.join(root, "exp", "mtn")
    path = os.path.join(root, "<FeaType>", "<ImageID>.npy")
    cmd = [sys.executable, "-m", "bist_tpu_torch.cli.train", "--fea-type", "resnext_st",
           "--train-path", path, "--train-set", test_set, "--valid-set", test_set,
           "--model", model, "--num-epochs", "1", "--batch-size", "4",
           "--nb-blocks", str(cfg.nb_blocks), "--nb-venc-blocks", str(cfg.nb_venc_blocks),
           "--nb-cenc-blocks", str(cfg.nb_cenc_blocks), "--d-model", str(cfg.d_model),
           "--att-h", str(cfg.att_h), "--include-caption", "summary",
           "--dropout", "0", "--attn-dropout", "0", "--cutoff", "0",
           "--warmup-steps", "10", "--report-interval", "1", "--device", device.type]
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"train CLI exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    headers = {"_train.csv": "epoch,step,loss,ae_temporal_loss,ae_spatial_loss",
               "_trace.csv": "epoch,split,loss,ae_temporal_loss,ae_spatial_loss"}
    for suffix, header in headers.items():
        with open(model + suffix) as f:
            lines = f.read().splitlines()
        if lines[0] != header or len(lines) < 2:
            raise AssertionError(f"{suffix}: {lines[:3]}")
    for suffix in (".conf", "_params.txt", "_best.pt"):
        if not os.path.exists(model + suffix):
            raise AssertionError(f"train CLI wrote no {model}{suffix}")
    out = os.path.join(root, "result.json")
    cmd = [sys.executable, "-m", "bist_tpu_torch.cli.generate", "--test-set", test_set,
           "--test-path", path, "--model", model + "_best", "--decode-style",
           "beam_search", "--beam", "3", "--undisclosed-only", "1",
           "--gen-batch-size", "4", "--output", out, "--device", device.type]
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"generate CLI from the trained checkpoint exited "
                             f"{r.returncode}:\n{r.stderr[-4000:]}")
    with open(out) as f:
        result = json.load(f)
    with open(test_set) as f:
        check_result_schema(result, json.load(f))
    with open(model + "_trace.csv") as f:
        trace = f.read().splitlines()[1:]
    return {"trace": trace, "answers": [d["dialog"][-1]["answer"]
                                        for d in result["dialogs"]]}


# ---------------------------------------------------------------------------
# phases 8-10: serving and scoring


def serving_model(device, model_kw=None, dv=DV):
    """Phase 3's model: the test set's vocabulary (cutoff 3), the flagship
    configuration at feature width `dv`, random weights from seed 0."""
    from bist_tpu_torch.models.model import init_model
    from bist_tpu_torch.vocab import get_vocabulary

    vocab = get_vocabulary(TEST_JSON, cutoff=3, include_caption="summary")
    cfg = flagship_cfg(len(vocab), dv=dv, **(model_kw or {}))
    return vocab, cfg, init_model(0, cfg, device=device)


def serving_requests(n, dv=DV, s=S, t_max=T_MAX, seed=0):
    """Client fields of n requests: the last (undisclosed) turn of the test
    set's first n dialogs (phase 3's turns) as text, its earlier turns as
    history, the summary as caption, and random features of 8..t_max clips
    of (s, dv) from a numpy seed."""
    with open(TEST_JSON) as f:
        dialogs = json.load(f)["dialogs"][:n]
    rng = np.random.default_rng(seed)
    out = []
    for d in dialogs:
        turns = d["dialog"]
        t = int(rng.integers(min(8, t_max), t_max + 1))
        out.append(dict(question=turns[-1]["question"],
                        history=" ".join(f"{u['question']} {u['answer']}" for u in turns[:-1]),
                        caption=d["summary"],
                        features=rng.standard_normal((t, s, dv), dtype=np.float32)))
    return out


def npy_b64(a):
    import base64
    import io

    buf = io.BytesIO()
    np.save(buf, a)
    return base64.b64encode(buf.getvalue()).decode()


def http_json(url, body=None, timeout=300):
    """GET (body None) or POST a JSON body; (status, decoded JSON), an HTTP
    error's status and body included."""
    import urllib.error
    import urllib.request

    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def reset_hop1_counts():
    from bist_tpu_torch.ops.bist_kernels import hop1_fused

    hop1_fused.launches = 0
    hop1_fused.variants = {}


def check_hop1_per_batch(device, what, batches):
    """K1 launched 6 times per served batch (t2s and s2t in each of 3 video
    layers), every time through "whole", since the counts were reset; on
    the CPU no launch.  Returns the counts."""
    from bist_tpu_torch.ops.bist_kernels import hop1_fused

    want = 6 * batches if device.type == "cuda" else 0
    launches, variants = hop1_fused.launches, dict(hop1_fused.variants)
    if launches != want or (device.type == "cuda" and variants != {"whole": want}):
        raise AssertionError(f"{what}: K1 launches {launches} by kernel {variants}, "
                             f"expected {want} on \"whole\" (6 per batch, {batches} batches)")
    return {"hop1_fwd": launches, "hop1_variants": variants}


def phase_serving_exact(device, model, fields, group=64, clients=64, dv=DV, s=S,
                        t_max=T_MAX):
    """Serving at one geometry (batch bucket `group`, lengths LQ/LH/LC, t_max
    clips), beam 5, float32 cache: the requests' reference answers from
    Responder.respond in groups of `group` in order, then the same requests
    as base64 .npy POSTs from `clients` threads released together, through
    a DynamicBatcher (10 ms window, pipeline depth 4) under the HTTP server.
    Each row's arithmetic is independent of its neighbours at one geometry,
    so every served answer must be its reference answer."""
    import threading

    import torch

    from bist_tpu_torch.cli.serve import make_http_server
    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.serving import DynamicBatcher, Responder

    vocab, cfg, params = model
    rsp = Responder(params, cfg, vocab, GenerateConfig(**GEN), max_batch=group,
                    batch_buckets=(group,), len_buckets={"q": (LQ,), "h": (LH,), "c": (LC,)},
                    time_buckets=(t_max,), feat_tail=(s, dv))
    rsp.warmup(feature_shape=(s, dv), t_clips=min(8, t_max))
    n = len(fields)
    reqs = [rsp.make_request(**f) for f in fields]
    for i in range(0, n, group):
        rsp.respond(reqs[i:i + group])
    reference = [r._answer for r in reqs]
    bodies = [json.dumps({"question": f["question"], "history": f["history"],
                          "caption": f["caption"],
                          "features_b64": npy_b64(f["features"])}).encode() for f in fields]

    batcher = DynamicBatcher(rsp, max_batch=group, max_wait_ms=10, pipeline_depth=4)
    batcher.start()
    httpd = make_http_server("127.0.0.1", 0, batcher, requires_features=True)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/respond"
    served, errors = [None] * n, []
    go = threading.Barrier(clients)

    def client(c):
        go.wait(timeout=120)
        for i in range(c, n, clients):
            code, resp = http_json(url, bodies[i])
            if code == 200:
                served[i] = resp["answer"]
            else:
                errors.append((i, code, resp))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    try:
        sync()
        reset_hop1_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        seconds = time.perf_counter() - t0
        sync()
        if any(t.is_alive() for t in threads):
            raise AssertionError("serving: a client did not finish within 600 s")
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()
    stats = dict(batcher.stats)
    differ = [i for i in range(n) if served[i] != reference[i]]
    if errors or stats["errors"]:
        raise AssertionError(f"serving: {len(errors)} requests failed ({errors[:3]}), "
                             f"batcher errors {stats['errors']}")
    if differ:
        raise AssertionError(
            f"serving: {len(differ)} of {n} served answers differ from the direct "
            f"respond() answers, e.g. request {differ[0]}: served "
            f"{served[differ[0]]!r}, direct {reference[differ[0]]!r}")
    if not stats["batches"] < n:
        raise AssertionError(f"serving: {stats['batches']} batches for {n} requests: "
                             f"nothing was coalesced")
    launches = check_hop1_per_batch(device, "serving", stats["batches"])
    m = batcher.metrics()
    return {"requests": n, "identical": n - len(differ), "errors": stats["errors"],
            "batches": stats["batches"], "mean_batch_rows": m["mean_batch_rows"],
            "seconds": seconds, "latency_ms": m["latency_ms"], **launches}


def device_busy_ms(prof):
    """Device time of the kernels and copies a torch.profiler run recorded
    (ms), None when it recorded none.  Sums the trace's device events as
    recorded: grouping them (key_averages()) takes ~10 s for a run's
    ~10^5 events."""
    from torch.autograd import DeviceType

    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    return sum(ns) / 1e6 if ns else None


def serve_window(device, rsp, fields, n, clients, profiled):
    """n requests from `clients` threads through a fresh DynamicBatcher (10
    ms window, pipeline depth 4), each client sending its next request as
    soon as the last is answered; returns the readings.  With `profiled`
    torch.profiler records the device's kernels and copies over the window,
    for the card's busy share (it slows the host: the window's requests/s
    and latencies are not the bare ones)."""
    import contextlib
    import itertools
    import threading

    import torch

    from bist_tpu_torch.serving import DynamicBatcher

    batcher = DynamicBatcher(rsp, max_batch=rsp.max_batch, max_wait_ms=10,
                             pipeline_depth=4)
    batcher.start()
    before = dict(rsp.timings)
    counter, errors = itertools.count(), []

    def client():
        for i in iter(lambda: next(counter), None):
            if i >= n:
                return
            try:
                batcher.submit(**fields[i % len(fields)], timeout=300)
            except Exception as e:   # recorded; the run fails on any error
                errors.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(clients)]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    prof = contextlib.nullcontext()
    if profiled and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        sync()
        reset_hop1_counts()
        with prof:
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            sync()
            seconds = time.perf_counter() - t0
    finally:
        batcher.stop()
    if any(t.is_alive() for t in threads):
        raise AssertionError("serving load: a client did not finish within 600 s")
    m = batcher.metrics()
    if errors or m["errors"]:
        raise AssertionError(f"serving load: {len(errors)} requests failed: {errors[:3]}")
    out = {"requests": n, "requests_per_s": n / seconds, "seconds": seconds,
           "latency_ms": m["latency_ms"], "batches": m["batches"],
           "mean_batch_rows": m["mean_batch_rows"],
           "component_seconds": {k: v - before.get(k, 0.0)
                                 for k, v in m["component_seconds"].items()},
           **check_hop1_per_batch(device, "serving load", m["batches"])}
    if profiled:
        busy = device_busy_ms(prof) if device.type == "cuda" else None
        out["device_busy_ms"] = busy
        out["device_busy_share"] = None if busy is None else busy / (seconds * 1e3)
    return out


def ship_breakdown(device, rsp, fields, rows=32, reps=3):
    """Host milliseconds of one served batch's parts on an idle server (the
    median of `reps`): assembly (make_batch), the copy to the card from
    pinned memory without waiting (dispatch's ship), the same batch by a
    plain blocking .to() from pageable memory, copying the pageable grid
    into pinned memory (the step that assembling into pinned memory saves),
    the decode's launches, and the two copies again with the decode of a
    batch before still running on the card."""
    import torch

    from bist_tpu_torch.data.batching import to_device

    reqs = [rsp.make_request(**f) for f in fields[:rows]]
    host = rsp.make_batch(reqs)
    pageable = host._replace(fts=np.array(host.fts))

    def clock(fn, busy=False):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            if busy:
                rsp._decode(rsp._to_device(host), None)
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return statistics.median(ms)

    batch = rsp._to_device(host)
    return {"rows": rows, "grid_mb": host.fts.nbytes / 2 ** 20,
            "assemble_ms": clock(lambda: rsp.make_batch(reqs)),
            "ship_pinned_ms": clock(lambda: rsp._to_device(host)),
            "ship_blocking_ms": clock(lambda: to_device(pageable, device)),
            "pin_grid_copy_ms": clock(lambda: torch.from_numpy(pageable.fts).pin_memory()),
            "decode_launch_ms": clock(lambda: rsp._decode(batch, None)),
            "ship_pinned_behind_decode_ms": clock(lambda: rsp._to_device(host), busy=True),
            "ship_blocking_behind_decode_ms": clock(lambda: to_device(pageable, device),
                                                    busy=True)}


def phase_serving_load(device, model, fields, n_req=512, n_other=128, n_prof=128,
                       clients=64, dv=DV, s=S):
    """Serving at the serve CLI's defaults (batch buckets 8-64, its length
    and time buckets, bfloat16 cache, beam 5, warmup over every batch
    bucket): n_req requests by beam search, then n_other greedily and
    n_other by beam search with a bfloat16 precompute (K1 on a bfloat16
    grid), each read bare; then n_prof more of each under torch.profiler
    for the card's busy share; on the card, the parts of one beam-search
    batch (ship_breakdown).  Readings, not gates, apart from no error and K1
    on "whole" 6 times per batch."""
    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.serving import Responder

    vocab, cfg, params = model
    runs = {"beam_search": (n_req, {}),
            "greedy": (n_other, {"decode_style": "greedy"}),
            "beam_search, encode bfloat16": (n_other, {"encode_dtype": "bfloat16"})}
    out = {}
    for name, (n, kw) in runs.items():
        gcfg = GenerateConfig(maxlen=12, beam=5, penalty=1.0, nbest=1,
                              cache_dtype="bfloat16", **kw)
        rsp = Responder(params, cfg, vocab, gcfg)
        t0 = time.perf_counter()
        rsp.warmup(feature_shape=(s, dv))
        warm = time.perf_counter() - t0
        out[name] = dict(serve_window(device, rsp, fields, n, clients, profiled=False),
                         warmup_seconds=warm,
                         profiled=serve_window(device, rsp, fields, n_prof, clients,
                                               profiled=True))
        if device.type == "cuda" and name == "beam_search":
            out[name]["ship_breakdown"] = ship_breakdown(device, rsp, fields)
        log(f"serving load, {name}: {json.dumps(out[name])}")
    return out


def phase_serve_cli(device, root, result_json, s=S, timeout=600):
    """The serve CLI (a process of its own, --port 0) on phase 5's model
    <root>/mtn: /healthz, /respond with nested-list features and with an
    int8 upload, a 400 without features, /metrics; then the evaluate CLI on
    `result_json` (phase 5's greedy result): its seven metrics printed and
    its .eval written."""
    import re
    import signal

    from bist_tpu_torch.config import load_conf
    from bist_tpu_torch.data.batching import quantize_features

    _, cfg, _, _ = load_conf(os.path.join(root, "mtn.conf"))
    log_path = os.path.join(root, "serve.log")
    cmd = [sys.executable, "-m", "bist_tpu_torch.cli.serve", "--model",
           os.path.join(root, "mtn"), "--port", "0", "--device", device.type]
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=logf, stderr=subprocess.STDOUT)

    def tail():
        with open(log_path) as f:
            return f.read()[-3000:]

    try:
        deadline, port = time.monotonic() + timeout, None
        while port is None:
            if proc.poll() is not None:
                raise AssertionError(f"serve CLI exited {proc.returncode}:\n{tail()}")
            if time.monotonic() > deadline:
                raise AssertionError(f"serve CLI did not start in {timeout} s:\n{tail()}")
            m = re.search(r"serving on [\d.]+:(\d+)", tail())
            if m:
                port = int(m.group(1))
            else:
                time.sleep(0.2)
        base = f"http://127.0.0.1:{port}"
        rng = np.random.default_rng(5)
        fts = rng.standard_normal((10, s, cfg.ft_sizes[0]), dtype=np.float32)
        q8, scale = quantize_features(fts[None])
        turn = {"question": "what is the man doing ?", "history": "is he inside ? yes",
                "caption": "a man sits on a couch ."}
        checks = {
            "healthz": http_json(f"{base}/healthz"),
            "respond, lists": http_json(f"{base}/respond", dict(turn, features=fts.tolist())),
            "respond, int8": http_json(f"{base}/respond", dict(
                turn, features_b64=npy_b64(q8[0]), features_scale_b64=npy_b64(scale[0]))),
            "respond, no features": http_json(f"{base}/respond", turn),
            "metrics": http_json(f"{base}/metrics"),
        }
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    want = {"healthz": 200, "respond, lists": 200, "respond, int8": 200,
            "respond, no features": 400, "metrics": 200}
    codes = {k: c for k, (c, _) in checks.items()}
    if codes != want or checks["healthz"][1].get("ok") is not True \
            or not all(isinstance(checks[k][1].get("answer"), str)
                       for k in ("respond, lists", "respond, int8")) \
            or checks["metrics"][1].get("requests", 0) < 2:
        raise AssertionError(f"serve CLI: {checks}\n{tail()}")

    r = subprocess.run([sys.executable, "-m", "bist_tpu_torch.cli.evaluate", result_json],
                       cwd=HERE, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"evaluate CLI exited {r.returncode}:\n{r.stderr[-3000:]}")
    summary = r.stdout.split("--- summary ---")[-1]
    metrics = dict(re.findall(r"^(Bleu_[1-4]|METEOR|ROUGE_L|CIDEr): ([\d.]+)$", summary,
                              re.M))
    eval_path = os.path.splitext(result_json)[0] + ".eval"
    if len(metrics) != 7 or not os.path.exists(eval_path):
        raise AssertionError(f"evaluate CLI: metrics {metrics}, .eval written: "
                             f"{os.path.exists(eval_path)}\n{r.stdout[-2000:]}")
    return {"serve": {k: v for k, v in checks.items() if k != "metrics"},
            "serve_metrics": {k: checks["metrics"][1][k] for k in ("requests", "batches",
                                                                    "errors")},
            "evaluate": {k: float(v) for k, v in metrics.items()}}


# ---------------------------------------------------------------------------


def kernel_entry(name, source, replaces, cases, launches, path):
    main = cases[0]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_on": path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "kernel_ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            **{k: main[k] for k in ("variant", "bound_f32_ms", "tiled_ms", "tiled_device_ms",
                                    "library_device_ms")
               if k in main},
            "cases": cases}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("CUDA is not available: this smoke run needs an NVIDIA GPU")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t_start = time.perf_counter()
    laps = [("start", t_start)]           # (phase, when it ended)
    lap = lambda name: laps.append((name, time.perf_counter()))

    from bist_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    t0 = time.perf_counter()
    built = _build.build(ptxas_verbose=True)
    for name, info in built.items():
        log(f"built {name} in {info['seconds']:.1f} s\n{info['log'].strip()}")
    for name in ("hop1_fwd", "hop1_bwd", "flash_fwd"):
        for row in ptxas_report(built[name]["log"]) if name in built else ():
            print(f"ptxas {name}: {json.dumps(row)}", flush=True)
    print(f"build: {len(built)} kernel libraries compiled in "
          f"{time.perf_counter() - t0:.1f} s (wall, in parallel)", flush=True)
    lap("build")

    hop1_cases, bwd_cases, flash_cases = phase_kernels(device)
    for c in hop1_cases + bwd_cases + flash_cases:
        log(f"kernel case {c['case']}: {json.dumps(c)}")
    phase2_ms = [c for c in hop1_cases if c["case"].startswith("train")] + [
        dict(c, case="bwd " + c["case"]) for c in bwd_cases]
    lap("kernels")

    main_path = phase_main_path(device)
    print(f"main path on {card}: {json.dumps(main_path)}", flush=True)
    lap("main path")

    mha_flash = phase_mha_flash(device)
    print(f"mha flash regime on {card}: {json.dumps(mha_flash)}", flush=True)
    lap("mha flash")

    cli = phase_cli(device, os.path.join(HERE, "build", "chip_smoke", "cli"))
    print(f"generate CLI: {json.dumps(cli)}", flush=True)
    lap("generate CLI")

    train = phase_train(device, phase2_ms)
    print(f"training path on {card}: {json.dumps(train)}", flush=True)
    lap("training")

    train_cli = phase_train_cli(device, os.path.join(HERE, "build", "chip_smoke",
                                                     "train_cli"))
    print(f"train CLI: {json.dumps(train_cli)}", flush=True)
    lap("train CLI")

    model = serving_model(device)
    fields = serving_requests(256)
    serving = phase_serving_exact(device, model, fields)
    print(f"serving at one geometry on {card}: {json.dumps(serving)}", flush=True)
    lap("serving")

    serving_load = phase_serving_load(device, model, fields)
    print(f"serving load on {card}: {json.dumps(serving_load)}", flush=True)
    lap("serving load")
    del model, fields

    serve_cli = phase_serve_cli(device, os.path.join(HERE, "build", "chip_smoke", "cli"),
                                cli["greedy_result"])
    print(f"serve and evaluate CLIs: {json.dumps(serve_cli)}", flush=True)
    lap("serve and evaluate CLIs")

    kernels = [
        dict(kernel_entry("hop1_fwd", "bist_tpu_torch/csrc/hop1_fwd.cu",
                          "bist_tpu/ops/bist_kernels.py:63", hop1_cases,
                          main_path["launches"]["hop1_fwd"],
                          f"flagship beam_search, {main_path['batches']} batches "
                          f"of {main_path['batch_size']}"),
             variants=main_path["hop1_variants"],
             launches_train=train["launches"]["hop1_fwd"],
             launches_serving=serving["hop1_fwd"],
             launches_serving_load={k: v["hop1_fwd"] for k, v in serving_load.items()}),
        dict(kernel_entry("hop1_bwd", "bist_tpu_torch/csrc/hop1_bwd.cu",
                          "bist_tpu/ops/bist_kernels.py:243", bwd_cases,
                          train["launches"]["hop1_bwd"],
                          f"flagship train step, {train['steps']} steps of "
                          f"{train['batch_size']}"),
             variants=train["hop1_bwd_variants"]),
        dict(kernel_entry("flash_fwd", "bist_tpu_torch/csrc/flash_fwd.cu",
                          "bist_tpu/ops/flash_attention.py:43", flash_cases,
                          mha_flash["launches"],
                          "models.layers.mha, d_model 512, 8 heads, kv 32768 "
                          f"(flagship beam_search: {main_path['launches']['flash_fwd']})")),
    ]
    log("seconds by phase: " + json.dumps({name: round(t - laps[i][1], 1)
                                           for i, (name, t) in enumerate(laps[1:])}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
