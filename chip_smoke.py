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
     name the kernel they must run ("whole", "wide" or "tiled" of
     csrc/hop1_fwd.cu; "whole", "wide" or "tiled" of csrc/hop1_bwd.cu);
     their main-path cases also check and time "tiled", the kernel that
     held those widths before "whole" and "wide", at the same inputs.  K1
     "wide" at the reference's width (D 512, 8 heads: t2s, s2t, training
     with K2 on its residuals, ragged rows with a fully masked row, a
     bfloat16 grid) and at D 256 (8 and 4 heads); past 64 kv rows (videos
     of more than 64 clips: K1 "wide" over kv tiles at D 128-512, 65-600
     kv rows, a bfloat16 grid, one video, the training launch with K2
     "tiled" on its residuals; "t2s Lk200" and "t2s Lk200 D=512" with the
     peak device memory of a call against plain's); at d_k 128 and every
     D that is a multiple of 128 up to 1024 (K1 "wide" at D 1024 with 8 and
     16 heads, t2s at B 8 and 64, s2t, 200 kv rows, a bfloat16 grid, the
     training launch with K2 "tiled" on its residuals; D 512 with 4 heads,
     D 768 with 12).  K1 and K2 also run at widths neither takes (D 120,
     384 and 520 with 8 heads; K2 also at D 1024).  K3 (one kernel,
     csrc/flash_fwd.cu) at mha's shape in float32 and on a bfloat16 grid,
     one query row at d 16 and head dim 320, each beside one SDPA call by
     both methods;
  3. the main path: the flagship AVSD model (d_model 128, 8 heads, 3/3/3
     blocks, summary caption, pointer generator over query,cap; random
     weights from seed 0) generating for 4 batches of 64 real test turns
     (random features, 8-40 clips of 16 x 2048) by beam search (beam 5,
     maxlen 12, nbest 5, float32 cache), eager and through its compiled
     program (decode.compiled.DecodeProgram: one CUDA graph per geometry)
     in one call.  Eager: a warm-up, then the 4 batches timed with the
     kernels' launch counts zeroed just before and read just after (K1 6
     times per batch, all "whole").  Program: a capture pass (each new
     geometry warmed up eagerly and captured: 12 K1 launches through the
     wrapper each), a timed pass of replays (no launch through the
     wrappers: nothing eager) and a pass of replays under torch.profiler in
     which K1's kernels are counted by name (6 per batch, all "whole";
     this is the "launches" of the kernels line).  Every replayed output
     must equal the eager one.  Then greedy decoding of the same batches
     the same way, and, replayed against eager, beam search and greedy on
     a bfloat16 cache and sampling with per-row seeds on float32 and
     bfloat16 caches.  The same batches then run with the kernels forced
     off: every precomputed context tensor must agree to 2e-4 and the
     greedy tokens must be identical;
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
     per step and the hop-1 kernels' part of it.  Then the compiled steps
     (train.compiled: one CUDA graph per batch geometry), each from a copy
     of the same start state: a TrainProgram's first 11 calls (the first
     the geometry's eager warm-up) held against the first 11 eager steps
     (loss and metrics to 5e-4 relative, parameters after them to 5e-4 +
     5e-3·|p|, the key biases to 5e-4 + 2·Σlr), 30 replays timed beside the
     eager ms/step, 3 under torch.profiler (K1 and K2 6 times a step each
     by kernel name, all "whole"; device ms and busy share); the flagship
     as it trains (dropout 0.2) eager and replayed, 8 steps each at the
     same seeds, held to each other; grad_accum 2, one replay held against
     the eager step; an EvalProgram against make_eval_step (5e-4), its K1
     counted by name;
  7. the train CLI for one epoch on phase 5's tiny dataset without dropout
     and with --num-workers 4 (its train and eval steps through their
     programs, its batches by the native assembler: no fallback line in its
     log; its epoch feed and program stats read from the log), then the
     generate CLI from its <model>_best.pt; the CSV headers, the artifacts
     and the result JSON checked;
  8. serving at one geometry: phase 3's model in a Responder (beam 5,
     maxlen 12, float32 cache, batch bucket 64, lengths 32/256/64, 40
     clips of 16 x 2048; its decode one CUDA graph, captured in warmup())
     answers phase 3's 256 turns (as text, random features from numpy seed
     0) by `respond` in 4 groups of 64, each equal to the eager
     `beam_search` answer for the same rows; then the same requests as
     base64 .npy POSTs from 64 client threads released together, through a
     DynamicBatcher (10 ms window, pipeline depth 4) under the HTTP server
     on port 0, under torch.profiler.  Required: every served answer equal
     to its eager answer (a row's arithmetic does not depend on its
     neighbours at one geometry), no error, fewer batches than requests, no
     eager decode but a capture's warm-up, and K1 6 times per batch in the
     replays, all "whole", counted by kernel name;
  9. serving at the serve CLI's defaults (batch buckets 8-64, its length
     and time buckets, bfloat16 cache, beam 5, every bucket captured in
     warmup(), then the traffic's geometries by serving its 256 requests
     once and capturing each length and time combination that pass reached,
     and each axis-wise maximum of them, at every batch bucket): 512
     requests from 64 closed-loop clients by beam search,
     then 128 greedily and 128 with a bfloat16 precompute (K1 on a bfloat16
     grid): requests/s, latency percentiles, mean batch rows and component
     seconds, read with no profiler; then 128 more of each under
     torch.profiler (recording the device only) for the card's busy share
     and K1's kernels by name; each run's captured geometries, capture
     seconds, graph pool and reserved device memory (a window that captured
     a geometry read again, up to 3 reads, and the read that captured
     nothing reported); and the host times of one 32-row beam-search
     batch's parts (assembly, pinning, the replay's
     ship, a blocking copy, the eager decode's launches).  No error, no
     eager decode but a capture's warm-up (eager runs equal captures) and
     K1 on "whole" 6 times per batch in the profiled replays are required;
     the rest are readings;
 10. the serve CLI as a process of its own on phase 5's model (--port 0,
     the port read from its log): /healthz, /respond with nested-list
     features and with an int8 upload, a 400 without features, /metrics;
     then the evaluate CLI on phase 5's greedy result: seven metrics and
     its .eval;
 11. serving bundles (bist_tpu_torch.export) of phase 3's model at the serve
     CLI's decode settings (beam 5, maxlen 12, bfloat16 cache): a beam
     bundle of 4 geometries (batch 8 and 64 x histories 64 and 256, LQ, LC,
     40 clips of 16 x 2048; torch.export programs exported by 4 worker
     processes) and a greedy bundle of one, loaded into fresh objects.
     The beam bundle's Responder captures its table (warmup_geometries) and
     answers phase 3's 256 turns in groups that reach every geometry, under
     torch.profiler.  Required: each answer equal to a DecodeProgram
     Responder's for the same rows, no capture and no eager K1 launch in the
     served window, K1 6 times per batch in the replays, all "whole", by
     kernel name, and 6 K1 op nodes and no weight in each program; seed 1's
     params.npz swapped into the same bundle (nothing exported) giving a
     seed-1 DecodeProgram Responder's answers; the greedy bundle giving the
     greedy DecodeProgram's; the serve CLI exporting a bundle of phase 5's
     model (--export-bundle) and serving it (--bundle: /healthz,
     /respond).  Readings: export, load and capture seconds per geometry,
     .pt2 and params.npz bytes, the graph pool, requests/s (in turns) and
     device ms per batch of the bundle's and the DecodeProgram's Responders
     at one geometry, and the first batch at a geometry off warmup()'s
     diagonal after warmup() alone and after warmup_geometries.

 12. the video feature extractor (bist_tpu_torch.models.resnext3d, no Pallas
     kernel on its path: cuDNN convolutions as XLA's in bist_tpu): ResNeXt-101
     with random weights from seed 0; 4 random clips of 16 x 112 x 112
     through the card in float32 (TF32 off) and through the port on the CPU,
     held to 1e-4 of max |f|; bfloat16 and int8 (stages 3 and 4, static
     scales calibrated on the batch) against float32 as |Δ|/|f| on a batch
     of 128 and on the 4 clips, bounded by 0.05 and 0.06; each precision's
     speed at batch 128 (median of 5 batches after 2: clips/s, TFLOP/s from
     the convolutions' multiply-adds, 19.1 GFLOP a clip), then one batch
     under torch.profiler: device ms by part (stem, stages 1-4, CUDA events
     between them), the card's busy share (the union of its kernels'
     intervals over the batch's wall time) and the top kernels; then every
     int8 convolution's shape at batch 128, with the plans the timed runs
     chose, held bit for bit against float64 sums.  Then the
     extract CLI on 6 synthetic .npy videos (40-300 frames, 112 x 112 and
     240 x 320; 221 clips) with a kenshohara-format checkpoint (--model),
     packed and per-video, the two held identical (or within 1e-5 of max
     |f|), its grids written into phase 5's tiny dataset; the generate CLI
     (beam search) answering every turn from them, K1's kernels counted by
     name ("wide" for the 75-clip video's t2s, "whole" else, no "tiled").
 13. TGIF-QA (bist_tpu_torch.tasks.tgifqa, cli/train_tgif.py) at the train_tgif
     CLI's width (d_model 128, 8 heads, 2 video blocks, grids of 16 x 2048,
     random weights from seed 0): (a) for each task, tgif_forward through K1
     against force_plain() on one batch (8 questions, 40 rows for multiple
     choice, 32 clips) within 5e-4, and one train step's loss (5e-4
     relative) and gradients (5e-4 + 5e-3·|g|) at dropout 0 (4 K1 with
     residuals, 4 K2); (b) the train_tgif CLI (its main, in this process,
     under torch.profiler) for each task at --dropout 0 and for count at the
     default 0.1, 2 epochs of batches of 32 on synthetic splits of 64 train
     and 40 test questions over GIFs of 8-40 clips and one of 70 (in
     frameqa's train and count's test split: t_pad 128 sends t2s's K1
     through "wide" and its K2 through "tiled"); each run's K1 and K2
     counted through the wrappers (8 a
     captured geometry, K1 4 a test batch) and by kernel name (4 a step, K1
     4 a test batch; with dropout K1 in the test split only), its
     examples/s by epoch, captures and TEST metric read from its log; (c)
     the eager step against its StepProgram's replays at one geometry
     (frameqa 32 and action 32 x 5 rows, 32 clips): ms/step, and 3 replays
     under torch.profiler (K1 and K2 "whole" 4 a replay by name, the card's
     busy share and top kernels); (d) tests/test_tgifqa.py's held-out Transition proof at its
     tiny configuration (d_model 16: K1 and K2 "tiled"): 400 replayed steps,
     held-out accuracy above 0.6.
 14. the data-parallel layer (bist_tpu_torch.parallel) on the one card: (a)
     phase 6's train program built on a one-rank NCCL process group (made by
     init_process_group: init_multihost is a no-op at one process), its
     count, gradient and metric all-reduces captured in each graph, its
     first 5 calls bit for bit phase 6's program's (metrics and parameters)
     from the same start on the same batches, the collectives issued from
     Python (in warm-ups and captures only), ms/step of the two programs'
     replays alternated in one window, and K1 and K2 by kernel name in 3
     replays (18 "whole" each); (b) two ranks sharing the card over gloo
     (this script with --dp-rank, one process each), each on its 16 rows of
     phase 6's first batch of 32, eager: the loss within 1e-5 and the
     gradients within 1e-4·max(|g|, 1) of the one-process step at the
     global batch, the ranks' parameters after Adam bit-identical, K1 and
     K2 6 times each in each rank's step by kernel name, and a TrainProgram
     on the gloo group refused; (c) a Responder over [cuda:0, cuda:0]
     answering phase 8's 256 turns (groups of 64) as the one-device
     Responder does, K1 by name 6 a replica a batch in 4 batches replayed
     again under torch.profiler; then a greedy bundle
     of phase 5's model exported by `serve --export-dp 2` (in the
     background from the phase's start; batch bucket 8: one program of 4
     rows) served on the same pair against the one-device greedy Responder
     of that model, in groups of 8, K1 counted likewise.
     No data-parallel speed-up is read: the machine has one card.
 15. tensor parallelism (bist_tpu_torch.parallel.tp) on the one card: two
     ranks sharing it over gloo (this script with --tp-rank, one process
     each) at a (1 data × 2 model) mesh of the flagship (4 heads a rank):
     one train step at dropout 0 on phase 6's first batch of 32 against the
     one-device eager step (the loss within 5e-4 relative, each gathered
     gradient within 5e-4 + 5e-3·|g|), K1 and K2 0 times under TP by kernel
     name where the one-device step runs 6 each, 5 eager TP Adam steps
     timed (a smoke reading: gloo on one card says nothing about NVLink),
     and beam search (beam 5, maxlen 12) of phase 3's model on one batch of
     64 turns inside `tensor_parallel`: the tokens of one device.
 16. sequence parallelism (bist_tpu_torch.parallel.sp) on the one card: (a)
     two ranks sharing it over gloo (this script with --sp-rank, one
     process each) at a (1 data × 2 seq) mesh of the flagship, each rank
     holding half of the history (128 of 256 tokens) and of the clips:
     one train step at dropout 0 on phase 6's first batch of 32 against
     the one-device eager step (phase 15's bounds), K1 and K2 6 times each
     on each rank by kernel name, all "whole" (t2s over the whole T, s2t
     over the rank's T/2 groups), the peak memory the step adds on each
     rank against one device, the seq axis's collectives (`sp.counts`), 5
     eager SP Adam steps timed (a smoke reading), and beam search of phase
     3's model on 64 turns inside `sequence_parallel`: the tokens of one
     device, K1 6 times a rank; (b) four ranks at a (1 × 2 model × 2 seq)
     mesh at tests/test_sp.py's widths, started with (a): one step, the
     loss and gradients against one device.
 17. the reference's width: the flagship configuration at d_model 512 with
     8 heads (bist_tpu's and the reference's default; hop 1 through K1
     "wide"), random weights from seed 0: beam search (phase 3's settings)
     on 2 batches of 64 turns, eager and replayed (K1 "wide" 6 a batch
     through the wrappers and by kernel name), then under force_plain
     eager and replayed: responses/s of the four, the graph pools, and
     every hypothesis's tokens identical to the plain path's; then one
     train step's loss and gradients at dropout 0 against force_plain
     (phase 6's bounds; K1 "wide" and K2 "wide" 6 each), 5 eager steps
     and a TrainProgram's replays (ms/step; K1 "wide" and K2 "wide" 6 a
     step by kernel name).  Then the same configuration at d_model 1024
     with 8 heads (d_k 128; K1 "wide"): beam search on 1 batch of 64
     turns, eager and replayed, against force_plain the same way (K1
     "wide" 6 a batch through the wrappers and by kernel name), and one
     train step's loss and gradients against force_plain (K1 "wide" 6 with
     residuals, K2 "tiled" 6).
 18. videos of more than 64 clips: 2 batches of 32 test turns with random
     grids of 65-180 clips (an 11-30 s video's 16-frame clips at stride 4,
     24 fps; padded to multiples of 40 by bucket_len, up to T 200), beam
     search (phase 3's settings) at the flagship's d_model 128 (K1 3 "wide"
     at t2s over the clips and 3 "whole" at s2t a batch) and at d_model 512
     (6 "wide"), eager and replayed, each against force_plain eager and
     replayed: tokens and lengths identical, responses/s of the four, K1 by
     kernel name in the replays, the graph pools; then one train step at
     d_model 512, dropout 0, on a batch of 32 such turns: loss and
     gradients against force_plain (phase 6's bounds), K1 "wide" 6, K2
     "tiled" 3 (t2s) and "wide" 3 (s2t) through the wrappers.

The last two lines of standard output are one JSON object listing every
kernel ({"kernels": [...]}) and {"ok": true, "device": {...}}; the card's
name and power limit are printed before them.
"""

from __future__ import annotations

import contextlib
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


def kernel_device_ms(fn, pattern: str, calls: int = 10) -> dict:
    """Device ms a call of each kernel whose name matches the regex
    `pattern` (its first match names it), from torch.profiler over `calls`
    calls after one warm-up."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        m = re.search(pattern, e.key)
        if m and t > 0:
            out[m.group(0)] = out.get(m.group(0), 0.0) + t / 1e3 / calls
    return out


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
    "wide"'s attention kernels (K1's, K2's) the head width (and for K1's over
    kv tiles the 16-row query tiles a task); for K3 its mode, 8-row kv
    tiles a scoring warp and output tiles a warp up to."""
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
            elif cur["kernel"] in ("hop1_fwd_wide_attn_kernel",
                                   "hop1_bwd_wide_attn_kernel") and len(args) == 1:
                cur.update(dk=8 * args[0])
            elif cur["kernel"] == "hop1_fwd_wide_attn_tiles_kernel" and len(args) == 2:
                cur.update(dk=8 * args[0], query_tiles=args[1])
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


def as_float64(args):
    """`hop1_bwd_plain`'s arguments with every floating tensor in float64 (the
    mask and h as they are): its float64 evaluation is the reference K2's
    kernels are held against.  At the reference width's train step (B 32,
    20,480 kv rows, dW entries up to ~300) the float32 evaluation is itself
    up to 3.2e-4 off the float64 one at entries below 1, past 2e-4 +
    2e-4·|value| (PERF.md, section 6), so that it cannot referee the kernels
    there; the tolerance is the same."""
    import torch

    return tuple(a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                 for a in args)


def rel_beyond_atol(got, want):
    """Largest |diff| / |want| over the elements off by more than TOL
    absolute, which pass only through the relative term (0 when none)."""
    diff = (got.float() - want.float()).abs()
    over = diff > TOL
    if not over.any():
        return 0.0
    return (diff[over] / want.float().abs()[over]).max().item()


def peak_mb(fn):
    """Device memory (MB) one call of `fn` adds at its peak, its result
    included."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def check_hop1(device, name, variant, B, G, Lq, Lk, D, h, masked, strided_t2s,
               seed, residuals=False, bf16=False, vs_tiled=False, bwd=False, memory=False):
    """One K1 case, which must run the named kernel variant; with
    `residuals` the training launch, whose concat and lse are held against
    the plain version's too; with `bf16` a bfloat16 grid.  The bound counts
    every product at the rate "whole" and "wide" run it on the tensor cores:
    3xTF32, or two passes for the projection of a bfloat16 grid;
    `bound_f32_ms` counts every operation at the float32 rate (the bound of
    the kernels before the tensor cores).  With `vs_tiled` the "tiled"
    kernel is checked and timed at the same inputs too (the slow yardstick,
    at less depth: 5 single calls, 3 runs of 5 back to back).  With `bwd` (and
    `residuals`) K2 runs on the kernel's own residuals, with a random
    upstream gradient, and its six gradients are held against
    `hop1_bwd_plain` on the same inputs in float64 (`as_float64`;
    "bwd_variant", "bwd_max_abs_err").  With `memory` the device memory one
    call of the kernel and one of the plain version add at their peak
    ("peak_mb": "wide"'s [K | V] workspace against plain's K, V and
    scores)."""
    import torch

    from bist_tpu_torch.ops.bist_kernels import (_hop1_fused_as, hop1_bwd, hop1_bwd_plain,
                                                 hop1_fused, hop1_plain, hop1_resources)

    rng, p, x, q, kv, mask = hop1_inputs(device, B, G, Lq, Lk, D, h, masked,
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
    if bwd:
        _, concat, lse = got
        g = torch.tensor(rng.standard_normal((B, G, Lq, D), dtype=np.float32), device=device)
        dcc = (g @ p["wo"]["w"].t()).contiguous()
        dh = (dcc * concat).reshape(B, G, Lq, h, D // h).sum(-1)
        args = (q, kv, mask, dcc, dh, lse, p["wk"]["w"], p["wk"]["b"], p["wv"]["w"],
                p["wv"]["b"], h)
        before = dict(hop1_bwd.variants)
        grads = hop1_bwd(*args)
        ran_bwd = [v for v, n in hop1_bwd.variants.items() if n != before.get(v, 0)]
        want_grads = hop1_bwd_plain(*as_float64(args))
        torch.cuda.synchronize()
        extra = {"bwd_variant": ran_bwd[0], "bwd_max_abs_err": max(
            assert_agree(f"hop1_bwd on the residuals of hop1 {name} {n}", a, b_,
                         rtol=2 ** -7 if bf16 and n == "dkv" else TOL)
            for n, a, b_ in zip(("dq", "dkv", "dWk", "dWv", "dbk", "dbv"), grads,
                                want_grads))}
    if memory:
        extra["peak_mb"] = {"kernel": peak_mb(run), "plain": peak_mb(plain)}
    if vs_tiled:
        tiled = lambda: _hop1_fused_as("tiled", x, q, kv, p, h, mask, residuals)
        extra.update(tiled_max_abs_err=agree(tiled(), f"hop1 {name} (tiled)"),
                     tiled_ms=time_ms(tiled, reps=5, warmup=1),
                     tiled_device_ms=device_time_ms(tiled, launches=5, reps=3, warmup=1))
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
            # "wide" runs three kernels: each one's device ms a call
            **({"kernel_device_ms": kernel_device_ms(run, r"hop1_fwd_wide_\w+?_kernel")}
               if variant == "wide" else {}),
            "resources": hop1_resources(G, Lq, Lk, D, h, bf16)}


def check_hop1_bwd(device, name, B, G, Lq, Lk, D, h, masked, strided_t2s, seed,
                   full_row=False, *, variant=None, vs_tiled=False, bf16=False,
                   memory=False, hold_tiled=True):
    """One K2 case: the residuals of the plain forward on random inputs, a
    random upstream gradient, d_concat and Dh as `hop1_trainable`'s glue
    makes them; every gradient held against `hop1_bwd_plain` evaluated in
    float64 (`as_float64`; "max_abs_err_vs_plain32": against its float32
    evaluation, the timed plain version).  With
    `variant` the case must run that kernel ("whole", "wide" or "tiled", the
    three of csrc/hop1_bwd.cu); with `vs_tiled` "tiled" is checked and
    timed at the same inputs too (as `check_hop1` times it; with
    `hold_tiled` false, where "tiled" is known to miss the tolerance, its
    error is read ("tiled_within_tol") and not held); with `bf16` a
    bfloat16 grid (dkv then
    within one bfloat16 step).  The bound counts every product at the rate
    "whole" and "wide" run it: 3xTF32, two passes for the products with a
    bfloat16 grid as an operand; `bound_f32_ms` counts every operation at
    the float32 rate (the bound of the FMA kernels).  For "wide" also each
    of its kernels' device ms a call (`kernel_device_ms`) and whether two
    calls give bit-identical gradients (`bit_identical`).  With `memory` the
    device memory one call of the kernel and one of the plain version add
    at their peak ("peak_mb": "wide"'s workspace against plain's K, V and
    scores)."""
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
    want = hop1_bwd_plain(*as_float64(args))
    want32 = hop1_bwd_plain(*args)
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
    vs32 = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want32))
    run = lambda: hop1_bwd(*args)
    plain = lambda: hop1_bwd_plain(*args)
    extra = {}
    if ran[0] == "wide":
        again = run()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"hop1_bwd {name}: two calls of \"wide\" differ")
        extra = {"bit_identical": True, "kernel_device_ms": kernel_device_ms(
            run, r"hop1_bwd_wide_\w+?_kernel|sum_middle_kernel")}
    if memory:
        extra["peak_mb"] = {"kernel": peak_mb(run), "plain": peak_mb(plain)}
    if vs_tiled:
        tiled = lambda: _hop1_bwd_as("tiled", *args)
        if hold_tiled:
            extra["tiled_max_abs_err"] = agree(tiled(), f"{name} (tiled)")
        else:
            t_got = tiled()
            extra["tiled_max_abs_err"] = max((a.float() - b.float()).abs().max().item()
                                             for a, b in zip(t_got, want))
            extra["tiled_within_tol"] = all(
                torch.allclose(a.float(), b.float(), rtol=TOL, atol=TOL)
                for a, b in zip(t_got, want))
        extra.update(tiled_ms=time_ms(tiled, reps=5, warmup=1),
                     tiled_device_ms=device_time_ms(tiled, launches=5, reps=3, warmup=1))
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
            "max_abs_err_vs_plain32": vs32,
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
        # videos of more than 64 clips (t2s attends over the clips): "wide"
        # streams K and V in tiles of 16 kv rows; each against "tiled" at
        # the same inputs.  Many kv tiles at the reference's width, the
        # flagship's t2s (a fully masked batch row) and the reference's at
        # 200 clips, one row into a last kv tile, a bfloat16 grid, one video
        # through the generate CLI, the training launch with K2 ("wide" over
        # kv slices) on its residuals
        check_hop1(device, "multi-tile", "wide", 4, 8, 32, 600, 512, 8, True, False, 3,
                   vs_tiled=True),
        check_hop1(device, "t2s Lk200", "wide", 64, 16, 32, 200, 128, 8, True, True, 60,
                   vs_tiled=True, memory=True),
        check_hop1(device, "t2s Lk200 D=512", "wide", 64, 16, 32, 200, 512, 8, True, True, 61,
                   vs_tiled=True, memory=True),
        check_hop1(device, "t2s Lk65 D=256 h=4", "wide", 64, 16, 32, 65, 256, 4, True, True,
                   62, vs_tiled=True),
        check_hop1(device, "t2s Lk200 D=512 bf16", "wide", 64, 16, 32, 200, 512, 8, True, True,
                   63, bf16=True, vs_tiled=True),
        check_hop1(device, "one video Lk176", "wide", 1, 16, 32, 176, 128, 8, False, True, 64,
                   vs_tiled=True),
        check_hop1(device, "train t2s Lk200 D=512", "wide", 32, 16, 32, 200, 512, 8, True,
                   True, 65, True, vs_tiled=True, bwd=True),
        # the reference's width (d_model 512, 8 heads) and D 256 at the main
        # path's batch ("wide"), each against "tiled" at the same inputs: the
        # two launches of each video layer, the training launches with K2
        # on their residuals, rows that fill no tile with a fully masked
        # batch row, a bfloat16 grid
        check_hop1(device, "t2s D=512", "wide", 64, 16, 32, 40, 512, 8, True, True, 8,
                   vs_tiled=True),
        check_hop1(device, "s2t D=512", "wide", 64, 40, 32, 16, 512, 8, False, False, 34,
                   vs_tiled=True),
        check_hop1(device, "t2s D=256", "wide", 64, 16, 32, 40, 256, 8, True, True, 7,
                   vs_tiled=True),
        check_hop1(device, "t2s D=256 h=4", "wide", 64, 16, 32, 40, 256, 4, True, True, 35,
                   vs_tiled=True),
        check_hop1(device, "train t2s D=512", "wide", 32, 16, 32, 40, 512, 8, True, True, 36,
                   True, vs_tiled=True, bwd=True),
        check_hop1(device, "train s2t D=512", "wide", 32, 40, 32, 16, 512, 8, False, False,
                   37, True, vs_tiled=True, bwd=True),
        check_hop1(device, "ragged Lq5 Lk37 D=512", "wide", 64, 16, 5, 37, 512, 8, True, True,
                   38, vs_tiled=True),
        check_hop1(device, "t2s D=512 bf16", "wide", 64, 16, 32, 40, 512, 8, True, True, 39,
                   bf16=True, vs_tiled=True),
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
        # "wide" at every D that is a multiple of 128 up to 1024 with heads
        # that tile 128 columns: d_k 128 (one head an attention block) at
        # D 1024 (8 heads) and at the reference's width (4 heads), d_k 64 at
        # D 1024 and 768; each against "tiled" at the same inputs.  t2s at
        # B 8 (the old "tiled" case, to compare with its earlier times) and
        # at the main path's B 64, s2t, the kv-tile kernel past 64 kv rows,
        # a bfloat16 grid, the training launch with K2 ("wide" at D 1024)
        # on its residuals
        check_hop1(device, "t2s D=1024 h=8", "wide", 8, 16, 32, 40, 1024, 8, True, True,
                   21, vs_tiled=True),
        check_hop1(device, "t2s D=1024 B64", "wide", 64, 16, 32, 40, 1024, 8, True, True,
                   72, vs_tiled=True),
        check_hop1(device, "s2t D=1024", "wide", 64, 40, 32, 16, 1024, 8, False, False, 73,
                   vs_tiled=True),
        check_hop1(device, "t2s D=1024 h=16", "wide", 8, 16, 32, 40, 1024, 16, True, True,
                   74, vs_tiled=True),
        check_hop1(device, "t2s D=512 h=4", "wide", 64, 16, 32, 40, 512, 4, True, True, 75,
                   vs_tiled=True),
        check_hop1(device, "t2s Lk200 D=1024", "wide", 8, 16, 32, 200, 1024, 8, True, True,
                   76, vs_tiled=True),
        check_hop1(device, "t2s D=768 h=12", "wide", 8, 16, 32, 40, 768, 12, True, True, 77,
                   vs_tiled=True),
        check_hop1(device, "t2s D=1024 bf16", "wide", 8, 16, 32, 40, 1024, 8, True, True, 78,
                   bf16=True, vs_tiled=True),
        check_hop1(device, "train t2s D=1024", "wide", 32, 16, 32, 40, 1024, 8, True, True,
                   79, True, vs_tiled=True, bwd=True),
        # widths "whole" and "wide" are not built for: d_k 15 (padded to 16
        # in the kernel), D above 512 with d_k 65, d_k 48; a bfloat16 grid
        check_hop1(device, "t2s D=120 h=8", "tiled", 8, 16, 32, 40, 120, 8, True, True,
                   19),
        check_hop1(device, "t2s D=520 h=8", "tiled", 8, 16, 32, 40, 520, 8, True, True,
                   20),
        check_hop1(device, "t2s D=384 h=8", "tiled", 8, 16, 32, 40, 384, 8, True, True,
                   80),
        check_hop1(device, "t2s D=120 h=8 bf16", "tiled", 8, 16, 32, 40, 120, 8, True,
                   True, 22, bf16=True),
    ]
    whole = dict(variant="whole", vs_tiled=True)
    hop1_bwd = [
        # the training step's two hop-1 backward launches of each video layer
        check_hop1_bwd(device, "t2s", 32, 16, 32, 40, 128, 8, True, True, 11, **whole),
        check_hop1_bwd(device, "s2t", 32, 40, 32, 16, 128, 8, False, False, 12, **whole),
        check_hop1_bwd(device, "t2s D=512", 8, 16, 32, 40, 512, 8, True, True, 13,
                       variant="wide", vs_tiled=True),
        check_hop1_bwd(device, "t2s, a fully masked row", 32, 16, 32, 40, 128, 8,
                       True, True, 14, full_row=True, **whole),
        # a bfloat16 grid; rows that fill no MMA tile (query rows, kv rows)
        check_hop1_bwd(device, "t2s bf16", 32, 16, 32, 40, 128, 8, True, True, 27,
                       bf16=True, **whole),
        check_hop1_bwd(device, "ragged Lq5 Lk37", 32, 16, 5, 37, 128, 8, True, True, 28,
                       full_row=True, **whole),
        # "wide" at the reference's width at the train step's shapes (phase 17:
        # B 32, a strided t2s view), D 256 at 8 and 4 heads, rows that fill
        # no tile with a fully masked batch row, a bfloat16 grid; each
        # against "tiled" at the same inputs
        check_hop1_bwd(device, "train t2s D=512", 32, 16, 32, 40, 512, 8, True, True, 49,
                       variant="wide", vs_tiled=True),
        check_hop1_bwd(device, "train s2t D=512", 32, 40, 32, 16, 512, 8, False, False, 50,
                       variant="wide", vs_tiled=True),
        check_hop1_bwd(device, "train t2s D=256", 32, 16, 32, 40, 256, 8, True, True, 51,
                       variant="wide", vs_tiled=True),
        check_hop1_bwd(device, "train t2s D=256 h=4", 32, 16, 32, 40, 256, 4, True, True, 52,
                       variant="wide", vs_tiled=True),
        check_hop1_bwd(device, "ragged Lq5 Lk37 D=512", 32, 16, 5, 37, 512, 8, True, True, 53,
                       full_row=True, variant="wide", vs_tiled=True),
        check_hop1_bwd(device, "train t2s D=512 bf16", 32, 16, 32, 40, 512, 8, True, True, 54,
                       bf16=True, variant="wide", vs_tiled=True),
        # past 64 kv rows (t2s over a video of more than 64 clips) "wide"
        # splits a group's kv rows over attention blocks of at most 64: the
        # long-video train step's t2s at the reference's width and at the
        # flagship's (phase 18's shapes), many slices, one row into a last
        # tile with a fully masked batch row, a bfloat16 grid, d_k 8; each
        # against "tiled" at the same inputs, with its peak memory against
        # plain's
        check_hop1_bwd(device, "train t2s Lk200 D=512", 32, 16, 32, 200, 512, 8, True, True,
                       66, variant="wide", vs_tiled=True, memory=True),
        check_hop1_bwd(device, "train t2s Lk200 D=128", 32, 16, 32, 200, 128, 8, True, True,
                       67, variant="wide", vs_tiled=True, memory=True),
        check_hop1_bwd(device, "multi-tile Lk600 D=512", 4, 8, 32, 600, 512, 8, True, False,
                       68, variant="wide", vs_tiled=True, memory=True),
        check_hop1_bwd(device, "t2s Lk65 D=256 h=4", 32, 16, 32, 65, 256, 4, True, True, 69,
                       full_row=True, variant="wide", vs_tiled=True, memory=True),
        check_hop1_bwd(device, "train t2s Lk200 D=512 bf16", 32, 16, 32, 200, 512, 8, True,
                       True, 70, bf16=True, variant="wide", vs_tiled=True, memory=True),
        check_hop1_bwd(device, "t2s Lk130 D=128 h=16", 8, 16, 32, 130, 128, 16, True, True,
                       71, variant="wide", vs_tiled=True, memory=True),
        # "wide" at K1 "wide"'s widths past D 512 and d_k 64: d_model 1024
        # with 8 heads (d_k 128, two warps a head) at B 8 (the old "tiled"
        # case, its seed and a fully masked row, to compare with its
        # earlier times), at the train step's B 32 (phase 17's d_model 1024
        # leg) t2s and s2t, d_k 128 at the reference's width, D 768, past 64
        # kv rows with its peak memory against plain's, a bfloat16 grid;
        # each against "tiled" at the same inputs
        check_hop1_bwd(device, "t2s D=1024 h=8", 8, 16, 32, 40, 1024, 8, True, True, 25,
                       full_row=True, variant="wide", vs_tiled=True),
        check_hop1_bwd(device, "train t2s D=1024", 32, 16, 32, 40, 1024, 8, True, True, 81,
                       variant="wide", vs_tiled=True, memory=True),
        # ("tiled", its dW summed over 20,480 kv rows on the FMA units,
        # misses the tolerance in dWk there: its error read, not held)
        check_hop1_bwd(device, "train s2t D=1024", 32, 40, 32, 16, 1024, 8, False, False, 82,
                       variant="wide", vs_tiled=True, hold_tiled=False),
        check_hop1_bwd(device, "t2s D=512 h=4", 8, 16, 32, 40, 512, 4, True, True, 83,
                       variant="wide", vs_tiled=True),
        check_hop1_bwd(device, "t2s D=768 h=12", 8, 16, 32, 40, 768, 12, True, True, 84,
                       variant="wide", vs_tiled=True),
        check_hop1_bwd(device, "t2s Lk200 D=1024", 8, 16, 32, 200, 1024, 8, True, True, 85,
                       variant="wide", vs_tiled=True, memory=True),
        check_hop1_bwd(device, "t2s D=1024 bf16", 8, 16, 32, 40, 1024, 8, True, True, 86,
                       bf16=True, variant="wide", vs_tiled=True),
        # the widths "wide" is not built for: d_k 15, d_k 65, D above 1024
        check_hop1_bwd(device, "t2s D=120 h=8", 8, 16, 32, 40, 120, 8, True, True, 23,
                       full_row=True, variant="tiled"),
        check_hop1_bwd(device, "t2s D=520 h=8", 8, 16, 32, 40, 520, 8, True, True, 24,
                       full_row=True, variant="tiled"),
        check_hop1_bwd(device, "t2s D=1152 h=8", 8, 16, 32, 40, 1152, 8, True, True, 87,
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


def make_batches(data, n_batches, B, seed, answers=False, clips=(8, T_MAX), dv=DV, s=S):
    """Host batches of real test turns clipped to LQ/LH/LC, with random
    feature grids of `clips` (least, most) clips of s x dv (zero-padded to
    the batch's bucket: T_BUCKETS, then multiples of 40); with `answers`,
    the turns' answers (clipped to LA) as targets."""
    from bist_tpu_torch.data.batching import Batch, bucket_len, pad_to
    from bist_tpu_torch.vocab import SOS

    rng = np.random.default_rng(seed)
    batches = []
    for n in range(n_batches):
        exs = data.examples[n * B:(n + 1) * B]
        n_clips = rng.integers(clips[0], clips[1] + 1, size=len(exs))
        t_pad = bucket_len(int(n_clips.max()), T_BUCKETS)
        fts = np.zeros((len(exs), t_pad, s, dv), np.float32)
        for r, t in enumerate(n_clips):
            fts[r, :t] = rng.standard_normal((t, s, dv), dtype=np.float32)
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


K1_NONE = {"whole": 0, "tiled": 0, "wide": 0}
K2_NONE = dict(K1_NONE)


def k1_ran(prof):
    """K1 kernels the card ran in a torch.profiler window, by kernel ("whole",
    "tiled", "wide"), from the trace's kernel names: a graph replay's
    kernels are recorded there, where the wrappers' Python counts see only
    their eager launches and captures.  A "wide" call runs three kernels
    and is counted once, by its attention kernel (the whole group's, or the
    kv tiles' past 64 kv rows)."""
    from torch.autograd import DeviceType

    out = dict(K1_NONE)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            if "hop1_fwd_whole_kernel" in name:
                out["whole"] += 1
            elif "hop1_fwd_tiles_kernel" in name:
                out["tiled"] += 1
            elif "hop1_fwd_wide_attn" in name:
                out["wide"] += 1
    return out


def profiler_window(device):
    """torch.profiler recording the card's kernels and copies, or a null
    context on the CPU."""
    import contextlib

    if device.type != "cuda":
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def same_outputs(a, b):
    """Whether two decodes' outputs (a BeamResult or token ids) are equal
    element for element."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def eager_and_replayed(device, name, eager_fn, program, batches, extra=None,
                       variant="whole"):
    """One decode style eager and replayed on the same batches, in one call:
    the eager function timed (after a warm-up, the wrappers' counts zeroed
    before and read after: K1 6 times per batch), then the program's
    capture pass (each new geometry warmed up eagerly and captured; counted
    the same way: 12 K1 launches per capture), a timed pass of replays
    (which must launch nothing through the wrappers) and a pass of replays
    under torch.profiler, whose K1 kernels are counted by name (6 per
    batch, all through `variant`, or `variant` a {kernel: launches a batch}
    of 6 in all).  Every replayed output must equal the eager one."""
    import torch

    from bist_tpu_torch.ops.bist_kernels import hop1_fused

    extra = extra or [{}] * len(batches)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n, rows = len(batches), sum(b.query.shape[0] for b in batches)
    per_batch = variant if isinstance(variant, dict) else {variant: 6}
    times = lambda k: {v: k * c for v, c in per_batch.items()}

    def counts():
        return hop1_fused.launches, dict(hop1_fused.variants)

    eager_fn(batches[0], **extra[0])                                   # warm-up
    sync()
    reset_hop1_counts()
    t0 = time.perf_counter()
    eager = [eager_fn(b, **kw) for b, kw in zip(batches, extra)]
    sync()
    eager_s = time.perf_counter() - t0
    eager_counts = counts()
    if cuda and eager_counts != (6 * n, times(n)):
        raise AssertionError(f"{name}, eager: K1 launches {eager_counts}, expected "
                             f"{times(n)} (per batch {per_batch})")

    reset_hop1_counts()
    before = program.stats()
    first = [program(b, **kw) for b, kw in zip(batches, extra)]
    sync()
    caps = program.captures - before["captures"]
    if cuda and (counts() != (12 * caps, times(2 * caps))
                 or program.eager_runs - before["eager_runs"] != caps):
        raise AssertionError(f"{name}, capture pass: K1 launches {counts()} for {caps} "
                             f"captures, expected 12 each (the warm-up and the capture)")
    reset_hop1_counts()
    t0 = time.perf_counter()
    replayed = [program(b, **kw) for b, kw in zip(batches, extra)]
    sync()
    replay_s = time.perf_counter() - t0
    if counts()[0] or program.captures != before["captures"] + caps:
        raise AssertionError(f"{name}: the replay pass launched K1 {counts()} through the "
                             f"wrappers or captured again: it decoded eagerly")
    prof = profiler_window(device)
    with prof:
        again = [program(b, **kw) for b, kw in zip(batches, extra)]
        sync()
    ran = k1_ran(prof) if cuda else dict(K1_NONE)
    if cuda and ran != dict(K1_NONE, **times(n)):
        raise AssertionError(f"{name}: K1 kernels in {n} replays by name {ran}, expected "
                             f"{times(n)} (per batch {per_batch})")
    differ = [i for i, (e, a, b, c) in enumerate(zip(eager, first, replayed, again))
              if not (same_outputs(e, a) and same_outputs(e, b) and same_outputs(e, c))]
    if differ:
        raise AssertionError(f"{name}: the replayed outputs of batches {differ} differ from "
                             f"the eager ones")
    stats = program.stats()
    out = {"eager_responses_per_s": rows / eager_s, "replayed_responses_per_s": rows / replay_s,
           "eager_seconds": eager_s, "replayed_seconds": replay_s,
           "geometries_captured": stats["captures"],
           "capture_seconds": stats["capture_seconds"],
           "graph_pool_mb": stats["pool_bytes"] / 2 ** 20,
           "eager_launches": {"hop1_fwd": eager_counts[0], "hop1_variants": eager_counts[1]},
           "replayed_k1_by_name": ran, "identical_batches": n}
    log(f"main path, {name}: {json.dumps(out)}")
    return eager, out


def phase_main_path(device, n_batches=4, B=64):
    """Beam-search and greedy generation at the flagship width, each eager
    and through its program (one CUDA graph per geometry); sampling and a
    bfloat16 cache replayed against eager too; returns a summary."""
    import torch

    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.decode.beam import NEG, beam_search, greedy_decode
    from bist_tpu_torch.decode.compiled import DecodeProgram
    from bist_tpu_torch.decode.sample import sample_decode
    from bist_tpu_torch.models.model import init_model, precompute_decode_ctx
    from bist_tpu_torch.ops import dispatch
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
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    flash_attention.launches = 0
    results, beam = eager_and_replayed(
        device, "beam_search", lambda b: beam_search(params, cfg, b, gcfg),
        DecodeProgram(params, cfg, gcfg), batches)
    K = gcfg.nbest
    for r in results:
        if tuple(r.tokens.shape) != (B, K, gcfg.maxlen):
            raise AssertionError(f"beam tokens shape {tuple(r.tokens.shape)}")
        best = r.scores[:, 0]
        if not (torch.isfinite(best).all() and (best > NEG / 2).all()
                and (r.lengths[:, 0] >= 1).all()):
            raise AssertionError("beam search left a row without a finite "
                                 "first-best hypothesis")

    # greedy decoding of the same batches (the generate CLI's default style)
    greedy_cfg = GenerateConfig(**dict(GEN, decode_style="greedy"))
    greedy, greedy_run = eager_and_replayed(
        device, "greedy", lambda b: greedy_decode(params, cfg, b, gcfg.maxlen),
        DecodeProgram(params, cfg, greedy_cfg), batches)
    for g in greedy:
        if tuple(g.shape) != (B, gcfg.maxlen) or not ((g >= 0) & (g < len(vocab))).all():
            raise AssertionError(f"greedy tokens: shape {tuple(g.shape)} or ids out "
                                 f"of the vocabulary")
    flash_launches = flash_attention.launches

    # a bfloat16 cache (beam, greedy) and sampling with per-row seeds (float32
    # and bfloat16 caches): replayed outputs equal to eager ones
    others = {}
    bf16 = GenerateConfig(**dict(GEN, cache_dtype="bfloat16"))
    _, others["beam_search, bfloat16 cache"] = eager_and_replayed(
        device, "beam_search, bfloat16 cache", lambda b: beam_search(params, cfg, b, bf16),
        DecodeProgram(params, cfg, bf16), batches)
    _, others["greedy, bfloat16 cache"] = eager_and_replayed(
        device, "greedy, bfloat16 cache",
        lambda b: greedy_decode(params, cfg, b, gcfg.maxlen, cache_dtype="bfloat16"),
        DecodeProgram(params, cfg, GenerateConfig(**dict(GEN, cache_dtype="bfloat16",
                                                        decode_style="greedy"))), batches)
    seeds = [{"row_seeds": list(range(i * B, (i + 1) * B))} for i in range(n_batches)]
    for cache in ("float32", "bfloat16"):
        sg = GenerateConfig(**dict(GEN, cache_dtype=cache, decode_style="sample",
                                   temperature=0.8, top_k=20, top_p=0.9, sample_seed=3))
        _, others[f"sample, {cache} cache"] = eager_and_replayed(
            device, f"sample, {cache} cache",
            lambda b, row_seeds: sample_decode(
                params, cfg, b, sg.maxlen, sg.sample_seed, temperature=sg.temperature,
                top_k=sg.top_k, top_p=sg.top_p, cache_dtype=sg.cache_dtype,
                row_seeds=row_seeds),
            DecodeProgram(params, cfg, sg), batches, extra=seeds)

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
    ran = beam["replayed_k1_by_name"]
    return {"batches": n_batches, "batch_size": B,
            "responses_per_s": beam["replayed_responses_per_s"],
            "seconds": beam["replayed_seconds"],
            "precompute_seconds": precompute_seconds,
            # K1 in the replayed beam-search pass, by kernel name (profiler)
            "launches": {"hop1_fwd": sum(ran.values()), "flash_fwd": flash_launches},
            "hop1_variants": {k: v for k, v in ran.items() if v},
            "beam_search": beam,
            "ctx_max_abs_diff": worst,
            "first_best_identical_share": same / total,
            "greedy": dict(greedy_run, identical_share=greedy_same / (n_batches * B)),
            "replayed_against_eager": others}


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


def start_generate(root, test_set, args, device, out_name="result.json"):
    """The generate CLI (a process of its own, started) on `test_set` with
    the model <root>/mtn, writing <root>/<out_name>: (process, args, path)."""
    out = os.path.join(root, out_name)
    cmd = [sys.executable, "-m", "bist_tpu_torch.cli.generate",
           "--test-set", test_set,
           "--test-path", os.path.join(root, "<FeaType>", "<ImageID>.npy"),
           "--model", os.path.join(root, "mtn"), *args, "--maxlen", "12",
           "--gen-batch-size", "4", "--output", out, "--device", device.type]
    return (subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True), args, out)


def finish_generate(started, timeout=600):
    """The result JSON of a generate CLI run `start_generate` started, once
    its process has exited 0."""
    proc, args, out = started
    stdout, stderr = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"generate CLI {' '.join(args)} exited {proc.returncode}:\n"
                             f"{stdout[-2000:]}\n{stderr[-4000:]}")
    with open(out) as f:
        return json.load(f)


def run_generate(root, test_set, args, device):
    """The generate CLI on `test_set` with the model <root>/mtn, run to its
    end; returns its result JSON (<root>/result.json)."""
    return finish_generate(start_generate(root, test_set, args, device))


def phase_cli(device, root, n_dialogs=6, model_kw=None, dv=DV, s=S, t_max=T_MAX):
    """The generate CLI in every decode style on a tiny dataset: at its
    defaults (greedy), beam search, an ensemble of two models by beam
    search, sampling, and oracle on the dataset's labeled turns (each
    dialog without its undisclosed last turn), the five processes run at
    once (each one's start-up, mostly the host's, overlaps the others');
    each result JSON checked against its input.  Returns the answers by
    style."""
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
    started = {style: start_generate(root, data, args, device, f"result_{i}.json")
               for i, (style, (data, args)) in enumerate(runs.items())}
    answers = {}
    try:
        for style, (data, _) in runs.items():
            result = finish_generate(started[style])
            # greedy, sampled and oracle rows are cut at <eos>: on a random
            # model an answer may be empty, as in bist_tpu; beam search ranks
            # only hypotheses of at least one token
            check_result_schema(result, labeled if data == labeled_set else orig,
                                undisclosed=data == test_set,
                                allow_empty=not style.startswith("beam"))
            answers[style] = [t["answer"] for d in result["dialogs"] for t in d["dialog"]]
    finally:
        for proc, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    # phase 10 scores the greedy result
    shutil.copy(started["greedy (default)"][2], os.path.join(root, "result_greedy.json"))
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


def phase_train(device, kernel_cases=(), steps=30, B=32, warmup=10, model_kw=None,
                check=11):
    """Noam-Adam steps of the flagship model without dropout (hop 1 through
    K1 with residuals and K2) over 2 cycled batches of B real training
    turns; returns a summary.  One step's gradients are first held against
    the plain path (force_plain).  Then the train and eval programs
    (`train_programs`), the first `check` program calls held against the
    first `check` eager steps."""
    import torch

    from bist_tpu_torch.config import TrainConfig
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.train.loop import create_train_state, make_train_step
    from bist_tpu_torch.vocab import get_vocabulary

    vocab = get_vocabulary(TEST_JSON, cutoff=3, include_caption="summary")
    cfg = flagship_cfg(len(vocab), **dict(model_kw or {}, dropout=0.0,
                                          attn_dropout=0.0))
    data = load_avsd(TEST_JSON, vocab, include_caption="summary",
                     separate_caption=True)
    tcfg = TrainConfig(warmup_steps=warmup)
    batches = [to_device(b, device) for b in
               make_batches(data, 2, B, seed=1, answers=True)]
    state, tx = create_train_state(0, cfg, tcfg, device=device)
    start = copy_state(state)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    grad_check = grads_against_plain(device, state, cfg, tcfg, batches[0])
    names = leaf_names(state.params)

    step = make_train_step(cfg, tcfg, tx)
    sync()
    hop1_fused.launches = hop1_bwd.launches = 0
    hop1_fused.variants, hop1_bwd.variants = {}, {}
    losses, times, eager_metrics, eager_params = [], [], [], None
    check = min(check, steps)
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batches[i % 2], None)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if i < check:             # what phase 6's program is held against
            eager_metrics.append(m)
            if i == check - 1:
                eager_params = copy_state(state).params
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
    del state
    compiled = train_programs(device, cfg, tcfg, tx, batches, start, eager_metrics,
                              eager_params, names, steps, ms, model_kw)
    return {"steps": steps, "batch_size": B, "ms_per_step": ms,
            "profile": profile, "compiled": compiled,
            "examples_per_s": B / ms * 1e3, "first_step_ms": times[0] * 1e3,
            "launches": launches, "hop1_variants": variants,
            "hop1_bwd_variants": bwd_variants, "loss_first": first, "loss_last_same_batch": last,
            "grad_check": {k: v for k, v in grad_check.items() if k != "variants"},
            "kernel_ms_per_step_from_phase2": kernel_ms,
            "kernel_share_of_step": None if kernel_ms is None else kernel_ms / ms}


def grads_against_plain(device, state, cfg, tcfg, batch):
    """One step's loss and gradients through the kernels against the plain
    path (force_plain): the loss to 5e-4 relative, each gradient to 5e-4 +
    5e-3·|g| (the key biases', analytically zero, to 5e-4); on the card K1
    and K2 launched 6 times each through the wrappers.  Returns the
    readings and the launches by kernel ("variants")."""
    import torch

    from bist_tpu_torch.models.model import forward_logprobs
    from bist_tpu_torch.ops import dispatch
    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.train.losses import compute_losses
    from bist_tpu_torch.weights import tree_leaves

    def loss_grads():
        logp, ft = forward_logprobs(state.params, cfg, batch)
        loss, _ = compute_losses(logp, ft, state.params["embed"]["lut"], cfg, batch,
                                 tcfg.smoothing)
        return loss, torch.autograd.grad(loss, tree_leaves(state.params), allow_unused=True)

    before = (hop1_fused.launches, hop1_bwd.launches, dict(hop1_fused.variants),
              dict(hop1_bwd.variants))
    loss_k, grads_k = loss_grads()
    if device.type == "cuda":
        torch.cuda.synchronize()
    check_launches = (hop1_fused.launches - before[0], hop1_bwd.launches - before[1])
    if device.type == "cuda" and check_launches != (6, 6):
        raise AssertionError(f"gradient check: K1, K2 launched {check_launches} "
                             f"times, expected 6 each")
    variants = [{k: n - was.get(k, 0) for k, n in now.items() if n != was.get(k, 0)}
                for now, was in ((hop1_fused.variants, before[2]),
                                 (hop1_bwd.variants, before[3]))]
    with dispatch.force_plain():
        loss_p, grads_p = loss_grads()
    grad_err, grad_max = 0.0, 0.0
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if loss_rel > 5e-4:
        raise AssertionError(f"train loss: kernel path {loss_k.item()} vs plain "
                             f"{loss_p.item()}")
    for name, a, b in zip(leaf_names(state.params), grads_k, grads_p):
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
    return {"loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
            "loss_rel_diff": loss_rel, "max_abs_diff": grad_err, "max_abs_grad": grad_max,
            "launches": check_launches,
            "variants": {"hop1_fwd": variants[0], "hop1_bwd": variants[1]}}


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


def copy_state(state):
    """A TrainState of copies of `state`'s tensors (parameters that require
    grad, Adam's count, mu and nu)."""
    from bist_tpu_torch.train.loop import trainable

    opt = state.opt_state
    return state._replace(params=trainable(state.params),
                          opt_state={"count": opt["count"].clone(),
                                     "mu": [t.clone() for t in opt["mu"]],
                                     "nu": [t.clone() for t in opt["nu"]]})


def hop1_ran(prof):
    """K1's and K2's kernels the card ran in a torch.profiler window, each by
    kernel ("whole", "tiled", "wide"), from the trace's kernel names: K1 as
    `k1_ran`, K2 by its first pass (a launch of K2 "whole" also runs its dW
    pass, one of "tiled" its dkv and dW passes) or, for "wide", by its
    attention-backward kernel (a launch also runs its projection, dkv and
    dW GEMMs)."""
    from torch.autograd import DeviceType

    k2 = dict(K2_NONE)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            if "hop1_bwd_whole_kernel" in name:
                k2["whole"] += 1
            elif "hop1_bwd_kernel" in name:
                k2["tiled"] += 1
            elif "hop1_bwd_wide_attn_kernel" in name:
                k2["wide"] += 1
    return {"k1": k1_ran(prof), "k2": k2}


def metrics_agree(what, got, want, rtol=5e-4):
    """Each metric of each step within rtol relative (of the larger
    magnitude) of the eager step's; returns the largest relative error."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if set(g) != set(w):
            raise AssertionError(f"{what}, step {i}: metrics {sorted(g)} against {sorted(w)}")
        for k in w:
            a, b = float(g[k]), float(w[k])
            rel = abs(a - b) / max(abs(a), abs(b), 1e-30)
            worst = max(worst, rel)
            if not (np.isfinite(a) and rel <= rtol):
                raise AssertionError(f"{what}, step {i}: {k} {a} against the eager {b}")
    return worst


def params_agree(what, got, want, names, lr_sum):
    """Parameters after the same steps within 5e-4 + 5e-3·|p|.  The key
    biases' gradient is analytically zero (a bias added to every key of a
    row shifts its scores by one constant), so Adam turns its round-off
    residue's sign into ±lr a step: theirs are held to 5e-4 + 2·Σlr, and the
    forward does not read them.  Returns the largest difference."""
    import torch

    from bist_tpu_torch.weights import tree_leaves

    worst = 0.0
    for name, a, b in zip(names, tree_leaves(got), tree_leaves(want)):
        err = (a - b).abs().max().item()
        if name.endswith("wk.b"):
            ok = err <= 5e-4 + 2 * lr_sum
        else:
            worst = max(worst, err)
            ok = torch.allclose(a, b, rtol=5e-3, atol=5e-4)
        if not ok:
            raise AssertionError(f"{what}: parameter {name} differs from the eager "
                                 f"step's by {err:.3e}")
    return worst


def train_programs(device, cfg, tcfg, tx, batches, start, eager_metrics, eager_params,
                   names, steps, eager_ms, model_kw):
    """Phase 6's compiled steps (`train.compiled`), each from a copy of the
    start state and against the eager step in this call:

      * a TrainProgram: its first len(eager_metrics) calls (the first a
        geometry's eager warm-up, then replays) held against the eager
        steps (loss and metrics to 5e-4 relative, parameters after them by
        `params_agree`); the wrappers launch K1 and K2 12 times a capture
        (the warm-up and the capture) and never in a replay; `steps`
        replays timed (median after the first) beside the eager ms/step;
        3 replays under torch.profiler: K1 and K2 6 times a step each by
        kernel name, all "whole", and the device ms and busy share a step;
      * the flagship as it trains (dropout 0.2, attention dropout 0.1; hop 1
        has no kernel there), 8 steps eager and 8 through a program from
        the same start at the same seeds, timed and held to each other;
      * grad_accum 2: 2 eager steps and 2 program calls (one replay);
      * an EvalProgram over the batches, held against make_eval_step to
        5e-4, its K1 counted by name in the replays (6 a batch, "whole").
    Returns the readings."""
    import torch

    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.train.compiled import EvalProgram, TrainProgram
    from bist_tpu_torch.train.loop import (create_train_state, dropout_generator,
                                           make_eval_step, make_train_step, seed_for_step)

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    check = len(eager_metrics)
    lr_sum = sum(tx.schedule(i) for i in range(check))

    def counts():
        return (hop1_fused.launches, dict(hop1_fused.variants), hop1_bwd.launches,
                dict(hop1_bwd.variants))

    def run(step, state, n, gen=None, seed=0, timed=False):
        out, times = [], []
        for i in range(n):
            if gen is not None:
                gen.manual_seed(seed_for_step(seed, state.step))
            t0 = time.perf_counter()
            state, m = step(state, batches[i % len(batches)], gen)
            if timed:
                sync()
                times.append(time.perf_counter() - t0)
            out.append(m)
        sync()
        return state, out, times

    # the step without dropout: K1 with residuals and K2 inside the graph
    state = copy_state(start)
    prog = TrainProgram(state, cfg, tcfg, tx)
    reset_hop1_counts()
    hop1_bwd.launches, hop1_bwd.variants = 0, {}
    state, got, _ = run(prog, state, check)
    caps = prog.captures
    want = 12 * caps if cuda else 0
    if counts() != (want, {"whole": want} if want else {}, want,
                    {"whole": want} if want else {}):
        raise AssertionError(f"train program: wrapper launches {counts()} for {caps} "
                             f"captures, expected {want} K1 and K2 (12 a capture)")
    rel = metrics_agree("train program", got, eager_metrics)
    perr = params_agree("train program", state.params, eager_params, names, lr_sum)
    state, _, times = run(prog, state, steps, timed=True)
    if counts()[0] != want or prog.captures != caps:
        raise AssertionError("train program: a replay launched K1 through the wrapper "
                             "or captured again: it stepped eagerly")
    replayed_ms = statistics.median(times[1:]) * 1e3
    out = {"eager_ms_per_step": eager_ms, "replayed_ms_per_step": replayed_ms,
           "calls_held": check, "metrics_max_rel_err": rel, "params_max_abs_err": perr,
           "stats": prog.stats()}
    if cuda:
        with profiler_window(device) as prof:
            t0 = time.perf_counter()
            state, _, _ = run(prog, state, 3)
            wall = time.perf_counter() - t0
        ran = hop1_ran(prof)
        if ran != {"k1": dict(K1_NONE, whole=18), "k2": dict(K2_NONE, whole=18)}:
            raise AssertionError(f"train program: K1, K2 kernels in 3 replays by name "
                                 f"{ran}, expected 18 \"whole\" each (6 a step)")
        busy = device_busy_ms(prof) / 3
        out.update(replayed_by_name=ran, device_ms_per_step=busy,
                   busy_share=busy / replayed_ms, busy_share_profiled=busy * 3 / (wall * 1e3))
    log(f"train program on the flagship, no dropout: eager {eager_ms:.2f} ms/step, "
        f"replayed {replayed_ms:.2f} ms/step: {json.dumps(out)}")
    del prog, state

    # the flagship as it trains: dropout 0.2 (hop 1 takes its plain path)
    dcfg = flagship_cfg(cfg.vocab_size, dv=cfg.ft_sizes[0], **(model_kw or {}))
    dstart, dtx = create_train_state(0, dcfg, tcfg, device=device)
    gen = dropout_generator(dcfg, device)
    n = 8
    estate, eager, eager_t = run(make_train_step(dcfg, tcfg, dtx), copy_state(dstart), n,
                                 gen, seed=7, timed=True)
    dstate = copy_state(dstart)
    dprog = TrainProgram(dstate, dcfg, tcfg, dtx, gen=gen)
    dstate, got, prog_t = run(dprog, dstate, n, gen, seed=7, timed=True)
    dropout = {"dropout": dcfg.dropout, "attn_dropout": dcfg.attn_dropout, "steps": n,
               "eager_ms_per_step": statistics.median(eager_t[1:]) * 1e3,
               "replayed_ms_per_step": statistics.median(prog_t[1:]) * 1e3,
               "metrics_max_rel_err": metrics_agree("train program with dropout", got, eager),
               "params_max_abs_err": params_agree("train program with dropout",
                                                  dstate.params, estate.params, names,
                                                  sum(dtx.schedule(i) for i in range(n))),
               "stats": dprog.stats()}
    log(f"train program on the flagship, dropout {dcfg.dropout}: {json.dumps(dropout)}")
    del dprog, dstate, estate, dstart

    # grad_accum 2: the microbatch loop inside one graph
    astate = copy_state(start)
    aprog = TrainProgram(astate, cfg, tcfg, tx, grad_accum=2)
    astate, got, _ = run(aprog, astate, 2)
    estate, eager, _ = run(make_train_step(cfg, tcfg, tx, grad_accum=2), copy_state(start), 2)
    accum = {"grad_accum": 2, "calls_held": 2,
             "metrics_max_rel_err": metrics_agree("train program, grad_accum 2", got, eager),
             "params_max_abs_err": params_agree("train program, grad_accum 2", astate.params,
                                                estate.params, names,
                                                sum(tx.schedule(i) for i in range(2))),
             "stats": aprog.stats()}
    log(f"train program, grad_accum 2: {json.dumps(accum)}")
    del aprog, astate

    # the eval step on the trained parameters
    eprog = EvalProgram(estate.params, cfg, tcfg)
    estep = make_eval_step(cfg, tcfg)
    for b in batches:                                   # warm-up and capture
        eprog(estate.params, b)
    prof = profiler_window(device)
    with prof:
        got = [eprog(estate.params, b) for b in batches]
        sync()
    want = [estep(estate.params, b) for b in batches]
    ev = {"batches": len(batches),
          "metrics_max_rel_err": metrics_agree("eval program", got, want),
          "stats": eprog.stats()}
    if cuda:
        ran = k1_ran(prof)
        if ran != dict(K1_NONE, whole=6 * len(batches)):
            raise AssertionError(f"eval program: K1 kernels by name {ran}, expected "
                                 f"{6 * len(batches)} \"whole\" (6 a batch)")
        ev["replayed_k1_by_name"] = ran
    log(f"eval program: {json.dumps(ev)}")
    if cuda:
        torch.cuda.empty_cache()
    return {"no_dropout": out, "dropout": dropout, "grad_accum": accum, "eval": ev}


def leaf_names(tree, prefix=""):
    """Dotted names of a parameter tree's leaves, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]




def phase_train_cli(device, root, n_dialogs=6, model_kw=None, dv=DV, s=S,
                    t_max=T_MAX):
    """The train CLI for one epoch on phase 5's tiny dataset (no dropout,
    --num-workers 4), then the generate CLI from its best checkpoint; checks
    the artifacts, that the CLI assembled its batches natively (no fallback
    line in its log) and stepped through its programs (on the card every
    geometry captured after one eager warm-up step), and returns its logged
    epoch feed (examples/s end to end, loader wait) and program stats."""
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
           "--warmup-steps", "10", "--report-interval", "1", "--num-workers", "4",
           "--device", device.type]
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"train CLI exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    from bist_tpu_torch.native.loader import FALLBACK_LOG

    if FALLBACK_LOG in r.stderr or "runs eagerly" in r.stderr:
        raise AssertionError(f"train CLI: the native assembler or a program was not "
                             f"used:\n{r.stderr[-4000:]}")
    logged = {}
    for key, marker in (("train_feed", "train epoch feed: "), ("eval_feed", "eval epoch feed: "),
                        ("train_program", "epoch 1 train program: "),
                        ("eval_program", "epoch 1 eval program: ")):
        lines = [ln.split(marker, 1)[1] for ln in r.stderr.splitlines() if marker in ln]
        if len(lines) != 1:
            raise AssertionError(f"train CLI: {len(lines)} lines of {marker!r} in its log")
        logged[key] = json.loads(lines[0])
    for key in ("train_program", "eval_program"):
        st = logged[key]
        if device.type == "cuda" and not (st["captures"] == st["eager_runs"]
                                          == st["geometries"] > 0):
            raise AssertionError(f"train CLI: {key} {st}: a geometry stepped eagerly")
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
                                        for d in result["dialogs"]], **logged}


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


def check_k1_window(device, what, batches, program, before, prof=None):
    """A served window's decodes went through the Responder's program: every
    eager run was a capture's warm-up, the wrappers launched K1 only for the
    window's captures (6 in the warm-up, 6 captured), and, with a profiler
    window `prof`, the card ran K1 6 times per batch and per warm-up (t2s
    and s2t in each of 3 video layers), all "whole", counted by kernel name
    in the trace.  On the CPU nothing is captured or launched.  Returns the
    wrappers' counts ("hop1_fwd") and the trace's ("hop1_fwd_ran")."""
    from bist_tpu_torch.ops.bist_kernels import hop1_fused

    cuda = device.type == "cuda"
    stats = program.stats()
    caps = stats["captures"] - before["captures"]
    warm = stats["eager_runs"] - before["eager_runs"]
    out = {"hop1_fwd": hop1_fused.launches, "hop1_variants": dict(hop1_fused.variants),
           "captures": caps}
    if stats["eager_runs"] != stats["captures"] or warm != caps:
        raise AssertionError(f"{what}: {stats['eager_runs']} eager runs for "
                             f"{stats['captures']} captures: the Responder decoded eagerly")
    want = 12 * caps if cuda else 0
    if hop1_fused.launches != want or (cuda and want and hop1_fused.variants != {"whole": want}):
        raise AssertionError(f"{what}: K1 wrapper launches {hop1_fused.launches} "
                             f"{hop1_fused.variants}, expected {want} for {caps} captures")
    if prof is not None:
        ran = k1_ran(prof) if cuda else dict(K1_NONE)
        want = 6 * (batches + warm) if cuda else 0
        if ran != dict(K1_NONE, whole=want):
            raise AssertionError(f"{what}: K1 kernels by name {ran}, expected {want} "
                                 f"\"whole\" (6 per batch, {batches} batches, {warm} warm-ups)")
        out.update(hop1_fwd_ran=sum(ran.values()),
                   hop1_ran_variants={k: v for k, v in ran.items() if v})
    return out


def phase_serving_exact(device, model, fields, group=64, clients=64, dv=DV, s=S,
                        t_max=T_MAX):
    """Serving at one geometry (batch bucket `group`, lengths LQ/LH/LC, t_max
    clips), beam 5, float32 cache: the requests' reference answers from the
    eager `beam_search` on their batches in groups of `group` in order,
    which Responder.respond (a replay of the warmed geometry) must give too;
    then the same requests as base64 .npy POSTs from `clients` threads
    released together, through a DynamicBatcher (10 ms window, pipeline
    depth 4) under the HTTP server, with torch.profiler counting K1's
    kernels in the replays.  Each row's arithmetic is independent of its
    neighbours at one geometry, so every served answer must be its
    reference answer."""
    import threading

    import torch

    from bist_tpu_torch.cli.serve import make_http_server
    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.decode.beam import beam_search, extract_hyps
    from bist_tpu_torch.serving import DynamicBatcher, Responder

    vocab, cfg, params = model
    gcfg = GenerateConfig(**GEN)
    rsp = Responder(params, cfg, vocab, gcfg, max_batch=group,
                    batch_buckets=(group,), len_buckets={"q": (LQ,), "h": (LH,), "c": (LC,)},
                    time_buckets=(t_max,), feat_tail=(s, dv))
    rsp.warmup(feature_shape=(s, dv), t_clips=min(8, t_max))
    n = len(fields)
    reqs = [rsp.make_request(**f) for f in fields]
    reference = []
    for i in range(0, n, group):
        part = reqs[i:i + group]
        eager = beam_search(params, cfg, rsp.make_batch(part), gcfg)
        for row in range(len(part)):
            hyps = extract_hyps(eager, rsp.id2word, row, gcfg.nbest)
            reference.append(" ".join(hyps[0][0]) if hyps else "")
        rsp.respond(part)
    replayed = [r._answer for r in reqs]
    if replayed != reference:
        bad = [i for i in range(n) if replayed[i] != reference[i]]
        raise AssertionError(f"serving: {len(bad)} of {n} respond() answers (replays) differ "
                             f"from the eager beam_search ones, e.g. request {bad[0]}: "
                             f"{replayed[bad[0]]!r} against {reference[bad[0]]!r}")
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
    prof = profiler_window(device)
    try:
        sync()
        reset_hop1_counts()
        before = rsp.program.stats()
        with prof:
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
            f"serving: {len(differ)} of {n} served answers differ from the eager "
            f"beam_search answers, e.g. request {differ[0]}: served "
            f"{served[differ[0]]!r}, direct {reference[differ[0]]!r}")
    if not stats["batches"] < n:
        raise AssertionError(f"serving: {stats['batches']} batches for {n} requests: "
                             f"nothing was coalesced")
    launches = check_k1_window(device, "serving", stats["batches"], rsp.program, before, prof)
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
    for the card's busy share and K1's kernels by name (it slows the host:
    the window's requests/s and latencies are not the bare ones)."""
    import contextlib
    import itertools
    import threading

    import torch

    from bist_tpu_torch.serving import DynamicBatcher

    batcher = DynamicBatcher(rsp, max_batch=rsp.max_batch, max_wait_ms=10,
                             pipeline_depth=4)
    batcher.start()
    timings = dict(rsp.timings)
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
    prof = profiler_window(device) if profiled else contextlib.nullcontext()
    try:
        sync()
        reset_hop1_counts()
        before = rsp.program.stats()
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
           "component_seconds": {k: v - timings.get(k, 0.0)
                                 for k, v in m["component_seconds"].items()},
           **check_k1_window(device, "serving load", m["batches"], rsp.program, before,
                             prof if profiled else None)}
    if profiled:
        busy = device_busy_ms(prof) if device.type == "cuda" else None
        out["device_busy_ms"] = busy
        out["device_busy_share"] = None if busy is None else busy / (seconds * 1e3)
    return out


def warm_table(device, rsp):
    """Capture (on the card) each geometry of `traffic_table` over the
    geometries `rsp` has entered that it has not entered yet; returns the
    table's size and how many of it were new."""
    seen = rsp.program.geometries()
    table = traffic_table(seen, rsp.batch_buckets)
    new = [g for g in table if g not in seen]
    if device.type == "cuda":
        rsp.warmup_geometries(new)
    return len(table), len(new)


def settled_window(device, rsp, fields, n, clients, profiled, what, reads=3):
    """`serve_window`, read again (up to `reads` times in all) while a read
    captured a geometry (its time then holds the capture, not serving),
    with `warm_table`'s new geometries captured before each further read
    (a captured group adds its buckets at every batch size, and their
    maxima with the groups before): returns the first read that captured
    nothing, with each read's captures, the geometries it entered, the
    table's new geometries after it and the program stats before and after
    it; raises when every read captured."""
    tried = []
    for _ in range(reads):
        before, seen = rsp.program.stats(), rsp.program.geometries()
        w = serve_window(device, rsp, fields, n, clients, profiled)
        after = rsp.program.stats()
        tried.append({"captures": w["captures"], "requests_per_s": w["requests_per_s"],
                      "new_geometries": [g for g in rsp.program.geometries()
                                         if g not in seen],
                      "program_before": before, "program_after": after})
        log(f"serving load, {what}, read {len(tried)}: {w['requests_per_s']:.2f} "
            f"requests/s, {w['captures']} captures in the window "
            f"(program {json.dumps(before)} -> {json.dumps(after)})")
        if w["captures"] == 0:
            log(f"serving load, {what}: reporting read {len(tried)}, which captured nothing")
            return dict(w, reads=tried)
        tried[-1]["table_after"] = dict(zip(("geometries", "new"), warm_table(device, rsp)))
    raise AssertionError(f"serving load, {what}: each of {reads} reads captured a geometry: "
                         f"{json.dumps(tried)}")


def ship_breakdown(device, rsp, fields, rows=32, reps=3):
    """Host milliseconds of one served batch's parts on an idle server (the
    median of `reps`): assembly (make_batch), pinning the token arrays,
    dispatch's ship (the program's copy into the static inputs without
    waiting, the graph's replay and the copy-out, enqueued), the same batch
    by a plain blocking .to() from pageable memory, and the eager
    beam_search's launches on the device batch (what an eager dispatch
    would ship), each followed by a synchronize outside the clock."""
    import torch

    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.decode.beam import beam_search

    reqs = [rsp.make_request(**f) for f in fields[:rows]]
    host = rsp.make_batch(reqs)
    pageable = host._replace(fts=np.array(host.fts))
    pinned = rsp._pinned(host)
    batch = to_device(pageable, device)

    def clock(fn):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return statistics.median(ms)

    rsp.program(pinned)                         # the geometry captured, if new
    return {"rows": rows, "grid_mb": host.fts.nbytes / 2 ** 20,
            "assemble_ms": clock(lambda: rsp.make_batch(reqs)),
            "pin_tokens_ms": clock(lambda: rsp._pinned(host)),
            "replay_ship_ms": clock(lambda: rsp.program(pinned)),
            "ship_blocking_ms": clock(lambda: to_device(pageable, device)),
            "eager_decode_launch_ms": clock(lambda: beam_search(rsp.params, rsp.cfg, batch,
                                                                rsp.gcfg))}


def traffic_table(geoms, batch_buckets):
    """Every batch bucket crossed with the length and time buckets of each
    of the geometries `geoms` (`DecodeProgram.geometries()`) and of each
    axis-wise maximum of them: the geometries of the groups a traffic
    formed, at any batch size, and of any union of such groups (a group's
    buckets are its requests' largest)."""
    combos = {tuple(sorted((k, v) for k, v in g.items() if k != "B")) for g in geoms}
    while True:
        joins = {tuple((k, max(x, y)) for (k, x), (_, y) in zip(a, b))
                 for a in combos for b in combos} - combos
        if not joins:
            return [dict(c, B=b) for b in batch_buckets for c in sorted(combos)]
        combos |= joins


def phase_serving_load(device, model, fields, n_req=512, n_other=128, n_prof=128,
                       clients=64, dv=DV, s=S):
    """Serving at the serve CLI's defaults (batch buckets 8-64, its length
    and time buckets, bfloat16 cache, beam 5, warmup over every batch
    bucket, then the requests of `fields` once and a pass at the window's
    own size, each followed by `warm_table`, so that the geometries of
    their traffic are captured before the windows): n_req requests by beam
    search, then n_other greedily and n_other by beam search with a
    bfloat16 precompute (K1 on a bfloat16 grid), each read bare; then n_prof more of each under torch.profiler
    for the card's busy share; on the card, the parts of one beam-search
    batch (ship_breakdown); each run's captured geometries, capture seconds
    and graph pool, and the device memory reserved at its end.  A window
    that captured a geometry is read again (`settled_window`).  Readings,
    not gates, apart from no error, no eager decode but a capture's warm-up,
    K1 on "whole" 6 times per batch in the profiled replays, and a window
    that captured nothing within 3 reads."""
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
        at_warmup = rsp.program.stats()
        # the traffic's own geometries (warmup() takes one length and time
        # bucket a batch bucket) captured before the windows are read: one
        # pass of its requests, then `warm_table` (the batches' sizes, and
        # so the groups' bucket maxima, follow the host's timing: on a slow
        # host a pass alone, and then a pass and one table, left a new
        # geometry for each of 3 reads); on the CPU nothing is captured, so
        # the table is only counted
        traffic = serve_window(device, rsp, fields, len(fields), clients, profiled=False)
        at_traffic = rsp.program.stats()
        t0 = time.perf_counter()
        table, _ = warm_table(device, rsp)
        # one more pass at the window's own size (its groups follow its
        # request count), its new groups' table captured as well
        serve_window(device, rsp, fields, n, clients, profiled=False)
        table, _ = warm_table(device, rsp)
        table_s = time.perf_counter() - t0
        at_table = rsp.program.stats()
        out[name] = dict(settled_window(device, rsp, fields, n, clients, False, name),
                         warmup_seconds=warm, warmup_captures=at_warmup["captures"],
                         warmup_capture_seconds=at_warmup["capture_seconds"],
                         traffic_warmup={
                             "requests": traffic["requests"], "seconds": traffic["seconds"],
                             "captures": traffic["captures"],
                             "capture_seconds": at_traffic["capture_seconds"]
                             - at_warmup["capture_seconds"]},
                         traffic_table={
                             "geometries": table, "seconds": table_s,
                             "captures": at_table["captures"] - at_traffic["captures"],
                             "capture_seconds": at_table["capture_seconds"]
                             - at_traffic["capture_seconds"]},
                         profiled=settled_window(device, rsp, fields, n_prof, clients,
                                                 True, name + ", profiled"))
        if device.type == "cuda" and name == "beam_search":
            out[name]["ship_breakdown"] = ship_breakdown(device, rsp, fields)
        prog = rsp.program.stats()
        out[name].update(geometries_captured=prog["captures"],
                         capture_seconds=prog["capture_seconds"],
                         graph_pool_mb=prog["pool_bytes"] / 2 ** 20)
        if device.type == "cuda":
            import torch
            out[name]["device_memory_reserved_mb"] = torch.cuda.memory_reserved() / 2 ** 20
        log(f"serving load, {name}: {json.dumps(out[name])}")
        del rsp
    return out


class ServeProcess:
    """The serve CLI as a process of its own with `args` (--port 0 added),
    its output in `log_path`: entering waits for its "serving on <host>:
    <port>" line and gives the base URL; leaving sends SIGINT and waits."""

    def __init__(self, args, log_path, timeout=600):
        self.cmd = [sys.executable, "-m", "bist_tpu_torch.cli.serve", *args, "--port", "0"]
        self.log_path, self.timeout = log_path, timeout

    def tail(self):
        with open(self.log_path) as f:
            return f.read()[-3000:]

    def __enter__(self):
        import re

        with open(self.log_path, "w") as logf:
            self.proc = subprocess.Popen(self.cmd, cwd=HERE, stdout=logf,
                                         stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + self.timeout
            while True:
                if self.proc.poll() is not None:
                    raise AssertionError(f"serve CLI exited {self.proc.returncode}:\n"
                                         f"{self.tail()}")
                if time.monotonic() > deadline:
                    raise AssertionError(f"serve CLI did not start in {self.timeout} s:\n"
                                         f"{self.tail()}")
                m = re.search(r"serving on [\d.]+:(\d+)", self.tail())
                if m:
                    return f"http://127.0.0.1:{int(m.group(1))}"
                time.sleep(0.2)
        except BaseException:
            self.__exit__()
            raise

    def __exit__(self, *exc):
        import signal

        self.proc.send_signal(signal.SIGINT)
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)


def phase_serve_cli(device, root, result_json, s=S, timeout=600):
    """The serve CLI (a process of its own, --port 0) on phase 5's model
    <root>/mtn: /healthz, /respond with nested-list features and with an
    int8 upload, a 400 without features, /metrics; then the evaluate CLI on
    `result_json` (phase 5's greedy result): its seven metrics printed and
    its .eval written."""
    import re

    from bist_tpu_torch.config import load_conf
    from bist_tpu_torch.data.batching import quantize_features

    _, cfg, _, _ = load_conf(os.path.join(root, "mtn.conf"))
    server = ServeProcess(["--model", os.path.join(root, "mtn"), "--device", device.type],
                          os.path.join(root, "serve.log"), timeout)
    with server as base:
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
    want = {"healthz": 200, "respond, lists": 200, "respond, int8": 200,
            "respond, no features": 400, "metrics": 200}
    codes = {k: c for k, (c, _) in checks.items()}
    if codes != want or checks["healthz"][1].get("ok") is not True \
            or not all(isinstance(checks[k][1].get("answer"), str)
                       for k in ("respond, lists", "respond, int8")) \
            or checks["metrics"][1].get("requests", 0) < 2:
        raise AssertionError(f"serve CLI: {checks}\n{server.tail()}")

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
# phase 11: serving bundles


def with_history(f, words):
    """A client's fields with a history of `words` words: its own history's
    last words, repeated (with its question) where it is shorter."""
    w = f["history"].split() or f["question"].split()
    while len(w) < words:
        w = w + f["question"].split() + w
    return dict(f, history=" ".join(w[-words:]))


def bundle_groups(fields, big=64, small=8):
    """Phase 3's turns as two halves, the first with histories of 80 words
    (they pad to the 256 bucket), the second of 12 (the 64 bucket), each
    half as one group of `big` rows and then groups of `small`: groups that
    reach every geometry of a (small, big) x (64, 256) table."""
    half = len(fields) // 2
    groups = []
    for part in ([with_history(f, 80) for f in fields[:half]],
                 [with_history(f, 12) for f in fields[half:]]):
        groups.append(part[:big])
        groups += [part[i:i + small] for i in range(big, len(part), small)]
    return groups


def respond_groups(rsp, groups):
    """Each group through Responder.respond: the answers in order and each
    batch's geometry key."""
    from bist_tpu_torch.export import geometry_key, geometry_of

    answers, keys = [], []
    for group in groups:
        reqs = [rsp.make_request(**f) for f in group]
        keys.append(geometry_key(geometry_of(rsp.make_batch(reqs))))
        rsp.respond(reqs)
        answers += [r._answer for r in reqs]
    return answers, keys


def phase_bundles(device, model, fields, cli_root, dv=DV, s=S, t_max=T_MAX, workers=4,
                  big=64, small=8, lh=(64, LH)):
    """Serving bundles (`bist_tpu_torch.export`) of phase 3's model at the
    serve CLI's decode settings (beam 5, maxlen 12, bfloat16 cache): a beam
    bundle of 4 geometries (batch `small` and `big` x histories `lh`, LQ,
    LC, t_max clips of (s, dv)) exported by `workers` processes and a greedy
    bundle of one geometry, both loaded into fresh objects; the beam
    bundle's Responder captures its table (`warmup_geometries`) and answers
    `fields` in groups that reach every geometry, each answer equal to a
    DecodeProgram Responder's for the same rows, with no capture and no
    eager K1 launch in the served window and, on the card, K1 6 times per
    batch, all "whole", by kernel name; params.npz of seed 1 swapped into
    the same bundle (no export) gives a seed-1 DecodeProgram's answers; the
    greedy bundle gives the greedy DecodeProgram's.  Readings: export,
    load and capture seconds per geometry, file bytes, graph pool,
    requests/s and device ms per batch of both Responders at one geometry
    (in turns), and the first batch at a geometry off warmup()'s diagonal
    with and without warmup_geometries.  Then the serve CLI exports a
    bundle of phase 5's model and serves it (`phase_bundle_cli`), its export
    started first and run beside the bundles'."""
    # three exports at once: the serve CLI's (a process), the greedy bundle
    # (a thread of this process, which only waits on the beam bundle's
    # worker processes meanwhile) and the beam bundle's; the CLI's process
    # is stopped whatever happens
    cli_export = start_bundle_cli_export(device, cli_root, s)
    try:
        return bundle_checks(device, model, fields, cli_root, cli_export, dv, s, t_max,
                             workers, big, small, lh)
    finally:
        if cli_export[0].poll() is None:
            cli_export[0].kill()
            cli_export[0].wait(timeout=30)


def bundle_checks(device, model, fields, cli_root, cli_export, dv, s, t_max, workers, big,
                  small, lh):
    """`phase_bundles` once the serve CLI's export is started."""
    import concurrent.futures
    import dataclasses

    import torch

    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.export import (default_serving_geometries, flatten_params,
                                       geometry_key, load_bundle, save_bundle)
    from bist_tpu_torch.models.model import init_model
    from bist_tpu_torch.ops.bist_kernels import hop1_fused
    from bist_tpu_torch.serving import Responder

    vocab, cfg, params = model
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    K1 = torch.ops.bist_tpu_torch.hop1_fwd.default
    gcfg = GenerateConfig(maxlen=12, beam=5, penalty=1.0, nbest=1, cache_dtype="bfloat16")
    greedy = dataclasses.replace(gcfg, decode_style="greedy")
    geoms = default_serving_geometries(cfg, batch_buckets=(small, big), Lq=LQ, Lh=lh,
                                       Lc=LC, T=t_max, S=s)
    kw = dict(max_batch=big, batch_buckets=(small, big),
              len_buckets={"q": (LQ,), "h": tuple(lh), "c": (LC,)},
              time_buckets=(t_max,), feat_tail=(s, dv))
    root = os.path.join(HERE, "build", "chip_smoke", "bundles")
    shutil.rmtree(root, ignore_errors=True)
    beam_dir, greedy_dir = os.path.join(root, "beam"), os.path.join(root, "greedy")
    out = {"geometries": [geometry_key(g) for g in geoms]}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        greedy_saved = pool.submit(save_bundle, greedy_dir, params, cfg, greedy, vocab,
                                   geoms[-1:])
        t0 = time.perf_counter()
        written = save_bundle(beam_dir, params, cfg, gcfg, vocab, geoms, workers=workers)
        out["export_seconds"] = time.perf_counter() - t0
        greedy_saved.result()
    for name, d in (("beam", beam_dir), ("greedy", greedy_dir)):
        with open(os.path.join(d, "bundle.json")) as f:
            out[f"{name}_export_seconds_per_program"] = json.load(f)["export_seconds"]
    out["pt2_bytes"] = {k: os.path.getsize(p) for k, p in written.items()}
    out["params_npz_bytes"] = os.path.getsize(os.path.join(beam_dir, "params.npz"))

    t0 = time.perf_counter()
    bundle = load_bundle(beam_dir, device)
    out["load_seconds"] = time.perf_counter() - t0
    out["load_seconds_per_program"] = bundle.load_seconds
    nodes = {k: sum(n.target is K1 for n in ep.graph.nodes) for k, ep in bundle.programs.items()}
    out["k1_op_nodes"] = nodes
    if set(nodes.values()) != {2 * cfg.nb_venc_blocks} \
            or any(len(ep.state_dict) for ep in bundle.programs.values()):
        raise AssertionError(f"bundles: K1 op nodes {nodes} (expected "
                             f"{2 * cfg.nb_venc_blocks} a program) or weights in a program")

    rsp_b = bundle.make_responder()
    derived = {k: getattr(rsp_b, k) for k in ("batch_buckets", "q_buckets", "h_buckets",
                                               "c_buckets", "time_buckets", "feat_tail")}
    if derived != {"batch_buckets": (small, big), "q_buckets": (LQ,), "h_buckets": tuple(lh),
                   "c_buckets": (LC,), "time_buckets": (t_max,), "feat_tail": (s, dv)}:
        raise AssertionError(f"bundles: make_responder derived {derived}")
    out["capture_seconds_per_geometry"] = {}
    for key, g in bundle.geometries.items():
        t0 = time.perf_counter()
        rsp_b.warmup_geometries([g])
        sync()
        out["capture_seconds_per_geometry"][key] = time.perf_counter() - t0
    rsp_p = Responder(params, cfg, vocab, gcfg, **kw)
    rsp_p.warmup_geometries(geoms)

    groups = bundle_groups(fields, big, small)
    want, _ = respond_groups(rsp_p, groups)
    sync()
    reset_hop1_counts()
    before = rsp_b.program.stats()
    prof = profiler_window(device)
    with prof:
        got, keys = respond_groups(rsp_b, groups)
        sync()
    after = rsp_b.program.stats()
    out["program"] = after
    out["graph_pool_mb"] = after["pool_bytes"] / 2 ** 20
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if differ:
        raise AssertionError(f"bundles: {len(differ)} of {len(want)} answers differ from the "
                             f"DecodeProgram Responder's, e.g. request {differ[0]}: "
                             f"{got[differ[0]]!r} against {want[differ[0]]!r}")
    if set(keys) != set(bundle.geometries):
        raise AssertionError(f"bundles: the groups reached {sorted(set(keys))}, not every "
                             f"geometry of {sorted(bundle.geometries)}")
    if any(after[k] != before[k] for k in ("geometries", "captures", "eager_runs")) \
            or hop1_fused.launches:
        raise AssertionError(f"bundles: the served window captured or ran eagerly: program "
                             f"{before} -> {after}, K1 launches {hop1_fused.launches}")
    ran = k1_ran(prof) if cuda else dict(K1_NONE)
    if cuda and ran != dict(K1_NONE, whole=6 * len(groups)):
        raise AssertionError(f"bundles: K1 kernels by name {ran} in {len(groups)} replayed "
                             f"batches, expected {6 * len(groups)} \"whole\"")
    out.update(served={"requests": len(got), "identical": len(got), "batches": len(groups),
                       "geometries_reached": len(set(keys)), "hop1_fwd_ran": ran["whole"]})

    # requests/s and device ms per batch at one geometry (big rows, long histories)
    one = [groups[0], [with_history(f, 80) for f in fields[-big:]]]
    reqs = {name: [[r.make_request(**f) for f in g] for g in one]
            for name, r in (("bundle", rsp_b), ("program", rsp_p))}
    rates = {"bundle": [], "program": []}
    for name, rsp in (("bundle", rsp_b), ("program", rsp_p), ("program", rsp_p),
                      ("bundle", rsp_b)):
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            for r in reqs[name]:
                rsp.respond(r)
        sync()
        rates[name].append(3 * big * len(one) / (time.perf_counter() - t0))
    device_ms = {}
    for name, rsp in (("bundle", rsp_b), ("program", rsp_p)):
        prof = profiler_window(device)
        with prof:
            for r in reqs[name]:
                rsp.respond(r)
            sync()
        device_ms[name] = device_busy_ms(prof) / len(one) if cuda else None
    out["one_geometry"] = {"geometry": geometry_key(geoms[-1]), "requests_per_s": rates,
                           "device_ms_per_batch": device_ms}
    del rsp_p

    # the first batch at a geometry off warmup()'s diagonal (groups[1]: small
    # rows, long histories), after warmup() alone and after warmup_geometries
    first = {}
    for name in ("warmup", "warmup_geometries"):
        rsp = bundle.make_responder()
        if name == "warmup":
            rsp.warmup(feature_shape=(s, dv), t_clips=min(16, t_max))
        else:
            rsp.warmup_geometries(geoms)
        warmed = rsp.program.stats()["geometries"]
        reqs1 = [rsp.make_request(**f) for f in groups[1]]
        sync()
        t0 = time.perf_counter()
        rsp.respond(reqs1)
        sync()
        first[name] = {"ms": (time.perf_counter() - t0) * 1e3, "warmed": warmed,
                       "captured": rsp.program.stats()["geometries"] - warmed}
        del rsp
    if first["warmup_geometries"]["captured"] or not first["warmup"]["captured"]:
        raise AssertionError(f"bundles: first batch off the diagonal {first}")
    out["first_batch_off_diagonal"] = first

    # a weight swap: seed 1's params.npz in the same bundle, nothing exported
    mtimes = {k: os.path.getmtime(p) for k, p in written.items()}
    params1 = init_model(1, cfg, device=device)
    np.savez(os.path.join(beam_dir, "params.npz"), **flatten_params(params1))
    bundle.reload_params()
    swap = [groups[0], groups[-1]]
    got1, _ = respond_groups(bundle.make_responder(), swap)
    want1, _ = respond_groups(Responder(params1, cfg, vocab, gcfg, **kw), swap)
    if got1 != want1 or mtimes != {k: os.path.getmtime(p) for k, p in written.items()}:
        raise AssertionError("bundles: the swapped weights' answers differ from a seed-1 "
                             "DecodeProgram Responder's, or a program was written again")
    out["weight_swap"] = {"requests": len(got1), "identical": len(got1),
                          "changed_from_seed_0": sum(a != b for a, b in zip(got1, got))}
    del bundle, rsp_b

    gb = load_bundle(greedy_dir, device)
    rg = gb.make_responder()
    rg.warmup_geometries(gb.geometries.values())
    gkw = dict(kw, max_batch=big, batch_buckets=(big,),
               len_buckets={"q": (LQ,), "h": (lh[-1],), "c": (LC,)})
    got_g, _ = respond_groups(rg, one)
    want_g, _ = respond_groups(Responder(params, cfg, vocab, greedy, **gkw), one)
    if got_g != want_g:
        raise AssertionError("bundles: the greedy bundle's answers differ from the greedy "
                             "DecodeProgram Responder's")
    out["greedy"] = {"requests": len(got_g), "identical": len(got_g),
                     "geometry": next(iter(gb.geometries))}
    del gb, rg
    out["serve_cli"] = phase_bundle_cli(device, cli_root, cli_export, s)
    log(f"bundles: {json.dumps(out)}")
    return out


def start_bundle_cli_export(device, root, s=S):
    """Start the serve CLI's --export-bundle of phase 5's model <root>/mtn
    (one geometry: batch 8, LQ/64/LC tokens, 16 clips of (s, Dv)) into
    <root>/bundle, its output in <root>/export_bundle.log; returns the
    process and its start time."""
    cmd = [sys.executable, "-m", "bist_tpu_torch.cli.serve", "--model",
           os.path.join(root, "mtn"), "--export-bundle", os.path.join(root, "bundle"),
           "--max-batch", "8", "--export-lq", str(LQ), "--export-lh", "64",
           "--export-lc", str(LC), "--export-t", "16", "--feat-s", str(s),
           "--device", device.type]
    with open(os.path.join(root, "export_bundle.log"), "w") as logf:
        return subprocess.Popen(cmd, cwd=HERE, stdout=logf,
                                stderr=subprocess.STDOUT), time.perf_counter()


def phase_bundle_cli(device, root, export, s=S, timeout=900):
    """The serve CLI on phase 5's model <root>/mtn: waits for the
    --export-bundle process `export` (`start_bundle_cli_export`), then
    serves the bundle with --bundle as a process of its own: /healthz and
    /respond answering, its log naming the warmup over its geometry
    table."""
    from bist_tpu_torch.config import load_conf

    proc, t0 = export
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    export_s = time.perf_counter() - t0
    with open(os.path.join(root, "export_bundle.log")) as f:
        export_log = f.read()
    if rc != 0:
        raise AssertionError(f"serve CLI --export-bundle exited {rc}:\n{export_log[-4000:]}")
    _, cfg, _, _ = load_conf(os.path.join(root, "mtn.conf"))
    server = ServeProcess(["--bundle", os.path.join(root, "bundle"), "--device", device.type],
                          os.path.join(root, "serve_bundle.log"), timeout)
    with server as base:
        fts = np.random.default_rng(6).standard_normal((10, s, cfg.ft_sizes[0]),
                                                        dtype=np.float32)
        checks = {"healthz": http_json(f"{base}/healthz"),
                  "respond": http_json(f"{base}/respond", {
                      "question": "what is the man doing ?", "history": "is he inside ? yes",
                      "caption": "a man sits on a couch .", "features": fts.tolist()})}
        log_text = server.tail()
    if [c for c, _ in checks.values()] != [200, 200] \
            or not isinstance(checks["respond"][1].get("answer"), str) \
            or "every geometry of the bundle" not in log_text:
        raise AssertionError(f"serve CLI --bundle: {checks}\n{log_text}")
    return {"export_seconds": export_s, "serve": checks}


# ---------------------------------------------------------------------------
# phase 12: the video feature extractor

EXTRACT_TOL = 1e-4       # card against CPU, float32 both: max |Δ| over max |f|
BF16_DEV_MAX = 0.05      # ‖f_bf16 - f‖ / ‖f‖ at depth 101 (read 0.0082 on an H100)
# ‖f_int8 - f‖ / ‖f‖, stages 3 and 4, static scales: bist_tpu's own bound
# (tests/test_resnext3d.py:347); read 0.0377 on an H100 (700 W)
INT8_DEV_MAX = 0.06
PACK_TOL = 1e-5          # packed against per-video, if not identical: over max |f|
# (frames, height, width) of the synthetic videos: 221 clips at stride 4
VIDEOS = ((40, 112, 112), (64, 240, 320), (100, 112, 112), (160, 240, 320),
          (220, 112, 112), (300, 240, 320))


def conv_out(d, k, s):
    """A convolution's output extent along one axis (torch's k//2 padding)."""
    return (d + 2 * (k // 2) - k) // s + 1


def resnext_conv_macs(params, t=16, h=112, w=112) -> dict:
    """Multiply-adds of every convolution of one t×h×w clip through a
    ResNeXt tree (DHWIO kernels), by part: the stem and each stage, from
    the kernels' shapes and torch's output extents."""
    from bist_tpu_torch.models.resnext3d import STAGE_STRIDES

    out = conv_out
    kd, kh, kw, ci, co = params["stem"]["conv"].shape
    ext = (out(t, kd, 1), out(h, kh, 2), out(w, kw, 2))
    macs = {"stem": int(np.prod(ext)) * kd * kh * kw * ci * co}
    ext = tuple(out(d, 3, 2) for d in ext)                     # the max pool
    for s, stage in enumerate(params["stages"]):
        m = 0
        for b, blk in enumerate(stage):
            stride = STAGE_STRIDES[s] if b == 0 else 1
            ext_out = tuple(out(d, 1, stride) for d in ext)    # 1³ and padded 3³ alike
            for name in ("conv1", "conv2", "conv3", "down_conv"):
                if name in blk:
                    at = ext if name == "conv1" else ext_out
                    m += int(np.prod(at)) * int(np.prod(blk[name].shape))
            ext = ext_out
        macs[f"stage{s + 1}"] = m
    return macs


def kenshohara_resnext_state_dict(depth, seed=0, n_classes=400):
    """A synthetic state dict with the key names and shapes of a kenshohara
    Kinetics ResNeXt checkpoint (DataParallel's 'module.' prefixes, torch
    (O, I/g, kD, kH, kW) kernels, BatchNorm running stats), random from
    numpy: He-normal kernels, BN weights near 1."""
    import torch

    from bist_tpu_torch.models.resnext3d import (CARDINALITY, DEPTH_BLOCKS, EXPANSION,
                                                 PLANES, STAGE_STRIDES)

    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[f"module.{name}.weight"] = rng.standard_normal((o, i, k, k, k), np.float32) \
            * np.float32(np.sqrt(2.0 / (i * k ** 3)))

    def bn(name, c):
        sd[f"module.{name}.weight"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"module.{name}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"module.{name}.running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"module.{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    c_in = 64
    for s, (n_blocks, planes, stride) in enumerate(zip(DEPTH_BLOCKS[depth], PLANES,
                                                        STAGE_STRIDES)):
        c_out = planes * EXPANSION
        for b in range(n_blocks):
            pre = f"layer{s + 1}.{b}"
            conv(pre + ".conv1", planes, c_in, 1)
            bn(pre + ".bn1", planes)
            conv(pre + ".conv2", planes, planes // CARDINALITY, 3)
            bn(pre + ".bn2", planes)
            conv(pre + ".conv3", c_out, planes, 1)
            bn(pre + ".bn3", c_out)
            if b == 0 and (c_in != c_out or stride != 1):
                conv(pre + ".downsample.0", c_out, c_in, 1)
                bn(pre + ".downsample.1", c_out)
            c_in = c_out
    sd["module.fc.weight"] = (0.01 * rng.standard_normal((n_classes, c_in))).astype(np.float32)
    sd["module.fc.bias"] = np.zeros(n_classes, np.float32)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def kinetics_clips(n, seed, device):
    """n random 16-frame 112×112 clips as the preprocessing leaves them:
    0..255 pixels minus the Kinetics means, (n, 16, 112, 112, 3) float32."""
    import torch

    from bist_tpu_torch.models.resnext3d import KINETICS_MEAN

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, (n, 16, 112, 112, 3), generator=g, device=device)
    return x.float() - torch.tensor(KINETICS_MEAN, device=device)


def rel_dev(got, want) -> float:
    """‖got - want‖ / ‖want‖ in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def parts_apply(net, clips, mark):
    """resnext101_apply's 'spatio_temporal' forward with `mark(name)` called
    after the stem and after each stage."""
    from bist_tpu_torch.models import resnext3d as rx

    with rx.conv_precision():
        x = rx.stem_apply(net, clips)
        mark("stem")
        for s, stage in enumerate(net.params["stages"]):
            for b, blk in enumerate(stage):
                x = rx.block_apply(blk, x, rx.STAGE_STRIDES[s] if b == 0 else 1)
            mark(f"stage{s + 1}")
        return rx.finish(x, net.params, "spatio_temporal")


def device_timeline(prof, top=8, after=None):
    """The card's work in a torch.profiler window: its busy ms (the union of
    the kernels' and copies' intervals, annotations left out: cuDNN's work
    can overlap itself, so durations summed overcount), the streams it ran
    on, and the `top` kernels by device ms.  With `after`, only the work
    that starts after the last kernel whose name holds it."""
    from torch.autograd import DeviceType

    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    if after is not None:
        ends = [e.end_ns() for e in events if after in e.name()]
        if not ends:
            raise AssertionError(f"no {after} kernel in the profiler window")
        events = [e for e in events if e.start_ns() >= max(ends)]
    busy, cur = 0, None
    for start, end in sorted((e.start_ns(), e.end_ns()) for e in events):
        if cur is None or start > cur[1]:
            busy += cur[1] - cur[0] if cur else 0
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy += cur[1] - cur[0] if cur else 0
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name()[:80], (0.0, 0))
        by_name[e.name()[:80]] = (ms + e.duration_ns() / 1e6, n + 1)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"busy_ms": busy / 1e6, "summed_ms": sum(e.duration_ns() for e in events) / 1e6,
            "streams": len({e.device_resource_id() for e in events}),
            "top_kernels": [{"name": k, "ms": ms, "calls": n} for k, (ms, n) in kernels]}


def extractor_speed(device, net, clips, macs_per_clip, reps=5, warmup=2):
    """One precision's net on a batch of clips: the median ms of `reps`
    batches after `warmup` (CUDA events around each, the card idle before),
    clips/s and TFLOP/s (2 × the convolutions' multiply-adds) from it; then
    one batch under torch.profiler (after a batch and a marker kernel), its
    device ms by part (CUDA events between the parts), the card's busy share
    (`device_timeline`'s busy ms after the marker over the batch's wall
    time) and its top kernels.  On the CPU: host clock, no parts."""
    import torch

    from bist_tpu_torch.models import resnext3d as rx

    cuda = device.type == "cuda"
    run = lambda: rx.resnext101_apply(net, clips)  # noqa: E731
    for _ in range(warmup):
        run()
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    n = clips.shape[0]
    out = {"batch": n, "ms_per_batch": ms, "ms_runs": times, "clips_per_s": n / ms * 1e3,
           "tflops": 2 * macs_per_clip * n / ms / 1e9}
    if not cuda:
        return out
    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    prof = profiler_window(device)
    with prof:
        # CUPTI may start recording a while after the window opens (in a
        # process that has profiled before, a batch's first ~50 ms went
        # missing): one batch first, then a marker kernel, then the batch
        # that is read
        run()
        torch.cuda._sleep(1000)                      # "spin_kernel"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        parts_apply(net, clips, mark)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    names = list(events)
    out["part_ms"] = {b: events[a].elapsed_time(events[b]) for a, b in zip(names, names[1:])}
    timeline = device_timeline(prof, after="spin_kernel")
    out.update(profiled_ms=wall, busy_share=timeline["busy_ms"] / wall, **timeline)
    return out


def int_conv_f64(x, w, stride):
    """The integer sums of an int8 convolution in float64, by an explicit
    patch product (exact: every sum is an integer below 2^53).  w as
    `resnext3d.prepare` leaves an int8 kernel: the (I, O) matrix of a 1³
    one, else (O, I/g, k, k, k) float32 integers."""
    import torch
    import torch.nn.functional as F

    x = x.double()
    if w.dim() == 2:
        return torch.einsum("ncthw,co->nothw", x[:, :, ::stride, ::stride, ::stride],
                            w.double())
    k, groups = w.shape[2], x.shape[1] // w.shape[1]
    p = F.pad(x, (k // 2,) * 6).unfold(2, k, stride).unfold(3, k, stride).unfold(4, k, stride)
    n, c, t, h, wd = p.shape[:5]
    p = p.reshape(n, groups, c // groups, t, h, wd, k, k, k)
    wg = w.double().reshape(groups, -1, c // groups, k, k, k)
    return torch.einsum("ngcthwijk,gocijk->ngothw", p, wg).reshape(n, -1, t, h, wd)


def int8_sums_exact(net, clips_shape, seed=5):
    """Every convolution of the int8 stages' first two blocks (later blocks
    repeat the second's shapes) through `_conv3d_int8` at the shapes a
    batch of `clips_shape` gives it, in the net's layout, on random int8
    activations over the full range (a grouped 3³ conv's sums stay under
    27·32·127² < 2^24, so a float32 sum is exact only where the algorithm
    adds the products directly), held bit for bit against `int_conv_f64`.
    Called in the process that timed the int8 net, the convolutions run
    with the plans its cuDNN search chose.  Returns each one's input shape
    and largest |sum|; raises at the first that differs."""
    import torch

    from bist_tpu_torch.models import resnext3d as rx

    n, t, h, w = clips_shape[:4]
    dev = net.device
    kd, kh, kw = net.params["stem"]["conv"].shape[2:]
    ext = (conv_out(t, kd, 1), conv_out(h, kh, 2), conv_out(w, kw, 2))
    ext = tuple(conv_out(d, 3, 2) for d in ext)                # the max pool
    g = torch.Generator(device=dev).manual_seed(seed)
    checked = []
    with rx.conv_precision():
        for si, stage in enumerate(net.params["stages"]):
            for b, blk in enumerate(stage):
                stride = rx.STAGE_STRIDES[si] if b == 0 else 1
                ext_out = tuple(conv_out(d, 1, stride) for d in ext)
                if blk["conv1"].dtype == torch.int8 and b < 2:
                    for name in ("conv1", "conv2", "conv3", "down_conv"):
                        if name not in blk:
                            continue
                        wt = blk[name]
                        c = wt.shape[0] if wt.dim() == 2 else wt.shape[1] * rx.CARDINALITY
                        s = stride if name in ("conv2", "down_conv") else 1
                        xq = torch.randint(-127, 128, (n, c) + (ext_out if name == "conv3"
                                                                 else ext),
                                           generator=g, device=dev).to(torch.int8)
                        xq = xq.contiguous(memory_format=rx.MEMORY_FORMAT)
                        got = rx._conv3d_int8(xq, wt, s).double()
                        want = int_conv_f64(xq, wt, s)
                        what = f"stage {si + 1} block {b} {name} on {tuple(xq.shape)}"
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"extractor int8: {what}: the sums differ from float64's "
                                f"by up to {float((got - want).abs().max())}")
                        checked.append({"conv": what, "max_abs_sum": float(want.abs().max())})
                        del xq, got, want
                ext = ext_out
    return checked


def phase_extractor(device, root, depth=101, batch=128, reps=5, n_check=4, videos=VIDEOS,
                    model_kw=None, stride=4):
    """The extractor on the card: ResNeXt at `depth` with seeded random
    weights, float32 against the port's own CPU forward; bfloat16 and int8
    (stages 3 and 4, static scales calibrated on the batch) against float32;
    the speed of each at `batch` clips; then the extract CLI on synthetic
    .npy videos with a kenshohara-format checkpoint, packed and per-video,
    its grids written into phase 5's tiny dataset, and the generate CLI
    (beam search) answering every turn from them, K1's kernels counted by
    name in its run.  Returns the readings."""
    import contextlib

    import torch

    from bist_tpu_torch.models import resnext3d as rx
    from bist_tpu_torch.weights import tree_map

    cuda = device.type == "cuda"
    out = {"depth": depth}
    params = rx.init_resnext101(torch.Generator().manual_seed(0), depth=depth)
    macs = resnext_conv_macs(params)
    macs_per_clip = sum(macs.values())
    out["gflop_per_clip"] = 2 * macs_per_clip / 1e9
    out["gflop_per_clip_by_part"] = {k: 2 * v / 1e9 for k, v in macs.items()}
    net = rx.prepare(params, device)

    with torch.inference_mode():
        # 1. the card's float32 features against the port's CPU forward
        check = kinetics_clips(n_check, 1, torch.device("cpu"))
        f_cpu = rx.resnext101_apply(rx.prepare(params, "cpu"), check)
        f_card = rx.resnext101_apply(net, check.to(device)).cpu()
        if f_card.shape != (n_check, 16, 2048) or not torch.isfinite(f_card).all():
            raise AssertionError(f"extractor: features {tuple(f_card.shape)}, finite "
                                 f"{bool(torch.isfinite(f_card).all())}")
        err = float((f_card - f_cpu).abs().max() / f_cpu.abs().max())
        out["card_vs_cpu"] = {"clips": n_check, "max_abs_err_over_max_abs": err,
                              "max_abs": float(f_cpu.abs().max()), "tol": EXTRACT_TOL}
        if not err <= EXTRACT_TOL:
            raise AssertionError(f"extractor float32: card against CPU {err:.3e} of max |f| "
                                 f"> {EXTRACT_TOL}")
        del f_cpu

        # 2, 3. bfloat16 and int8 against float32, and each one's speed
        clips = kinetics_clips(batch, 2, device)
        nets = {"float32": net,
                "bfloat16": rx.prepare(tree_map(lambda t: t.to(torch.bfloat16), params),
                                       device)}
        scales = rx.collect_act_scales(net, clips.to(torch.bfloat16))
        nets["int8"] = rx.prepare(rx.quantize_resnext_int8(params, act_scales=scales,
                                                           stages=(2, 3)), device)
        ref = rx.resnext101_apply(net, clips).float()
        ref_check = f_card.to(device)
        speed, devs = {}, {}
        for name, n in nets.items():
            if name != "float32":
                devs[name] = {
                    "calibration_batch": rel_dev(rx.resnext101_apply(n, clips).float(), ref),
                    "fresh_clips": rel_dev(rx.resnext101_apply(n, check.to(device)).float(),
                                           ref_check),
                    "bound": BF16_DEV_MAX if name == "bfloat16" else INT8_DEV_MAX}
                if not max(devs[name]["calibration_batch"], devs[name]["fresh_clips"]) \
                        <= devs[name]["bound"]:
                    raise AssertionError(f"extractor {name}: deviation from float32 "
                                         f"{devs[name]} beyond its bound")
            speed[name] = extractor_speed(device, n, clips, macs_per_clip, reps=reps)
            log(f"extractor {name}: {json.dumps(speed[name])}")
        out.update(deviation_from_float32=devs, speed=speed,
                   int8_sums_exact=int8_sums_exact(nets["int8"], clips.shape))
        del nets, clips, ref, scales

    # 4. the extract CLI on synthetic videos: packed, then per-video
    from bist_tpu_torch.cli import extract_features, generate

    test_set = write_tiny_dataset(root, n_dialogs=len(videos), model_kw=model_kw, dv=2048)
    with open(test_set) as f:
        orig = json.load(f)
    ids = [d["image_id"] for d in orig["dialogs"]]
    vroot, packed, per_video = (os.path.join(root, d) for d in
                                ("videos", "resnext_st", "per_video"))
    shutil.rmtree(packed)                      # write_tiny_dataset's random grids
    os.makedirs(vroot)
    rng = np.random.default_rng(3)
    for vid, (n, h, w) in zip(ids, videos):
        np.save(os.path.join(vroot, vid + ".npy"),
                rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8))
    ckpt = os.path.join(root, "resnext.pth")
    torch.save({"arch": f"resnext-{depth}",
                "state_dict": kenshohara_resnext_state_dict(depth, seed=4)}, ckpt)
    args = ["--video_root", vroot, "--model", ckpt, "--model_depth", str(depth),
            "--batch_size", str(batch), "--stride", str(stride), "--device", device.type]
    secs = {}
    with open(os.path.join(root, "extract.log"), "w") as logf, \
            contextlib.redirect_stdout(logf):
        for name, dst, extra in (("packed", packed, []), ("per_video", per_video,
                                                          ["--pack", "0"])):
            t0 = time.perf_counter()
            extract_features.main(args + ["--output", dst] + extra)
            secs[name] = time.perf_counter() - t0
    worst, n_clips = 0.0, 0
    for vid, (n, h, w) in zip(ids, videos):
        a, b = (np.load(os.path.join(d, vid + ".npy")) for d in (packed, per_video))
        want = (len(range(0, max(n - 1, 1), stride)), 16, 2048)
        if a.shape != want or b.shape != want or not np.isfinite(a).all():
            raise AssertionError(f"extract CLI {vid}: shapes {a.shape}, {b.shape}, want {want}")
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
        n_clips += want[0]
    if worst > PACK_TOL:
        raise AssertionError(f"extract CLI: packed against per-video {worst:.3e} of max |f|")
    out["cli"] = {"videos": len(videos), "clips": n_clips, "seconds": secs,
                  "packed_equals_per_video": "identical" if worst == 0 else worst,
                  "clips_per_s_packed_setup_included": n_clips / secs["packed"]}

    # 5. the grids into generation: beam search answering every turn
    result_json = os.path.join(root, "result_extracted.json")
    gen_args = ["--test-set", test_set,
                "--test-path", os.path.join(root, "<FeaType>", "<ImageID>.npy"),
                "--model", os.path.join(root, "mtn"), "--decode-style", "beam_search",
                "--beam", "5", "--penalty", "1.0", "--nbest", "5", "--undisclosed-only", "1",
                "--maxlen", "12", "--gen-batch-size", "4", "--output", result_json,
                "--device", device.type]
    prof = profiler_window(device)
    with open(os.path.join(root, "generate.log"), "w") as logf, \
            contextlib.redirect_stdout(logf), prof:
        generate.main(gen_args)
    with open(result_json) as f:
        result = json.load(f)
    check_result_schema(result, orig, undisclosed=True)
    ran = k1_ran(prof) if cuda else dict(K1_NONE)
    # the 75-clip video's t2s through "wide" (Lk > 64), the rest "whole"
    if cuda and not (ran["wide"] > 0 and ran["whole"] > 0 and ran["tiled"] == 0):
        raise AssertionError(f"generate from extracted features: K1 by name {ran}, expected "
                             f"\"wide\" (the 75-clip video's t2s) and \"whole\", no \"tiled\"")
    out["generate"] = {"turns": sum(len(d["dialog"]) for d in result["dialogs"]),
                       "answers": [t["answer"] for d in result["dialogs"] for t in d["dialog"]],
                       "k1_ran": ran}
    return out


# ---------------------------------------------------------------------------
# phase 13: TGIF-QA


TGIF_TASKS = ("frameqa", "count", "action", "transition")
TGIF_TOL = 5e-4
TGIF_TINY = dict(d_model=16, att_h=2, nb_venc_blocks=2, dv=12)   # tests/test_tgifqa.py's


def tgif_cfg(vocab_size, d_model=128, att_h=8, nb_venc_blocks=2, dv=DV):
    """The train_tgif CLI's model configuration (its defaults: d_model 128,
    8 heads, 2 video blocks) at --dropout 0."""
    from bist_tpu_torch.config import ModelConfig

    return ModelConfig(vocab_size=vocab_size, nb_blocks=nb_venc_blocks,
                       nb_venc_blocks=nb_venc_blocks, nb_cenc_blocks=0, d_model=d_model,
                       att_h=att_h, dropout=0.0, include_caption="none",
                       enc_vc_combine="none", ft_sizes=(dv,), ptr_ft="query")


def tgif_batch(rng, task, B, T, Lq, vocab_size, dv=DV, s=S, n_answers=1000):
    """A host TgifBatch: B questions (B·5 question + candidate rows for
    multiple choice) with a PAD tail, grids of T clips whose last quarter
    is zero (padding the temporal mask must hide), labels of the task."""
    from bist_tpu_torch.tasks.tgifqa import MULTIPLE_CHOICE, TgifBatch, TGIFTask
    from bist_tpu_torch.vocab import PAD

    rows = B * 5 if TGIFTask(task) in MULTIPLE_CHOICE else B
    query = rng.integers(4, vocab_size, size=(rows, Lq)).astype(np.int32)
    query[:, -(Lq // 4):] = PAD
    fts = rng.standard_normal((rows, T, s, dv), dtype=np.float32)
    fts[:, T - T // 4:] = 0.0
    hi = {"frameqa": n_answers, "count": 11}.get(task, 5)
    label = rng.integers(1 if task == "count" else 0, hi, size=B).astype(np.int32)
    return TgifBatch(query, fts, label)


def mc_heldout_batches(rng, transition, T=8, S=2, D=12, before_tok=6, after_tok=7):
    """tests/test_tgifqa.py's 5-way generator (fresh batches per call): a
    fixed action codebook U; action: the whole video is U[a], answer a;
    transition: halves U[a] and U[b] and a cue token (before/after) that
    selects which, unsolvable without temporal order."""
    from bist_tpu_torch.tasks.tgifqa import TgifBatch

    U = (rng.standard_normal((5, D)) * 2.0).astype(np.float32)

    def gen(n):
        rows, fts, labels = [], [], []
        for _ in range(n):
            grid = rng.standard_normal((T, S, D)).astype(np.float32) * 0.3
            if transition:
                a, b = rng.choice(5, size=2, replace=False)
                grid[: T // 2] += U[a]
                grid[T // 2:] += U[b]
                use_before = bool(rng.integers(0, 2))
                cue = before_tok if use_before else after_tok
                label = a if use_before else b
            else:
                label = int(rng.integers(0, 5))
                grid += U[label]
                cue = 5
            for c in range(5):
                rows.append(np.array([cue, 10 + c], np.int32))
            fts.extend([grid] * 5)
            labels.append(label)
        return TgifBatch(query=np.stack(rows), fts=np.stack(fts),
                         label=np.asarray(labels, np.int32))

    return gen


TGIF_WORDS = ("what is the man woman cat dog doing how many times does do jump run "
              "walk turn nod wave before after red blue green two three four").split()


def write_tgif_dataset(root, n_train=64, n_test=40, n_gifs=40, t_range=(8, 40), long_t=70,
                       dv=DV, s=S, seed=0):
    """Synthetic TGIF-QA splits under `root`: .npy grids (T, s, dv) of
    n_gifs GIFs of t_range clips and one of long_t clips ("long", in
    frameqa's train split and count's test split only, so t_pad 128 sends
    t2s's K1 and K2 through "wide" past 64 kv rows), and each task's
    train and test TSVs in the public format.  Returns {task: (train tsv,
    test tsv)} and the feature directory."""
    rng = np.random.default_rng(seed)
    feats = os.path.join(root, "feats")
    os.makedirs(feats, exist_ok=True)
    gifs = [f"gif{i:03d}" for i in range(n_gifs)]
    for g in gifs:
        t = int(rng.integers(t_range[0], t_range[1] + 1))
        np.save(os.path.join(feats, g + ".npy"), rng.standard_normal((t, s, dv), dtype=np.float32))
    np.save(os.path.join(feats, "long.npy"), rng.standard_normal((long_t, s, dv), dtype=np.float32))
    text = lambda lo, hi: " ".join(rng.choice(TGIF_WORDS, size=int(rng.integers(lo, hi))))
    splits = {}
    for task in TGIF_TASKS:
        for split, n in (("train", n_train), ("test", n_test)):
            names = list(rng.choice(gifs, size=n))
            if (task, split) in (("frameqa", "train"), ("count", "test")):
                names[0] = "long"
            if task in ("action", "transition"):
                lines = ["gif_name\tquestion\ta1\ta2\ta3\ta4\ta5\tanswer"] + [
                    f"{g}\t{text(4, 12)}\t" + "\t".join(text(1, 5) for _ in range(5))
                    + f"\t{rng.integers(0, 5)}" for g in names]
            elif task == "count":
                lines = ["gif_name\tquestion\tanswer"] + [
                    f"{g}\thow many times does the man {text(1, 4)}\t{rng.integers(1, 11)}"
                    for g in names]
            else:
                lines = ["gif_name\tquestion\tanswer"] + [
                    f"{g}\t{text(4, 20)}\t{rng.choice(TGIF_WORDS[-8:])}" for g in names]
            path = os.path.join(root, f"{split}_{task}.tsv")
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            splits.setdefault(task, []).append(path)
    return splits, feats


def tgif_grads_agree(task, names, loss_k, grads_k, loss_p, grads_p):
    """One train step's loss (5e-4 relative) and gradients (5e-4 +
    5e-3·|g|; the key biases', analytically zero, to 5e-4) on the kernel
    path against the plain path; returns the largest differences."""
    import torch

    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if loss_rel > TGIF_TOL:
        raise AssertionError(f"TGIF {task} train loss: kernels {loss_k.item()} against "
                             f"plain {loss_p.item()}")
    worst = 0.0
    for name, a, b in zip(names, grads_k, grads_p):
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        rtol = 0.0 if name.endswith("wk.b") else 5e-3
        if not torch.allclose(a, b, rtol=rtol, atol=TGIF_TOL):
            raise AssertionError(f"TGIF {task} gradient {name}: kernels and plain differ "
                                 f"by {err:.3e}")
    return loss_rel, worst


def tgif_kernels_against_plain(device, task, params, cfg, batch):
    """(a) for one task: the forward through the kernels (4 K1 launches)
    against `dispatch.force_plain()` within 5e-4, then one train step's
    loss and gradients at dropout 0 (4 K1 with residuals, 4 K2)."""
    import torch

    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.ops import dispatch
    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.tasks.tgifqa import TGIFTask, tgif_forward, tgif_loss
    from bist_tpu_torch.train.loop import trainable
    from bist_tpu_torch.weights import tree_leaves

    cuda = device.type == "cuda"
    t = TGIFTask(task)
    b = to_device(batch, device)
    before = hop1_fused.launches
    with torch.no_grad():
        got = tgif_forward(params, cfg, b.query, b.fts, t)
        with dispatch.force_plain():
            want = tgif_forward(params, cfg, b.query, b.fts, t)
    fwd_launches = hop1_fused.launches - before
    if cuda and fwd_launches != 4:
        raise AssertionError(f"TGIF {task} forward: K1 launched {fwd_launches} times, "
                             f"expected 4 (2 layers, t2s and s2t)")
    err = (got - want).abs().max().item()
    if not (torch.isfinite(got).all() and torch.allclose(got, want, rtol=TGIF_TOL,
                                                          atol=TGIF_TOL)):
        raise AssertionError(f"TGIF {task} forward: kernels and plain differ by {err:.3e}")

    params = trainable(params)
    leaves = tree_leaves(params)

    def loss_grads():
        loss, _ = tgif_loss(params, cfg, b, t)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss, [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]

    before = hop1_fused.launches, hop1_bwd.launches
    loss_k, grads_k = loss_grads()
    step_launches = (hop1_fused.launches - before[0], hop1_bwd.launches - before[1])
    if cuda and step_launches != (4, 4):
        raise AssertionError(f"TGIF {task} train step: K1, K2 launched {step_launches} "
                             f"times, expected 4 each")
    with dispatch.force_plain():
        loss_p, grads_p = loss_grads()
    loss_rel, grad_err = tgif_grads_agree(task, leaf_names(params), loss_k, grads_k,
                                          loss_p, grads_p)
    return {"rows": int(b.query.shape[0]), "fts": list(b.fts.shape),
            "forward_max_abs_err": err, "loss_rel_err": loss_rel,
            "grad_max_abs_err": grad_err, "launches": {"forward_k1": fwd_launches,
                                                       "step_k1_k2": list(step_launches)}}


def run_tgif_cli(device, argv):
    """The train_tgif CLI in this process (its `main`, as `python -m` runs
    it) under torch.profiler on the card, the wrappers' counts zeroed
    before: returns its log lines, the wrappers' K1 and K2 launches and the
    kernels the card ran by name (`hop1_ran`)."""
    import logging

    from bist_tpu_torch.cli import train_tgif
    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    root = logging.getLogger()
    handler, level = Keep(level=logging.INFO), root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    reset_hop1_counts()
    hop1_bwd.launches, hop1_bwd.variants = 0, {}
    prof = profiler_window(device)
    try:
        with prof:
            train_tgif.main(argv)
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    wrappers = {"k1": hop1_fused.launches, "k2": hop1_bwd.launches}
    ran = hop1_ran(prof) if device.type == "cuda" else None
    return lines, wrappers, ran


def tgif_cli_checks(device, task, dropout, lines, wrappers, ran, n_train, n_test, B, epochs):
    """The CLI run's log read back and its kernels held to what its steps
    must launch: with dropout 0, K1 4 a step and 4 a test batch, K2 4 a
    step by name (a geometry's first step is its eager warm-up; a capture
    runs nothing), and through the wrappers K1 and K2 8 a captured geometry
    (warm-up and capture) and K1 4 a test batch; with dropout hop 1 trains
    on the plain path, so K1 only in the test split and no K2."""
    import math

    def logged(marker):
        return [json.loads(ln.split(marker, 1)[1]) for ln in lines if marker in ln]

    feeds = [logged(f"epoch {e + 1} train feed: ") for e in range(epochs)]
    stats = [logged(f"epoch {e + 1} train program: ") for e in range(epochs)]
    test = [ln for ln in lines if ln.startswith("TEST ")]
    saved = [ln for ln in lines if ln.startswith("saved ")]
    if not (all(len(f) == 1 for f in feeds + stats) and len(test) == 1 and saved):
        raise AssertionError(f"TGIF CLI {task}: log lines missing:\n" + "\n".join(lines[-20:]))
    steps = sum(f[0]["steps"] for f in feeds)
    test_batches = math.ceil(n_test / B)
    st = stats[-1][0]
    if steps != epochs * (n_train // B) or test[0].split()[-2] != str(n_test):
        raise AssertionError(f"TGIF CLI {task}: {steps} steps, {test[0]!r}")
    metric = float(test[0].split(": ")[1].split()[0])
    if not math.isfinite(metric):
        raise AssertionError(f"TGIF CLI {task}: {test[0]}")
    cuda = device.type == "cuda"
    if cuda and not st["captures"] == st["eager_runs"] == st["geometries"] > 0:
        raise AssertionError(f"TGIF CLI {task}: program stats {st}: a geometry stepped "
                             f"eagerly")
    if cuda:
        want_wrappers = {"k1": 4 * test_batches + (0 if dropout else 8 * st["captures"]),
                         "k2": 0 if dropout else 8 * st["captures"]}
        by_name = {k: sum(v.values()) for k, v in ran.items()}
        want_by_name = {"k1": 4 * test_batches + (0 if dropout else 4 * steps),
                        "k2": 0 if dropout else 4 * steps}
        if wrappers != want_wrappers or by_name != want_by_name:
            raise AssertionError(f"TGIF CLI {task}, dropout {dropout}: K1/K2 through the "
                                 f"wrappers {wrappers} (expected {want_wrappers}), by "
                                 f"name {ran} (expected {want_by_name})")
    return {"task": task, "dropout": dropout, "steps": steps, "test_batches": test_batches,
            "test": test[0], "metric": metric,
            "examples_per_s": [f[0]["examples_per_s"] for f in feeds],
            "epoch_seconds": [f[0]["seconds"] for f in feeds],
            "program": st, "wrapper_launches": wrappers, "by_name": ran}


def tgif_step_speed(device, task, params, cfg, batch, eager_steps=10, replays=20):
    """(c) one geometry: the eager step and the StepProgram's replays on
    the same device batch from copies of one state, ms/step (median after
    the first); 3 replays under torch.profiler: K1 and K2 4 a replay each by
    name, all "whole" at T <= 64, the card's busy share of them (the union
    of its kernels' intervals) and its top kernels a step."""
    import torch

    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.tasks.tgifqa import (TGIFTask, create_tgif_train_state,
                                             make_tgif_train_step, tgif_optimizer)
    from bist_tpu_torch.train.compiled import StepProgram

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t = TGIFTask(task)
    b = to_device(batch, device)
    tx = tgif_optimizer(1e-3)
    step = make_tgif_train_step(cfg, t, tx)

    def timed(fn, state, n):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            state, m = fn(state, b)
            sync()
            times.append(time.perf_counter() - t0)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"TGIF {task} step: loss {float(m['loss'])}")
        return state, statistics.median(times[1:]) * 1e3

    _, eager_ms = timed(step, create_tgif_train_state(params, tx), eager_steps)
    state = create_tgif_train_state(params, tx)
    prog = StepProgram(state, step, label=f"tgif {task} train step")
    state, replayed_ms = timed(prog, state, replays)
    out = {"rows": int(b.query.shape[0]), "fts": list(b.fts.shape), "eager_ms_per_step": eager_ms,
           "replayed_ms_per_step": replayed_ms,
           "replayed_examples_per_s": len(batch.label) / replayed_ms * 1e3,
           "stats": prog.stats()}
    if cuda:
        with profiler_window(device) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                state, _ = prog(state, b)
            sync()
            wall = time.perf_counter() - t0
        ran = hop1_ran(prof)
        if ran != {"k1": dict(K1_NONE, whole=12), "k2": dict(K2_NONE, whole=12)}:
            raise AssertionError(f"TGIF {task}: K1, K2 kernels in 3 replays by name {ran}, "
                                 f"expected 12 \"whole\" each (4 a step)")
        tl = device_timeline(prof)
        out.update(replayed_by_name=ran, device_ms_per_step=tl["busy_ms"] / 3,
                   busy_share=tl["busy_ms"] / (wall * 1e3),
                   top_kernels_per_step=[dict(k, ms=k["ms"] / 3, calls=k["calls"] / 3)
                                         for k in tl["top_kernels"]])
    return out


def tgif_heldout(device, steps=400, seed=0):
    """(d) tests/test_tgifqa.py's held-out Transition proof at its tiny
    configuration (d_model 16, 2 heads, 2 video blocks, Dv 12: K1 and K2
    "tiled"): `steps` replayed steps of Adam at 3e-3 on fresh batches of 16,
    then 48 held-out examples scored eagerly; accuracy above 0.6 (chance
    0.2)."""
    import torch

    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.tasks.tgifqa import (TGIFTask, create_tgif_train_state,
                                             init_tgif_model, make_tgif_train_step,
                                             tgif_loss, tgif_optimizer)
    from bist_tpu_torch.train.compiled import StepProgram

    tiny = dict(TGIF_TINY)
    cfg = tgif_cfg(40, **tiny)
    t = TGIFTask.TRANSITION
    gen = mc_heldout_batches(np.random.default_rng(seed), transition=True, D=tiny["dv"])
    params = init_tgif_model(torch.Generator().manual_seed(1), cfg, t, device=device)
    tx = tgif_optimizer(3e-3)
    state = create_tgif_train_state(params, tx)
    prog = StepProgram(state, make_tgif_train_step(cfg, t, tx), label="tgif heldout")
    before = hop1_fused.launches, hop1_bwd.launches
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = prog(state, gen(16))
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = (hop1_fused.launches - before[0], hop1_bwd.launches - before[1])
    st = prog.stats()
    if device.type == "cuda" and (launches != (8, 8) or st["captures"] != 1):
        raise AssertionError(f"TGIF held-out: K1, K2 through the wrappers {launches}, "
                             f"stats {st}: expected one capture (8 each), then replays")
    with torch.no_grad():
        _, metrics = tgif_loss(state.params, cfg, to_device(gen(48), device), t)
    acc = float(metrics["acc"])
    if not acc > 0.6:
        raise AssertionError(f"TGIF held-out Transition: accuracy {acc} after {steps} "
                             f"replayed steps (chance 0.2, required > 0.6)")
    return {"steps": steps, "heldout_acc": acc, "seconds": seconds,
            "last_loss": float(m["loss"]), "wrapper_launches": list(launches)}


def phase_tgif(device, root, model_kw=None, dv=DV, s=S, n_train=64, n_test=40, B=32,
               t_range=(8, 40), long_t=70, speed_T=32, heldout_steps=400):
    """TGIF-QA on the card at the train_tgif CLI's width (d_model 128, 8
    heads, 2 video blocks, Dv 2048, S 16; `model_kw` narrows it for a CPU
    rehearsal):

      (a) per task, `tgif_forward` through the kernels against
          force_plain() and one train step's loss and gradients
          (`tgif_kernels_against_plain`);
      (b) the CLI for each task at --dropout 0 (hop 1 trains through K1
          with residuals and K2) and for count at the default 0.1 (hop 1
          trains on the plain path, the test split runs K1), 2 epochs on
          synthetic splits (`write_tgif_dataset`), each run's kernels
          counted by name and through the wrappers (`tgif_cli_checks`);
      (c) replayed against eager ms/step at one geometry, frameqa B and
          action B·5 at T speed_T (`tgif_step_speed`);
      (d) the held-out Transition proof (`tgif_heldout`).
    Returns the readings."""
    import torch

    from bist_tpu_torch.tasks.tgifqa import TGIFTask, init_tgif_model

    kw = dict(model_kw or {})
    width = dict(d_model=kw.get("d_model", 128), att_h=kw.get("att_h", 8),
                 nb_venc_blocks=kw.get("nb_venc_blocks", 2))
    cuda = device.type == "cuda"
    out = {"width": dict(width, dv=dv, s=s)}
    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    vocab_size = 30
    kernels, speed = {}, {}
    for task in TGIF_TASKS:
        cfg = tgif_cfg(vocab_size, dv=dv, **width)
        params = init_tgif_model(torch.Generator().manual_seed(0), cfg, TGIFTask(task),
                                 device=device)
        batch = tgif_batch(rng, task, 8, 32, 16, vocab_size, dv=dv, s=s)
        kernels[task] = tgif_kernels_against_plain(device, task, params, cfg, batch)
        if task in ("frameqa", "action"):
            big = tgif_batch(rng, task, B, speed_T, 16 if task == "frameqa" else 32,
                             vocab_size, dv=dv, s=s)
            speed[task] = tgif_step_speed(device, task, params, cfg, big)
            del big
        del params
    out["kernels_against_plain"], out["step_speed"] = kernels, speed
    out["seconds_a_c"] = time.perf_counter() - t0
    log(f"TGIF kernels against plain: {json.dumps(kernels)}")
    log(f"TGIF step speed: {json.dumps(speed)}")

    t0 = time.perf_counter()
    splits, feats = write_tgif_dataset(root, n_train, n_test, t_range=t_range, long_t=long_t,
                                       dv=dv, s=s)
    width_args = ["--d-model", str(width["d_model"]), "--att-h", str(width["att_h"]),
                  "--nb-venc-blocks", str(width["nb_venc_blocks"])]
    runs = []
    for task, dropout in [(t, 0.0) for t in TGIF_TASKS] + [("count", 0.1)]:
        train, test = splits[task]
        argv = ["--task", task, "--train-tsv", train, "--test-tsv", test,
                "--feature-path", feats, "--model", os.path.join(root, "exp", f"{task}_{dropout}"),
                "--num-epochs", "2", "--batch-size", str(B), "--device", device.type] \
            + width_args + ([] if dropout == 0.1 else ["--dropout", str(dropout)])
        lines, wrappers, ran = run_tgif_cli(device, argv)
        runs.append(tgif_cli_checks(device, task, dropout, lines, wrappers, ran, n_train,
                                    n_test, B, 2))
        log(f"TGIF CLI: {json.dumps(runs[-1])}")
        if cuda:
            torch.cuda.empty_cache()
    if cuda:
        for run, name in ((runs[0], "frameqa"), (runs[4], "count")):
            # the 70-clip GIF: t2s at t_pad 128 through "wide" (frameqa trains
            # on it, count scores it), the rest through "whole"
            k1 = run["by_name"]["k1"]
            if not (k1["wide"] > 0 and k1["whole"] > 0 and k1["tiled"] == 0):
                raise AssertionError(f"TGIF CLI {name}: K1 by name {run['by_name']}: no "
                                     f"\"wide\" for the 70-clip GIF, or a \"tiled\"")
        k2 = runs[0]["by_name"]["k2"]
        if not (k2["wide"] > 0 and k2["tiled"] == 0):
            raise AssertionError(f"TGIF CLI frameqa: K2 by name {runs[0]['by_name']}: no "
                                 f"\"wide\" for the 70-clip GIF, or a \"tiled\"")
    out["cli"] = runs
    out["cli_seconds"] = time.perf_counter() - t0

    out["heldout"] = tgif_heldout(device, steps=heldout_steps)
    log(f"TGIF held-out Transition: {json.dumps(out['heldout'])}")
    return out


# ---------------------------------------------------------------------------
# phase 14: the data-parallel layer


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_train_setup(device, B=32, model_kw=None):
    """Phase 6's training set-up: the flagship without dropout, Noam-Adam
    (warm-up 10), the start state from seed 0 and 2 batches of B real turns
    (numpy seed 1)."""
    from bist_tpu_torch.config import TrainConfig
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.train.loop import create_train_state
    from bist_tpu_torch.vocab import get_vocabulary

    vocab = get_vocabulary(TEST_JSON, cutoff=3, include_caption="summary")
    cfg = flagship_cfg(len(vocab), **dict(model_kw or {}, dropout=0.0, attn_dropout=0.0))
    data = load_avsd(TEST_JSON, vocab, include_caption="summary", separate_caption=True)
    tcfg = TrainConfig(warmup_steps=10)
    batches = [to_device(b, device) for b in make_batches(data, 2, B, seed=1, answers=True)]
    state, tx = create_train_state(0, cfg, tcfg, device=device)
    return cfg, tcfg, tx, state, batches


def nccl_kernels(prof):
    """NCCL kernels the card ran in a torch.profiler window (a one-rank
    in-place all-reduce may run none)."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and "nccl" in e.name().lower())


def dp_world_one(device, calls=5, timed=20, B=32, model_kw=None):
    """(a) The TrainProgram built on a one-rank process group (NCCL on the
    card, made by init_process_group directly: init_multihost is a no-op at
    one process): the count, gradient and metric all-reduces are captured
    with the step.  Its first `calls` calls (eager warm-ups and replays)
    against phase 6's program (no group) from the same start on the same
    batches, bit for bit: metrics and parameters.  The collectives issued
    from Python (3 a call in each warm-up and each capture, none in a
    replay), K1 and K2 by kernel name in 3 replays (18 "whole" each), and
    ms/step of both programs' replays, alternated in one window."""
    import datetime

    import torch
    import torch.distributed as dist

    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.parallel import DataParallel
    from bist_tpu_torch.parallel.mesh import canonical_device
    from bist_tpu_torch.train.compiled import TrainProgram
    from bist_tpu_torch.weights import tree_leaves

    device = canonical_device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, tcfg, tx, start, batches = dp_train_setup(device, B, model_kw)
    threads = torch.get_num_threads()
    if cuda:
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)    # the CPU's threaded index_put sums in no fixed order
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        dp = DataParallel.in_group(device)

        def run(prog, state, n, times=None):
            out = []
            for i in range(n):
                t0 = time.perf_counter()
                state, m = prog(state, batches[i % len(batches)])
                if times is not None:
                    sync()
                    times.append(time.perf_counter() - t0)
                out.append(m)
            sync()
            return state, out

        s6 = copy_state(start)
        p6 = TrainProgram(s6, cfg, tcfg, tx)
        s6, m6 = run(p6, s6, calls)
        s14 = copy_state(start)
        p14 = TrainProgram(s14, cfg, tcfg, tx, dp=dp)
        reset_hop1_counts()
        hop1_bwd.launches, hop1_bwd.variants = 0, {}
        s14, m14 = run(p14, s14, calls)
        caps = p14.captures
        want = 12 * caps if cuda else 0
        wrappers = {"hop1_fwd": hop1_fused.launches, "hop1_bwd": hop1_bwd.launches}
        if wrappers != {"hop1_fwd": want, "hop1_bwd": want}:
            raise AssertionError(f"dp world 1: wrapper launches {wrappers} for {caps} captures, "
                                 f"expected {want} each (12 a capture)")
        issued = dp.collectives
        if issued != (6 * caps if cuda else 3 * calls):
            raise AssertionError(f"dp world 1: {issued} collectives issued in {calls} calls "
                                 f"({caps} captures)")
        for i, (a, b) in enumerate(zip(m14, m6)):
            if set(a) != set(b) or any(not torch.equal(a[k], b[k]) for k in b):
                raise AssertionError(f"dp world 1, call {i}: metrics {a} against phase 6's {b}")
        names = leaf_names(start.params)
        for name, a, b in zip(names, tree_leaves(s14.params), tree_leaves(s6.params)):
            if not torch.equal(a, b):
                raise AssertionError(f"dp world 1: parameter {name} differs from phase 6's "
                                     f"program's by {(a - b).abs().max().item():.3e}")
        t6, t14 = [], []
        for _ in range(2):          # alternated: A, B, A, B
            s6, _ = run(p6, s6, timed // 2, t6)
            s14, _ = run(p14, s14, timed // 2, t14)
        if cuda and (dp.collectives != issued or p14.captures != caps):
            raise AssertionError("dp world 1: a replay issued a collective from Python or "
                                 "captured again: it stepped eagerly")
        out = {"calls_bit_identical": calls, "captures": caps, "geometries": len(p14._entries),
               "collectives_issued_in_warm_ups_and_captures": issued,
               "wrapper_launches": wrappers,
               "ms_per_step": {"phase6_program": statistics.median(t6) * 1e3,
                               "dp_program": statistics.median(t14) * 1e3},
               "stats": p14.stats()}
        if cuda:
            with profiler_window(device) as prof:
                s14, _ = run(p14, s14, 3)
            ran = hop1_ran(prof)
            if ran != {"k1": dict(K1_NONE, whole=18), "k2": dict(K2_NONE, whole=18)}:
                raise AssertionError(f"dp world 1: K1, K2 kernels in 3 replays by name {ran}, "
                                     f"expected 18 \"whole\" each (6 a step)")
            out.update(replayed_by_name=ran, nccl_kernels_in_3_replays=nccl_kernels(prof))
        return out
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def dp_rank_main(argv) -> int:
    """One rank of (b): `python chip_smoke.py --dp-rank <address> <rank>
    <dir> <device type> <global rows>`.  Joins a 2-rank gloo group on the device (both
    ranks share one card), takes its rows of the global batch, runs the
    data-parallel gradient step eagerly under torch.profiler (K1, K2 by
    kernel name) and the Adam update, checks the ranks' parameters bit for
    bit, tries a TrainProgram on the group (refused on the card), and saves
    what it computed to <dir>/rank<r>.pt."""
    import torch
    import torch.distributed as dist

    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.parallel import DataParallel
    from bist_tpu_torch.train.compiled import TrainProgram
    from bist_tpu_torch.train.loop import make_grad_step
    from bist_tpu_torch.weights import tree_leaves

    address, rank, root, kind, B = argv[0], int(argv[1]), argv[2], argv[3], int(argv[4])
    device = torch.device(kind, 0) if kind == "cuda" else torch.device(kind)
    if kind == "cpu":
        torch.set_num_threads(2)     # two ranks share the host's cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # gloo on the card too: two NCCL ranks cannot share one card
    dist.init_process_group("gloo", init_method=f"tcp://{address}", world_size=2, rank=rank)
    dp = DataParallel.in_group(device)
    cfg, tcfg, tx, state, batches = dp_train_setup(device, B)
    (local,) = dp.shard(batches[0])
    grad_fn = make_grad_step(cfg, tcfg, dp=dp)
    grad_fn(state.params, local)                  # loads the kernels
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    reset_hop1_counts()
    hop1_bwd.launches, hop1_bwd.variants = 0, {}
    with profiler_window(device) as prof:
        loss, metrics, grads = grad_fn(state.params, local)
        sync()
    out = {"rows": int(local.query.shape[0]), "loss": loss.cpu(),
           "metrics": {k: v.cpu() for k, v in metrics.items()},
           "grads": [g.cpu() for g in grads],
           "wrappers": {"hop1_fwd": hop1_fused.launches, "hop1_bwd": hop1_bwd.launches},
           "by_name": hop1_ran(prof) if device.type == "cuda" else None}
    leaves = tree_leaves(state.params)
    tx.update(leaves, grads, state.opt_state)
    out["params"] = [t.detach().cpu() for t in leaves]
    out["identical"] = dp.replicas_identical(state.params)
    try:
        TrainProgram(state, cfg, tcfg, tx, dp=dp)
        out["program_refused"] = None
    except ValueError as e:
        out["program_refused"] = str(e)
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def dp_two_ranks(device, root, B=32, timeout=600, meanwhile=None):
    """(b) Two ranks sharing the one card over gloo, eager steps
    (`dp_rank_main`), each on its B/2 rows of phase 6's first batch of B:
    the loss within 1e-5 and the gradients within 1e-4·max(|g|, 1) of the
    one-process step at the global batch, the ranks' parameters after Adam
    bit-identical, K1 and K2 6 times each in each rank's step by kernel name,
    and a TrainProgram on the gloo group refused on the card.  `meanwhile()`
    runs in this process while the ranks run.  Returns the readings and
    what `meanwhile` returned."""
    import torch

    from bist_tpu_torch.train.loop import make_grad_step

    os.makedirs(root, exist_ok=True)
    address = f"127.0.0.1:{free_port()}"
    logs = [os.path.join(root, f"rank{r}.log") for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as logf:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                           "--dp-rank", address, str(r), root, device.type,
                                           str(B)], stdout=logf, stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        side = meanwhile() if meanwhile is not None else None
        for p, path in zip(procs, logs):
            p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            if p.returncode != 0:
                with open(path) as f:
                    raise AssertionError(f"dp rank exited {p.returncode}:\n{f.read()[-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    cfg, tcfg, tx, state, batches = dp_train_setup(device, B)
    loss, metrics, grads = make_grad_step(cfg, tcfg)(state.params, batches[0])
    names = leaf_names(state.params)
    worst_loss, worst_grad = 0.0, 0.0
    for r, got in enumerate(ranks):
        rel = abs(float(got["loss"]) - float(loss)) / abs(float(loss))
        worst_loss = max(worst_loss, rel)
        if rel > 1e-5:
            raise AssertionError(f"dp rank {r}: loss {float(got['loss'])} against the "
                                 f"one-process {float(loss)}")
        for name, g, w in zip(names, got["grads"], grads):
            w = w.cpu()
            err = (g - w).abs().max().item()
            bound = 1e-4 * max(w.abs().max().item(), 1.0)
            worst_grad = max(worst_grad, err / bound)
            if err > bound:
                raise AssertionError(f"dp rank {r}: gradient {name} differs from the "
                                     f"one-process step's by {err:.3e} (bound {bound:.3e})")
        if not got["identical"]:
            raise AssertionError(f"dp rank {r}: the ranks' checksums differ after Adam")
        if device.type == "cuda":
            if got["by_name"] != {"k1": dict(K1_NONE, whole=6), "k2": dict(K2_NONE, whole=6)}:
                raise AssertionError(f"dp rank {r}: K1, K2 by name {got['by_name']}, "
                                     f"expected 6 \"whole\" each")
            if not (got["program_refused"] and "cannot be captured" in got["program_refused"]):
                raise AssertionError(f"dp rank {r}: a TrainProgram on a gloo group on the card "
                                     f"was not refused: {got['program_refused']}")
    a, b = ranks
    differ = [n for n, x, y in zip(names, a["params"], b["params"]) if not torch.equal(x, y)]
    if differ:
        raise AssertionError(f"dp ranks: parameters differ after Adam: {differ[:4]}")
    return {"ranks": 2, "rows_each": [r["rows"] for r in ranks], "seconds": seconds,
            "loss_max_rel_err": worst_loss, "grad_max_err_over_bound": worst_grad,
            "params_bit_identical": True,
            "by_name": [r["by_name"] for r in ranks],
            "wrappers": [r["wrappers"] for r in ranks],
            "program_refused": ranks[0]["program_refused"]}, side


def export_dp_bundle(device, cli_root, root, s=S, t_max=T_MAX, maxlen=4):
    """`export.save_bundle(dp=2)` of phase 5's model <cli_root>/mtn into
    <root>/dp2_bundle at the serve CLI's geometry for batch bucket 8 (LQ/LH/LC
    tokens, t_max clips of (s, Dv)): one greedy program of 4 rows, float32
    cache, `maxlen` steps (the trace grows with them).  Returns its
    seconds."""
    from bist_tpu_torch.config import GenerateConfig, load_conf
    from bist_tpu_torch.export import default_serving_geometries, save_bundle
    from bist_tpu_torch.weights import load_params

    t0 = time.perf_counter()
    vocab, cfg, _, _ = load_conf(os.path.join(cli_root, "mtn.conf"))
    params = load_params(os.path.join(cli_root, "mtn.pt"), device)
    geoms = default_serving_geometries(cfg, batch_buckets=(8,), Lq=LQ, Lh=LH, Lc=LC,
                                       T=t_max, S=s, Ta=t_max if cfg.has_audio else None)
    save_bundle(os.path.join(root, "dp2_bundle"), params, cfg,
                GenerateConfig(maxlen=maxlen, nbest=1, decode_style="greedy",
                               cache_dtype="float32"), vocab, geoms, dp=2)
    return time.perf_counter() - t0


def dp_serving(device, model, fields, root, export_s, group=64, dv=DV, s=S, t_max=T_MAX):
    """(c) A Responder over [device, device] (two replicas on the one card)
    against the one-device Responder at phase 8's geometry: the same answers
    and n-best words for every request, in groups of `group`, K1 by kernel
    name in the replays of 4 batches (6 a replica a batch); then the dp 2
    bundle (`export_dp_bundle`, one program of 4 rows, exported in
    `export_s` seconds) served on the same pair against the one-device greedy
    Responder of its model, in groups of 8, K1 counted likewise."""
    import torch

    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.export import load_bundle
    from bist_tpu_torch.ops.bist_kernels import hop1_fused
    from bist_tpu_torch.parallel.mesh import canonical_device
    from bist_tpu_torch.serving import Responder

    device = canonical_device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    vocab, cfg, params = model

    def buckets(rows, dim):
        return dict(max_batch=rows, batch_buckets=(rows,),
                    len_buckets={"q": (LQ,), "h": (LH,), "c": (LC,)}, time_buckets=(t_max,),
                    feat_tail=(s, dim))

    def answer(rsp, rows):
        """The answers and n-best words of every request, in groups of `rows`,
        and the seconds; then K1 by kernel name in the replays of a profiled
        window of the first 4 groups again (a window of every group of the
        bundle's greedy decode, ~190,000 kernels, lost some of the trace's
        records)."""
        reqs = [rsp.make_request(**f) for f in fields]
        reset_hop1_counts()
        before = rsp.stats()
        t0 = time.perf_counter()
        for i in range(0, len(reqs), rows):
            rsp.respond(reqs[i:i + rows])
        sync()
        seconds = time.perf_counter() - t0
        ran = None
        if cuda:
            with profiler_window(device) as prof:
                for i in range(0, 4 * rows, rows):
                    rsp.respond([rsp.make_request(**f) for f in fields[i:i + rows]])
                sync()
            ran = k1_ran(prof)
        after = rsp.stats()
        if after["captures"] != before["captures"] or hop1_fused.launches:
            raise AssertionError(f"dp serving: the window captured or launched K1 eagerly "
                                 f"({before} -> {after}, {hop1_fused.launches} launches)")
        return [(r._answer, [w for w, _ in r._nbest]) for r in reqs], ran, seconds

    def agree(what, got, want, ran):
        bad = [i for i in range(len(want)) if got[i] != want[i]]
        if bad:
            raise AssertionError(f"{what}: {len(bad)} of {len(want)} answers differ from one "
                                 f"device's, e.g. request {bad[0]}: {got[bad[0]]} against "
                                 f"{want[bad[0]]}")
        k1 = dict(K1_NONE, whole=6 * 2 * 4)         # 6 a replica a batch, 4 batches
        if cuda and ran != k1:
            raise AssertionError(f"{what}: K1 by name {ran} in 4 batches of the pair's "
                                 f"replays, expected {k1}")

    out = {"requests": len(fields), "devices": [str(device)] * 2}
    beam = GenerateConfig(**GEN)
    one = Responder(params, cfg, vocab, beam, **buckets(group, dv))
    two = Responder(params, cfg, vocab, beam, devices=[device, device], **buckets(group, dv))
    for rsp in (one, two):
        rsp.warmup(feature_shape=(s, dv), t_clips=min(8, t_max))
    want, _, t_one = answer(one, group)
    got, ran, t_two = answer(two, group)
    agree("dp serving, beam search", got, want, ran)
    out["responder"] = {"group": group, "identical": len(want), "k1_by_name_4_batches": ran,
                        "seconds_one": t_one, "seconds_pair": t_two,
                        "stats_pair": two.stats()}
    del one, two

    bundle = load_bundle(os.path.join(root, "dp2_bundle"), device)
    pair = bundle.make_responder(devices=[device, device])
    pair.warmup_geometries(bundle.geometries.values())
    one = Responder(bundle.params, bundle.cfg, bundle.vocab, bundle.gcfg,
                    **buckets(8, bundle.cfg.ft_sizes[0]))
    one.warmup(feature_shape=(s, bundle.cfg.ft_sizes[0]), t_clips=min(8, t_max))
    want, _, t_b1 = answer(one, 8)
    got, ran, t_b = answer(pair, 8)
    agree("dp 2 bundle", got, want, ran)
    out["bundle"] = {"dp": bundle.dp, "geometries": sorted(bundle.geometries),
                     "program_rows": 4, "identical": len(want), "k1_by_name_4_batches": ran,
                     "export_seconds": export_s, "seconds_one": t_b1, "seconds_pair": t_b}
    if cuda:
        torch.cuda.empty_cache()
    return out


def phase_data_parallel(device, root, model, fields, cli_root, phase6_ms=None, model_kw=None,
                        B=32, group=64, dv=DV, s=S, t_max=T_MAX):
    """Phase 14: the data-parallel layer on one card: (a) `dp_world_one`,
    (b) `dp_two_ranks`, (c) `dp_serving`.  The dp 2 bundle of phase 5's
    model under <cli_root> is exported in this process while (b)'s two
    rank processes run.  Returns their readings."""
    t0 = time.perf_counter()
    out = {"world_one": dp_world_one(device, B=B, model_kw=model_kw)}
    out["world_one"]["phase6_replayed_ms_per_step"] = phase6_ms
    log(f"dp world 1: {json.dumps(out['world_one'])}")
    out["two_ranks"], export_s = dp_two_ranks(
        device, os.path.join(root, "ranks"), B=B,
        meanwhile=lambda: export_dp_bundle(device, cli_root, root, s=s, t_max=t_max))
    log(f"dp two ranks: {json.dumps(out['two_ranks'])}")
    out["serving"] = dp_serving(device, model, fields, root, export_s, group=group, dv=dv,
                                s=s, t_max=t_max)
    log(f"dp serving: {json.dumps(out['serving'])}")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 15: tensor parallelism


def grads_within_bound(what, names, got, want):
    """Each gradient leaf within phase 6's bound, 5e-4 + 5e-3·|g| (wk.b, a
    zero gradient with round-off, 5e-4); returns the largest error over
    the bound."""
    worst = 0.0
    for name, a, b in zip(names, got, want):
        rtol = 0.0 if name.endswith("wk.b") else 5e-3
        err = (a - b).abs()
        bound = 5e-4 + rtol * b.abs()
        worst = max(worst, float((err / bound).max()))
        if not bool((err <= bound).all()):
            raise AssertionError(f"{what}: gradient {name} differs from one device's by "
                                 f"{err.max().item():.3e}")
    return worst


def tp_beam_setup(device, rows=64, model_kw=None):
    """Phase 3's model (the flagship, random weights from seed 0) and its
    first batch of `rows` undisclosed test turns (numpy seed 0), with
    phase 3's beam search settings."""
    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.models.model import init_model
    from bist_tpu_torch.vocab import get_vocabulary

    vocab = get_vocabulary(TEST_JSON, cutoff=3, include_caption="summary")
    cfg = flagship_cfg(len(vocab), **(model_kw or {}))
    data = load_avsd(TEST_JSON, vocab, include_caption="summary", separate_caption=True,
                     undisclosed_only=True)
    batch = to_device(make_batches(data, 1, rows, seed=0)[0], device)
    return cfg, GenerateConfig(**GEN), init_model(0, cfg, device=device), batch


def eager_steps_ms(step, state, batches, steps, sync):
    """`steps` eager train steps on the batches in turn, each timed from
    the host with the device synchronised after it: (state, ms a step)."""
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        state, _ = step(state, batches[i % len(batches)])
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, times


def tp_rank_main(argv) -> int:
    """One rank of phase 15: `python chip_smoke.py --tp-rank <address> <rank>
    <dir> <device type> <train rows> <beam rows> <steps> [<model widths as
    JSON>]`.  Joins a 2-rank gloo group on the device (both ranks share one
    card), builds a (1 data × 2 model) mesh, and on this rank's shards of
    phase 6's start state runs the gradient step eagerly under
    torch.profiler (K1, K2 by kernel name), its gradients gathered to full
    leaves, then, once the parent process has left the card
    (<dir>/refs.done), `steps` eager Adam steps (timed), the same again
    with each model-axis all-reduce timed between two synchronisations of
    the device, then beam search of phase 3's model on one batch inside
    `tensor_parallel`; saves what it computed to <dir>/rank<r>.pt."""
    import torch
    import torch.distributed as dist

    from bist_tpu_torch.decode.beam import beam_search
    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.parallel import (DataParallel, TensorParallel, gather_params,
                                         make_mesh, shard_params, tensor_parallel)
    from bist_tpu_torch.parallel import tp as tp_mod
    from bist_tpu_torch.train.loop import (TrainState, make_grad_step, make_train_step,
                                           trainable)
    from bist_tpu_torch.weights import tree_leaves, tree_map

    address, rank, root, kind = argv[0], int(argv[1]), argv[2], argv[3]
    B, rows, steps = int(argv[4]), int(argv[5]), int(argv[6])
    model_kw = json.loads(argv[7]) if len(argv) > 7 else None
    device = torch.device(kind, 0) if kind == "cuda" else torch.device(kind)
    if kind == "cpu":
        torch.set_num_threads(2)     # two ranks share the host's cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # gloo on the card too: two NCCL ranks cannot share one card
    dist.init_process_group("gloo", init_method=f"tcp://{address}", world_size=2, rank=rank)
    mesh = make_mesh(model_axis=2, device_type=kind)
    tp = TensorParallel.from_mesh(mesh)
    dp = DataParallel.in_group(device, mesh)
    cfg, tcfg, tx, state, batches = dp_train_setup(device, B, model_kw)
    local = [dp.shard(b)[0] for b in batches]
    params = trainable(shard_params(state.params, tp))
    del state
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    grad_fn = make_grad_step(cfg, tcfg, dp=dp, tp=tp)
    grad_fn(params, local[0])                     # warm-up
    sync()
    reset_hop1_counts()
    hop1_bwd.launches, hop1_bwd.variants = 0, {}
    tp_mod.counts.update(all_reduces=0, bytes=0)
    with profiler_window(device) as prof:
        loss, _, grads = grad_fn(params, local[0])
        sync()
    step_reduces = dict(tp_mod.counts)
    it = iter(grads)
    full = gather_params(tree_map(lambda _: next(it).clone(), params), tp)
    out = {"mesh": (mesh.mesh.tolist(), mesh.mesh_dim_names), "model": (tp.rank, tp.size),
           "data": (dp.rank, dp.n), "loss": loss.cpu(),
           "grads": [g.cpu() for g in tree_leaves(full)],
           "wrappers": {"hop1_fwd": hop1_fused.launches, "hop1_bwd": hop1_bwd.launches},
           "by_name": hop1_ran(prof) if device.type == "cuda" else None,
           "model_all_reduces_a_step": step_reduces}
    st = TrainState(params, tx.init(tree_leaves(params)), 0)
    step = make_train_step(cfg, tcfg, tx, dp=dp, tp=tp)
    flag, deadline = os.path.join(root, "refs.done"), time.monotonic() + 300
    while not os.path.exists(flag):         # the parent's references off the card
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {flag} after 300 s")
        time.sleep(0.05)
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        st, m = step(st, local[i % 2])
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    out["ms_per_step"] = statistics.median(times[1:] or times)
    out["step_ms"], out["losses"] = times, losses
    # the same steps with every model-axis all-reduce timed, the device
    # synchronised before and after it (the wait for the peer rank included)
    reduce_s, untimed = [0.0], tp_mod._all_reduce

    def timed_reduce(x, group):
        sync()
        t0 = time.perf_counter()
        y = untimed(x, group)
        sync()
        reduce_s[0] += time.perf_counter() - t0
        return y

    tp_mod._all_reduce = timed_reduce
    try:
        timed = []
        for i in range(steps):
            reduce_s[0] = 0.0
            t0 = time.perf_counter()
            st, _ = step(st, local[i % 2])
            sync()
            timed.append(((time.perf_counter() - t0) * 1e3, reduce_s[0] * 1e3))
    finally:
        tp_mod._all_reduce = untimed
    out["timed_step_ms"] = [t for t, _ in timed]
    out["reduce_ms"] = [r for _, r in timed]
    out["reduce_share"] = statistics.median(r / t for t, r in (timed[1:] or timed))
    del st, step, grad_fn, params
    bcfg, gcfg, bparams, bbatch = tp_beam_setup(device, rows, model_kw)
    shards = shard_params(bparams, tp)
    del bparams
    reset_hop1_counts()
    tp_mod.counts.update(all_reduces=0, bytes=0)
    t0 = time.perf_counter()
    with tensor_parallel(tp):
        res = beam_search(shards, bcfg, bbatch, gcfg)
    sync()
    out["beam_seconds"] = time.perf_counter() - t0
    out["beam_model_all_reduces"] = dict(tp_mod.counts)
    out["beam_k1_wrapper"] = hop1_fused.launches
    out["beam_tokens"] = res.tokens.cpu()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def phase_tensor_parallel(device, root, B=32, rows=64, steps=5, timeout=600,
                          model_kw=None):
    """Phase 15: tensor parallelism on one card.  Two ranks sharing the card
    over gloo (`tp_rank_main`) at a (1 data × 2 model) mesh of the flagship
    (4 of its 8 heads a rank): one train step at dropout 0 on phase 6's
    first batch of B against the one-device eager step (this process, while
    the ranks run): the loss within 5e-4 relative and each gathered
    gradient within phase 6's bound (5e-4 + 5e-3·|g|); K1 and K2 0 times in
    the TP step, by kernel name, where the one-device step launches 6 each;
    then one `rows`-row beam batch of phase 3's model (beam 5, maxlen 12):
    the tokens of one device.  Returns the readings, the eager TP ms/step a
    smoke reading (gloo on one card, not NVLink), with the share of the TP
    step spent in the model axis's all-reduces and, after the ranks exit,
    the one-device eager step with K1/K2 and under `force_plain` (TP's
    hop 1)."""
    import torch

    from bist_tpu_torch.decode.beam import beam_search
    from bist_tpu_torch.ops import dispatch
    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.train.loop import make_grad_step, make_train_step

    t_start = time.perf_counter()
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    os.makedirs(root, exist_ok=True)
    flag = os.path.join(root, "refs.done")
    if os.path.exists(flag):
        os.remove(flag)
    address = f"127.0.0.1:{free_port()}"
    logs = [os.path.join(root, f"rank{r}.log") for r in range(2)]
    extra = [json.dumps(model_kw)] if model_kw else []
    procs = []
    for r in range(2):
        with open(logs[r], "w") as logf:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-rank", address, str(r), root,
                 device.type, str(B), str(rows), str(steps), *extra],
                stdout=logf, stderr=subprocess.STDOUT))
    try:
        # the one-device references while the ranks start
        cfg, tcfg, tx, state, batches = dp_train_setup(device, B, model_kw)
        make_grad_step(cfg, tcfg)(state.params, batches[0])          # warm-up
        sync()
        reset_hop1_counts()
        hop1_bwd.launches, hop1_bwd.variants = 0, {}
        with profiler_window(device) as prof:
            loss, _, grads = make_grad_step(cfg, tcfg)(state.params, batches[0])
            sync()
        one = {"loss": float(loss), "grads": [g.cpu() for g in grads],
               "wrappers": {"hop1_fwd": hop1_fused.launches, "hop1_bwd": hop1_bwd.launches},
               "by_name": hop1_ran(prof) if cuda else None}
        names = leaf_names(state.params)
        del grads
        bcfg, gcfg, bparams, bbatch = tp_beam_setup(device, rows, model_kw)
        tokens = beam_search(bparams, bcfg, bbatch, gcfg).tokens.cpu()
        del bparams
        sync()
        open(flag, "w").close()             # the ranks' timed steps may start
        for p, path in zip(procs, logs):
            p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t_start)))
            if p.returncode != 0:
                with open(path) as f:
                    raise AssertionError(f"tp rank exited {p.returncode}:\n{f.read()[-6000:]}")
        # the one-device eager step alone on the card, as the ranks time it
        step = make_train_step(cfg, tcfg, tx)
        state, kernel_ms = eager_steps_ms(step, state, batches, steps, sync)
        with dispatch.force_plain():
            state, plain_ms = eager_steps_ms(step, state, batches, steps, sync)
        one["ms_per_step"] = {"kernels": statistics.median(kernel_ms[1:] or kernel_ms),
                              "plain": statistics.median(plain_ms[1:] or plain_ms)}
        del state
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    if cuda:
        want = {"k1": dict(K1_NONE, whole=6), "k2": dict(K2_NONE, whole=6)}
        if one["by_name"] != want or one["wrappers"] != {"hop1_fwd": 6, "hop1_bwd": 6}:
            raise AssertionError(f"tp: the one-device step ran K1, K2 {one['by_name']} by "
                                 f"name ({one['wrappers']}), expected 6 \"whole\" each")
    worst_loss, worst_grad = 0.0, 0.0
    for r, got in enumerate(ranks):
        if got["mesh"] != ([[0, 1]], ("data", "model")) or got["model"] != (r, 2):
            raise AssertionError(f"tp rank {r}: mesh {got['mesh']}, model place {got['model']}")
        rel = abs(float(got["loss"]) - one["loss"]) / abs(one["loss"])
        worst_loss = max(worst_loss, rel)
        if rel > 5e-4:
            raise AssertionError(f"tp rank {r}: loss {float(got['loss'])} against one "
                                 f"device's {one['loss']}")
        worst_grad = max(worst_grad, grads_within_bound(f"tp rank {r}", names, got["grads"],
                                                        one["grads"]))
        if cuda and (got["by_name"] != {"k1": dict(K1_NONE),
                                        "k2": dict(K2_NONE)}
                     or got["wrappers"] != {"hop1_fwd": 0, "hop1_bwd": 0}
                     or got["beam_k1_wrapper"] != 0):
            raise AssertionError(f"tp rank {r}: K1, K2 ran under TP: by name {got['by_name']}, "
                                 f"wrappers {got['wrappers']}, beam {got['beam_k1_wrapper']}")
        if not all(np.isfinite(got["losses"])):
            raise AssertionError(f"tp rank {r}: non-finite losses {got['losses']}")
        if not torch.equal(got["beam_tokens"], tokens):
            diff = int((got["beam_tokens"] != tokens).any(-1).any(-1).sum())
            raise AssertionError(f"tp rank {r}: beam tokens differ from one device's in "
                                 f"{diff} of {rows} rows")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"tp: the model ranks' losses differ: {ranks[0]['losses']} "
                             f"against {ranks[1]['losses']}")
    return {"mesh": "1 data x 2 model, gloo, both ranks on one device",
            "heads_a_rank": bcfg.att_h // 2, "train_rows": B, "beam_rows": rows,
            "loss_rel_err": worst_loss, "grad_max_err_over_bound": worst_grad,
            "one_device_by_name": one["by_name"], "tp_by_name": [r["by_name"] for r in ranks],
            "beam_tokens_identical_rows": rows,
            "eager_tp_ms_per_step": [r["ms_per_step"] for r in ranks],
            "eager_tp_step_ms": [r["step_ms"] for r in ranks],
            "timed_tp_step_ms": [r["timed_step_ms"] for r in ranks],
            "model_all_reduce_ms": [r["reduce_ms"] for r in ranks],
            "model_all_reduce_share": [r["reduce_share"] for r in ranks],
            "one_device_eager_ms_per_step": one["ms_per_step"],
            "model_all_reduces_a_step": ranks[0]["model_all_reduces_a_step"],
            "beam_model_all_reduces": ranks[0]["beam_model_all_reduces"],
            "tp_losses": ranks[0]["losses"],
            "beam_seconds": [r["beam_seconds"] for r in ranks],
            "seconds": time.perf_counter() - t_start}


# ---------------------------------------------------------------------------
# phase 16: sequence parallelism

# (b)'s widths: tests/test_sp.py's model on phase 6's batches
SP_TINY = dict(d_model=32, att_h=4, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2)


def sp_rank_main(argv) -> int:
    """One rank of phase 16: `python chip_smoke.py --sp-rank <address> <world>
    <rank> <dir> <device type> <train rows> <beam rows> <steps> <model axis>
    <seq axis> [<model widths as JSON>]`.  Joins a gloo group of <world>
    ranks on the device (all share one card), builds the (data, [model,]
    seq) mesh, takes its block of the long axes of phase 6's first batch
    and runs the gradient step eagerly under torch.profiler (K1, K2 by
    kernel name; with a model axis on this rank's shards, the gradients
    gathered to full leaves), reading the peak memory the step added; then,
    with <steps> > 0, once the parent process has left the card
    (<dir>/refs.done), <steps> eager Adam steps (timed); with <beam rows>
    > 0, beam search of phase 3's model on one batch inside
    `sequence_parallel`; saves what it computed to <dir>/rank<r>.pt."""
    import torch
    import torch.distributed as dist

    from bist_tpu_torch.decode.beam import beam_search
    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.parallel import (DataParallel, SequenceParallel, TensorParallel,
                                         gather_params, make_mesh, sequence_parallel,
                                         shard_params)
    from bist_tpu_torch.parallel import sp as sp_mod
    from bist_tpu_torch.train.loop import (TrainState, make_grad_step, make_train_step,
                                           trainable)
    from bist_tpu_torch.weights import tree_leaves, tree_map

    address, world, rank, root, kind = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    B, rows, steps, model_axis, seq_axis = (int(a) for a in argv[5:10])
    model_kw = json.loads(argv[10]) if len(argv) > 10 else None
    device = torch.device(kind, 0) if kind == "cuda" else torch.device(kind)
    cuda = device.type == "cuda"
    if not cuda:
        torch.set_num_threads(1 if world > 2 else 2)     # the ranks share the host's cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # gloo on the card too: NCCL ranks cannot share one card
    dist.init_process_group("gloo", init_method=f"tcp://{address}", world_size=world, rank=rank)
    mesh = make_mesh(model_axis=model_axis, seq_axis=seq_axis, device_type=kind)
    tp = TensorParallel.from_mesh(mesh) if model_axis > 1 else None
    sp = SequenceParallel.from_mesh(mesh)
    dp = DataParallel.in_group(device, mesh)
    cfg, tcfg, tx, state, batches = dp_train_setup(device, B, model_kw)
    local = [sp_mod.shard_batch(dp.shard(b)[0], sp) for b in batches]
    params = trainable(state.params if tp is None else shard_params(state.params, tp))
    del state
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    grad_fn = make_grad_step(cfg, tcfg, dp=dp, tp=tp, sp=sp)
    grad_fn(params, local[0])                     # warm-up
    sync()
    reset_hop1_counts()
    hop1_bwd.launches, hop1_bwd.variants = 0, {}
    sp_mod.counts.update(all_gathers=0, all_reduces=0, bytes=0)
    before = torch.cuda.memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with profiler_window(device) as prof:
        loss, _, grads = grad_fn(params, local[0])
        sync()
    out = {"mesh": (mesh.mesh.tolist(), mesh.mesh_dim_names), "seq": (sp.rank, sp.size),
           "data": (dp.rank, dp.n), "model": None if tp is None else (tp.rank, tp.size),
           "his_block": int(local[0].his.shape[1]), "t_block": int(local[0].fts.shape[1]),
           "loss": loss.cpu(), "step_counts": dict(sp_mod.counts),
           "wrappers": {"hop1_fwd": hop1_fused.launches, "hop1_bwd": hop1_bwd.launches},
           "variants": {"hop1_fwd": dict(hop1_fused.variants),
                        "hop1_bwd": dict(hop1_bwd.variants)},
           "by_name": hop1_ran(prof) if cuda else None,
           "peak_mb": torch.cuda.max_memory_allocated(device) / 2**20 if cuda else None,
           "step_peak_mb": (torch.cuda.max_memory_allocated(device) - before) / 2**20
           if cuda else None}
    it = iter(grads)
    full = tree_map(lambda _: next(it).clone(), params)
    out["grads"] = [g.cpu() for g in tree_leaves(full if tp is None else
                                                 gather_params(full, tp))]
    del grads, full
    if steps > 0:
        st = TrainState(params, tx.init(tree_leaves(params)), 0)
        step = make_train_step(cfg, tcfg, tx, dp=dp, tp=tp, sp=sp)
        flag, deadline = os.path.join(root, "refs.done"), time.monotonic() + 300
        while not os.path.exists(flag):         # the parent's references off the card
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {flag} after 300 s")
            time.sleep(0.05)
        times, losses = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            st, m = step(st, local[i % 2])
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        out["ms_per_step"] = statistics.median(times[1:] or times)
        out["step_ms"], out["losses"] = times, losses
        del st, step
    del grad_fn, params
    if rows > 0:
        bcfg, gcfg, bparams, bbatch = tp_beam_setup(device, rows, model_kw)
        bbatch = sp_mod.shard_batch(dp.shard(bbatch)[0], sp)
        reset_hop1_counts()
        sp_mod.counts.update(all_gathers=0, all_reduces=0, bytes=0)
        t0 = time.perf_counter()
        with sequence_parallel(sp):
            res = beam_search(bparams, bcfg, bbatch, gcfg)
        sync()
        out["beam_seconds"] = time.perf_counter() - t0
        out["beam_counts"] = dict(sp_mod.counts)
        out["beam_k1_wrapper"] = hop1_fused.launches
        out["beam_tokens"] = res.tokens.cpu()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def start_sp_ranks(device, root, world, B, rows, steps, model_axis, seq_axis, model_kw):
    """`world` processes of `sp_rank_main` on the device, their logs under
    `root`; returns (processes, log paths)."""
    os.makedirs(root, exist_ok=True)
    flag = os.path.join(root, "refs.done")
    if os.path.exists(flag):
        os.remove(flag)
    address = f"127.0.0.1:{free_port()}"
    logs = [os.path.join(root, f"rank{r}.log") for r in range(world)]
    extra = [json.dumps(model_kw)] if model_kw else []
    procs = []
    for r in range(world):
        with open(logs[r], "w") as logf:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--sp-rank", address, str(world),
                 str(r), root, device.type, str(B), str(rows), str(steps), str(model_axis),
                 str(seq_axis), *extra], stdout=logf, stderr=subprocess.STDOUT))
    return procs, logs


def wait_ranks(procs, logs, deadline, what):
    for p, path in zip(procs, logs):
        p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        if p.returncode != 0:
            with open(path) as f:
                raise AssertionError(f"{what} rank exited {p.returncode}:\n{f.read()[-6000:]}")


def one_device_grads(device, B, model_kw, profiled=False):
    """Phase 6's one-device eager gradient step at dropout 0 (K1/K2 as
    dispatched): loss, gradients, leaf names, the peak memory the step
    added; with `profiled`, K1/K2 by kernel name; and the set-up."""
    import torch

    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.train.loop import make_grad_step

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    setup = dp_train_setup(device, B, model_kw)
    cfg, tcfg, _, state, batches = setup
    make_grad_step(cfg, tcfg)(state.params, batches[0])          # warm-up
    sync()
    reset_hop1_counts()
    hop1_bwd.launches, hop1_bwd.variants = 0, {}
    before = torch.cuda.memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with profiler_window(device) if profiled else contextlib.nullcontext() as prof:
        loss, _, grads = make_grad_step(cfg, tcfg)(state.params, batches[0])
        sync()
    return {"loss": float(loss), "grads": [g.cpu() for g in grads],
            "names": leaf_names(state.params),
            "step_peak_mb": (torch.cuda.max_memory_allocated(device) - before) / 2**20
            if cuda else None,
            "wrappers": {"hop1_fwd": hop1_fused.launches, "hop1_bwd": hop1_bwd.launches},
            "by_name": hop1_ran(prof) if cuda and profiled else None}, setup


def phase_sequence_parallel(device, root, B=32, rows=64, steps=5, timeout=600,
                            model_kw=None, tiny_kw=SP_TINY, tiny_B=8):
    """Phase 16: sequence parallelism on one card, its ranks sharing the card
    over gloo (`sp_rank_main`).  (a) Two ranks at a (1 data × 2 seq) mesh of
    the flagship (`model_kw` widths; his and T even, each rank a half): one
    train step at dropout 0 on phase 6's first batch of B against the
    one-device eager step (this process, while the ranks run): the loss
    within 5e-4 relative and each gradient within phase 6's bound; K1 and
    K2 6 times each on each rank by kernel name, all "whole" (t2s at the
    whole T, s2t at T/2 groups), as on one device; the peak memory the step
    added on each rank and on one device; `sp.counts`; then 5 eager SP Adam
    steps timed, and beam search (beam 5, maxlen 12) of phase 3's model on
    one batch of `rows` turns inside `sequence_parallel`: the tokens of one
    device, K1 6 times on each rank.  (b) Four ranks at (1 × 2 model × 2
    seq) at `tiny_kw` widths on phase 6's first `tiny_B` rows, started with
    (a) and done before (a)'s timed steps: one step, the loss and gradients
    against one device.  Returns the readings; ms/step is a smoke reading
    (gloo through the host on one card)."""
    import torch

    from bist_tpu_torch.decode.beam import beam_search
    from bist_tpu_torch.train.loop import make_train_step

    t_start = time.perf_counter()
    deadline = t_start + timeout
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    root_a, root_b = os.path.join(root, "a"), os.path.join(root, "b")
    procs_a, logs_a = start_sp_ranks(device, root_a, 2, B, rows, steps, 1, 2, model_kw)
    procs_b, logs_b = start_sp_ranks(device, root_b, 4, tiny_B, 0, 0, 2, 2, tiny_kw)
    try:
        # the one-device references while the ranks start
        one, (cfg, tcfg, tx, state, batches) = one_device_grads(device, B, model_kw,
                                                                profiled=True)
        tiny, _ = one_device_grads(device, tiny_B, tiny_kw)
        bcfg, gcfg, bparams, bbatch = tp_beam_setup(device, rows, model_kw)
        tokens = beam_search(bparams, bcfg, bbatch, gcfg).tokens.cpu()
        del bparams
        sync()
        wait_ranks(procs_b, logs_b, deadline, "sp (b)")
        open(os.path.join(root_a, "refs.done"), "w").close()     # (a)'s timed steps may start
        wait_ranks(procs_a, logs_a, deadline, "sp (a)")
        # the one-device eager step alone on the card, as the ranks time it
        state, one_ms = eager_steps_ms(make_train_step(cfg, tcfg, tx), state, batches,
                                       steps, sync)
        one["ms_per_step"] = statistics.median(one_ms[1:] or one_ms)
        del state
    finally:
        for p in procs_a + procs_b:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [torch.load(os.path.join(root_a, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    ranks_b = [torch.load(os.path.join(root_b, f"rank{r}.pt"), weights_only=False)
               for r in range(4)]
    whole6 = {"k1": dict(K1_NONE, whole=6), "k2": dict(K2_NONE, whole=6)}
    if cuda and (one["by_name"] != whole6 or one["wrappers"] != {"hop1_fwd": 6,
                                                                  "hop1_bwd": 6}):
        raise AssertionError(f"sp: the one-device step ran K1, K2 {one['by_name']} by name "
                             f"({one['wrappers']}), expected 6 \"whole\" each")
    worst_loss, worst_grad = 0.0, 0.0
    for r, got in enumerate(ranks):
        what = f"sp (a) rank {r}"
        if got["mesh"] != ([[0, 1]], ("data", "seq")) or got["seq"] != (r, 2):
            raise AssertionError(f"{what}: mesh {got['mesh']}, seq place {got['seq']}")
        rel = abs(float(got["loss"]) - one["loss"]) / abs(one["loss"])
        worst_loss = max(worst_loss, rel)
        if rel > 5e-4:
            raise AssertionError(f"{what}: loss {float(got['loss'])} against one device's "
                                 f"{one['loss']}")
        worst_grad = max(worst_grad, grads_within_bound(what, one["names"], got["grads"],
                                                        one["grads"]))
        if cuda and (got["wrappers"] != {"hop1_fwd": 6, "hop1_bwd": 6}
                     or got["beam_k1_wrapper"] != 6 or got["by_name"] != whole6):
            raise AssertionError(f"{what}: K1, K2 launched {got['wrappers']} in the step "
                                 f"({got['by_name']} by name), K1 {got['beam_k1_wrapper']} in "
                                 f"the beam precompute, expected 6 \"whole\" each")
        if not all(np.isfinite(got["losses"])):
            raise AssertionError(f"{what}: non-finite losses {got['losses']}")
        if not torch.equal(got["beam_tokens"], tokens):
            diff = int((got["beam_tokens"] != tokens).any(-1).any(-1).sum())
            raise AssertionError(f"{what}: beam tokens differ from one device's in {diff} "
                                 f"of {rows} rows")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"sp: the seq ranks' losses differ: {ranks[0]['losses']} "
                             f"against {ranks[1]['losses']}")
    worst_b = 0.0
    for r, got in enumerate(ranks_b):
        what = f"sp (b) rank {r}"
        if (got["mesh"] != ([[[0, 1], [2, 3]]], ("data", "model", "seq"))
                or got["model"] != (r // 2, 2) or got["seq"] != (r % 2, 2)):
            raise AssertionError(f"{what}: mesh {got['mesh']}, model {got['model']}, "
                                 f"seq {got['seq']}")
        rel = abs(float(got["loss"]) - tiny["loss"]) / abs(tiny["loss"])
        worst_b = max(worst_b, rel)
        if rel > 5e-4:
            raise AssertionError(f"{what}: loss {float(got['loss'])} against one device's "
                                 f"{tiny['loss']}")
        grads_within_bound(what, tiny["names"], got["grads"], tiny["grads"])
        if got["wrappers"] != {"hop1_fwd": 0, "hop1_bwd": 0}:
            raise AssertionError(f"{what}: K1, K2 ran under TP x SP: {got['wrappers']}")
    return {"mesh": "1 data x 2 seq, gloo, both ranks on one device",
            "train_rows": B, "beam_rows": rows,
            "blocks": {"his": ranks[0]["his_block"], "t": ranks[0]["t_block"]},
            "loss_rel_err": worst_loss, "grad_max_err_over_bound": worst_grad,
            "one_device_by_name": one["by_name"], "sp_by_name": [r["by_name"] for r in ranks],
            "sp_variants": [r["variants"] for r in ranks],
            "beam_tokens_identical_rows": rows,
            "beam_k1_wrapper": [r["beam_k1_wrapper"] for r in ranks],
            "eager_sp_ms_per_step": [r["ms_per_step"] for r in ranks],
            "eager_sp_step_ms": [r["step_ms"] for r in ranks],
            "one_device_eager_ms_per_step": one["ms_per_step"],
            "step_peak_mb": {"one_device": one["step_peak_mb"],
                             "sp_ranks": [r["step_peak_mb"] for r in ranks]},
            "sp_rank_peak_mb": [r["peak_mb"] for r in ranks],
            "seq_collectives_a_step": ranks[0]["step_counts"],
            "beam_seq_collectives": ranks[0]["beam_counts"],
            "sp_losses": ranks[0]["losses"],
            "beam_seconds": [r["beam_seconds"] for r in ranks],
            "tp_sp": {"mesh": "1 data x 2 model x 2 seq, gloo, four ranks on one device",
                      "widths": tiny_kw, "rows": tiny_B, "loss_rel_err": worst_b,
                      "seq_collectives_a_step": ranks_b[0]["step_counts"]},
            "seconds": time.perf_counter() - t_start}


# ---------------------------------------------------------------------------
# phase 17: the reference's width (d_model 512, 8 heads)

REFERENCE_WIDTH = dict(d_model=512, att_h=8)


def step_breakdown(prof, steps, top=8):
    """Device ms a step by kernel from a torch.profiler window over `steps`
    replayed train steps: the whole step, K1 "wide"'s three kernels, K2
    "wide"'s four and the fixed-order sums (`hop1_*`, `sum_middle`), and
    the `top` other kernels by time (names cut to 80 characters, the times
    of names alike there summed)."""
    import re

    dev = lambda e: (getattr(e, "self_device_time_total", 0.0) or 0.0) / 1e3 / steps
    events = [e for e in prof.key_averages() if dev(e) > 0]
    hop1 = {}
    for e in events:
        m = re.search(r"(hop1_\w+|sum_middle)_kernel", e.key)
        if m:
            hop1[m.group(1)] = hop1.get(m.group(1), 0.0) + dev(e)
    others = {}
    for e in events:
        if not re.search(r"(hop1_\w+|sum_middle)_kernel", e.key):
            others[e.key[:80]] = others.get(e.key[:80], 0.0) + dev(e)
    k1 = {k: v for k, v in hop1.items() if k.startswith("hop1_fwd")}
    k2 = {k: v for k, v in hop1.items() if not k.startswith("hop1_fwd")}
    return {"device_ms_per_step": sum(dev(e) for e in events),
            "k1_ms": k1, "k1_total_ms": sum(k1.values()),
            "k2_ms": k2, "k2_total_ms": sum(k2.values()),
            "top_other_ms": dict(sorted(others.items(), key=lambda kv: -kv[1])[:top])}


def generation_against_plain(device, what, params, cfg, batches, variant):
    """Beam search (phase 3's settings) on `batches` through the kernels,
    eager and through a DecodeProgram (`eager_and_replayed`: K1 through
    `variant` in the wrappers and by kernel name in the replays), then eager
    and replayed again under force_plain (no K1): responses/s of the four,
    each graph pool, and every hypothesis's tokens and length identical
    between the kernel path and the plain path, eager and replayed.
    Returns the readings."""
    import torch

    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.decode.beam import beam_search
    from bist_tpu_torch.decode.compiled import DecodeProgram
    from bist_tpu_torch.ops import dispatch
    from bist_tpu_torch.ops.bist_kernels import hop1_fused

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gcfg = GenerateConfig(**GEN)
    rows = sum(b.query.shape[0] for b in batches)
    program = DecodeProgram(params, cfg, gcfg)
    kern, beam = eager_and_replayed(device, f"beam_search, {what}",
                                    lambda b: beam_search(params, cfg, b, gcfg), program,
                                    batches, variant=variant)
    reset_hop1_counts()
    with dispatch.force_plain():
        beam_search(params, cfg, batches[0], gcfg)                   # warm-up
        sync()
        t0 = time.perf_counter()
        plain = [beam_search(params, cfg, b, gcfg) for b in batches]
        sync()
        plain_eager_s = time.perf_counter() - t0
        plain_program = DecodeProgram(params, cfg, gcfg)
        for b in batches:                                            # warm-up, capture
            plain_program(b)
        sync()
        t0 = time.perf_counter()
        plain_replayed = [plain_program(b) for b in batches]
        sync()
        plain_replay_s = time.perf_counter() - t0
    if hop1_fused.launches:
        raise AssertionError(f"{what}: K1 launched {hop1_fused.launches} times under "
                             f"force_plain")

    def same(a, b):
        return torch.equal(a.tokens, b.tokens) and torch.equal(a.lengths, b.lengths)

    differ = [i for i, (k, p, pr) in enumerate(zip(kern, plain, plain_replayed))
              if not (same(k, p) and same(p, pr))]
    if differ:
        raise AssertionError(f"{what}: the beam tokens of batches {differ} differ "
                             f"between the kernel path and the plain path")
    generation = {
        "batches": len(batches), "batch_size": batches[0].query.shape[0],
        "clips": [b.fts.shape[1] for b in batches],
        "responses_per_s": {"kernels_eager": beam["eager_responses_per_s"],
                            "kernels_replayed": beam["replayed_responses_per_s"],
                            "plain_eager": rows / plain_eager_s,
                            "plain_replayed": rows / plain_replay_s},
        "graph_pool_mb": {"kernels": beam["graph_pool_mb"],
                          "plain": plain_program.stats()["pool_bytes"] / 2 ** 20},
        "replayed_k1_by_name": beam["replayed_k1_by_name"],
        "eager_launches": beam["eager_launches"],
        "tokens_identical_to_plain": {"eager": rows, "replayed": rows}}
    log(f"{what} generation: {json.dumps(generation)}")
    del program, plain_program
    return generation


def width_leg(device, model_kw, n_batches, B, train_B, want):
    """The flagship configuration at `model_kw`'s width, random weights from
    seed 0: beam search (phase 3's settings) on n_batches batches of B test
    turns against force_plain (`generation_against_plain`: K1 "wide" 6 a
    batch through the wrappers and by kernel name in the replays, tokens
    identical), then, without dropout, 2 batches of train_B train turns and
    the first one's loss and gradients against force_plain (phase 6's
    bounds), K1 and K2 through the wrappers by kernel as `want` says on the
    card (none on the CPU).  Returns the generation's readings, the
    gradient check, the train state, its optimizer, the model and train
    configurations and the train batches."""
    from bist_tpu_torch.config import TrainConfig
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.models.model import init_model
    from bist_tpu_torch.train.loop import create_train_state
    from bist_tpu_torch.vocab import get_vocabulary

    cuda = device.type == "cuda"
    what = f"d_model {model_kw['d_model']}"
    vocab = get_vocabulary(TEST_JSON, cutoff=3, include_caption="summary")
    cfg = flagship_cfg(len(vocab), **model_kw)
    data = load_avsd(TEST_JSON, vocab, include_caption="summary", separate_caption=True,
                     undisclosed_only=True)
    batches = [to_device(b, device) for b in make_batches(data, n_batches, B, seed=0)]
    params = init_model(0, cfg, device=device)
    generation = generation_against_plain(device, what, params, cfg, batches,
                                          "wide" if cuda else None)
    del params, batches

    tcfg_model = flagship_cfg(len(vocab), **model_kw, dropout=0.0, attn_dropout=0.0)
    tcfg = TrainConfig(warmup_steps=10)
    train_data = load_avsd(TEST_JSON, vocab, include_caption="summary", separate_caption=True)
    tb = [to_device(b, device) for b in make_batches(train_data, 2, train_B, seed=1,
                                                     answers=True)]
    state, tx = create_train_state(0, tcfg_model, tcfg, device=device)
    grad_check = grads_against_plain(device, state, tcfg_model, tcfg, tb[0])
    want = want if cuda else {"hop1_fwd": {}, "hop1_bwd": {}}
    if grad_check["variants"] != want:
        raise AssertionError(f"{what} gradient check: K1, K2 by kernel "
                             f"{grad_check['variants']}, expected {want}")
    return generation, grad_check, state, tx, tcfg_model, tcfg, tb


def phase_reference_width(device, n_batches=2, B=64, train_B=32, steps=5,
                          model_kw=REFERENCE_WIDTH):
    """The flagship configuration at bist_tpu's default width (`model_kw`:
    d_model 512, 8 heads; hop 1 through K1 "wide"), random weights from
    seed 0:

      * beam search and one step's loss and gradients against force_plain
        (`width_leg`: K1 "wide" with residuals and K2 "wide" 6 each);
      * training without dropout on the 2 cycled train batches: `steps`
        eager Noam-Adam steps (the wrappers' counts zeroed before, read
        after: K1 and K2 "wide" 6 a step each) and a TrainProgram's warm-up,
        capture and `steps` replays timed (ms/step, median after the first;
        its graph pool), 2 replays under torch.profiler (K1 "wide" and K2
        "wide" 6 a step each by name) and the replayed step's device ms by
        kernel (`step_breakdown`; empty on the CPU).
    Returns the readings."""
    import torch

    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.train.compiled import TrainProgram
    from bist_tpu_torch.train.loop import make_train_step

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    generation, grad_check, state, tx, tcfg_model, tcfg, tb = width_leg(
        device, model_kw, n_batches, B, train_B,
        {"hop1_fwd": {"wide": 6}, "hop1_bwd": {"wide": 6}})
    start = copy_state(state)
    step = make_train_step(tcfg_model, tcfg, tx)
    reset_hop1_counts()
    hop1_bwd.launches, hop1_bwd.variants = 0, {}
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, tb[i % 2], None)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    eager_counts = {"hop1_fwd": dict(hop1_fused.variants), "hop1_bwd": dict(hop1_bwd.variants)}
    want = {"hop1_fwd": {"wide": 6 * steps}, "hop1_bwd": {"wide": 6 * steps}} if cuda else \
        {"hop1_fwd": {}, "hop1_bwd": {}}
    if eager_counts != want or not all(np.isfinite(losses)):
        raise AssertionError(f"d_model 512 train steps: K1, K2 by kernel {eager_counts} "
                             f"(expected {want}), losses {losses}")
    del state
    pstate = copy_state(start)
    prog = TrainProgram(pstate, tcfg_model, tcfg, tx)
    for b in tb:                                     # each geometry's warm-up, capture
        pstate, _ = prog(pstate, b, None)
    sync()
    caps = prog.captures
    replay = []
    for i in range(steps):
        t0 = time.perf_counter()
        pstate, m = prog(pstate, tb[i % 2], None)
        sync()
        replay.append(time.perf_counter() - t0)
    st = prog.stats()
    if (cuda and not (st["captures"] == caps == st["eager_runs"] == st["geometries"] > 0)) \
            or not np.isfinite(float(m["loss"])):
        raise AssertionError(f"d_model 512 train program: {st}, loss {m['loss']}: a "
                             f"geometry stepped eagerly or the loss is not finite")
    ran, breakdown = None, {}
    if cuda:
        with profiler_window(device) as prof:
            for i in range(2):
                pstate, _ = prog(pstate, tb[i % 2], None)
            sync()
        ran = hop1_ran(prof)
        want = {"k1": dict(K1_NONE, wide=12), "k2": dict(K2_NONE, wide=12)}
        if ran != want:
            raise AssertionError(f"d_model 512 train program: K1, K2 in 2 replays by name "
                                 f"{ran}, expected {want}")
        breakdown = step_breakdown(prof, 2)
    training = {"batch_size": train_B, "steps": steps,
                "grad_check": grad_check,
                "eager_ms_per_step": statistics.median(times[1:]) * 1e3,
                "replayed_ms_per_step": statistics.median(replay[1:]) * 1e3,
                "losses": losses, "eager_launches": eager_counts, "replayed_by_name": ran,
                "replayed_breakdown": breakdown,
                "graph_pool_mb": st["pool_bytes"] / 2 ** 20, "program": st}
    log(f"d_model 512 training: {json.dumps(training)}")
    del prog, pstate, start
    if cuda:
        torch.cuda.empty_cache()
    return {"config": model_kw, "generation": generation, "training": training}


WIDTH_1024 = dict(d_model=1024, att_h=8)
# K1 and K2 through the wrappers by kernel in a train step of phase 17's
# d_model 1024 leg (its gradient check, and each timed step)
WIDTH_1024_TRAIN = {"hop1_fwd": {"wide": 6}, "hop1_bwd": {"wide": 6}}


def phase_width_1024(device, B=64, train_B=32, model_kw=WIDTH_1024):
    """Phase 17's leg at d_model 1024 with 8 heads (`model_kw`; d_k 128,
    hop 1 through K1 and K2 "wide"): `width_leg` on 1 batch of B test turns
    and a train batch of train_B turns, K1 and K2 in its gradient check as
    WIDTH_1024_TRAIN says; then that batch's eager train step against
    force_plain and its device ms by kernel (`long_train_speed`, K1 and K2
    by kernel WIDTH_1024_TRAIN a step).  Returns the readings."""
    import torch

    t0 = time.perf_counter()
    generation, grad_check, state, tx, tcfg_model, tcfg, tb = width_leg(
        device, model_kw, 1, B, train_B, WIDTH_1024_TRAIN)
    speed = long_train_speed(device, state, tcfg_model, tcfg, tx, tb[0])
    runs = 2 * LONG_TRAIN_STEPS
    want = {k: {v: n * runs for v, n in c.items()} for k, c in WIDTH_1024_TRAIN.items()} \
        if device.type == "cuda" else {"hop1_fwd": {}, "hop1_bwd": {}}
    if speed["kernel_launches"] != want:
        raise AssertionError(f"d_model {model_kw['d_model']} train steps: K1, K2 by kernel "
                             f"{speed['kernel_launches']}, expected {want}")
    out = {"config": model_kw, "generation": generation,
           "training": {"batch_size": train_B, "grad_check": grad_check, "speed": speed},
           "seconds": time.perf_counter() - t0}
    log(f"d_model {model_kw['d_model']}: {json.dumps(out)}")
    del state, tb
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 18: videos of more than 64 clips


LONG_CLIPS = (65, 180)       # an 11-30 s video's 16-frame clips at stride 4, 24 fps
FLAGSHIP_WIDTH = dict(d_model=128, att_h=8)
# K1's launches a batch by kernel: t2s attends over the T clips (Lk > 64:
# "wide"), s2t over the 16 regions ("whole" at the flagship's width)
LONG_WIDTHS = ((FLAGSHIP_WIDTH, {"wide": 3, "whole": 3}), (REFERENCE_WIDTH, {"wide": 6}))
# the train step at d_model 512: K1 and K2 "wide" at t2s (Lk > 64: K2's kv
# rows over slices of at most 64) and at s2t
LONG_TRAIN = {"hop1_fwd": {"wide": 6}, "hop1_bwd": {"wide": 6}}
LONG_TRAIN_STEPS = 3         # timed steps a run of `long_train_speed`


def long_train_speed(device, state, cfg, tcfg, tx, batch):
    """Eager train steps on `batch` through the kernels and under
    force_plain, each from a copy of `state`: one warm-up step each, then
    runs of LONG_TRAIN_STEPS steps in turns (kernels, plain, plain,
    kernels), ms a step from the host with the device synchronised after
    each (median over both runs); K1 and K2 through the wrappers by
    kernel over the kernels' runs; then the device ms of 2 kernel steps by
    kernel under torch.profiler (`step_breakdown`; empty on the CPU)."""
    import torch

    from bist_tpu_torch.ops import dispatch
    from bist_tpu_torch.ops.bist_kernels import hop1_bwd, hop1_fused
    from bist_tpu_torch.train.loop import make_train_step

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    step = make_train_step(cfg, tcfg, tx)

    def run(n, plain):
        st, times = copy_state(state), []
        with dispatch.force_plain() if plain else contextlib.nullcontext():
            for _ in range(n):
                t0 = time.perf_counter()
                st, m = step(st, batch, None)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"eager train step (plain {plain}): loss {m['loss']}")
        return times

    run(1, False)
    run(1, True)
    reset_hop1_counts()
    hop1_bwd.launches, hop1_bwd.variants = 0, {}
    ms = {"kernels": [], "plain": []}
    for plain in (False, True, True, False):
        ms["plain" if plain else "kernels"] += run(LONG_TRAIN_STEPS, plain)
    counts = {"hop1_fwd": dict(hop1_fused.variants), "hop1_bwd": dict(hop1_bwd.variants)}
    breakdown = {}
    if cuda:
        with profiler_window(device) as prof:
            run(2, False)
        breakdown = step_breakdown(prof, 2)
    return {"steps_a_run": LONG_TRAIN_STEPS,
            "eager_ms_per_step": {k: statistics.median(v) for k, v in ms.items()},
            "eager_ms": ms, "kernel_launches": counts, "breakdown": breakdown}


def phase_long_video(device, n_batches=2, B=32, clips=LONG_CLIPS, dv=DV, s=S,
                     widths=LONG_WIDTHS, train_kw=REFERENCE_WIDTH, train_variants=LONG_TRAIN):
    """Videos of more than 64 clips: test turns with random grids of
    clips[0]-clips[1] clips of s x dv (zero-padded to multiples of 40, up to
    T 200), the flagship configuration at each of `widths` (model widths,
    K1's launches a batch by kernel), random weights from seed 0:

      * beam search (phase 3's settings) on n_batches batches of B turns
        against force_plain (`generation_against_plain`: K1 by kernel as
        `widths` says through the wrappers and by kernel name in the
        replays; tokens and lengths identical; responses/s and graph pools);
      * one train step at dropout 0 at `train_kw`'s width on a batch of B
        such turns: loss and gradients against force_plain (phase 6's
        bounds), K1 and K2 through the wrappers by kernel as
        `train_variants` says; then its eager ms/step against force_plain
        and its device ms by kernel (`long_train_speed`; K1 and K2 by
        kernel `train_variants` a step).
    On the CPU every count is 0 (the plain versions).  Returns the readings."""
    import torch

    from bist_tpu_torch.config import TrainConfig
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.models.model import init_model
    from bist_tpu_torch.train.loop import create_train_state
    from bist_tpu_torch.vocab import get_vocabulary

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    vocab = get_vocabulary(TEST_JSON, cutoff=3, include_caption="summary")
    data = load_avsd(TEST_JSON, vocab, include_caption="summary", separate_caption=True,
                     undisclosed_only=True)
    batches = [to_device(b, device) for b in make_batches(data, n_batches, B, seed=2,
                                                          clips=clips, dv=dv, s=s)]
    out = {"clips": list(clips), "generation": {}}
    for model_kw, per_batch in widths:
        cfg = flagship_cfg(len(vocab), dv=dv, **model_kw)
        params = init_model(0, cfg, device=device)
        what = f"long videos, d_model {model_kw['d_model']}"
        out["generation"][str(model_kw["d_model"])] = generation_against_plain(
            device, what, params, cfg, batches, per_batch if cuda else None)
        del params
    del batches

    cfg = flagship_cfg(len(vocab), dv=dv, **train_kw, dropout=0.0, attn_dropout=0.0)
    train_data = load_avsd(TEST_JSON, vocab, include_caption="summary", separate_caption=True)
    batch = to_device(make_batches(train_data, 1, B, seed=3, answers=True, clips=clips, dv=dv,
                                   s=s)[0], device)
    tcfg = TrainConfig(warmup_steps=10)
    state, tx = create_train_state(0, cfg, tcfg, device=device)
    grad_check = grads_against_plain(device, state, cfg, tcfg, batch)
    want = train_variants if cuda else {"hop1_fwd": {}, "hop1_bwd": {}}
    if grad_check["variants"] != want:
        raise AssertionError(f"long videos, d_model {train_kw['d_model']} gradient check: K1, "
                             f"K2 by kernel {grad_check['variants']}, expected {want}")
    speed = long_train_speed(device, state, cfg, tcfg, tx, batch)
    runs = 2 * LONG_TRAIN_STEPS
    want = {k: {v: n * runs for v, n in c.items()} for k, c in want.items()}
    if speed["kernel_launches"] != want:
        raise AssertionError(f"long videos, d_model {train_kw['d_model']} train steps: K1, K2 "
                             f"by kernel {speed['kernel_launches']}, expected {want}")
    out["train_step"] = dict(grad_check, d_model=train_kw["d_model"], batch_size=B,
                             clips=batch.fts.shape[1], speed=speed)
    out["seconds"] = time.perf_counter() - t0
    log(f"long videos: {json.dumps(out)}")
    del state, batch
    if cuda:
        torch.cuda.empty_cache()
    return out


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
    prog = train["compiled"]["no_dropout"]
    drop = train["compiled"]["dropout"]
    print(f"train step on {card}: eager {prog['eager_ms_per_step']:.2f} ms/step, replayed "
          f"{prog['replayed_ms_per_step']:.2f} ms/step (device {prog['device_ms_per_step']:.2f} "
          f"ms/step, busy {prog['busy_share']:.3f}); dropout {drop['dropout']}: eager "
          f"{drop['eager_ms_per_step']:.2f}, replayed {drop['replayed_ms_per_step']:.2f} "
          f"ms/step", flush=True)
    lap("training")

    train_cli = phase_train_cli(device, os.path.join(HERE, "build", "chip_smoke",
                                                     "train_cli"))
    print(f"train CLI: {json.dumps(train_cli)}", flush=True)
    lap("train CLI")

    model = serving_model(device)
    fields = serving_requests(256)
    serving = phase_serving_exact(device, model, fields)
    serving_fields = fields
    print(f"serving at one geometry on {card}: {json.dumps(serving)}", flush=True)
    lap("serving")

    # half the default depth: the script's run time stays inside its limit
    serving_load = phase_serving_load(device, model, fields, n_req=256, n_other=64,
                                      n_prof=64)
    print(f"serving load on {card}: {json.dumps(serving_load)}", flush=True)
    lap("serving load")

    serve_cli = phase_serve_cli(device, os.path.join(HERE, "build", "chip_smoke", "cli"),
                                cli["greedy_result"])
    print(f"serve and evaluate CLIs: {json.dumps(serve_cli)}", flush=True)
    lap("serve and evaluate CLIs")

    bundles = phase_bundles(device, model, fields,
                            os.path.join(HERE, "build", "chip_smoke", "cli"))
    one = bundles["one_geometry"]
    print(f"serving bundles on {card}: export {bundles['export_seconds']:.1f} s for "
          f"{len(bundles['geometries'])} programs ({bundles['beam_export_seconds_per_program']}), "
          f"load {bundles['load_seconds']:.1f} s ({bundles['load_seconds_per_program']}), "
          f"capture {bundles['capture_seconds_per_geometry']}, graph pool "
          f"{bundles['graph_pool_mb']:.1f} MB; at {one['geometry']}: requests/s bundle "
          f"{one['requests_per_s']['bundle']} against DecodeProgram "
          f"{one['requests_per_s']['program']}, device ms a batch {one['device_ms_per_batch']}; "
          f"first batch off the diagonal {bundles['first_batch_off_diagonal']}", flush=True)
    print(f"serving bundles on {card}: {json.dumps(bundles)}", flush=True)
    lap("serving bundles")

    extractor = phase_extractor(device, os.path.join(HERE, "build", "chip_smoke", "extract"))
    sp = extractor["speed"]
    print(f"extractor on {card}: ResNeXt-{extractor['depth']} "
          f"({extractor['gflop_per_clip']:.2f} GFLOP a clip), batch {sp['float32']['batch']}: "
          + "; ".join(f"{k} {v['clips_per_s']:.1f} clips/s, {v['tflops']:.2f} TFLOP/s, busy "
                      f"{v['busy_share']:.3f}, ms by part {json.dumps(v['part_ms'])}"
                      for k, v in sp.items())
          + f"; float32 card against CPU {extractor['card_vs_cpu']['max_abs_err_over_max_abs']:.3e}"
            f" of max |f|; deviation from float32 "
          + json.dumps(extractor["deviation_from_float32"])
          + f"; int8 sums bit for bit float64's in {len(extractor['int8_sums_exact'])} "
            f"convolutions at batch {sp['int8']['batch']}"
          + f"; CLI {extractor['cli']['clips']} clips, packed against per-video "
            f"{extractor['cli']['packed_equals_per_video']}; generate answered "
            f"{extractor['generate']['turns']} turns, K1 by name "
            f"{json.dumps(extractor['generate']['k1_ran'])}", flush=True)
    print(f"extractor on {card}: {json.dumps(extractor)}", flush=True)
    lap("extractor")

    tgif = phase_tgif(device, os.path.join(HERE, "build", "chip_smoke", "tgif"))
    print(f"TGIF-QA on {card}: "
          + "; ".join(f"{r['task']} dropout {r['dropout']}: {r['test']}, examples/s by epoch "
                      f"{[round(x, 1) for x in r['examples_per_s']]}, "
                      f"{r['program']['captures']} captures in "
                      f"{r['program']['capture_seconds']:.2f} s" for r in tgif["cli"])
          + "; " + "; ".join(f"{k} {v['rows']} rows: eager {v['eager_ms_per_step']:.2f} "
                             f"ms/step, replayed {v['replayed_ms_per_step']:.2f} (busy "
                             f"{v['busy_share']:.3f})" for k, v in tgif["step_speed"].items())
          + f"; held-out Transition acc {tgif['heldout']['heldout_acc']:.3f} after "
            f"{tgif['heldout']['steps']} replayed steps", flush=True)
    print(f"TGIF-QA on {card}: {json.dumps(tgif)}", flush=True)
    lap("tgif")
    # K1 and K2 kernels the card ran in each TGIF CLI run, by name
    tgif_runs = {f"{r['task']} dropout {r['dropout']}": r["by_name"] for r in tgif["cli"]}

    dp = phase_data_parallel(device, os.path.join(HERE, "build", "chip_smoke", "dp"), model,
                             serving_fields, os.path.join(HERE, "build", "chip_smoke", "cli"),
                             phase6_ms=prog["replayed_ms_per_step"])
    del model, fields, serving_fields
    w1, two, dps = dp["world_one"], dp["two_ranks"], dp["serving"]
    print(f"data parallel on {card}: world-1 NCCL program bit-identical to phase 6's over "
          f"{w1['calls_bit_identical']} calls ({w1['captures']} captures, "
          f"{w1['collectives_issued_in_warm_ups_and_captures']} collectives issued), replayed "
          f"{w1['ms_per_step']['dp_program']:.2f} ms/step against phase 6's program "
          f"{w1['ms_per_step']['phase6_program']:.2f} in the same window (phase 6 read "
          f"{prog['replayed_ms_per_step']:.2f}); K1/K2 by name in 3 replays "
          f"{json.dumps(w1['replayed_by_name'])}; 2 gloo ranks on one card: loss "
          f"{two['loss_max_rel_err']:.2e} rel, gradients {two['grad_max_err_over_bound']:.3f} "
          f"of the bound, parameters bit-identical, by name {json.dumps(two['by_name'])}; "
          f"Responder on 2 replicas: {dps['responder']['identical']} answers identical, K1 "
          f"in 4 batches {json.dumps(dps['responder']['k1_by_name_4_batches'])}; dp 2 bundle: "
          f"{dps['bundle']['identical']} identical, K1 in 4 batches "
          f"{json.dumps(dps['bundle']['k1_by_name_4_batches'])}"
          f"; {dp['seconds']:.1f} s", flush=True)
    print(f"data parallel on {card}: {json.dumps(dp)}", flush=True)
    lap("data parallel")

    tpr = phase_tensor_parallel(device, os.path.join(HERE, "build", "chip_smoke", "tp"))
    print(f"tensor parallel on {card}: 2 gloo ranks on one card, (1 data x 2 model) mesh, "
          f"{tpr['heads_a_rank']} heads a rank: loss {tpr['loss_rel_err']:.2e} rel, "
          f"gradients {tpr['grad_max_err_over_bound']:.3f} of phase 6's bound, K1/K2 by name "
          f"under TP {json.dumps(tpr['tp_by_name'])} (one device "
          f"{json.dumps(tpr['one_device_by_name'])}); beam 5 on {tpr['beam_rows']} rows: tokens "
          f"identical; eager TP step {[round(x, 2) for x in tpr['eager_tp_ms_per_step']]} "
          f"ms (smoke: gloo on one card) with {tpr['model_all_reduces_a_step']['all_reduces']} "
          f"model-axis all-reduces of {tpr['model_all_reduces_a_step']['bytes'] / 1e6:.1f} MB "
          f"a rank, {[round(x, 3) for x in tpr['model_all_reduce_share']]} of a timed step in "
          f"them; one device eager {tpr['one_device_eager_ms_per_step']['kernels']:.2f} ms, "
          f"plain hop 1 {tpr['one_device_eager_ms_per_step']['plain']:.2f} ms; "
          f"{tpr['seconds']:.1f} s", flush=True)
    print(f"tensor parallel on {card}: {json.dumps(tpr)}", flush=True)
    lap("tensor parallel")

    spr = phase_sequence_parallel(device, os.path.join(HERE, "build", "chip_smoke", "sp"))
    mem = spr["step_peak_mb"]
    print(f"sequence parallel on {card}: 2 gloo ranks on one card, (1 data x 2 seq) mesh, "
          f"blocks of {spr['blocks']['his']} history tokens and {spr['blocks']['t']} clips a "
          f"rank: loss {spr['loss_rel_err']:.2e} rel, gradients "
          f"{spr['grad_max_err_over_bound']:.3f} of phase 6's bound, K1/K2 by name under SP "
          f"{json.dumps(spr['sp_by_name'])} (one device {json.dumps(spr['one_device_by_name'])}"
          f"); beam 5 on {spr['beam_rows']} rows: tokens identical, K1 "
          f"{spr['beam_k1_wrapper']} a rank; eager SP step "
          f"{[round(x, 2) for x in spr['eager_sp_ms_per_step']]} ms (smoke: gloo on one card; "
          f"one device {spr['one_device_eager_ms_per_step']:.2f}) with "
          f"{json.dumps(spr['seq_collectives_a_step'])} on the seq axis; peak memory a step "
          f"adds {[round(x, 1) for x in mem['sp_ranks']]} MB a rank against "
          f"{mem['one_device']:.1f} on one device; (1 x 2 x 2) TP x SP at tiny widths: loss "
          f"{spr['tp_sp']['loss_rel_err']:.2e} rel; {spr['seconds']:.1f} s", flush=True)
    print(f"sequence parallel on {card}: {json.dumps(spr)}", flush=True)
    lap("sequence parallel")

    ref = phase_reference_width(device)
    gen, trn = ref["generation"], ref["training"]
    rps = gen["responses_per_s"]
    print(f"reference width (d_model 512, 8 heads) on {card}: beam search "
          f"{rps['kernels_replayed']:.1f} responses/s replayed ({rps['kernels_eager']:.1f} "
          f"eager) against plain {rps['plain_replayed']:.1f} ({rps['plain_eager']:.1f}), "
          f"tokens identical to plain on {gen['tokens_identical_to_plain']['replayed']} rows, "
          f"K1 by name {json.dumps(gen['replayed_k1_by_name'])}, graph pool "
          f"{gen['graph_pool_mb']['kernels']:.1f} MB against plain "
          f"{gen['graph_pool_mb']['plain']:.1f}; train step B {trn['batch_size']}: eager "
          f"{trn['eager_ms_per_step']:.2f} ms, replayed {trn['replayed_ms_per_step']:.2f} ms, "
          f"loss {trn['grad_check']['loss_rel_diff']:.2e} rel of plain, K1/K2 by name "
          f"{json.dumps(trn['replayed_by_name'])}, graph pool {trn['graph_pool_mb']:.1f} MB; "
          f"replayed step device ms {trn['replayed_breakdown']['device_ms_per_step']:.2f}: K1 "
          f"{trn['replayed_breakdown']['k1_total_ms']:.2f} "
          f"{json.dumps(trn['replayed_breakdown']['k1_ms'])}, K2 "
          f"{trn['replayed_breakdown']['k2_total_ms']:.2f} "
          f"{json.dumps(trn['replayed_breakdown']['k2_ms'])}, top others "
          f"{json.dumps(trn['replayed_breakdown']['top_other_ms'])}", flush=True)
    print(f"reference width on {card}: {json.dumps(ref)}", flush=True)
    lap("reference width")

    w1024 = phase_width_1024(device)
    rps = w1024["generation"]["responses_per_s"]
    chk = w1024["training"]["grad_check"]
    w_speed = w1024["training"]["speed"]
    print(f"d_model 1024, 8 heads on {card}: beam search {rps['kernels_replayed']:.1f} "
          f"responses/s replayed ({rps['kernels_eager']:.1f} eager) against plain "
          f"{rps['plain_replayed']:.1f} ({rps['plain_eager']:.1f}), tokens identical to plain "
          f"on {w1024['generation']['tokens_identical_to_plain']['replayed']} rows, K1 by name "
          f"{json.dumps(w1024['generation']['replayed_k1_by_name'])}; train step B "
          f"{w1024['training']['batch_size']}: loss {chk['loss_rel_diff']:.2e} rel of plain, "
          f"gradients max |diff| {chk['max_abs_diff']:.2e}, K1/K2 by kernel "
          f"{json.dumps(chk['variants'])}; eager ms/step "
          f"{json.dumps(w_speed['eager_ms_per_step'])}, device ms/step "
          f"{w_speed['breakdown']['device_ms_per_step']:.2f}: K1 "
          f"{json.dumps(w_speed['breakdown']['k1_ms'])}, K2 "
          f"{json.dumps(w_speed['breakdown']['k2_ms'])}; {w1024['seconds']:.1f} s", flush=True)
    print(f"d_model 1024 on {card}: {json.dumps(w1024)}", flush=True)
    lap("d_model 1024")

    long = phase_long_video(device)
    print(f"long videos on {card}: " + "; ".join(
        f"d_model {w} beam search {g['responses_per_s']['kernels_replayed']:.1f} responses/s "
        f"replayed ({g['responses_per_s']['kernels_eager']:.1f} eager) against plain "
        f"{g['responses_per_s']['plain_replayed']:.1f} ({g['responses_per_s']['plain_eager']:.1f})"
        f" over clips {g['clips']}, tokens identical to plain on "
        f"{g['tokens_identical_to_plain']['replayed']} rows, K1 by name "
        f"{json.dumps(g['replayed_k1_by_name'])}, graph pool {g['graph_pool_mb']['kernels']:.1f}"
        f" MB against plain {g['graph_pool_mb']['plain']:.1f}"
        for w, g in long["generation"].items())
        + f"; train step d_model {long['train_step']['d_model']} at {long['train_step']['clips']}"
          f" clips: loss {long['train_step']['loss_rel_diff']:.2e} rel of plain, K1/K2 by kernel "
          f"{json.dumps(long['train_step']['variants'])}, eager ms/step "
          f"{json.dumps(long['train_step']['speed']['eager_ms_per_step'])}, device ms/step "
          f"{long['train_step']['speed']['breakdown']['device_ms_per_step']:.2f}: K1 "
          f"{json.dumps(long['train_step']['speed']['breakdown']['k1_ms'])}, K2 "
          f"{json.dumps(long['train_step']['speed']['breakdown']['k2_ms'])}; "
          f"{long['seconds']:.1f} s", flush=True)
    print(f"long videos on {card}: {json.dumps(long)}", flush=True)
    lap("long videos")

    # phase 17 at d_model 512 and, for K1 in the replays, at d_model 1024
    ref_k1 = {k: gen["replayed_k1_by_name"][k]
              + w1024["generation"]["replayed_k1_by_name"][k] for k in K1_NONE}
    # K2 through the wrapper in phase 17's eager steps and its d_model 1024
    # gradient check and timed eager steps
    ref_k2 = {k: trn["eager_launches"]["hop1_bwd"].get(k, 0)
              + chk["variants"]["hop1_bwd"].get(k, 0)
              + w_speed["kernel_launches"]["hop1_bwd"].get(k, 0) for k in K2_NONE}
    ref_k2 = {k: n for k, n in ref_k2.items() if n}
    long_k1 = {k: sum(g["replayed_k1_by_name"][k] for g in long["generation"].values())
               for k in K1_NONE}
    # K2 through the wrapper in the long videos' gradient check and timed
    # eager steps (phase 18)
    long_k2 = {k: long["train_step"]["variants"]["hop1_bwd"].get(k, 0)
               + long["train_step"]["speed"]["kernel_launches"]["hop1_bwd"].get(k, 0)
               for k in K2_NONE}
    wide_main = next(c for c in hop1_cases if c["case"] == "t2s D=512")
    wide_1024 = next(c for c in hop1_cases if c["case"] == "t2s D=1024 h=8")
    wide_bwd = next(c for c in bwd_cases if c["case"] == "train t2s D=512")
    wide_bwd_long = next(c for c in bwd_cases if c["case"] == "train t2s Lk200 D=512")
    wide_bwd_1024 = next(c for c in bwd_cases if c["case"] == "train t2s D=1024")
    # K2 by kernel over the paths: "tiled" runs only in phase 2's forced and
    # "tiled"-only cases
    k2_variants = {k: train["hop1_bwd_variants"].get(k, 0) + ref_k2.get(k, 0)
                   + long_k2.get(k, 0) for k in K2_NONE}
    k2_variants = {k: n for k, n in k2_variants.items() if n}
    if "tiled" in k2_variants:
        raise AssertionError(f"K2 \"tiled\" ran on a path: {k2_variants}")
    kernels = [
        dict(kernel_entry("hop1_fwd", "bist_tpu_torch/csrc/hop1_fwd.cu",
                          "bist_tpu/ops/bist_kernels.py:63", hop1_cases,
                          main_path["launches"]["hop1_fwd"] + sum(ref_k1.values())
                          + sum(long_k1.values()),
                          f"beam_search replayed (one CUDA graph a geometry), counted by "
                          f"kernel name: the flagship's {main_path['batches']} batches of "
                          f"{main_path['batch_size']} (phase 3), the reference width's "
                          f"{gen['batches']} batches of {gen['batch_size']} and d_model "
                          f"1024's {w1024['generation']['batches']} (phase 17) and "
                          f"the long videos' batches at d_model 128 and 512 (phase 18)"),
             variants={k: main_path["hop1_variants"].get(k, 0) + ref_k1.get(k, 0)
                       + long_k1[k] for k in K1_NONE
                       if main_path["hop1_variants"].get(k, 0) + ref_k1.get(k, 0) + long_k1[k]},
             launches_main_path=main_path["launches"]["hop1_fwd"],
             launches_reference_width={"beam_search_replayed": gen["replayed_k1_by_name"],
                                       "train_replayed": trn["replayed_by_name"]["k1"]},
             # phase 17's d_model 1024 leg: K1 by name in its beam-search
             # replays, through the wrapper in its gradient check
             launches_width_1024={
                 "beam_search_replayed": w1024["generation"]["replayed_k1_by_name"],
                 "grad_check": chk["variants"]["hop1_fwd"],
                 "train_steps": w_speed["kernel_launches"]["hop1_fwd"]},
             # K1 kernels the card ran by name in the long videos' beam-search
             # replays (phase 18) at each width, and through the wrapper in
             # its train step
             launches_long_video={"beam_search_replayed": {
                 w: g["replayed_k1_by_name"] for w, g in long["generation"].items()},
                 "train_step": long["train_step"]["variants"]["hop1_fwd"]},
             # "wide" at the reference's width (phase 2's t2s D=512 case)
             wide={k: wide_main[k] for k in ("case", "ms", "device_ms", "plain_ms",
                                             "bound_ms", "bound_by", "tiled_ms",
                                             "max_abs_err")},
             # "wide" at D 1024, d_k 128 (phase 2's t2s D=1024 h=8 case, B 8)
             # and each of its kernels' device ms
             wide_d1024={k: wide_1024[k] for k in (
                 "case", "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
                 "bound_by", "tiled_ms", "tiled_device_ms", "max_abs_err",
                 "kernel_device_ms")},
             launches_train=train["launches"]["hop1_fwd"],
             # K1 kernels the card ran in 3 train and 2 eval replays, by name
             launches_train_replayed=train["compiled"]["no_dropout"]["replayed_by_name"]["k1"],
             launches_eval_replayed=train["compiled"]["eval"]["replayed_k1_by_name"],
             # K1 kernels the card ran in the replays, by name (profiler)
             launches_serving=serving["hop1_fwd_ran"],
             launches_serving_load={k: v["profiled"]["hop1_fwd_ran"]
                                    for k, v in serving_load.items()},
             # K1 kernels the card ran in the serving bundle's replays, by name
             launches_bundle=bundles["served"]["hop1_fwd_ran"],
             # K1 kernels the card ran, by name, generating from extracted features
             launches_extract_chain=extractor["generate"]["k1_ran"],
             launches_tgif={k: v["k1"] for k, v in tgif_runs.items()},
             # K1 kernels the card ran, by name: 3 replays of the world-1 NCCL
             # train program, each gloo rank's step, 4 batches of the
             # 2-replica Responder's and of the dp 2 bundle's replays
             launches_dp={"world_one_train_replayed": w1["replayed_by_name"]["k1"],
                          "gloo_ranks": [r["k1"] for r in two["by_name"]],
                          "responder_pair": dps["responder"]["k1_by_name_4_batches"],
                          "bundle_pair": dps["bundle"]["k1_by_name_4_batches"]},
             # K1 kernels the card ran, by name, in each seq rank's train step
             # (phase 16); K1 launches through the wrapper in each seq rank's
             # beam-search precompute
             launches_sp={"seq_ranks_train": [r["k1"] for r in spr["sp_by_name"]],
                          "seq_ranks_beam": spr["beam_k1_wrapper"]}),
        dict(kernel_entry("hop1_bwd", "bist_tpu_torch/csrc/hop1_bwd.cu",
                          "bist_tpu/ops/bist_kernels.py:243", bwd_cases,
                          train["launches"]["hop1_bwd"] + sum(ref_k2.values())
                          + sum(long_k2.values()),
                          f"eager train steps, counted through the wrapper: the "
                          f"flagship's {train['steps']} steps of {train['batch_size']} "
                          f"(phase 6), the reference width's {trn['steps']} steps of "
                          f"{trn['batch_size']} and d_model 1024's gradient check and "
                          f"timed steps (phase 17) and the long videos' gradient check "
                          f"and timed steps (phase 18)"),
             variants=k2_variants,
             launches_train=train["launches"]["hop1_bwd"],
             # "wide" at the reference's width (phase 2's train t2s D=512 case,
             # the train step's shape) and each of its kernels' device ms
             wide={k: wide_bwd[k] for k in ("case", "ms", "device_ms", "plain_ms", "bound_ms",
                                            "bound_by", "tiled_ms", "max_abs_err",
                                            "kernel_device_ms")},
             # "wide" past 64 kv rows (phase 2's train t2s Lk200 D=512 case,
             # phase 18's train step's t2s shape)
             wide_past_64={k: wide_bwd_long[k] for k in (
                 "case", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "tiled_ms",
                 "max_abs_err", "kernel_device_ms", "peak_mb")},
             # "wide" at d_model 1024, d_k 128 (phase 2's train t2s D=1024
             # case, phase 17's d_model 1024 train step's t2s shape)
             wide_d1024={k: wide_bwd_1024[k] for k in (
                 "case", "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
                 "bound_by", "tiled_ms", "tiled_device_ms", "max_abs_err",
                 "kernel_device_ms", "peak_mb")},
             # K2 at the reference width (phase 17): eager steps through the
             # wrapper (and d_model 1024's gradient check and timed steps),
             # and kernels (first pass; "wide" by its attention kernel) the
             # card ran in 2 train replays, by name
             launches_reference_width={"eager": ref_k2,
                                       "train_replayed": trn["replayed_by_name"]["k2"]},
             # K2 through the wrapper in the long videos' train steps (phase 18)
             launches_long_video=long_k2,
             # K2 kernels (first pass) the card ran in 3 train replays, by name
             launches_train_replayed=train["compiled"]["no_dropout"]["replayed_by_name"]["k2"],
             launches_tgif={k: v["k2"] for k, v in tgif_runs.items()},
             # K2 kernels (first pass) the card ran, by name: 3 replays of the
             # world-1 NCCL train program and each gloo rank's step
             launches_dp={"world_one_train_replayed": w1["replayed_by_name"]["k2"],
                          "gloo_ranks": [r["k2"] for r in two["by_name"]]},
             # K2 kernels (first pass) the card ran, by name, in each seq
             # rank's train step (phase 16)
             launches_sp={"seq_ranks_train": [r["k2"] for r in spr["sp_by_name"]]}),
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
    if sys.argv[1:2] == ["--dp-rank"]:          # a rank of phase 14 (b), not a run
        sys.exit(dp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-rank"]:          # a rank of phase 15, not a run
        sys.exit(tp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--sp-rank"]:          # a rank of phase 16, not a run
        sys.exit(sp_rank_main(sys.argv[2:]))
    sys.exit(main())
