#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bist_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

  0. the card's name and power limit (nvidia-smi); no CUDA → exit 1;
  1. build the CUDA kernels of bist_tpu_torch/csrc, one nvcc per source, all
     started together (into build/bist_tpu_torch/);
  2. each kernel against its plain PyTorch version (float32, TF32 off,
     tolerance 2e-4 abs/rel) at the shapes the main path gives it, timed as
     the median of CUDA-event runs beside the plain version, a library call
     where one computes the same function, and the card's bound;
  3. the main path: the flagship AVSD model (d_model 128, 8 heads, 3/3/3
     blocks, summary caption, pointer generator over query,cap; random
     weights from seed 0) generating for 4 batches of 64 real test turns
     (random features, 8-40 clips of 16 x 2048) by beam search (beam 5,
     maxlen 12, nbest 5, float32 cache).  Kernel launch counts are zeroed
     just before and read just after; hop 1 must have gone through its
     kernel 6 times per batch.  The same batches then run with the kernels
     forced off: every precomputed context tensor must agree to 2e-4;
  4. the flash kernel through models.layers.mha in the regime that sends it
     there (d_model 512, 8 heads, 32 queries, 32768 keys, key-padding mask),
     counts zeroed and read around it, held against the plain path;
  5. the generate CLI on a tiny on-disk dataset (turns from the vendored test
     set, random .npy features, a .conf + .pt from the port's init_model),
     with its result JSON checked.

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
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
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
T_BUCKETS = (16, 24, 32, 40)
GEN = dict(maxlen=12, beam=5, penalty=1.0, nbest=5)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call, CUDA events around each call."""
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


def bound(nbytes: float, flops: float):
    """(least time in ms, what bounds it) on the card's published peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hop1_work(B, G, Lq, Lk, D, masked):
    """Bytes that must move (each input read once, the output written once)
    and float32 operations of one fused hop-1 call."""
    nbytes = 4 * (2 * B * Lq * D + B * G * Lk * D + 3 * D * D + 3 * D
                  + B * G * Lq * D) + (4 * B * Lk if masked else 0)
    flops = (2 * 2 * B * G * Lk * D * D        # K and V projections
             + 2 * 2 * B * G * Lq * Lk * D     # scores and p·v over all heads
             + 2 * B * G * Lq * D * D)         # Wo
    return nbytes, flops


def flash_work(G, Lq, Lk, d, masked):
    nbytes = 4 * (2 * G * Lq * d + 2 * G * Lk * d) + (4 * G * Lk if masked else 0)
    return nbytes, 4 * G * Lq * Lk * d


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version


def random_mha_params(h, d, seed, device):
    import torch

    from bist_tpu_torch.models.layers import mha_init
    p = mha_init(torch.Generator().manual_seed(seed), h, d)
    return {n: {k: t.to(device) for k, t in w.items()} for n, w in p.items()}


def check_hop1(device, name, B, G, Lq, Lk, D, h, masked, strided_t2s, seed):
    """One K1 case: random inputs from a numpy seed; `strided_t2s` passes kv
    as the main path's t2s does, a (B, T, S, D) grid with T and S swapped."""
    import torch

    from bist_tpu_torch.ops.bist_kernels import hop1_fused, hop1_plain

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
        m[0] = 0                                   # one fully masked row
        mask = torch.tensor(m[:, None, :], device=device)
    got = hop1_fused(x, q, kv, p, h, mask)
    want = hop1_plain(x, q, kv, p, h, mask)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=TOL, atol=TOL):
        raise AssertionError(f"hop1 {name}: kernel differs from plain version, "
                             f"max |diff| {err:.3e} > {TOL}")
    nbytes, flops = hop1_work(B, G, Lq, Lk, D, masked)
    b_ms, b_by = bound(nbytes, flops)
    return {"case": name, "shape": dict(B=B, G=G, Lq=Lq, Lk=Lk, D=D, h=h,
                                        masked=masked),
            "max_abs_err": err,
            "ms": time_ms(lambda: hop1_fused(x, q, kv, p, h, mask)),
            "plain_ms": time_ms(lambda: hop1_plain(x, q, kv, p, h, mask)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops}


def check_flash(device, name, G, Lq, Lk, d, masked, seed):
    import torch
    import torch.nn.functional as F

    from bist_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.standard_normal(s, dtype=np.float32), device=device)
               for s in ((G, Lq, d), (G, Lk, d), (G, Lk, d)))
    mask = None
    if masked:
        lengths = rng.integers(1, Lk + 1, size=G)
        m = (np.arange(Lk)[None, :] < lengths[:, None]).astype(np.int32)
        m[0] = 0                                   # one fully masked row
        mask = torch.tensor(m, device=device)
    got = flash_attention(q, k, v, mask)
    want = attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=TOL, atol=TOL):
        raise AssertionError(f"flash {name}: kernel differs from plain version, "
                             f"max |diff| {err:.3e} > {TOL}")
    bool_mask = None if mask is None else (mask != 0)[:, None, :]
    nbytes, flops = flash_work(G, Lq, Lk, d, masked)
    b_ms, b_by = bound(nbytes, flops)
    return {"case": name, "shape": dict(G=G, Lq=Lq, Lk=Lk, d=d, masked=masked),
            "max_abs_err": err,
            "ms": time_ms(lambda: flash_attention(q, k, v, mask)),
            "plain_ms": time_ms(lambda: attention_plain(q, k, v, mask)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bool_mask)),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops}


def phase_kernels(device):
    hop1 = [
        # the main path's two hop-1 launches of each video layer
        check_hop1(device, "t2s", 64, 16, 32, 40, 128, 8, True, True, 1),
        check_hop1(device, "s2t", 64, 40, 32, 16, 128, 8, False, False, 2),
        # many kv tiles at the widest D the kernel takes
        check_hop1(device, "multi-tile", 4, 8, 32, 600, 512, 8, True, False, 3),
        # the t2s launch of wider models at the main path's batch
        check_hop1(device, "t2s D=256", 64, 16, 32, 40, 256, 8, True, True, 7),
        check_hop1(device, "t2s D=512", 64, 16, 32, 40, 512, 8, True, True, 8),
    ]
    flash = [
        # the regime mha sends to the kernel (phase 4's shape)
        check_flash(device, "mha kv=32768", 128, 32, 32768, 64, True, 4),
        check_flash(device, "short kv, d=16", 4096, 1, 40, 16, True, 5),
    ]
    return hop1, flash


# ---------------------------------------------------------------------------
# phase 3: the main path


def flagship_cfg(vocab_size, dv=DV, **kw):
    from bist_tpu_torch.config import ModelConfig
    return ModelConfig(vocab_size=vocab_size, ft_sizes=(dv,), **dict(FLAGSHIP, **kw))


def make_batches(data, n_batches, B, seed):
    """Host batches of real test turns clipped to LQ/LH/LC, with random
    feature grids of 8..T_MAX clips (zero-padded to the batch's bucket)."""
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
        dummy = np.full((len(exs), 1), SOS, np.int32)
        batches.append(Batch(
            query=pad_to([e.question[:LQ] for e in exs], LQ),
            his=pad_to([e.history[-LH:] for e in exs], LH),
            cap=pad_to([e.caption[:LC] for e in exs], LC),
            trg=dummy, trg_y=dummy, fts=fts))
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
    """Beam-search generation at the flagship width; returns a summary."""
    import torch

    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.decode.beam import NEG, beam_search
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
    t0 = time.perf_counter()
    results = [beam_search(params, cfg, b, gcfg) for b in batches]
    sync()
    seconds = time.perf_counter() - t0
    launches = {"hop1_fwd": hop1_fused.launches,
                "flash_fwd": flash_attention.launches}

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
            "launches": launches, "ctx_max_abs_diff": worst,
            "first_best_identical_share": same / total}


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


def phase_cli(device, root, n_dialogs=6, model_kw=None, dv=DV, s=S, t_max=T_MAX):
    test_set = write_tiny_dataset(root, n_dialogs, model_kw, dv, s, t_max)
    out = os.path.join(root, "result.json")
    cmd = [sys.executable, "-m", "bist_tpu_torch.cli.generate",
           "--test-set", test_set,
           "--test-path", os.path.join(root, "<FeaType>", "<ImageID>.npy"),
           "--model", os.path.join(root, "mtn"), "--decode-style", "beam_search",
           "--beam", "5", "--penalty", "1.0", "--nbest", "5", "--maxlen", "12",
           "--undisclosed-only", "1", "--gen-batch-size", "4",
           "--output", out, "--device", device.type]
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"generate CLI exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    with open(out) as f:
        result = json.load(f)
    with open(test_set) as f:
        orig = json.load(f)
    check_result_schema(result, orig)
    return {"dialogs": len(result["dialogs"]),
            "answers": [d["dialog"][-1]["answer"] for d in result["dialogs"]]}


def check_result_schema(result, orig):
    """The result JSON of an --undisclosed-only run: one entry per dialog,
    same image ids, the last turn's question kept and its answer generated."""
    if set(result) != {"dialogs"} or len(result["dialogs"]) != len(orig["dialogs"]):
        raise AssertionError("result JSON: expected one dialog per test dialog")
    for rd, od in zip(result["dialogs"], orig["dialogs"]):
        if rd["image_id"] != od["image_id"] or len(rd["dialog"]) != 1:
            raise AssertionError(f"result JSON: bad entry for {od['image_id']}")
        turn = rd["dialog"][0]
        if (turn["question"] != od["dialog"][-1]["question"]
                or not isinstance(turn["answer"], str) or not turn["answer"]
                or turn["answer"] == "__UNDISCLOSED__"):
            raise AssertionError(f"result JSON: bad answer for {od['image_id']}")


# ---------------------------------------------------------------------------


def kernel_entry(name, source, replaces, cases, launches, path):
    main = cases[0]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_on": path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
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

    from bist_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    t0 = time.perf_counter()
    built = _build.build(ptxas_verbose=True)
    for name, info in built.items():
        log(f"built {name} in {info['seconds']:.1f} s\n{info['log'].strip()}")
    print(f"build: {len(built)} kernel libraries compiled in "
          f"{time.perf_counter() - t0:.1f} s (wall, in parallel)", flush=True)

    hop1_cases, flash_cases = phase_kernels(device)
    for c in hop1_cases + flash_cases:
        log(f"kernel case {c['case']}: {json.dumps(c)}")

    main_path = phase_main_path(device)
    print(f"main path on {card}: {json.dumps(main_path)}", flush=True)

    mha_flash = phase_mha_flash(device)
    print(f"mha flash regime on {card}: {json.dumps(mha_flash)}", flush=True)

    cli = phase_cli(device, os.path.join(HERE, "build", "chip_smoke", "cli"))
    print(f"generate CLI: {json.dumps(cli)}", flush=True)

    kernels = [
        kernel_entry("hop1_fwd", "bist_tpu_torch/csrc/hop1_fwd.cu",
                     "bist_tpu/ops/bist_kernels.py:63", hop1_cases,
                     main_path["launches"]["hop1_fwd"],
                     f"flagship beam_search, {main_path['batches']} batches "
                     f"of {main_path['batch_size']}"),
        kernel_entry("flash_fwd", "bist_tpu_torch/csrc/flash_fwd.cu",
                     "bist_tpu/ops/flash_attention.py:43", flash_cases,
                     mha_flash["launches"],
                     "models.layers.mha, d_model 512, 8 heads, kv 32768 "
                     f"(flagship beam_search: {main_path['launches']['flash_fwd']})"),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
