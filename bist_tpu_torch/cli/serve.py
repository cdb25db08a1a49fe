#!/usr/bin/env python
"""HTTP serving with the PyTorch port: a JSON API over the dynamic-batching
responder (`bist_tpu_torch.serving`), the API of `bist_tpu.cli.serve`.

    python -m bist_tpu_torch.cli.serve --model exps/mtn --port 8000 [--device cpu]

    POST /respond   {"question": "...", "history": "...", "caption": "...",
                     "features": [[...]] optional (T, S, Dv) nested lists
                     or "features_b64": base64 of .npy bytes (float32, or
                     int8 with "features_scale_b64" beside it);
                     "audio" / "audio_b64": (Ta, Da) likewise, for
                     audio-visual models; "seed": int, sampling only}
    → {"answer": "...", "latency_ms": ...}

    GET /healthz    → {"ok": true, "stats": {...}}
    GET /metrics    → counters, latency percentiles, component seconds

It reads <model>.conf (JSON, either package's) and the port checkpoint
<model>.pt (or <model>_best.pt), or a reference-format checkpoint (a
pickled .conf beside <model>_best.pth.tar, read through
`bist_tpu_torch.convert` with --reference-root), captures every batch
bucket's decode as a CUDA graph (warmup; on the CPU it runs each once) and
logs "serving on <host>:<port>" with the port it bound (--port 0 picks a
free one).  It runs on CUDA unless --device cpu is given, and raises
without CUDA otherwise.  Concurrent requests are coalesced into batches
(`serving.DynamicBatcher`).  On a host with several cards the rows of each
batch split over the largest number of them that divides every batch
bucket (`serving.Responder`; one card: the whole batch on it).

Serving bundles (`bist_tpu_torch.export`):

    python -m bist_tpu_torch.cli.serve --model exps/mtn --export-bundle B \
        [--export-lq 32 --export-lh 64,256 --export-lc 64 --export-t 16,32]
    python -m bist_tpu_torch.cli.serve --bundle B --port 8000

--export-bundle writes one `torch.export` program per geometry of the
cross product of the batch buckets and the --export-* buckets, on this
device type (--export-platforms cpu,cuda for both), and exits.  --bundle
serves from the bundle's programs and decode configuration (decode flags
given on the command line are ignored with a warning) and captures its
whole geometry table before it takes traffic (`warmup_geometries`).
--export-dp N writes a data-parallel bundle: each program decodes one of N
devices' row blocks (every batch bucket must divide by N), and serving it
needs N cards (`export.save_bundle`).
`bist_tpu`'s persistent compilation cache has no counterpart here: a CUDA
graph does not outlive its process, and the CUDA kernels are built once
per checkout (`ops._build`).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import os
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

# the decode flags a bundle's own configuration overrides
BUNDLE_IGNORES = ("decode_style", "beam", "maxlen", "penalty", "cache_dtype",
                  "encode_dtype", "scan_unroll", "temperature", "top_k", "top_p",
                  "sample_seed", "feat_int8", "feat_s")


def build_parser():
    p = argparse.ArgumentParser(description="bist_tpu_torch HTTP serving")
    p.add_argument("--model", default="",
                   help="checkpoint prefix: <prefix>.pt or <prefix>_best.pt "
                        "(+ <prefix>.conf), or a reference-format checkpoint")
    p.add_argument("--model-conf", default="")
    p.add_argument("--bundle", default="",
                   help="serve a bundle written by --export-bundle (its programs, "
                        "weights, vocabulary and decode configuration)")
    p.add_argument("--export-bundle", default="",
                   help="write a serving bundle of --model to this directory and exit")
    p.add_argument("--export-platforms", default="",
                   help="device types to export for, comma-separated (cpu, cuda); "
                        "default this --device's")
    p.add_argument("--export-lq", default="32", help="question length buckets")
    p.add_argument("--export-lh", default="64,256", help="history length buckets")
    p.add_argument("--export-lc", default="64", help="caption length buckets")
    p.add_argument("--export-t", default="",
                   help="clip-count buckets (default the serving time buckets)")
    p.add_argument("--export-workers", type=int, default=1,
                   help="programs exported at a time, each in a process of its own")
    p.add_argument("--export-dp", type=int, default=1,
                   help="data-parallel width of the bundle: each program takes "
                        "1/N of a batch's rows, and serving it needs N devices")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=10.0)
    p.add_argument("--pipeline-depth", type=int, default=4,
                   help="batches kept in flight under a backlog: batch N+1's "
                        "assembly, copy and launches overlap batch N's device "
                        "work; 1 = strictly serial")
    p.add_argument("--feat-int8", type=int, default=0,
                   help="quantise assembled feature grids to int8 on the host "
                        "(4x fewer bytes to the device, dequantised there)")
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--decode-style", default="beam_search",
                   choices=["beam_search", "greedy", "sample"],
                   help="greedy: one hypothesis row per request; sample: a "
                        "reproducible stream per request (its JSON may carry "
                        "a 'seed'); beam_search: the evaluation default")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--sample-seed", type=int, default=1,
                   help="base seed; answers are reproducible per "
                        "(sample seed, request seed)")
    p.add_argument("--cache-dtype", default="bfloat16",
                   choices=["float32", "bfloat16", "float8_e4m3fn", "float8_e5m2"],
                   help="storage of the decode memory; float32 gives the "
                        "answers of the generate CLI's default; float8 is "
                        "read as bfloat16 (answers may differ)")
    p.add_argument("--encode-dtype", default="", choices=["", "float32", "bfloat16"],
                   help="context-precompute activation dtype ('' = the "
                        "model's own; answers may differ from float32)")
    p.add_argument("--maxlen", type=int, default=12)
    p.add_argument("--penalty", type=float, default=1.0)
    p.add_argument("--scan-unroll", type=int, default=4,
                   help="accepted for CLI parity; the port's decode loop is a "
                        "Python loop, so there is nothing to unroll")
    p.add_argument("--feat-s", type=int, default=0,
                   help="spatial grid size S of the (T, S, Dv) features: pins "
                        "the served grid at warmup (other grids are rejected "
                        "at submit); 0 = unpinned")
    p.add_argument("--reference-root", default="",
                   help="a checkout of the reference, for serving reference-format "
                        "checkpoints (--model mtn_best + pickled .conf; detected)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.export_bundle:
        from bist_tpu_torch.serving import default_batch_buckets

        bad = [b for b in default_batch_buckets(args.max_batch) if b % max(args.export_dp, 1)]
        if args.export_dp < 1 or bad:
            raise SystemExit(f"batch buckets {bad} not divisible by --export-dp "
                             f"{args.export_dp} (the buckets of --max-batch "
                             f"{args.max_batch}: each program takes 1/{args.export_dp} "
                             f"of a batch's rows)")
    if not (args.model or args.bundle):
        p.error("--model is required unless --bundle is given")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s: %(message)s")

    import torch

    from bist_tpu_torch import resolve_device
    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.serving import DynamicBatcher, Responder

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.bundle:
        from bist_tpu_torch.export import load_bundle

        ignored = [f for f in BUNDLE_IGNORES if getattr(args, f) != p.get_default(f)]
        if ignored:
            logging.warning("--bundle serves the bundle's decode configuration; ignoring "
                            "%s", ", ".join("--" + f.replace("_", "-") for f in ignored))
        t0 = time.perf_counter()
        bundle = load_bundle(args.bundle, device)
        logging.info("bundle loaded in %.2f s: %d program(s), geometries %s",
                     time.perf_counter() - t0, len(bundle.programs),
                     sorted(bundle.geometries))
        cfg = bundle.cfg
        responder = bundle.make_responder()
        logging.info("warmup: every geometry of the bundle (%d)", len(bundle.geometries))
        responder.warmup_geometries(bundle.geometries.values())
    else:
        params, cfg, vocab = load_model(args, device)
        gcfg = GenerateConfig(maxlen=args.maxlen, beam=args.beam, penalty=args.penalty,
                              nbest=1, cache_dtype=args.cache_dtype,
                              encode_dtype=args.encode_dtype,
                              decode_style=args.decode_style,
                              temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, sample_seed=args.sample_seed)
        if args.export_bundle:
            export(args, p, params, cfg, gcfg, vocab)
            return
        responder = Responder(params, cfg, vocab, gcfg, max_batch=args.max_batch,
                              feat_int8=bool(args.feat_int8))
        logging.info("warmup: every batch bucket %s", responder.batch_buckets)
        responder.warmup(feature_shape=((args.feat_s, cfg.ft_sizes[0])
                                        if args.feat_s and cfg.has_video else None))
    prog = responder.stats()
    logging.info("warmup: %d geometries captured in %.2f s on %d device(s) (graph pools "
                 "%.1f MB)", prog["captures"], prog["capture_seconds"], prog["devices"],
                 prog["pool_bytes"] / 2 ** 20)
    batcher = DynamicBatcher(responder, max_batch=responder.max_batch,
                             max_wait_ms=args.max_wait_ms,
                             pipeline_depth=args.pipeline_depth)
    batcher.start()
    httpd = make_http_server(args.host, args.port, batcher,
                             requires_features=cfg.has_video)
    logging.info("serving on %s:%d", args.host, httpd.server_address[1])
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        batcher.stop()


def load_model(args, device):
    """(params on `device`, cfg, vocab) of --model: the port's checkpoint
    with its JSON .conf, or a reference-format checkpoint (pickled .conf)
    through `convert`."""
    from bist_tpu_torch.config import load_conf
    from bist_tpu_torch.convert import (default_conf_for, is_reference_conf,
                                        load_reference_checkpoint_cli)
    from bist_tpu_torch.weights import load_params

    conf = args.model_conf or default_conf_for(args.model)
    if is_reference_conf(conf):
        logging.info("reference-format checkpoint detected; importing")
        params, cfg, _, vocab, _ = load_reference_checkpoint_cli(
            args.model, conf, reference_root=args.reference_root or None, device=device)
        return params, cfg, vocab
    vocab, cfg, _, _ = load_conf(conf)
    base = args.model[:-3] if args.model.endswith(".pt") else args.model
    ckpt = next((c for c in (base + ".pt", base + "_best.pt") if os.path.exists(c)),
                base + ".pt")
    logging.info("loading %s onto %s", ckpt, device)
    return load_params(ckpt, device), cfg, vocab


def export(args, p, params, cfg, gcfg, vocab) -> None:
    """--export-bundle: one program per geometry of the cross product of the
    batch buckets and the --export-* buckets (every shape the bundle's
    Responder can assemble), written with the model's weights and vocab."""
    from bist_tpu_torch.export import default_serving_geometries, save_bundle
    from bist_tpu_torch.serving import DEFAULT_TIME_BUCKETS, default_batch_buckets

    if args.decode_style not in ("beam_search", "greedy"):
        p.error("--export-bundle supports --decode-style beam_search or greedy "
                "(sampling streams are a live server's policy)")

    def buckets(s):
        return tuple(int(x) for x in s.split(",") if x.strip())

    t_buckets = buckets(args.export_t) or DEFAULT_TIME_BUCKETS
    geoms = default_serving_geometries(
        cfg, batch_buckets=default_batch_buckets(args.max_batch),
        Lq=buckets(args.export_lq), Lh=buckets(args.export_lh),
        Lc=buckets(args.export_lc), T=t_buckets, S=args.feat_s or 16,
        Ta=t_buckets[-1] if cfg.has_audio else None, feat_int8=bool(args.feat_int8))
    platforms = tuple(s.strip() for s in args.export_platforms.split(",") if s.strip())
    t0 = time.perf_counter()
    save_bundle(args.export_bundle, params, cfg, gcfg, vocab, geoms,
                platforms=platforms or None, dp=args.export_dp, workers=args.export_workers)
    logging.info("bundle written to %s (%d geometries) in %.1f s", args.export_bundle,
                 len(geoms), time.perf_counter() - t0)


def make_http_server(host, port, batcher, *, requires_features=False):
    """The ThreadingHTTPServer over a DynamicBatcher, built and not started
    (tests drive it with an in-process Responder); port 0 picks a free port
    (read it back from httpd.server_address)."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "stats": batcher.stats})
            elif self.path == "/metrics":
                self._send(200, batcher.metrics())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/respond":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))

                def load_array(prefix):
                    # "<prefix>_b64" (base64 .npy bytes; an int8 array comes
                    # with "<prefix>_scale_b64") or "<prefix>" (nested lists)
                    if f"{prefix}_b64" in req:
                        raw = base64.b64decode(req[f"{prefix}_b64"])
                        arr = np.load(io.BytesIO(raw), allow_pickle=False)
                        if arr.dtype == np.int8:
                            skey = f"{prefix}_scale_b64"
                            if skey not in req:
                                raise ValueError(f"int8 {prefix} upload requires {skey}")
                            scale = np.load(io.BytesIO(base64.b64decode(req[skey])),
                                            allow_pickle=False)
                            arr = arr.astype(np.float32) * scale
                        return arr
                    if req.get(prefix) is not None:
                        return np.asarray(req[prefix], np.float32)
                    return None

                features = load_array("features")
                audio = load_array("audio")
                if features is None and requires_features:
                    self._send(400, {"error": "model requires features"})
                    return
                if "question" not in req:
                    self._send(400, {"error": "missing 'question' field"})
                    return
                t0 = time.time()
                answer = batcher.submit(
                    req["question"], history=req.get("history", ""),
                    caption=req.get("caption"), features=features,
                    audio=audio, seed=req.get("seed"))
                self._send(200, {"answer": answer,
                                 "latency_ms": (time.time() - t0) * 1e3})
            except (ValueError, KeyError) as e:
                # submit()'s checks or a malformed payload: the client's error
                self._send(400, {"error": str(e)})
            except Exception as e:
                logging.exception("/respond failed")
                self._send(500, {"error": str(e)})

        def log_message(self, fmt, *a):
            logging.debug(fmt, *a)

    return ThreadingHTTPServer((host, port), Handler)


if __name__ == "__main__":
    main()
