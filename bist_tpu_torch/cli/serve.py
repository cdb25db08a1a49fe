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
<model>.pt (or <model>_best.pt), captures every batch bucket's decode as a
CUDA graph (warmup; on the CPU it runs each once) and
logs "serving on <host>:<port>" with the port it bound (--port 0 picks a
free one).  It runs on CUDA unless --device cpu is given, and raises
without CUDA otherwise.  Concurrent requests are coalesced into batches
(`serving.DynamicBatcher`).

Not ported yet, and refused with an error that names the ROADMAP item:
AOT bundles (--bundle, --export-*; queue 1 item 6) and reference-format
checkpoints (--reference-root; queue 1 item 7).  `bist_tpu`'s persistent
compilation cache has no counterpart here: the port runs eagerly and
builds its CUDA kernels once per checkout (`ops._build`).
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

# flags of bist_tpu's serve CLI the port refuses, and the ROADMAP item each waits for
_BUNDLES = "AOT bundles (ROADMAP queue 1 item 6)"
NOT_PORTED = {"bundle": _BUNDLES,
              **{f"export_{f}": _BUNDLES
                 for f in ("bundle", "platforms", "lq", "lh", "lc", "t", "dp")},
              "reference_root": "reference-format checkpoints (ROADMAP queue 1 item 7)"}


def build_parser():
    p = argparse.ArgumentParser(description="bist_tpu_torch HTTP serving")
    p.add_argument("--model", default="",
                   help="checkpoint prefix: <prefix>.pt or <prefix>_best.pt "
                        "(+ <prefix>.conf)")
    p.add_argument("--model-conf", default="")
    p.add_argument("--bundle", default="", help="not ported yet")
    p.add_argument("--export-bundle", default="", help="not ported yet")
    p.add_argument("--export-platforms", default="", help="not ported yet")
    p.add_argument("--export-lq", default="32", help="not ported yet")
    p.add_argument("--export-lh", default="64,256", help="not ported yet")
    p.add_argument("--export-lc", default="64", help="not ported yet")
    p.add_argument("--export-t", default="", help="not ported yet")
    p.add_argument("--export-dp", type=int, default=1, help="not ported yet")
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
    p.add_argument("--reference-root", default="", help="not ported yet")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    for name, what in NOT_PORTED.items():
        if getattr(args, name) != p.get_default(name):
            raise SystemExit(f"--{name.replace('_', '-')}: {what} are not "
                             f"ported to bist_tpu_torch yet")
    if not args.model:
        p.error("--model is required")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s: %(message)s")

    import torch

    from bist_tpu_torch import resolve_device
    from bist_tpu_torch.config import GenerateConfig, default_conf_for, load_conf
    from bist_tpu_torch.serving import DynamicBatcher, Responder
    from bist_tpu_torch.weights import load_params

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    vocab, cfg, _, _ = load_conf(args.model_conf or default_conf_for(args.model))
    base = args.model[:-3] if args.model.endswith(".pt") else args.model
    ckpt = next((c for c in (base + ".pt", base + "_best.pt") if os.path.exists(c)),
                base + ".pt")
    logging.info("loading %s onto %s", ckpt, device)
    params = load_params(ckpt, device)
    gcfg = GenerateConfig(maxlen=args.maxlen, beam=args.beam, penalty=args.penalty,
                          nbest=1, cache_dtype=args.cache_dtype,
                          encode_dtype=args.encode_dtype,
                          decode_style=args.decode_style,
                          temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, sample_seed=args.sample_seed)
    responder = Responder(params, cfg, vocab, gcfg, max_batch=args.max_batch,
                          feat_int8=bool(args.feat_int8))
    logging.info("warmup: every batch bucket %s", responder.batch_buckets)
    responder.warmup(feature_shape=((args.feat_s, cfg.ft_sizes[0])
                                    if args.feat_s and cfg.has_video else None))
    prog = responder.program.stats()
    logging.info("warmup: %d geometries captured in %.2f s (graph pool %.1f MB)",
                 prog["captures"], prog["capture_seconds"], prog["pool_bytes"] / 2 ** 20)
    batcher = DynamicBatcher(responder, max_batch=args.max_batch,
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
