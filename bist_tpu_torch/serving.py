"""Serving: dynamic-batching response generation on one device (after
`bist_tpu.serving`).

A `Responder` owns the parameters and the decode style and turns Requests
into answers; a `DynamicBatcher` thread coalesces concurrent requests into
batches of a few fixed geometries and hands them to the Responder.

  * a group of requests is padded to the smallest batch bucket that holds
    it (`default_batch_buckets`), each token field to its length bucket and
    the clips to a time bucket; padding rows are all-PAD and masked
    everywhere, so a row's answer does not depend on its neighbours;
  * one compiled program per (batch, shape-bucket) geometry: one CUDA
    graph of the decode (`decode.compiled.DecodeProgram`), captured at
    startup (`warmup()`), so no request group of a warmed geometry ever
    runs an eager decode; a geometry first seen at serve time is captured
    then, as `jax.jit` compiles at first use;
  * the batcher collects up to `max_batch` requests or waits `max_wait_ms`,
    whichever comes first.

`Responder.dispatch()` assembles the host batch (on a CUDA server the
feature grid straight into pinned memory), copies it into the geometry's
static inputs without waiting, replays the graph and copies its outputs
out on the stream; it returns while the device works.
`Responder.finish()` is where the host waits for the results
(`device_wait_s`) and extracts the answers.  Under a backlog the batcher
keeps up to `pipeline_depth` batches dispatched, so batch N+1's assembly
and replay overlap batch N's device work.

One device: the parameters' device is the serving device.  Serving over
several GPUs, AOT bundles (`bist_tpu`'s `beam_fn` and
`warmup_geometries`) and reference-format checkpoints are not ported yet.

Usage:
    responder = Responder(params, cfg, vocab, gcfg)
    responder.warmup()
    server = DynamicBatcher(responder, max_batch=64, max_wait_ms=10)
    server.start()
    answer = server.submit(question, history, caption, features)   # blocking
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bist_tpu_torch.config import GenerateConfig, ModelConfig
from bist_tpu_torch.data.batching import (Batch, bucket_len, pad_features, pad_tokens,
                                          pinned, quantize_features)
from bist_tpu_torch.decode.beam import BeamResult, extract_hyps
from bist_tpu_torch.decode.compiled import DecodeProgram
from bist_tpu_torch.vocab import EOS, PAD, SOS, ids2words, make_id2word, words2ids

log = logging.getLogger(__name__)

DEFAULT_LEN_BUCKETS = (16, 32, 64, 128, 256)
DEFAULT_TIME_BUCKETS = (16, 32, 48, 64)
SERVED_STYLES = ("beam_search", "greedy", "sample")


def default_batch_buckets(max_batch: int) -> Tuple[int, ...]:
    """The batch geometries: a group of requests is padded to the smallest
    bucket that holds it, so 3 queued requests do not pay for max_batch
    rows; under saturation every batch is max_batch."""
    return tuple(b for b in (8, 16, 32) if b < max_batch) + (max_batch,)


def _clamp_head(ids: np.ndarray, max_len: int) -> np.ndarray:
    """Truncate a [SOS, w.., EOS] sequence to max_len keeping the head words,
    EOS put back at the end."""
    if len(ids) <= max_len:
        return ids
    out = ids[:max_len].copy()
    out[-1] = EOS
    return out


def _clamp_tail(ids: np.ndarray, max_len: int) -> np.ndarray:
    """Truncate a [SOS, w.., EOS] sequence to max_len keeping the tail (the
    most recent history), SOS put back at the front."""
    if len(ids) <= max_len:
        return ids
    out = ids[-max_len:].copy()
    out[0] = SOS
    return out


@dataclass
class Request:
    question: np.ndarray
    history: np.ndarray
    caption: Optional[np.ndarray]
    features: Optional[np.ndarray]          # (T, S, Dv)
    audio: Optional[np.ndarray] = None
    seed: Optional[int] = None              # decode_style sample only: the
                                            # request's random stream
    _event: threading.Event = field(default_factory=threading.Event)
    _answer: Optional[str] = None
    _nbest: Optional[List[Tuple[List[str], float]]] = None
    _error: Optional[BaseException] = None


class Responder:
    """Owns the parameters and the decode style; turns Requests into
    answers on the parameters' device."""

    def __init__(self, params, cfg: ModelConfig, vocab: Dict[str, int],
                 gcfg: GenerateConfig, max_batch: int = 64,
                 len_buckets=DEFAULT_LEN_BUCKETS,
                 time_buckets=DEFAULT_TIME_BUCKETS,
                 batch_buckets: Optional[Tuple[int, ...]] = None,
                 feat_int8: bool = False,
                 audio_time_buckets=None,
                 feat_tail: Optional[Tuple[int, int]] = None):
        # validated first: a bad style fails at load, not on the first request
        if gcfg.decode_style not in SERVED_STYLES:
            raise ValueError(
                f"serving supports decode_style 'beam_search', 'greedy' or "
                f"'sample', not {gcfg.decode_style!r}")
        self._style = gcfg.decode_style
        self.params = params
        self.device = params["embed"]["lut"].device
        self.cfg = cfg
        self.gcfg = gcfg
        self.vocab = vocab
        self.id2word = make_id2word(vocab)
        self.max_batch = max_batch
        # one tuple for question, history and caption, or a
        # {"q": ..., "h": ..., "c": ...} dict of per-field buckets
        if isinstance(len_buckets, dict):
            self.q_buckets = tuple(sorted(len_buckets["q"]))
            self.h_buckets = tuple(sorted(len_buckets["h"]))
            self.c_buckets = tuple(sorted(len_buckets.get("c") or (16,)))
            self.len_buckets = tuple(sorted(
                {*self.q_buckets, *self.h_buckets, *self.c_buckets}))
        else:
            self.len_buckets = tuple(len_buckets)
            self.q_buckets = self.h_buckets = self.c_buckets = self.len_buckets
        self.time_buckets = tuple(time_buckets)
        self.audio_time_buckets = tuple(audio_time_buckets) \
            if audio_time_buckets else self.time_buckets
        # the per-clip feature shape (S, Dv) the server takes: set here or by
        # warmup(feature_shape=...); submit() rejects other grids, so one
        # malformed request cannot fail its whole coalesced batch
        self.feat_tail = tuple(feat_tail) if feat_tail else None
        self.batch_buckets = tuple(sorted(batch_buckets or default_batch_buckets(max_batch)))
        if self.batch_buckets[-1] != max_batch:
            raise ValueError(f"the largest batch bucket {self.batch_buckets[-1]} "
                             f"must be max_batch {max_batch}")
        # the decode: one CUDA graph per geometry (on the CPU, the same
        # stages run eagerly on its static buffers)
        self.program = DecodeProgram(params, cfg, gcfg)
        # cumulative seconds of each batch's parts, read through
        # DynamicBatcher.metrics()["component_seconds"]: host assembly,
        # the copy to the device and the graph's replay, the host's wait
        # for the device, token extraction
        self.timings = {"assemble_s": 0.0, "ship_s": 0.0,
                        "device_wait_s": 0.0, "extract_s": 0.0}
        # int8 features: the assembled grid quantised on the host (4x fewer
        # bytes to the device), dequantised on the device by encode()
        self.feat_int8 = feat_int8
        # auto-assigned sampling seeds count down from -1: disjoint from the
        # clients' seeds (submit() requires those >= 0)
        self._auto_seed = itertools.count(-1, -1)
        log.info("responder on %s: batch buckets %s, decode style %s",
                 self.device, self.batch_buckets, self._style)

    def tokenize(self, text: str) -> np.ndarray:
        return words2ids(text, self.vocab)

    def make_request(self, question: str, history: str = "",
                     caption: Optional[str] = None,
                     features: Optional[np.ndarray] = None,
                     audio: Optional[np.ndarray] = None,
                     seed: Optional[int] = None) -> Request:
        """The Request of a client's fields, as DynamicBatcher.submit makes
        it: each token field clamped to its largest length bucket with SOS
        and EOS kept (question and caption keep the head, history the most
        recent turns, the reference's policy, data_handler.py:79-85), the
        clips to the largest time bucket (the head ones)."""
        q_ids = _clamp_head(self.tokenize(question), self.q_buckets[-1])
        h_ids = _clamp_tail(self.tokenize(history), self.h_buckets[-1]) \
            if history else np.array([PAD], np.int32)
        c_ids = _clamp_head(self.tokenize(caption), self.c_buckets[-1]) \
            if caption is not None else None
        if features is not None:
            features = features[:self.time_buckets[-1]]
        if audio is not None:
            audio = audio[:self.audio_time_buckets[-1]]
        return Request(question=q_ids, history=h_ids, caption=c_ids,
                       features=features, audio=audio, seed=seed)

    def batch_rows(self, n_reqs: int) -> int:
        """The smallest batch bucket holding `n_reqs` rows; raises beyond the
        largest (the DynamicBatcher never exceeds max_batch; direct
        respond() callers must split)."""
        for b in self.batch_buckets:
            if n_reqs <= b:
                return b
        raise ValueError(
            f"{n_reqs} requests exceed the largest batch bucket "
            f"{self.batch_buckets[-1]}; split the group or raise max_batch")

    def make_batch(self, reqs: List[Request]) -> Batch:
        """The host batch of `reqs`, padded to its geometry with the
        assembly functions of the training and generation paths."""
        n = self.batch_rows(len(reqs))
        dummy = np.full((n, 1), SOS, np.int32)
        pad_rows = n - len(reqs)

        q = pad_tokens([r.question for r in reqs], self.q_buckets, n_rows=n)
        h = pad_tokens([r.history for r in reqs], self.h_buckets, n_rows=n)
        cap = None
        if self.cfg.has_caption:
            cap = pad_tokens([r.caption if r.caption is not None
                              else np.array([PAD], np.int32) for r in reqs],
                             self.c_buckets, n_rows=n)
        fts = None
        if self.cfg.has_video:
            T = bucket_len(max(r.features.shape[0] for r in reqs), self.time_buckets)
            tail = self.feat_tail or reqs[0].features.shape[1:]
            fts = pad_features([r.features for r in reqs], T, tail=tail, pad_rows=pad_rows,
                               out=None if self.feat_int8 else
                               self._grid((n, T) + tuple(tail)))
        audio = None
        if self.cfg.has_audio:
            Ta = bucket_len(max(r.audio.shape[0] for r in reqs),
                            self.audio_time_buckets)
            audio = pad_features([r.audio for r in reqs], Ta, pad_rows=pad_rows,
                                 out=self._grid((n, Ta) + reqs[0].audio.shape[1:]))
        fts_scale = None
        if fts is not None and self.feat_int8:
            fts, fts_scale = quantize_features(fts)
        return Batch(query=q, his=h, trg=dummy, trg_y=dummy, cap=cap,
                     fts=fts, audio_fts=audio, fts_scale=fts_scale)

    def _grid(self, shape) -> Optional[np.ndarray]:
        """A float32 host array for a batch's feature grid: on a CUDA server
        pinned memory (from PyTorch's caching host allocator, which reuses a
        block once the copies recorded on it are done), so the grid is
        written once and copied to the device without the host waiting."""
        if self.device.type != "cuda":
            return None
        return torch.empty(shape, dtype=torch.float32, pin_memory=True).numpy()

    def _pinned(self, host: Batch) -> Batch:
        """The host batch as CPU tensors; on a CUDA server in pinned memory
        (the grids are pinned already, the small token arrays are pinned
        here), so that the program copies them to the card without the host
        waiting: a blocking copy would wait for the batches still decoding
        on the stream."""
        return pinned(host, self.device)

    def dispatch(self, reqs: List[Request]):
        """Assemble the batch, copy it in and replay its geometry's graph
        (captured here if the geometry is new); returns a pending handle
        without waiting for the device.  finish() the
        handles in dispatch order."""
        t0 = time.perf_counter()
        host_batch = self.make_batch(reqs)
        seeds = None
        if self._style == "sample":
            seeds = [r.seed if r.seed is not None else next(self._auto_seed)
                     for r in reqs] + [0] * (len(host_batch.query) - len(reqs))
        t1 = time.perf_counter()
        # copy in and replay (row i samples from (sample_seed, seeds[i]):
        # reproducible per request and independent of the batch it lands in)
        out = self.program(self._pinned(host_batch), row_seeds=seeds)
        t2 = time.perf_counter()
        self.timings["assemble_s"] += t1 - t0
        self.timings["ship_s"] += t2 - t1
        # the host batch lives until finish(): its pinned memory is not
        # reused before the copies from it are done
        return out, reqs, host_batch

    def finish(self, pending) -> None:
        """Wait for a dispatch()ed batch's results and complete its requests."""
        out, reqs, _ = pending
        t0 = time.perf_counter()
        if self._style == "beam_search":
            out = BeamResult(*(t.cpu() for t in out))
        else:
            out = out.cpu().numpy()
        self.timings["device_wait_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            self._finish_host(out, reqs)
        finally:
            self.timings["extract_s"] += time.perf_counter() - t0

    def _finish_host(self, out, reqs) -> None:
        if self._style == "beam_search":
            for i, r in enumerate(reqs):
                hyps = extract_hyps(out, self.id2word, i, self.gcfg.nbest)
                r._nbest = hyps
                r._answer = " ".join(hyps[0][0]) if hyps else ""
                r._event.set()
            return
        for i, r in enumerate(reqs):
            words = ids2words(out[i], self.id2word)
            r._nbest = [(words, 0.0)]
            r._answer = " ".join(words)
            r._event.set()

    def respond(self, reqs: List[Request]) -> None:
        self.finish(self.dispatch(reqs))

    def warmup(self, feature_shape: Optional[Tuple[int, ...]] = None,
               lens=(16,), t_clips=16, all_batch_buckets: bool = True) -> None:
        """Capture the serving geometries before taking traffic (one CUDA
        graph each, `DecodeProgram`): every batch bucket (or only the
        smallest), each at the token lengths `lens` (question, history and
        caption all of length L) and `t_clips` clips.
        `feature_shape` (S, Dv) pins the served grid; without it a server
        takes whatever grid its first requests bring."""
        if self.cfg.has_video and self.feat_tail is None and feature_shape is not None:
            self.feat_tail = tuple(feature_shape)

        def mk(L):
            def tok(n):
                t = np.full((max(n, 2),), 4, np.int32)
                t[0], t[-1] = SOS, EOS
                return t

            return Request(
                question=tok(L), history=tok(L),
                caption=tok(L) if self.cfg.has_caption else None,
                features=np.zeros((t_clips,) + tuple(
                    feature_shape or (16, self.cfg.ft_sizes[0])), np.float32)
                if self.cfg.has_video else None,
                audio=np.zeros((t_clips, self.cfg.ft_sizes[1]), np.float32)
                if self.cfg.has_audio else None)

        buckets = self.batch_buckets if all_batch_buckets else self.batch_buckets[:1]
        for b in buckets:
            for L in lens:
                self.respond([mk(L) for _ in range(b)])


class DynamicBatcher:
    """Background thread coalescing requests into Responder batches."""

    def __init__(self, responder: Responder, max_batch: int = 64,
                 max_wait_ms: float = 10.0, pipeline_depth: int = 4):
        self.responder = responder
        self.max_batch = min(max_batch, responder.max_batch)
        self.max_wait = max_wait_ms / 1000.0
        # under a backlog up to `pipeline_depth` batches stay dispatched
        # before the oldest is waited for; sparse traffic (an empty queue
        # after a dispatch) is finished at once, so pipelining adds no
        # latency there.  1 = strictly serial.
        self.pipeline_depth = max(1, pipeline_depth)
        self._q: "queue.Queue[Request]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"requests": 0, "batches": 0, "errors": 0}
        # cumulative seconds the coalescing window was held open
        self.timings = {"coalesce_s": 0.0}
        # the latencies (seconds) of the last <= 4096 completed requests,
        # recorded by the clients' threads
        self._lat: List[float] = []
        self._lat_cap = 4096
        self._lat_lock = threading.Lock()

    def _record_latency(self, seconds: float) -> None:
        with self._lat_lock:
            if len(self._lat) >= self._lat_cap:
                del self._lat[: self._lat_cap // 2]
            self._lat.append(seconds)

    def metrics(self) -> Dict[str, object]:
        """Counters, queue depth, latency percentiles over the last <= 4096
        completed requests and the cumulative seconds of each part of a
        batch (serve's GET /metrics)."""
        with self._lat_lock:
            lat = sorted(self._lat)

        def pct(q: float) -> Optional[float]:
            if not lat:
                return None
            return lat[min(int(q * len(lat)), len(lat) - 1)] * 1e3

        return {
            **self.stats,
            "queue_depth": self._q.qsize(),
            "mean_batch_rows": self.stats["requests"] / max(self.stats["batches"], 1),
            "latency_ms": {"p50": pct(0.50), "p90": pct(0.90),
                           "p99": pct(0.99), "count": len(lat)},
            "error_rate": self.stats["errors"] / max(self.stats["requests"], 1),
            # coalescing window (batcher); assembly, ship and launches,
            # device wait, extraction (responder)
            "component_seconds": {**self.timings, **self.responder.timings},
        }

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _fail(self, reqs: List[Request], err: BaseException) -> None:
        # one error per request, so error_rate (errors / requests) keeps its
        # units when a whole batch fails
        self.stats["errors"] += len(reqs)
        for r in reqs:
            r._error = err
            r._event.set()

    def _finish_one(self, inflight: deque) -> None:
        pending = inflight.popleft()
        try:
            self.responder.finish(pending)
        except Exception as e:
            log.exception("batch failed while finishing")
            self._fail(pending[1], e)

    def _loop(self) -> None:
        inflight: deque = deque()
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                while inflight:                 # idle: finish everything
                    self._finish_one(inflight)
                continue
            reqs = [first]
            # monotonic: a wall-clock step must not stretch or shrink the
            # coalescing window
            t_co = time.monotonic()
            deadline = t_co + self.max_wait
            while len(reqs) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    reqs.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            self.timings["coalesce_s"] += time.monotonic() - t_co
            # one batch per feature grid: on a server whose grid is not
            # pinned, a request with another (S, Dv) must not fail its
            # neighbours (make_batch takes the group's first grid)
            groups: Dict[object, List[Request]] = {}
            for r in reqs:
                key = tuple(r.features.shape[1:]) if r.features is not None else None
                groups.setdefault(key, []).append(r)
            for group in groups.values():
                try:
                    inflight.append(self.responder.dispatch(group))
                except Exception as e:
                    # a bad batch fails its own requests, never the thread
                    log.exception("batch failed while dispatching")
                    self._fail(group, e)
            self.stats["requests"] += len(reqs)
            self.stats["batches"] += len(groups)
            while len(inflight) >= self.pipeline_depth or (inflight and self._q.empty()):
                self._finish_one(inflight)
        while inflight:
            self._finish_one(inflight)

    def submit(self, question: str, history: str = "",
               caption: Optional[str] = None,
               features: Optional[np.ndarray] = None,
               audio: Optional[np.ndarray] = None,
               timeout: float = 60.0, seed: Optional[int] = None) -> str:
        """Queue one request and wait for its answer.  Malformed requests
        raise ValueError here, before they are queued, so they cannot fail
        the batch they would have joined."""
        rsp = self.responder
        cfg = rsp.cfg
        if seed is not None:
            # a seed on a deterministic server is a client's mistake: they
            # expect seeded sampling
            if rsp._style != "sample":
                raise ValueError(
                    f"'seed' is only meaningful with decode_style 'sample' "
                    f"(this server decodes {rsp._style!r})")
            if isinstance(seed, bool) or not isinstance(seed, (int, np.integer)):
                raise ValueError(f"seed must be an integer, got {type(seed).__name__}")
            # negative seeds are the server's own (unseeded requests)
            if not 0 <= int(seed) < 2 ** 31:
                raise ValueError(f"seed must be in [0, 2**31), got {seed}")
        if cfg.has_video and features is None:
            raise ValueError("model requires video features")
        if cfg.has_audio and audio is None:
            raise ValueError("model requires audio features")
        if features is not None:
            if np.ndim(features) != 3:
                raise ValueError(f"features must be (T, S, Dv), got "
                                 f"shape {np.shape(features)}")
            if rsp.feat_tail is not None and tuple(features.shape[1:]) != rsp.feat_tail:
                raise ValueError(
                    f"features per-clip shape {tuple(features.shape[1:])} "
                    f"!= served grid {rsp.feat_tail}")
            elif rsp.feat_tail is None and cfg.ft_sizes \
                    and features.shape[2] != cfg.ft_sizes[0]:
                raise ValueError(f"feature dim {features.shape[2]} != "
                                 f"model ft_size {cfg.ft_sizes[0]}")
        if audio is not None:
            if np.ndim(audio) != 2:
                raise ValueError(f"audio must be (Ta, Da), got shape {np.shape(audio)}")
            if cfg.has_audio and len(cfg.ft_sizes) > 1 and audio.shape[1] != cfg.ft_sizes[1]:
                raise ValueError(f"audio dim {audio.shape[1]} != "
                                 f"model audio ft_size {cfg.ft_sizes[1]}")
        r = rsp.make_request(question, history, caption, features, audio, seed)
        t0 = time.monotonic()
        self._q.put(r)
        if not r._event.wait(timeout):
            raise TimeoutError("response generation timed out")
        self._record_latency(time.monotonic() - t0)
        if r._error is not None:
            raise RuntimeError(f"batch failed: {r._error}") from r._error
        return r._answer
