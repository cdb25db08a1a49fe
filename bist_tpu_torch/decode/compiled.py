"""Compiled decoding: one CUDA graph per decode geometry, the port's
counterpart of `bist_tpu.decode.beam.beam_search_jit` and of the `jax.jit`
wrappers of `bist_tpu.serving.Responder` and `bist_tpu.cli.generate`.

A `DecodeProgram` is built from (params or a list of them, cfg, gcfg; the
style is gcfg.decode_style) and keeps one entry per geometry: the style and the shape and dtype
of every Batch field that is not None.  Given a `beam_fn` (a serving
bundle's programs, `export.Bundle.beam_fn`), the program captures that
function on (params, static batch) in place of the eager stages, in one
graph, the same way; a geometry the function does not carry raises its
KeyError at the first call, before any capture.

The first call at a geometry runs the decode once eagerly on a side
stream (which builds and loads the kernels, fills the positional tables
and sets the kernels' shared-memory attributes) and then captures it into
a `torch.cuda.CUDAGraph`, in one memory pool shared by the program's
graphs.  Every call copies the batch
into the entry's static inputs without blocking, replays the graph and
copies the static outputs into fresh tensors on the stream right after the
replay, so that no later replay (of any geometry: the graphs share their
pool) overwrites a result before it is read.  A replay runs the code of the
eager functions (`decode.beam`, `decode.sample`) on the same inputs, so it
gives exactly their tokens.

  * Beam search without `early_exit` is one graph: the context precompute
    and all `maxlen` steps.  With `early_exit` it is one graph for the
    precompute and one per step l; between two replays the host reads the
    exact bound (`decode.beam._converged`, a sync), at the same l as the
    eager loop.  An ensemble's models all step inside the same graph.
  * Sampling draws its uniforms outside the graph, from one generator per
    row (`decode.sample._uniforms`), into a static input: the draws stay
    reproducible per (seed, row seed) and independent of the batch.
  * Static inputs of one field, shape and dtype are shared by the
    geometries (a 64-row grid of 48 clips is 403 MB).

On the card a capture that fails raises, naming the geometry: the program
never carries on eagerly.  On the CPU nothing is captured: each call runs
the same stages eagerly on the same static buffers with the same copy-in
and copy-out.  A lock serialises calls: an entry's buffers hold one batch
at a time on the host's side (the device work is ordered by the stream).
A CUDA graph does not outlive its process, so there is no persistent cache
(`bist_tpu`'s `utils/cache.py`); the kernels' build cache is `ops/_build.py`.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from bist_tpu_torch.config import GenerateConfig, ModelConfig
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.decode import beam, sample

STYLES = ("beam_search", "greedy", "sample", "oracle")


def describe(key) -> str:
    """A geometry key as text: the style, then each field's shape and dtype."""
    return f"{key[0]}: " + ", ".join(
        f"{name} {tuple(shape)} {str(dtype).replace('torch.', '')}"
        for name, shape, dtype in key[1:])


@contextlib.contextmanager
def no_gc():
    """Python's cyclic garbage collector held off (during a capture): a
    collection that frees an unreachable program's CUDA graphs mid-capture
    destroys them on the capturing thread, which CUDA forbids, and the
    capture fails."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def pool_bytes(pool) -> int:
    """Device bytes a graph memory pool holds (0 for None, on the CPU)."""
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


class _Entry:
    """One geometry: its static inputs (stage 0's input), its graphs (none
    on the CPU) and each graph's static outputs."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.outs: list = []


class DecodeProgram:
    """gcfg's decode style of one model (or, by beam search, an ensemble) as
    one CUDA graph per geometry.  `program(batch)` takes a host batch
    (numpy arrays or CPU tensors, pinned for a copy that does not block) or
    a device batch and returns what the eager function returns: a
    `BeamResult` by beam search, (B, maxlen) token ids greedily or sampled,
    (B, Lt) ids by oracle; `seed` and `row_seeds` are sampling's
    (`sample.sample_decode`; `seed` defaults to gcfg.sample_seed)."""

    def __init__(self, params, cfg: ModelConfig, gcfg: GenerateConfig, beam_fn=None):
        style = gcfg.decode_style
        if style not in STYLES:
            raise ValueError(f"decode style {style!r}: expected one of {STYLES}")
        ensemble = isinstance(params, (list, tuple))
        if ensemble and style != "beam_search":
            raise ValueError("an ensemble decodes by beam search only")
        if beam_fn is not None and (ensemble or style not in ("beam_search", "greedy")):
            raise ValueError("a beam_fn decodes one model by beam search or greedily")
        self.params_list = list(params) if ensemble else [params]
        self.cfg, self.gcfg, self.style = cfg, gcfg, style
        self.beam_fn = beam_fn
        self.device = self.params_list[0]["embed"]["lut"].device
        self._cuda = self.device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if self._cuda else None
        self._stages, self._stop, self._result = self._plan()
        self._entries: Dict[tuple, _Entry] = {}
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self._lock = threading.Lock()
        self.captures = 0          # geometries captured
        self.eager_runs = 0        # eager warm-up runs (one before each capture)
        self.capture_seconds = 0.0

    # -- the decode as stages -------------------------------------------

    def _plan(self):
        """(stages, stop, result): stage 0 maps (static batch, uniforms) to
        a state, stage i > 0 the state before it to the next; stop(state,
        i) says before stage i whether the decode is done; result(state)
        gives the output tensors."""
        P, cfg, g = self.params_list, self.cfg, self.gcfg
        if self.beam_fn is not None:
            # one stage: the function (a bundle's programs) on the static batch
            # (the function, not `self`, in the closure: no cycle keeps an
            # unused program and its graphs alive)
            fn = self.beam_fn
            return ([lambda inp: fn(P[0], inp[0])], None,
                    (lambda out: tuple(out)) if self.style == "beam_search"
                    else (lambda out: (out,)))
        if self.style == "beam_search":
            result = lambda s: tuple(beam._result(s))
            if not g.early_exit:
                def search(inp):
                    s = beam._start(P, cfg, inp[0], g)
                    for l in range(g.maxlen):
                        s = beam._step(P, cfg, g, s, l)
                    return s
                return [search], None, result
            # stage i > 0 is step i - 1
            return ([lambda inp: beam._start(P, cfg, inp[0], g)]
                    + [functools.partial(beam._step, P, cfg, g, l=l) for l in range(g.maxlen)],
                    lambda s, i: beam._converged(s.scores, s.comp_scores, i - 1, g),
                    result)
        p = P[0]
        if self.style == "greedy":
            body = lambda inp: beam.greedy_decode(
                p, cfg, inp[0], g.maxlen, cache_dtype=g.cache_dtype,
                encode_dtype=g.encode_dtype, compute_dtype=g.compute_dtype)
        elif self.style == "sample":
            body = lambda inp: sample._sample(
                p, cfg, inp[0], inp[1], g.temperature, g.top_k, g.top_p,
                g.cache_dtype, g.encode_dtype)
        else:
            body = lambda inp: beam.oracle_decode(p, cfg, inp[0])
        return [body], None, lambda out: (out,)

    # -- calls ----------------------------------------------------------

    @torch.no_grad()
    def __call__(self, batch: Batch, *, seed: Optional[int] = None,
                 row_seeds: Optional[Sequence[int]] = None,
                 uniforms: Optional[torch.Tensor] = None):
        """`uniforms` (sampling, (B, maxlen, V)) replaces the draws from
        (seed, row_seeds): a data-parallel caller's rows of one batch's
        draws (`ShardedDecode`)."""
        src = Batch(*[None if x is None else x if isinstance(x, torch.Tensor)
                      else torch.from_numpy(np.asarray(x)) for x in batch])
        B = src.query.shape[0]
        if self.style == "sample":
            sample.check_row_seeds(row_seeds, B)
        key = (self.style,) + tuple(
            (name, tuple(x.shape), x.dtype) for name, x in zip(Batch._fields, src)
            if x is not None)
        with self._lock:
            entry = self._entries.get(key)
            new = entry is None
            if new:
                entry = _Entry(self._static_inputs(src, B))
            static, u = entry.inputs
            for dst, x in zip(static, src):
                if x is not None:
                    dst.copy_(x, non_blocking=True)
            if u is not None and uniforms is not None:
                u.copy_(uniforms, non_blocking=True)
            elif u is not None:
                sample._uniforms(self.device, self.gcfg.sample_seed if seed is None
                                 else seed, B, u.shape[1], u.shape[2], row_seeds, out=u)
            if not self._cuda:
                state = self._eager(entry.inputs, early=True)
            else:
                if new:
                    self._capture(key, entry)
                state = self._replay(entry)
            out = tuple(t.clone() for t in self._result(state))
            if new:
                self._entries[key] = entry
        return beam.BeamResult(*out) if self.style == "beam_search" else out[0]

    def _static_inputs(self, src: Batch, B: int):
        """The static inputs of a new geometry: one buffer per Batch field
        (shared with the geometries that have a field of that shape and
        dtype) and, to sample, one for the uniforms."""
        def buffer(name, shape, dtype):
            k = (name, tuple(shape), dtype)
            if k not in self._buffers:
                self._buffers[k] = torch.empty(shape, dtype=dtype, device=self.device)
            return self._buffers[k]

        static = Batch(*[None if x is None else buffer(name, x.shape, x.dtype)
                         for name, x in zip(Batch._fields, src)])
        u = None
        if self.style == "sample":
            u = buffer("uniforms", (B, self.gcfg.maxlen, self.cfg.vocab_size),
                       torch.float32)
        return static, u

    def _eager(self, state, early: bool):
        for i, stage in enumerate(self._stages):
            if i and early and self._stop(state, i):
                break
            state = stage(state)
        return state

    def _replay(self, entry: _Entry):
        entry.graphs[0].replay()
        state = entry.outs[0]
        for i in range(1, len(entry.graphs)):
            if self._stop(state, i):
                break
            entry.graphs[i].replay()
            state = entry.outs[i]
        return state

    def _capture(self, key, entry: _Entry) -> None:
        """Warm the geometry up eagerly on a side stream (every stage), then
        capture each stage into a graph of the shared pool."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._eager(entry.inputs, early=False)
        current.wait_stream(side)
        self.eager_runs += 1
        state = entry.inputs
        try:
            for stage in self._stages:
                g = torch.cuda.CUDAGraph()
                with no_gc(), torch.cuda.graph(g, pool=self._pool,
                                               capture_error_mode="thread_local"):
                    state = stage(state)
                entry.graphs.append(g)
                entry.outs.append(state)
        except Exception as e:
            # a capture that ends in an error leaves its stream current
            torch.cuda.set_stream(current)
            entry.graphs.clear()
            entry.outs.clear()
            raise RuntimeError(f"DecodeProgram: capturing the {self.style} decode at "
                               f"geometry {describe(key)} failed: {e}") from e
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0

    # -- reports --------------------------------------------------------

    def geometries(self) -> List[Dict[str, Any]]:
        """The geometries entered so far, in order, each as
        `export.geometry_of` describes a batch of it: the table
        `Responder.warmup_geometries` takes."""
        from bist_tpu_torch.export import geometry_of

        with self._lock:
            keys = list(self._entries)
        return [geometry_of(Batch(**dict(dict.fromkeys(Batch._fields), **{
            name: torch.empty(shape, dtype=dtype, device="meta")
            for name, shape, dtype in key[1:]}))) for key in keys]

    def stats(self) -> Dict[str, object]:
        """Geometries seen, captured, eager warm-up runs, capture seconds and
        the pool's bytes."""
        with self._lock:
            n = len(self._entries)
        return {"geometries": n, "captures": self.captures,
                "eager_runs": self.eager_runs, "capture_seconds": self.capture_seconds,
                "pool_bytes": pool_bytes(self._pool)}


class ShardedDecode:
    """Data-parallel decoding: one `DecodeProgram` per device of `devices`
    (a list that may repeat a device), each on that device's copy of the
    parameters (`parallel.DataParallel.put_replicated`), with its own graphs.
    `decoder(batch)` splits the batch into `DataParallel.shard`'s row blocks
    (device i rows [i·B/n, (i+1)·B/n); B must divide by n), copies each block
    to its device and replays every device's graph before it waits for any;
    `gather(pending)` waits and returns the answers in row order on the CPU
    (a `BeamResult` of CPU tensors, or (B, maxlen) ids).  Rows are
    independent, so the answers are the one-device program's.  On one device
    it is that program, the batch not split.

    Sampling: with `row_seeds` each block takes its rows' seeds; without,
    the whole batch's uniforms are drawn once (on the first device) and each
    block copies its rows, so the draws do not depend on the device count."""

    def __init__(self, params, cfg: ModelConfig, gcfg: GenerateConfig,
                 devices: Optional[Sequence] = None, beam_fn=None):
        from bist_tpu_torch.parallel.mesh import DataParallel

        models = list(params) if isinstance(params, (list, tuple)) else [params]
        first = models[0]["embed"]["lut"].device
        self.dp = DataParallel(devices=devices if devices is not None else [first])
        self.devices = self.dp.devices
        replicas = [self.dp.put_replicated(p) for p in models]       # [model][device]
        self.programs = [
            DecodeProgram([r[i] for r in replicas] if isinstance(params, (list, tuple))
                          else replicas[0][i], cfg, gcfg, beam_fn=beam_fn)
            for i in range(self.dp.n)]
        self.cfg, self.gcfg = cfg, gcfg

    @property
    def n(self) -> int:
        return self.dp.n

    def __call__(self, batch: Batch, *, seed: Optional[int] = None,
                 row_seeds: Optional[Sequence[int]] = None) -> list:
        """The pending outputs, one per device (each on its device)."""
        if self.n == 1:
            return [self.programs[0](batch, seed=seed, row_seeds=row_seeds)]
        from bist_tpu_torch.parallel.mesh import row_slice

        B = batch.query.shape[0]
        u = None
        g = self.gcfg
        if g.decode_style == "sample":
            sample.check_row_seeds(row_seeds, B)
            if row_seeds is None:
                u = sample._uniforms(self.devices[0], g.sample_seed if seed is None else seed,
                                     B, g.maxlen, self.cfg.vocab_size, None)
        out = []
        for i, (prog, block) in enumerate(zip(self.programs, self.dp.blocks(batch))):
            rows = row_slice(i, self.n, B)
            out.append(prog(block, seed=seed,
                            row_seeds=None if row_seeds is None else list(row_seeds[rows]),
                            uniforms=None if u is None else u[rows]))
        return out

    def gather(self, pending: list):
        """Wait for the pending outputs and return them in row order on the
        CPU."""
        beam_search = self.gcfg.decode_style == "beam_search"
        parts = [beam.BeamResult(*(t.cpu() for t in out)) if beam_search else out.cpu()
                 for out in pending]
        if len(parts) == 1:
            return parts[0]
        if beam_search:
            return beam.BeamResult(*(torch.cat(f) for f in zip(*parts)))
        return torch.cat(parts)

    def stats(self) -> Dict[str, object]:
        """`DecodeProgram.stats` summed over the devices' programs."""
        per = [p.stats() for p in self.programs]
        out = {k: sum(s[k] for s in per) for k in per[0]}
        out["devices"] = self.n
        return out
