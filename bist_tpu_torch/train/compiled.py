"""Compiled training: the train step and the eval step as one CUDA graph per
batch geometry, the port's counterpart of the two `jax.jit` calls of
`bist_tpu.train.loop` (`make_train_step`, `make_eval_step`).

A `TrainProgram` is built on a TrainState and keeps one entry per geometry
(grad_accum and the shape and dtype of every Batch field that is not None).
A `StepProgram`, its base, does the same for any eager step on a TrainState
and any batch NamedTuple (`tasks.tgifqa`'s TgifBatch and its step).
The first call at a geometry runs the eager step (`loop.make_train_step`)
once on a side stream: that run IS the call's step (it updates the state
and its metrics are returned), and it builds and loads the kernels, sets
their shared-memory attributes and initialises autograd's device thread and
cuBLAS.  Then the step is captured into a `torch.cuda.CUDAGraph` in one
memory pool shared by the program's graphs; a capture executes nothing, so
no update is lost or done twice.  The graph holds the whole step: the
forward (K1 with residuals), the losses, `torch.autograd.grad` (K2 inside
autograd's backward), the zero fill of unused gradients and the Adam update,
with grad_accum > 1 the whole microbatch loop.  Later calls copy the batch
into the entry's static inputs without blocking, replay the graph and copy
the metrics into fresh tensors on the stream right after the replay, so
that a later replay (of any geometry: the graphs share their pool) cannot
overwrite them before `EpochStats` reads them.

The parameters, Adam's `mu`, `nu` and `count` are the program's static
state: they were allocated before any capture, outside the pool, and a
replay updates them in place, so the TrainState's tensors are always the
current ones (checkpoints and the eval program read them).  Adam keeps its
count on the device and computes the learning rate and the bias
corrections from it there (`train.schedule`), so each replay advances them.
An optimizer whose state is not tensors on the parameters' device cannot be
replayed: the program refuses it when it is built.

Dropout draws from the step's `torch.Generator`, registered with every
graph (`CUDAGraph.register_generator_state`): a replay reads the seed and
offset the generator holds when it starts, so re-seeding it from
`seed_for_step(seed, step)` before each call gives the eager step's masks.
`cfg.remat` (torch.utils.checkpoint) is captured like the rest without
dropout; with dropout its rounds draw from clones of the generator made
during the step, which no graph can register, so the program refuses that
configuration when it is built (train it with the eager step).

An `EvalProgram` is the eval step's forward and losses under no_grad (K1
without residuals), one graph per geometry, on the train program's
parameters.

Data-parallel (`dp`, a `parallel.DataParallel.in_group` of one process per
card): each rank's program captures the step with its collectives, the
all-reduce of the two token counts, the gradient all-reduce on the flat
buffer (allocated when the program is built, beside the parameters) and
the metric all-reduce, in the same graph as the forward, K1, K2 and Adam.
A replay runs each collective once, as the eager first call of a geometry
does, and a capture runs none, so the ranks stay in step whichever of the
two a call is.  Each rank takes its rows of one global batch, padded to the
global batch's buckets, so its geometry follows from the global one and
every rank captures at the same call; the eager first call is also the
collective NCCL needs before a capture.  gloo's collectives on CUDA
tensors cannot be captured: a program refuses a gloo group on the card when
it is built (step it with the eager `make_train_step`).

On the card a capture that fails raises, naming the geometry: a program
never carries on eagerly.  On the CPU nothing is captured: each call runs
the same step eagerly on the same static buffers with the same copy-in and
copy-out.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from bist_tpu_torch.config import ModelConfig, TrainConfig
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.decode.compiled import describe, no_gc, pool_bytes
from bist_tpu_torch.train.loop import Metrics, TrainState, make_eval_step, make_train_step
from bist_tpu_torch.weights import tree_leaves


class _Entry:
    """One geometry: its static inputs, its graph (None on the CPU) and the
    graph's static metrics."""

    def __init__(self, inputs: NamedTuple):
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outs: Metrics = {}


class _Program:
    """What the programs share: the geometries, the static inputs (one
    buffer per batch field, shape and dtype, shared by the geometries), one
    graph pool, and the warm-up, capture and replay of `_run(static batch)`,
    which returns a dict of 0-d metric tensors.  A batch is any NamedTuple
    of arrays or tensors (None for an absent field)."""

    def __init__(self, params, label: str, dp=None):
        self._leaves = tree_leaves(params)
        self.device = self._leaves[0].device
        self._cuda = self.device.type == "cuda"
        if dp is not None:
            if not dp.grouped:
                raise ValueError(f"{type(self).__name__}: dp must be a process group's "
                                 f"(DataParallel.in_group): one process drives one card")
            if self._cuda and dp.backend != "nccl":
                raise ValueError(
                    f"{type(self).__name__}: a {dp.backend} process group on CUDA: its "
                    f"collectives cannot be captured in a CUDA graph; use NCCL, or step "
                    f"eagerly with make_train_step")
            label = f"{label}, rank rows of {dp.n}"
        self._pool = torch.cuda.graph_pool_handle() if self._cuda else None
        self._label = label
        self._entries: Dict[tuple, _Entry] = {}
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self.captures = 0          # geometries captured
        self.eager_runs = 0        # eager warm-up steps (one before each capture)
        self.capture_seconds = 0.0  # warm-ups and captures
        self.warm_up_seconds = 0.0  # the warm-ups' part of it

    def _run(self, batch: NamedTuple) -> Metrics:
        raise NotImplementedError

    def _new_graph(self) -> torch.cuda.CUDAGraph:
        return torch.cuda.CUDAGraph()

    def _check_params(self, params) -> None:
        if tree_leaves(params)[0] is not self._leaves[0]:
            raise ValueError(f"{type(self).__name__}: these parameters are not the "
                             f"ones the program was built on")

    def _metrics(self, batch: NamedTuple) -> Metrics:
        kind = type(batch)
        src = kind(*[None if x is None else x if isinstance(x, torch.Tensor)
                     else torch.from_numpy(np.asarray(x)) for x in batch])
        key = (self._label,) + tuple(
            (name, tuple(x.shape), x.dtype) for name, x in zip(kind._fields, src)
            if x is not None)
        entry = self._entries.get(key)
        new = entry is None
        if new:
            entry = _Entry(kind(*[None if x is None else self._buffer(name, x)
                                  for name, x in zip(kind._fields, src)]))
        for dst, x in zip(entry.inputs, src):
            if x is not None:
                dst.copy_(x, non_blocking=True)
        if not self._cuda:
            out = self._run(entry.inputs)
        elif new:
            out = self._warm_up_and_capture(key, entry)
        else:
            entry.graph.replay()
            out = entry.outs
        out = {k: v.clone() for k, v in out.items()}
        if new:
            self._entries[key] = entry
        return out

    def _buffer(self, name: str, x: torch.Tensor) -> torch.Tensor:
        k = (name, tuple(x.shape), x.dtype)
        if k not in self._buffers:
            self._buffers[k] = torch.empty(x.shape, dtype=x.dtype, device=self.device)
        return self._buffers[k]

    def _warm_up_and_capture(self, key, entry: _Entry) -> Metrics:
        """The eager run of this call on a side stream (its metrics are the
        call's), then the capture of the same run into a graph of the pool."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._run(entry.inputs)
        current.wait_stream(side)
        side.synchronize()
        self.eager_runs += 1
        self.warm_up_seconds += time.perf_counter() - t0
        graph = self._new_graph()
        try:
            # the capture executes nothing: `out` stays the warm-up's metrics
            with no_gc(), torch.cuda.graph(graph, pool=self._pool,
                                           capture_error_mode="thread_local"):
                outs = self._run(entry.inputs)
        except Exception as e:
            # a capture that ends in an error leaves its stream current
            torch.cuda.set_stream(current)
            raise RuntimeError(f"{type(self).__name__}: capturing geometry "
                               f"{describe(key)} failed: {e}") from e
        entry.graph, entry.outs = graph, outs
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return out

    def stats(self) -> Dict[str, object]:
        """Geometries seen, captured, eager warm-up steps, capture seconds
        (the warm-ups' part of them apart) and the graph pool's bytes."""
        return {"geometries": len(self._entries), "captures": self.captures,
                "eager_runs": self.eager_runs, "capture_seconds": self.capture_seconds,
                "warm_up_seconds": self.warm_up_seconds,
                "pool_bytes": pool_bytes(self._pool)}


class StepProgram(_Program):
    """An eager train step on `state` as one CUDA graph per geometry:
    `step(state, batch, gen)` → (TrainState, metrics), updating the
    parameters and the optimizer state in place.  `program(state, batch,
    gen)` takes what the step takes (a host batch, pinned for a copy that
    does not block, or a device batch; `gen` the generator given here,
    re-seeded by the caller) and returns what it returns: (TrainState with
    step + 1, metrics)."""

    def __init__(self, state: TrainState, step: Callable, gen: Optional[torch.Generator] = None,
                 label: str = "train step", dp=None):
        super().__init__(state.params, label, dp)
        for name, value in state.opt_state.items():
            for t in value if isinstance(value, (list, tuple)) else [value]:
                if not (isinstance(t, torch.Tensor) and t.device == self.device):
                    raise ValueError(
                        f"{type(self).__name__}: the optimizer state's {name!r} holds a "
                        f"{type(t).__name__}"
                        f"{' on ' + str(t.device) if isinstance(t, torch.Tensor) else ''}, "
                        f"not a tensor on {self.device}: a graph replays only device "
                        f"tensors that the update changes in place (as "
                        f"train.schedule.Adam keeps its state)")
        self.state, self.gen = state, gen
        self._step = step

    def _new_graph(self) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        if self.gen is not None:
            graph.register_generator_state(self.gen)
        return graph

    def _run(self, batch: NamedTuple) -> Metrics:
        return self._step(self.state, batch, self.gen)[1]

    def __call__(self, state: TrainState, batch: NamedTuple,
                 gen: Optional[torch.Generator] = None):
        self._check_params(state.params)
        if gen is not self.gen:
            raise ValueError(f"{type(self).__name__}: step with the generator the program "
                             f"was built with (its graphs read that generator's state)")
        return state._replace(step=state.step + 1), self._metrics(batch)


class TrainProgram(StepProgram):
    """`make_train_step(cfg, tcfg, tx, grad_accum, dp)` on `state` as one
    CUDA graph per geometry (a StepProgram on AVSD's Batch)."""

    def __init__(self, state: TrainState, cfg: ModelConfig, tcfg: TrainConfig, tx,
                 grad_accum: int = 1, gen: Optional[torch.Generator] = None, dp=None):
        if cfg.remat and gen is not None:
            raise ValueError(
                "TrainProgram: remat with dropout draws each decoder round's masks "
                "from clones of the generator made during the step "
                "(models.bist.decoder_apply), which a CUDA graph cannot register; "
                "train this configuration with the eager make_train_step")
        super().__init__(state, make_train_step(cfg, tcfg, tx, grad_accum=grad_accum, dp=dp),
                         gen, f"train step, grad_accum {grad_accum}", dp)
        if dp is not None:
            dp.grad_buffer(self._leaves)    # static, outside the graphs' pool


class EvalProgram(_Program):
    """`make_eval_step(cfg, tcfg, dp)` on `params` (a train program's, so it
    reads the current weights) as one CUDA graph per geometry:
    `program(params, batch)` returns the eval step's metrics."""

    def __init__(self, params, cfg: ModelConfig, tcfg: TrainConfig, dp=None):
        super().__init__(params, "eval step", dp)
        self.params = params
        self._step = make_eval_step(cfg, tcfg, dp=dp)

    def _run(self, batch: Batch) -> Metrics:
        return self._step(self.params, batch)

    def __call__(self, params, batch: Batch) -> Metrics:
        self._check_params(params)
        return self._metrics(batch)
