"""Training step + epoch loop (after `bist_tpu.train.loop`).

Reference counterpart: train.py (epoch loop, run_epoch, CSV artifacts,
best-checkpoint logic).  As in the JAX package:

  * loss normalisation uses the whole batch's token counts, also when the
    batch is split into gradient-accumulation microbatches, so accumulated
    gradients equal the single-batch ones, and, data-parallel, the GLOBAL
    batch's counts on every rank, with the ranks' gradients summed, so n
    ranks compute the one-device step (`make_grad_step`);
  * checkpoints carry params + optimizer state + step (train/checkpoint.py);
  * CSV artifacts keep the reference's file names and column layout
    (train.py:121-128,151-155).

What differs: the steps here run eagerly, and `train.compiled` captures
each into one CUDA graph per batch geometry (the counterpart of the jit);
parameters are leaf tensors (`requires_grad`) updated in place by the
optimizer, as the JAX step donates its state; dropout draws from an
explicit `torch.Generator`, re-seeded every step from (seed, step) as the
JAX loop folds the step into its key, so a resumed run draws what an
uninterrupted one would.  Its bits differ from JAX's: with dropout the two
packages agree only in distribution.
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from bist_tpu_torch.config import ModelConfig, TrainConfig
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.decode.sample import mix_seed
from bist_tpu_torch.models.model import forward_logprobs, init_model
from bist_tpu_torch.train.losses import compute_losses
from bist_tpu_torch.train.schedule import Adam, make_optimizer
from bist_tpu_torch.vocab import PAD
from bist_tpu_torch.weights import tree_leaves, tree_map

log = logging.getLogger(__name__)

Metrics = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Any             # parameter tree, leaves requiring grad
    opt_state: Any          # Adam state: {"count", "mu", "nu"} (leaf order)
    step: int


def trainable(params):
    """A copy of the tree, every leaf a float32 tensor that requires grad
    (the optimizer updates the copy in place)."""
    return tree_map(lambda t: t.detach().float().clone().requires_grad_(True), params)


def create_train_state(seed: int, cfg: ModelConfig, tcfg: TrainConfig,
                       device=None) -> Tuple[TrainState, Adam]:
    params = trainable(init_model(seed, cfg, device=device))
    tx = make_optimizer(cfg.d_model, tcfg.warmup_steps, tcfg.noam_factor,
                        tcfg.adam_b1, tcfg.adam_b2, tcfg.adam_eps)
    return TrainState(params, tx.init(tree_leaves(params)), 0), tx


def dropout_generator(cfg: ModelConfig, device) -> Optional[torch.Generator]:
    """The generator dropout draws from, or None when the config has no
    dropout: then hop 1 runs K1/K2 (`ops.dispatch`).  The reference keeps
    attention dropout at 0.1 even with --dropout 0 (mtn.py:77), so both
    rates must be 0 for that."""
    if cfg.dropout > 0 or cfg.attn_dropout > 0:
        return torch.Generator(device=device)
    return None


def seed_for_step(seed: int, step: int, rank: int = 0) -> int:
    """The dropout seed of one step, the counterpart of jax.random.fold_in.
    A data-parallel rank r > 0 draws from another stream (the seed mixed
    with r through every bit: a CPU generator keeps only a seed's low 32
    bits), so two ranks never apply the same masks to their rows; rank 0
    draws what a one-process run draws."""
    base = (seed << 32) + step
    return base if rank == 0 else mix_seed(base, rank)


def make_grad_step(cfg: ModelConfig, tcfg: TrainConfig, grad_accum: int = 1,
                   dp=None) -> Callable:
    """Returns (params, batch, gen) → (loss, metrics, grads): the forward,
    the losses and `torch.autograd.grad` of the train step, without the
    update.  `grads` follow `tree_leaves(params)` (zeros where a leaf is not
    reached).

    grad_accum > 1 splits the batch into `grad_accum` microbatches and sums
    their gradients; the loss normalisers (ntokens/qntokens) are counted on
    the FULL batch before the split, so the sum equals the one-batch
    gradient.  With `dp` (`parallel.DataParallel.in_group`), `batch` is this
    rank's rows of a global batch: the two counts are summed across the
    ranks before the loss (one all-reduce), so every rank normalises on the
    GLOBAL batch, as `bist_tpu` does; then the gradients are SUMMED across
    the ranks (`all_reduce_grads`) and so are the metrics (one all-reduce),
    which makes the n ranks' step the one-device step on the global batch.
    A mean of per-rank losses (DDP's) would weight a rank's tokens by the
    inverse of its own count, which is wrong whenever the ranks' rows hold
    different numbers of tokens."""

    def loss_and_grads(params, leaves, batch: Batch, gen, norm_override=None):
        logp, ft = forward_logprobs(params, cfg, batch, rngs=gen)
        loss, metrics = compute_losses(logp, ft, params["embed"]["lut"], cfg,
                                       batch, tcfg.smoothing,
                                       norm_override=norm_override)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def grad_fn(params, batch: Batch, gen=None):
        leaves = tree_leaves(params)
        if grad_accum == 1 and dp is None:
            return loss_and_grads(params, leaves, batch, gen)
        norm = (torch.sum(batch.trg_y != PAD), torch.sum(batch.query != PAD))
        if dp is not None:
            norm = tuple(dp.all_reduce_sum(norm))
        grads, loss, metrics = None, 0.0, None
        for i in range(grad_accum):
            micro = batch if grad_accum == 1 else Batch(
                *[None if x is None else x.reshape((grad_accum, -1) + x.shape[1:])[i]
                  for x in batch])
            l_i, m_i, g_i = loss_and_grads(params, leaves, micro, gen, norm_override=norm)
            loss = loss + l_i
            if grads is None:
                grads, metrics = g_i, dict(m_i)
            else:
                torch._foreach_add_(grads, g_i)
                metrics = {k: metrics[k] + m_i[k] for k in metrics}
        # each microbatch reported the GLOBAL counts (norm_override): keep
        # them once
        metrics["ntokens"], metrics["qntokens"] = norm
        if dp is not None:
            grads = dp.all_reduce_grads(grads)
            loss, metrics = _sum_over_ranks(dp, loss, metrics)
        return loss, metrics, grads

    return grad_fn


def _sum_over_ranks(dp, loss, metrics):
    """The loss and the metric sums summed across the ranks in one
    all-reduce (the counts are global already)."""
    names = [k for k in metrics if k not in ("ntokens", "qntokens")]
    parts = [loss] + [metrics[k] for k in names]
    summed = dp.all_reduce_sum([t.float() for t in parts])
    out = dict(metrics)
    for k, v, t in zip(names, summed[1:], parts[1:]):
        out[k] = v.to(t.dtype)
    return summed[0].to(loss.dtype), out


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, tx: Adam,
                    grad_accum: int = 1, dp=None) -> Callable:
    """Returns (state, batch, gen) → (state, metrics); `gen` is the dropout
    generator (None without dropout).  metrics are 0-d tensors on the
    device, read by the caller when it needs them.  The gradients are
    `make_grad_step`'s (grad_accum microbatches, peak activation memory
    shrinking by the same factor; with `dp`, this rank's rows of a global
    batch and the sums across the ranks), then ONE optimizer update."""
    grad_fn = make_grad_step(cfg, tcfg, grad_accum=grad_accum, dp=dp)

    def step_fn(state: TrainState, batch: Batch, gen=None):
        loss, metrics, grads = grad_fn(state.params, batch, gen)
        opt_state = tx.update(tree_leaves(state.params), grads, state.opt_state)
        metrics["loss"] = loss
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return step_fn


def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig, dp=None) -> Callable:
    """Returns (params, batch) → metrics.  With `dp` (a process group),
    `batch` is this rank's rows: the counts, the loss and the metric sums
    are those of the global batch on every rank."""
    @torch.no_grad()
    def step_fn(params, batch: Batch) -> Metrics:
        logp, ft = forward_logprobs(params, cfg, batch, rngs=None)
        norm = None
        if dp is not None:
            norm = tuple(dp.all_reduce_sum((torch.sum(batch.trg_y != PAD),
                                            torch.sum(batch.query != PAD))))
        loss, metrics = compute_losses(logp, ft, params["embed"]["lut"], cfg,
                                       batch, tcfg.smoothing, norm_override=norm)
        if dp is not None:
            loss, metrics = _sum_over_ranks(dp, loss, metrics)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    return step_fn


class EpochStats:
    """Accumulates the reference's run_epoch totals (train.py:21-52).  The
    sums stay on the device, so the loop never waits on a step; they are
    read once in summary()."""

    def __init__(self):
        self.loss = self.temporal_ae = self.spatial_ae = 0.0
        self.tokens = self.qtokens = 0

    def update(self, m: Metrics):
        self.loss = self.loss + m["out"]
        self.temporal_ae = self.temporal_ae + m["temporal_ae"]
        self.spatial_ae = self.spatial_ae + m["spatial_ae"]
        self.tokens = self.tokens + m["ntokens"]
        self.qtokens = self.qtokens + m["qntokens"]

    def summary(self) -> Dict[str, float]:
        t = max(int(self.tokens), 1)
        q = max(int(self.qtokens), 1)
        return {"out": float(self.loss) / t,
                "temporal_ae": float(self.temporal_ae) / q,
                "spatial_ae": float(self.spatial_ae) / q}


def run_epoch(loader, state_or_params, step_fn, epoch: int, *, train: bool,
              gen: Optional[torch.Generator] = None, seed: int = 0, rank: int = 0,
              report_interval: int = 100, train_log_path: Optional[str] = None,
              prepare: Optional[Callable] = None,
              state_holder: Optional[list] = None,
              device=None) -> Dict[str, float]:
    """One pass over the loader.  `step_fn` is an eager step
    (`make_train_step`, `make_eval_step`) or a program of `train.compiled`
    (`TrainProgram`, `EvalProgram`), which take the same arguments.  For
    train=True, state_holder is a 1-element list holding the TrainState
    (replaced after every step, so the caller sees updates), and `gen`, if
    not None, is re-seeded from (seed, step, rank) before every step (the
    step a Python int on the host, so the loop never waits on the device;
    `rank` is a data-parallel rank's).
    `prepare` (e.g. the move to the device) runs on a background thread for
    the upcoming batches (data.loader.device_prefetch).

    Besides the step rate (`StepTimer`, the steps alone) it logs the
    epoch's examples/s end to end and the seconds it waited on the loader,
    as one JSON object on an "epoch feed" line."""
    from bist_tpu_torch.data.loader import device_prefetch
    from bist_tpu_torch.utils.profiling import StepTimer

    stats = EpochStats()
    timer = StepTimer(warmup=1, device=device)
    it = iter(loader) if prepare is None else device_prefetch(iter(loader), prepare=prepare)
    t_start = time.perf_counter()
    loader_wait, examples = 0.0, 0
    for j in itertools.count():
        t0 = time.perf_counter()
        item = next(it, None)
        loader_wait += time.perf_counter() - t0
        if item is None:
            break
        batch, meta = item
        examples += meta.real_count
        with timer.step(items=meta.real_count):
            if train:
                state = state_holder[0]
                if gen is not None:
                    gen.manual_seed(seed_for_step(seed, state.step, rank))
                state, metrics = step_fn(state, batch, gen)
                state_holder[0] = state
            else:
                metrics = step_fn(state_or_params, batch)
        stats.update(metrics)
        # the report block is the only per-interval host sync; the
        # non-finite guard rides it (detection latency <= report_interval)
        if train and (j + 1) % report_interval == 0:
            if not math.isfinite(float(metrics["loss"])):
                raise FloatingPointError(
                    f"non-finite training loss at epoch {epoch + 1} step "
                    f"{j + 1}; resume the last good checkpoint with --resume")
            nt = max(int(metrics["ntokens"]), 1)
            qt = max(int(metrics["qntokens"]), 1)
            if rank == 0:        # the metrics are the global batch's on every rank
                print(f"Epoch: {epoch + 1} Step: {j + 1} "
                      f"Loss: {float(metrics['out']) / nt:f} "
                      f"AETemporalLoss: {float(metrics['temporal_ae']) / qt:f} "
                      f"AESpatialLoss: {float(metrics['spatial_ae']) / qt:f}")
            if train_log_path:
                with open(train_log_path, "a") as f:
                    f.write("{},{},{:e},{:e},{:e}\n".format(
                        epoch + 1, j + 1, float(metrics["out"]) / nt,
                        float(metrics["temporal_ae"]) / qt,
                        float(metrics["spatial_ae"]) / qt))
    summary = stats.summary()            # reads the sums: waits for the last step
    seconds = time.perf_counter() - t_start
    split = "train" if train else "eval"
    t = timer.summary()
    if t["steps"] > 0:
        # the timer wraps step_fn only: the wait on the loader is not in it
        log.info("%s step rate: %.0f examples/s (%.1f ms/step over %d steps, "
                 "loader wait excluded)", split, t["items_per_s"],
                 t["mean_s"] * 1e3, t["steps"])
    log.info("%s epoch feed: %s", split, json.dumps({
        "epoch": epoch + 1, "steps": j, "examples": examples, "seconds": seconds,
        "examples_per_s": examples / seconds if seconds > 0 else 0.0,
        "loader_wait_seconds": loader_wait}))
    return summary


def init_csv_logs(model_prefix: str, resume: bool = False,
                  start_epoch: int = 0) -> Tuple[str, str]:
    """Create <model>_train.csv / <model>_trace.csv with reference headers.

    With resume=True, existing logs are kept and appended to; rows of epochs
    the resumed run will train again (> start_epoch) are dropped first, so no
    epoch carries two rows.  A fresh run truncates (train.py:121-128)."""
    trace_log_path = model_prefix + "_trace.csv"
    train_log_path = model_prefix + "_train.csv"
    for path, header in (
            (trace_log_path, "epoch,split,loss,ae_temporal_loss,ae_spatial_loss\n"),
            (train_log_path, "epoch,step,loss,ae_temporal_loss,ae_spatial_loss\n")):
        kept = []
        if resume and os.path.exists(path):
            with open(path) as f:
                kept = [ln for ln in f.readlines()[1:]
                        if ln.split(",", 1)[0].isdigit()
                        and int(ln.split(",", 1)[0]) <= start_epoch]
        with open(path, "w") as f:
            f.write(header)
            f.writelines(kept)
    return train_log_path, trace_log_path


def append_trace(trace_log_path: str, epoch: int, split: str,
                 losses: Dict[str, float]) -> None:
    with open(trace_log_path, "a") as f:
        f.write("{},{},{:e},{:e},{:e}\n".format(
            epoch + 1, split, losses["out"], losses["temporal_ae"],
            losses["spatial_ae"]))
