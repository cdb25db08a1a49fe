"""Training step + epoch loop (after `bist_tpu.train.loop`).

Reference counterpart: train.py (epoch loop, run_epoch, CSV artifacts,
best-checkpoint logic).  As in the JAX package:

  * loss normalisation uses the whole batch's token counts, also when the
    batch is split into gradient-accumulation microbatches, so accumulated
    gradients equal the single-batch ones;
  * checkpoints carry params + optimizer state + step (train/checkpoint.py);
  * CSV artifacts keep the reference's file names and column layout
    (train.py:121-128,151-155).

What differs: PyTorch runs eagerly, so there is no jit; parameters are leaf
tensors (`requires_grad`) updated in place by the optimizer, as the JAX step
donates its state; dropout draws from an explicit `torch.Generator`,
re-seeded every step from (seed, step) as the JAX loop folds the step into
its key, so a resumed run draws what an uninterrupted one would.  Its bits
differ from JAX's: with dropout the two packages agree only in distribution.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from bist_tpu_torch.config import ModelConfig, TrainConfig
from bist_tpu_torch.data.batching import Batch
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


def seed_for_step(seed: int, step: int) -> int:
    """The dropout seed of one step, the counterpart of jax.random.fold_in."""
    return (seed << 32) + step


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, tx: Adam,
                    grad_accum: int = 1) -> Callable:
    """Returns (state, batch, gen) → (state, metrics); `gen` is the dropout
    generator (None without dropout).  metrics are 0-d tensors on the
    device, read by the caller when it needs them.

    grad_accum > 1 splits the batch into `grad_accum` microbatches, runs
    forward and backward on each, sums the gradients and applies ONE
    optimizer update: peak activation memory shrinks by the same factor.
    The loss normalisers (ntokens/qntokens) are counted on the FULL batch
    before the split, so accumulated gradients and metrics equal the
    single-big-batch values."""

    def loss_and_grads(params, leaves, batch: Batch, gen, norm_override=None):
        logp, ft = forward_logprobs(params, cfg, batch, rngs=gen)
        loss, metrics = compute_losses(logp, ft, params["embed"]["lut"], cfg,
                                       batch, tcfg.smoothing,
                                       norm_override=norm_override)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def step_fn(state: TrainState, batch: Batch, gen=None):
        leaves = tree_leaves(state.params)
        if grad_accum == 1:
            loss, metrics, grads = loss_and_grads(state.params, leaves, batch, gen)
        else:
            norm = (torch.sum(batch.trg_y != PAD), torch.sum(batch.query != PAD))
            grads, loss, metrics = None, 0.0, None
            for i in range(grad_accum):
                micro = Batch(*[None if x is None
                                else x.reshape((grad_accum, -1) + x.shape[1:])[i]
                                for x in batch])
                l_i, m_i, g_i = loss_and_grads(state.params, leaves, micro, gen,
                                               norm_override=norm)
                loss = loss + l_i
                if grads is None:
                    grads, metrics = g_i, dict(m_i)
                else:
                    torch._foreach_add_(grads, g_i)
                    metrics = {k: metrics[k] + m_i[k] for k in metrics}
            # each microbatch reported the GLOBAL counts (norm_override), so
            # the sum holds them grad_accum times — undo that
            metrics["ntokens"] = metrics["ntokens"] // grad_accum
            metrics["qntokens"] = metrics["qntokens"] // grad_accum
        opt_state = tx.update(leaves, grads, state.opt_state)
        metrics["loss"] = loss
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return step_fn


def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    @torch.no_grad()
    def step_fn(params, batch: Batch) -> Metrics:
        logp, ft = forward_logprobs(params, cfg, batch, rngs=None)
        loss, metrics = compute_losses(logp, ft, params["embed"]["lut"], cfg,
                                       batch, tcfg.smoothing)
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
              gen: Optional[torch.Generator] = None, seed: int = 0,
              report_interval: int = 100, train_log_path: Optional[str] = None,
              prepare: Optional[Callable] = None,
              state_holder: Optional[list] = None,
              device=None) -> Dict[str, float]:
    """One pass over the loader.  For train=True, state_holder is a
    1-element list holding the TrainState (replaced after every step, so the
    caller sees updates), and `gen`, if not None, is re-seeded from (seed,
    step) before every step.  `prepare` (e.g. the move to the device) runs on
    a background thread for the upcoming batches (data.loader.device_prefetch)."""
    from bist_tpu_torch.data.loader import device_prefetch
    from bist_tpu_torch.utils.profiling import StepTimer

    stats = EpochStats()
    timer = StepTimer(warmup=1, device=device)
    it = loader if prepare is None else device_prefetch(iter(loader), prepare=prepare)
    for j, (batch, meta) in enumerate(it):
        with timer.step(items=meta.real_count):
            if train:
                state = state_holder[0]
                if gen is not None:
                    gen.manual_seed(seed_for_step(seed, state.step))
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
    t = timer.summary()
    if t["steps"] > 0:
        # the timer wraps step_fn only: the wait on the loader is not in it
        log.info("%s step rate: %.0f examples/s (%.1f ms/step over %d steps, "
                 "loader wait excluded)",
                 "train" if train else "eval", t["items_per_s"],
                 t["mean_s"] * 1e3, t["steps"])
    return stats.summary()


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
