"""TGIF-QA VideoQA on the BiST backbone (after `bist_tpu.tasks.tgifqa`;
BASELINE.json config 5).

The four TGIF-QA tasks over the same (B, T, S, D) spatio-temporal feature
grids as the dialogue model:

  * FrameQA    — open-ended: classify over the answer vocabulary;
  * Count      — regression head, rounded/clipped to [1, 10] at eval;
  * Action / Transition — 5-way multiple choice: each candidate answer is
    appended to the question, all 5 candidates run through the shared
    backbone (the video repeated for each), and a scalar scoring head picks
    the best.

The question (+ candidate) plays the dialogue model's "query" role; the BiST
video-reasoning stack (`models.bist.vid_layer_apply`) runs as in the
dialogue model, so hop 1 of both directions reaches K1, and under a
gradient K1 with residuals and K2, through `ops.dispatch` (dropout keeps it
on the plain path); the final layer's features are mean-pooled under the
query mask into a task head.  Unlike the dialogue model, the video grid
gets a temporal positional encoding: Transition (before/after questions)
cannot be solved without temporal order.

The parameter tree has `bist_tpu`'s keys and shapes, so
`weights.params_from_jax` carries a `bist_tpu` model across unchanged.  The
TSV parsing, `TgifExample` and `expand_candidates` are copies of
`bist_tpu`'s framework-free code.  `tgif_batches` is the train CLI's batch
builder (`cli.train_tgif`).

Data format: the public TGIF-QA TSV splits —
  frameqa:  gif_name, question, answer, ...
  count:    gif_name, question, answer(int)
  action / transition:  gif_name, question, a1..a5, answer(index)
"""

from __future__ import annotations

import csv
import enum
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from bist_tpu_torch import resolve_device
from bist_tpu_torch.config import ModelConfig
from bist_tpu_torch.data.batching import bucket_len, pad_to
from bist_tpu_torch.models import bist
from bist_tpu_torch.models.layers import (
    Params, add_positional, embed, embedding_init, layer_norm, layer_norm_init, linear,
    linear_init, positional_encoding_table,
)
from bist_tpu_torch.train.loop import TrainState, trainable
from bist_tpu_torch.train.schedule import Adam, constant_schedule
from bist_tpu_torch.vocab import PAD, words2ids
from bist_tpu_torch.weights import tree_leaves, tree_map

# the CLI's buckets: clips, and question tokens of the open-ended tasks
T_BUCKETS = (16, 32, 48, 64)
Q_BUCKETS = (16, 32)


class TGIFTask(str, enum.Enum):
    FRAMEQA = "frameqa"
    COUNT = "count"
    ACTION = "action"
    TRANSITION = "transition"


MULTIPLE_CHOICE = (TGIFTask.ACTION, TGIFTask.TRANSITION)


@dataclass
class TgifExample:
    gif_name: str
    question: np.ndarray                 # token ids
    # frameqa: answer class id; count: integer; action/transition: 0-4
    label: int
    candidates: Optional[List[np.ndarray]] = None   # 5 tokenised options


def load_tgif_tsv(path: str, task: TGIFTask, vocab: Dict[str, int],
                  answer_vocab: Optional[Dict[str, int]] = None
                  ) -> List[TgifExample]:
    """Parse a TGIF-QA TSV split.  For frameqa, `answer_vocab` maps answer
    strings to class ids (built from the train split's most frequent
    answers); unseen answers map to class 0."""
    out: List[TgifExample] = []
    with open(path) as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            q = words2ids(row["question"].lower(), vocab)
            if task == TGIFTask.FRAMEQA:
                label = (answer_vocab or {}).get(row["answer"].lower(), 0)
                out.append(TgifExample(row["gif_name"], q, label))
            elif task == TGIFTask.COUNT:
                out.append(TgifExample(row["gif_name"], q,
                                       int(float(row["answer"]))))
            else:
                cands = [words2ids(row[f"a{i}"].lower(), vocab)
                         for i in range(1, 6)]
                out.append(TgifExample(row["gif_name"], q,
                                       int(row["answer"]), cands))
    return out


def build_answer_vocab(path: str, top_k: int = 1000) -> Dict[str, int]:
    freq: Counter = Counter()
    with open(path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            freq[row["answer"].lower()] += 1
    return {a: i for i, (a, _) in enumerate(freq.most_common(top_k))}


class TgifBatch(NamedTuple):
    """numpy arrays on the host, tensors on a device."""
    query: np.ndarray           # (B, Lq) — or (B·5, Lq) for multiple choice
    fts: np.ndarray             # (B, T, S, Dv) — repeated to (B·5, ...) for MC
    label: np.ndarray           # (B,)


# ---------------------------------------------------------------------------
# Model


def init_tgif_model(gen: torch.Generator, cfg: ModelConfig, task: TGIFTask,
                    n_answers: int = 1000, device=None) -> Params:
    """Backbone = embeddings + query norm + video projection + BiST layers;
    head per task.  Drawn from `gen` on the CPU (xavier-uniform weights,
    U(±1/√fan_in) biases), then moved to `device` (default cuda; raises
    without it)."""
    device = resolve_device(device)
    params: Params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model),
        "q_norm": layer_norm_init(cfg.d_model),
        "vid_enc": {"W": linear_init(gen, cfg.ft_sizes[0], cfg.d_model),
                    "in_norm": layer_norm_init(cfg.d_model)},
        "v_layers": [bist.vid_layer_init(gen, cfg) for _ in range(cfg.nb_venc_blocks)],
        "out_norm_t": layer_norm_init(cfg.d_model),
        "out_norm_s": layer_norm_init(cfg.d_model),
    }
    head_in = cfg.d_model * (2 if cfg.both_directions else 1)
    # frameqa: a class per answer; count: the count; MC: a score per candidate
    params["head"] = linear_init(gen, head_in, n_answers if task == TGIFTask.FRAMEQA else 1)
    return tree_map(lambda t: t.to(device), params)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, L, D) × (B, L) → (B, D)."""
    m = mask.to(x.dtype)[..., None]
    return torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)


def tgif_forward(params: Params, cfg: ModelConfig, query: torch.Tensor,
                 fts: torch.Tensor, task: TGIFTask,
                 rngs: Optional[torch.Generator] = None) -> torch.Tensor:
    """Returns logits: (B, n_answers) for frameqa, (B,) for count, (B,) per-row
    candidate score for action/transition (the caller reshapes to (B, 5))."""
    pe = positional_encoding_table(cfg.d_model, cfg.max_pos, query.device)
    q_emb = add_positional(pe, embed(params["embed"], query, cfg.d_model),
                           cfg.dropout, rngs)
    q = layer_norm(params["q_norm"], q_emb)
    query_mask = (query != PAD)[:, None, :].to(torch.int32)

    v = torch.relu(linear(params["vid_enc"]["W"], fts))
    # the temporal positional encoding, broadcast over the spatial axis
    v = v + pe[: v.shape[1]][None, :, None, :]
    grid = layer_norm(params["vid_enc"]["in_norm"], v)
    temporal_mask = (torch.sum(fts, dim=(2, 3)) != 0)[:, None, :].to(torch.int32)

    masks = {"query_mask": query_mask, "temporal_mask": temporal_mask}
    ft = {"video_grid": grid, "encoded_query": q}
    in_ft = {"t2s": q, "s2t": q}
    for lp in params["v_layers"]:
        in_ft = bist.vid_layer_apply(lp, cfg, in_ft, ft, masks, rngs)

    pooled = []
    if cfg.s2t:
        pooled.append(_masked_mean(layer_norm(params["out_norm_t"], in_ft["s2t"]),
                                   query_mask[:, 0]))
    if cfg.t2s:
        pooled.append(_masked_mean(layer_norm(params["out_norm_s"], in_ft["t2s"]),
                                   query_mask[:, 0]))
    logits = linear(params["head"], torch.cat(pooled, dim=-1))
    if task == TGIFTask.FRAMEQA:
        return logits
    return logits[..., 0]


def _choice_loss(scores: torch.Tensor, label: torch.Tensor):
    """Cross-entropy of `scores` (B, C) against class ids, and accuracy."""
    label = label.long()
    logp = torch.log_softmax(scores, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, label[:, None]))
    acc = torch.mean((torch.argmax(scores, dim=-1) == label).float())
    return loss, {"acc": acc}


def tgif_loss(params: Params, cfg: ModelConfig, batch: TgifBatch, task: TGIFTask,
              rngs: Optional[torch.Generator] = None):
    """(loss, metrics) per task: CE for frameqa, MSE for count (metric: the
    MAE of the prediction rounded and clipped to [1, 10]), 5-way CE for
    action/transition (query/fts rows are B·5 candidate-expanded)."""
    logits = tgif_forward(params, cfg, batch.query, batch.fts, task, rngs)
    if task in MULTIPLE_CHOICE:
        return _choice_loss(logits.reshape(-1, 5), batch.label)
    if task == TGIFTask.COUNT:
        label = batch.label.float()
        loss = torch.mean(torch.square(logits - label))
        rounded = torch.clamp(torch.round(logits), 1, 10)
        return loss, {"mae": torch.mean(torch.abs(rounded - label))}
    return _choice_loss(logits, batch.label)


def tgif_optimizer(lr: float) -> Adam:
    """`optax.adam(lr)`: b1 0.9, b2 0.999, eps 1e-8 at a constant rate."""
    return Adam(constant_schedule(lr), b1=0.9, b2=0.999, eps=1e-8)


def create_tgif_train_state(params: Params, tx: Adam) -> TrainState:
    """A TrainState on trainable copies of `params` (float32 leaves that
    require grad) with a fresh optimizer state."""
    params = trainable(params)
    return TrainState(params, tx.init(tree_leaves(params)), 0)


def make_tgif_train_step(cfg: ModelConfig, task: TGIFTask, tx: Adam) -> Callable:
    """Returns (state, batch, gen) → (state, metrics): the forward, the loss,
    `torch.autograd.grad` and `tx`'s update of the parameters in place;
    metrics (the task's and "loss") are 0-d tensors on the device.  Dropout
    draws from `gen` when cfg.dropout > 0 (attention dropout too); at 0 no
    dropout runs, as `bist_tpu`'s step passes no key then."""

    def step(state: TrainState, batch: TgifBatch, gen: Optional[torch.Generator] = None):
        leaves = tree_leaves(state.params)
        loss, metrics = tgif_loss(state.params, cfg, batch, task,
                                  gen if cfg.dropout > 0 else None)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        opt_state = tx.update(leaves, grads, state.opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return step


def _candidate_rows(examples: Sequence[TgifExample], max_len: int) -> np.ndarray:
    """Each candidate appended to its question, cut to max_len, padded:
    (B·5, max_len)."""
    return pad_to([np.concatenate([e.question, cand])[:max_len]
                   for e in examples for cand in e.candidates], max_len)


def expand_candidates(examples: Sequence[TgifExample], fts_lookup,
                      max_len: int = 32) -> TgifBatch:
    """Action/Transition batch: append each candidate to the question →
    (B·5, L) rows sharing the video features (stacked as they are: the
    videos must have one length)."""
    fts = [fts_lookup(e.gif_name) for e in examples for _ in range(5)]
    return TgifBatch(query=_candidate_rows(examples, max_len), fts=np.stack(fts),
                     label=np.asarray([e.label for e in examples], np.int32))


def tgif_batches(examples: Sequence[TgifExample], task: TGIFTask, store, batch_size: int,
                 max_len: int, rng: Optional[np.random.Generator] = None,
                 drop_last: bool = True) -> Iterator[TgifBatch]:
    """The train CLI's batches (`bist_tpu.cli.train_tgif`'s): the order
    shuffled by `rng` (None: file order); `drop_last` for training (few
    geometries), the tail batch kept for the test split; clips padded with
    zeros (or cut) to t_pad = the T_BUCKETS bucket of the batch's longest
    GIF (`store.shape_of`, headers only), assembled by `store.get_batch`.
    Multiple choice: the question + candidate rows of `expand_candidates`
    at max_len tokens, each video repeated 5 times; the other tasks: the
    questions cut to max_len, padded to the Q_BUCKETS bucket of the
    longest."""
    idx = np.arange(len(examples))
    if rng is not None:
        rng.shuffle(idx)
    end = len(idx) - batch_size + 1 if drop_last else len(idx)
    for s in range(0, max(end, 0), batch_size):
        exs = [examples[i] for i in idx[s:s + batch_size]]
        t_pad = bucket_len(max(store.shape_of(e.gif_name)[0] for e in exs), T_BUCKETS)
        if task in MULTIPLE_CHOICE:
            query = _candidate_rows(exs, max_len)
            names = [e.gif_name for e in exs for _ in range(5)]
        else:
            query = pad_to([e.question[:max_len] for e in exs],
                           bucket_len(max(len(e.question) for e in exs), Q_BUCKETS))
            names = [e.gif_name for e in exs]
        yield TgifBatch(query=query, fts=store.get_batch(names, t_pad),
                        label=np.asarray([e.label for e in exs], np.int32))
