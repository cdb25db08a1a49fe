"""Batched beam search, greedy and teacher-forced (oracle) decoding (after
`bist_tpu.decode.beam`).

Scoring parity with the reference `beam_search_decode` (model/decode.py:53-104):
  * cumulative log-prob expansion keeping the top-`beam` continuations;
  * completion candidates at every step l ≥ min_len scored
    lp[<eos>] + penalty·(l + 1), collected across all steps and ranked at
    the end;
  * <unk> always banned from expansion, <eos> banned unless dec_eos;
  * returned hypotheses exclude <sos>/<eos>.

The search is a Python loop of `maxlen` static-shape steps (`_start`,
`_step`, `_result`): each step advances the B·beam cached decoder rows
(`models.model.decode_step`) with no host sync, so that
`decode.compiled.DecodeProgram` can capture the whole search, or each step,
in a CUDA graph.  Both
top-k selections break ties towards the lower index, as `jax.lax.top_k`
does, so the beams equal the JAX package's at float32 — including step 0,
where beams 1..K-1 are identical NEG copies.  `params` may be a list of
parameter trees of one configuration: the ensemble sums the models'
log-probabilities at every step, each model with its own context and KV
cache, all caches following the same parents.  The GenerateConfig knobs
`cache_dtype`, `encode_dtype` and `compute_dtype` set the precision of the
decode memory, of the context precompute and of the step
(`models.model`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from bist_tpu_torch.config import GenerateConfig, ModelConfig
from bist_tpu_torch.data.batching import Batch, to_device
from bist_tpu_torch.models.layers import storage_dtype
from bist_tpu_torch.models.model import (
    DecodeCache, decode_step, encode_cfg, forward_logprobs, init_cache,
    precompute_decode_ctx, step_dtype,
)
from bist_tpu_torch.vocab import EOS, PAD, SOS, UNK

NEG = -1.0e30


class BeamResult(NamedTuple):
    tokens: torch.Tensor   # (B, nbest, maxlen) int32, PAD-padded, no sos/eos
    scores: torch.Tensor   # (B, nbest) float32 (NEG = empty slot)
    lengths: torch.Tensor  # (B, nbest) int32


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; among equal values the lower index first
    (the `jax.lax.top_k` order; `torch.topk` leaves ties unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _converged(scores, comp_scores, l: int, gcfg: GenerateConfig) -> bool:
    """Exact early-exit bound of `bist_tpu.decode.beam`: a completion at any
    step l' ≥ l scores at most max(scores) + penalty·(l'+1) (every step adds
    a log-probability ≤ 0); stop once that cannot beat the worst kept n-best
    in any row.  The slack absorbs f32 rounding of a mixture's log."""
    slack = 1e-5 * gcfg.maxlen + 1e-6
    bonus = max(gcfg.penalty * gcfg.maxlen, gcfg.penalty * (l + 1))
    best = scores.max(dim=1).values + bonus
    return bool(torch.all(best + slack <= comp_scores.min(dim=1).values))


def _on_device(params, batch: Batch) -> Tuple[torch.device, Batch]:
    """The parameters' device, and `batch` moved there if it is a host batch
    (numpy arrays)."""
    device = params["embed"]["lut"].device
    if not isinstance(batch.query, torch.Tensor):
        batch = to_device(batch, device)
    return device, batch


class _Search(NamedTuple):
    """Beam search's state between two steps (`_start`, `_step`): the
    models' contexts and caches, the live beams and the kept completions."""
    ctxs: tuple
    caches: list
    tokens: torch.Tensor         # (B, K, maxlen + 1) int32, <sos> first
    scores: torch.Tensor         # (B, K) float32
    comp_tokens: torch.Tensor    # (B, nbest, maxlen) int32
    comp_scores: torch.Tensor    # (B, nbest) float32
    comp_lens: torch.Tensor      # (B, nbest) int32
    pos_range: torch.Tensor      # (maxlen,)
    rows: torch.Tensor           # (B, 1)


def _start(params_list, cfg: ModelConfig, batch: Batch,
           gcfg: GenerateConfig) -> _Search:
    """The search before step 0: each model's context and empty cache, beam
    0 live at score 0 (a device batch)."""
    device = params_list[0]["embed"]["lut"].device
    K, maxlen, nbest = gcfg.beam, gcfg.maxlen, gcfg.nbest
    B = batch.query.shape[0]
    cache_dt = storage_dtype(gcfg.cache_dtype)
    ecfg = encode_cfg(cfg, gcfg.encode_dtype)
    ctxs = tuple(precompute_decode_ctx(p, ecfg, batch, dtype=cache_dt) for p in params_list)
    caches = [init_cache(cfg, B * K, maxlen + 1, dtype=cache_dt, device=device)
              for _ in params_list]

    i32 = dict(dtype=torch.int32, device=device)
    # scalar writes by fill_ (not `x[i] = s`, which a torch.export trace
    # records as a copy from a host scalar tensor: no CUDA graph takes it)
    tokens = torch.full((B, K, maxlen + 1), PAD, **i32)
    tokens[:, :, 0].fill_(SOS)
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=device)
    scores[:, 0].fill_(0.0)
    return _Search(
        ctxs=ctxs, caches=caches, tokens=tokens, scores=scores,
        comp_tokens=torch.full((B, nbest, maxlen), PAD, **i32),
        comp_scores=torch.full((B, nbest), NEG, dtype=torch.float32, device=device),
        comp_lens=torch.zeros((B, nbest), **i32),
        pos_range=torch.arange(maxlen, device=device),
        rows=torch.arange(B, device=device)[:, None])


def _step(params_list, cfg: ModelConfig, gcfg: GenerateConfig, s: _Search,
          l: int) -> _Search:
    """Step l of the search: every model advances the B·K beams one token,
    the completions at l are ranked in, the top K continuations kept.  `l`
    and the `l >= min_len` branch are Python values (static in a CUDA graph
    of the step)."""
    K, V = gcfg.beam, cfg.vocab_size
    B = s.tokens.shape[0]
    rows = s.rows
    compute_dt = step_dtype(gcfg.compute_dtype)
    cur = s.tokens[:, :, l].reshape(B * K)
    caches = list(s.caches)
    logp = 0.0
    for m, (p, ctx) in enumerate(zip(params_list, s.ctxs)):
        lp_m, caches[m] = decode_step(p, cfg, ctx, caches[m], cur, l, beam=K,
                                      compute_dtype=compute_dt)
        logp = logp + lp_m
    lp = s.scores[:, :, None] + logp.reshape(B, K, V)             # (B, K, V)

    # completion candidates (decode.py:73-77); the bonus is an f32
    # product, as in the JAX package
    if l >= gcfg.min_len:
        bonus = float(np.float32(gcfg.penalty) * np.float32(l + 1))
        cand_score = lp[:, :, EOS] + bonus
    else:
        cand_score = torch.full((B, K), NEG, dtype=torch.float32, device=lp.device)
    cand_tok = torch.where(s.pos_range < l, s.tokens[:, :, 1:], PAD)
    all_scores = torch.cat([s.comp_scores, cand_score], dim=1)
    all_tokens = torch.cat([s.comp_tokens, cand_tok], dim=1)
    all_lens = torch.cat([s.comp_lens, torch.full((B, K), l, dtype=torch.int32,
                                                   device=lp.device)], dim=1)
    comp_scores, top = stable_topk(all_scores, gcfg.nbest)
    comp_tokens = all_tokens[rows, top]
    comp_lens = all_lens[rows, top]

    # expansion (decode.py:79-97): top-K over the K·V continuations
    lp[:, :, UNK].fill_(NEG)
    if not gcfg.dec_eos:
        lp[:, :, EOS].fill_(NEG)
    scores, flat_idx = stable_topk(lp.reshape(B, K * V), K)
    parent = flat_idx // V                                        # (B, K)
    tokens = s.tokens[rows, parent]
    tokens[:, :, l + 1] = (flat_idx % V).to(torch.int32)

    # the KV cache rows follow their parents
    def regroup(a: torch.Tensor) -> torch.Tensor:
        return a.reshape((B, K) + a.shape[1:])[rows, parent].reshape(a.shape)

    caches = [DecodeCache(k=tuple(regroup(a) for a in c.k),
                          v=tuple(regroup(a) for a in c.v)) for c in caches]
    return s._replace(caches=caches, tokens=tokens, scores=scores,
                      comp_tokens=comp_tokens, comp_scores=comp_scores,
                      comp_lens=comp_lens)


def _result(s: _Search) -> BeamResult:
    return BeamResult(tokens=s.comp_tokens, scores=s.comp_scores, lengths=s.comp_lens)


@torch.no_grad()
def beam_search(params, cfg: ModelConfig, batch: Batch,
                gcfg: GenerateConfig) -> BeamResult:
    """Beam search for every row of `batch` at once; `params` is one
    parameter tree or a list of them (an ensemble of one configuration).  A
    host batch (numpy arrays) moves to the parameters' device."""
    params_list = list(params) if isinstance(params, (list, tuple)) else [params]
    _, batch = _on_device(params_list[0], batch)
    s = _start(params_list, cfg, batch, gcfg)
    for l in range(gcfg.maxlen):
        if gcfg.early_exit and _converged(s.scores, s.comp_scores, l, gcfg):
            break
        s = _step(params_list, cfg, gcfg, s, l)
    return _result(s)


@torch.no_grad()
def greedy_decode(params, cfg: ModelConfig, batch: Batch, maxlen: int,
                  cache_dtype: str = "float32", encode_dtype: str = "",
                  compute_dtype: str = "float32") -> torch.Tensor:
    """Argmax decoding over the same cached `decode_step` as beam_search:
    (B, maxlen) int32 token ids, which may hold <eos> (the caller truncates,
    `vocab.ids2words`).  Ties go to the lower id, as `jnp.argmax`'s do.  The
    dtypes are GenerateConfig's knobs (`bist_tpu`'s greedy_decode has no
    compute_dtype: its step runs in float32, this default)."""
    device, batch = _on_device(params, batch)
    B = batch.query.shape[0]
    dt = storage_dtype(cache_dtype)
    compute_dt = step_dtype(compute_dtype)
    ctx = precompute_decode_ctx(params, encode_cfg(cfg, encode_dtype), batch, dtype=dt)
    cache = init_cache(cfg, B, maxlen + 1, dtype=dt, device=device)
    tok = torch.full((B,), SOS, dtype=torch.int32, device=device)
    out = []
    for l in range(maxlen):
        logp, cache = decode_step(params, cfg, ctx, cache, tok, l,
                                  compute_dtype=compute_dt)
        tok = torch.argmax(logp, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)


@torch.no_grad()
def oracle_decode(params, cfg: ModelConfig, batch: Batch) -> torch.Tensor:
    """Teacher-forced argmax: the model's most likely token at every target
    position given the ground-truth prefix, (B, Lt) int32.  Needs labeled
    targets (batch.trg), so not an undisclosed-only test set."""
    _, batch = _on_device(params, batch)
    logp, _ = forward_logprobs(params, cfg, batch, rngs=None)
    return torch.argmax(logp, dim=-1).to(torch.int32)


def extract_hyps(result: BeamResult, id2word: List[str],
                 row: int, nbest: int) -> List[Tuple[List[str], float]]:
    """The nbest hypotheses of one batch row as (words, score), empty slots
    skipped (generate.py:61-71)."""
    toks = result.tokens[row].cpu().numpy()
    scores = result.scores[row].cpu().numpy()
    lens = result.lengths[row].cpu().numpy()
    out = []
    for n in range(min(nbest, toks.shape[0])):
        if scores[n] <= NEG / 2:
            continue
        out.append(([id2word[t] for t in toks[n, : lens[n]]], float(scores[n])))
    return out
