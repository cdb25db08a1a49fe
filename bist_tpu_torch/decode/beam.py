"""Batched beam search (after `bist_tpu.decode.beam`).

Scoring parity with the reference `beam_search_decode` (model/decode.py:53-104):
  * cumulative log-prob expansion keeping the top-`beam` continuations;
  * completion candidates at every step l ≥ min_len scored
    lp[<eos>] + penalty·(l + 1), collected across all steps and ranked at
    the end;
  * <unk> always banned from expansion, <eos> banned unless dec_eos;
  * returned hypotheses exclude <sos>/<eos>.

The search is a Python loop of `maxlen` steps over static shapes: each step
advances the B·beam cached decoder rows (`models.model.decode_step`).  Both
top-k selections break ties towards the lower index, as `jax.lax.top_k`
does, so the beams equal the JAX package's at float32 — including step 0,
where beams 1..K-1 are identical NEG copies.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from bist_tpu_torch.config import GenerateConfig, ModelConfig
from bist_tpu_torch.data.batching import Batch, to_device
from bist_tpu_torch.models.layers import storage_dtype
from bist_tpu_torch.models.model import (
    DecodeCache, decode_step, init_cache, precompute_decode_ctx,
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


@torch.no_grad()
def beam_search(params, cfg: ModelConfig, batch: Batch,
                gcfg: GenerateConfig) -> BeamResult:
    """Beam search for every row of `batch` at once.  A host batch (numpy
    arrays) moves to the parameters' device."""
    device = params["embed"]["lut"].device
    if not isinstance(batch.query, torch.Tensor):
        batch = to_device(batch, device)
    K, maxlen, nbest = gcfg.beam, gcfg.maxlen, gcfg.nbest
    B = batch.query.shape[0]
    V = cfg.vocab_size
    cache_dt = storage_dtype(gcfg.cache_dtype)
    ctx = precompute_decode_ctx(params, cfg, batch, dtype=cache_dt)
    cache = init_cache(cfg, B * K, maxlen + 1, dtype=cache_dt, device=device)

    i32 = dict(dtype=torch.int32, device=device)
    tokens = torch.full((B, K, maxlen + 1), PAD, **i32)
    tokens[:, :, 0] = SOS
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    comp_tokens = torch.full((B, nbest, maxlen), PAD, **i32)
    comp_scores = torch.full((B, nbest), NEG, dtype=torch.float32, device=device)
    comp_lens = torch.zeros((B, nbest), **i32)
    pos_range = torch.arange(maxlen, device=device)
    rows = torch.arange(B, device=device)[:, None]

    for l in range(maxlen):
        if gcfg.early_exit and _converged(scores, comp_scores, l, gcfg):
            break
        logp, cache = decode_step(params, cfg, ctx, cache,
                                  tokens[:, :, l].reshape(B * K), l, beam=K)
        lp = scores[:, :, None] + logp.reshape(B, K, V)           # (B, K, V)

        # completion candidates (decode.py:73-77); the bonus is an f32
        # product, as in the JAX package
        if l >= gcfg.min_len:
            bonus = float(np.float32(gcfg.penalty) * np.float32(l + 1))
            cand_score = lp[:, :, EOS] + bonus
        else:
            cand_score = torch.full((B, K), NEG, dtype=torch.float32, device=device)
        cand_tok = torch.where(pos_range < l, tokens[:, :, 1:], PAD)
        all_scores = torch.cat([comp_scores, cand_score], dim=1)
        all_tokens = torch.cat([comp_tokens, cand_tok], dim=1)
        all_lens = torch.cat([comp_lens, torch.full((B, K), l, **i32)], dim=1)
        comp_scores, top = stable_topk(all_scores, nbest)
        comp_tokens = all_tokens[rows, top]
        comp_lens = all_lens[rows, top]

        # expansion (decode.py:79-97): top-K over the K·V continuations
        lp[:, :, UNK] = NEG
        if not gcfg.dec_eos:
            lp[:, :, EOS] = NEG
        scores, flat_idx = stable_topk(lp.reshape(B, K * V), K)
        parent = flat_idx // V                                    # (B, K)
        tokens = tokens[rows, parent]
        tokens[:, :, l + 1] = (flat_idx % V).to(torch.int32)

        # the KV cache rows follow their parents
        def regroup(a: torch.Tensor) -> torch.Tensor:
            return a.reshape((B, K) + a.shape[1:])[rows, parent] \
                .reshape(a.shape)

        cache = DecodeCache(k=tuple(regroup(a) for a in cache.k),
                            v=tuple(regroup(a) for a in cache.v))
    return BeamResult(tokens=comp_tokens, scores=comp_scores, lengths=comp_lens)


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
