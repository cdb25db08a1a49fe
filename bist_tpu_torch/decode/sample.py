"""Sampled decoding: temperature, top-k and nucleus (top-p) sampling (after
`bist_tpu.decode.sample`), over the same cached `decode_step` as greedy and
beam search.

Per step, on the model's log-probabilities:
  1. <unk>, <pad> and <sos> banned;
  2. divided by max(temperature, 1e-4);
  3. top-k: the k highest kept (0 = off);
  4. top-p: the smallest prefix of the probability-sorted vocabulary whose
     mass reaches p kept, the argmax always (0 = off);
  5. one categorical draw per row (the Gumbel-max trick).

The noise comes from explicit `torch.Generator`s on the parameters' device,
never the global RNG.  With `row_seeds`, row i's draws come from its own
generator, seeded from (seed, row_seeds[i]), and its step-l draws are the
l-th of that stream: they depend only on (seed, row_seeds[i], l), not on
the rows around it, as `bist_tpu`'s per-row `fold_in` keys give.  Torch's
random streams are not JAX's PRNG streams, so the two packages draw
different tokens from the same seed; only the filtering (`filter_logits`)
and top_k=1, which is greedy, can agree between them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bist_tpu_torch.config import ModelConfig
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.decode.beam import _on_device
from bist_tpu_torch.models.layers import storage_dtype
from bist_tpu_torch.models.model import (
    decode_step, encode_cfg, init_cache, precompute_decode_ctx,
)
from bist_tpu_torch.vocab import PAD, SOS, UNK

NEG = -1.0e30


def filter_logits(logits: torch.Tensor, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """Logits (..., V) with those outside the top-k set and/or the top-p
    nucleus set to NEG (`bist_tpu.decode.sample.filter_logits`)."""
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k, None]
        logits = torch.where(logits < kth, NEG, logits)
    if top_p and top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # mass before each token: the argmax has none and always survives
        cum_before = torch.cumsum(probs, dim=-1) - probs
        n_keep = (cum_before < top_p).sum(dim=-1, keepdim=True)      # >= 1
        thresh = torch.gather(sorted_logits, -1, n_keep - 1)
        logits = torch.where(logits < thresh, NEG, logits)
    return logits


def mix_seed(*parts: int) -> int:
    """One 63-bit generator seed from integers (splitmix64 steps)."""
    x = 0x9E3779B97F4A7C15
    for p in parts:
        x = (x ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x >> 31)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x >> 1


def _uniforms(device: torch.device, seed: int, rows: int, maxlen: int, V: int,
              row_seeds: Optional[Sequence[int]]) -> torch.Tensor:
    """(rows, maxlen, V) uniforms in [0, 1): one stream for the batch, or one
    per row from (seed, row_seeds[i])."""
    if row_seeds is None:
        gen = torch.Generator(device=device).manual_seed(mix_seed(seed))
        return torch.rand((rows, maxlen, V), generator=gen, device=device)
    out = []
    for s in row_seeds:
        gen = torch.Generator(device=device).manual_seed(mix_seed(seed, s))
        out.append(torch.rand((maxlen, V), generator=gen, device=device))
    return torch.stack(out)


@torch.no_grad()
def sample_decode(params, cfg: ModelConfig, batch: Batch, maxlen: int, seed: int,
                  temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                  cache_dtype: str = "float32",
                  row_seeds: Optional[Sequence[int]] = None,
                  encode_dtype: str = "") -> torch.Tensor:
    """Sampled decoding: (B, maxlen) int32 token ids, which may hold <eos>
    (the caller truncates, as with greedy_decode).  `seed` and, per row,
    `row_seeds` set the draws (module docstring); `cache_dtype` and
    `encode_dtype` are GenerateConfig's knobs."""
    device, batch = _on_device(params, batch)
    B = batch.query.shape[0]
    if row_seeds is not None and len(row_seeds) != B:
        raise ValueError(f"sample_decode: {len(row_seeds)} row seeds for {B} rows")
    dt = storage_dtype(cache_dtype)
    ctx = precompute_decode_ctx(params, encode_cfg(cfg, encode_dtype), batch, dtype=dt)
    cache = init_cache(cfg, B, maxlen + 1, dtype=dt, device=device)
    u = _uniforms(device, seed, B, maxlen, cfg.vocab_size, row_seeds)
    gumbel = -torch.log(-torch.log(u))
    temp = max(float(temperature), 1e-4)
    tok = torch.full((B,), SOS, dtype=torch.int32, device=device)
    out = []
    for l in range(maxlen):
        logp, cache = decode_step(params, cfg, ctx, cache, tok, l)
        logits = logp.float().clone()
        logits[:, [UNK, PAD, SOS]] = NEG
        logits = filter_logits(logits / temp, top_k=top_k, top_p=top_p)
        tok = torch.argmax(logits + gumbel[:, l], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)
