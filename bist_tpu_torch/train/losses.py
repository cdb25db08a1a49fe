"""Label-smoothed KL loss + multi-loss aggregation (after
`bist_tpu.train.losses`).

Parity targets:
  * LabelSmoothing (model/label_smoothing.py:9-30): target distribution has
    smoothing/(size-2) off-mass everywhere, `confidence` at the gold id, the
    PAD column zeroed, and rows whose gold id is PAD zeroed entirely;
    criterion is KLDiv with SUM reduction: Σ true·(log(true) − logp), with
    0·log0 = 0.
  * SimpleLossCompute (model/optimize.py:36-94): response loss normalised by
    ntokens; optional query auto-encoder losses — caption / audio / temporal /
    spatial (or fused spatiotemporal) features pushed through the tied AE
    generator and trained to reconstruct the *question*, each normalised by
    qntokens.  Total loss is the sum.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from bist_tpu_torch.config import ModelConfig
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.models.generator import vocab_log_softmax
from bist_tpu_torch.vocab import PAD


def label_smoothing_kl(logp: torch.Tensor, target: torch.Tensor,
                       smoothing: float) -> torch.Tensor:
    """Σ over all positions/classes of true·(log(true) − logp).

    logp: (N, V) log-probabilities; target: (N,) int ids.  Returns a scalar
    (SUM reduction, un-normalised — caller divides by the token count).  The
    target distribution takes two values, so Σ true·log(true) is counted per
    row from them instead of elementwise."""
    V = logp.shape[-1]
    off = smoothing / (V - 2)
    confidence = 1.0 - smoothing
    target = target.long()
    valid = (target != PAD).to(logp.dtype)                       # (N,)
    gold = logp.gather(1, target[:, None])[:, 0]
    # Σ_v true_v logp_v = off (Σ_v logp_v − logp_PAD − logp_gold) + conf logp_gold
    # (gold == PAD only on rows that are zeroed anyway)
    cross = off * (logp.sum(-1) - logp[:, PAD] - gold) + confidence * gold
    ent = (confidence * math.log(confidence) if confidence > 0 else 0.0) \
        + ((V - 2) * off * math.log(off) if off > 0 else 0.0)
    return torch.sum(valid * (ent - cross))


def compute_losses(logp: torch.Tensor, ft: Dict[str, torch.Tensor],
                   lut: torch.Tensor, cfg: ModelConfig, batch: Batch,
                   smoothing: float, norm_override=None,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total training loss + per-component unnormalised sums for logging.

    Returns (loss, metrics) where metrics['out'/'temporal_ae'/'spatial_ae'/
    'cap_ae'/'audio_ae'] are the *unnormalised* KL sums (reference logs
    loss·norm back, train.py:33-37) and metrics['ntokens'/'qntokens'] the
    normalisers, all 0-d tensors on the loss's device.

    norm_override=(ntokens, qntokens): use externally-computed normalisers —
    gradient accumulation passes the FULL batch's counts so the sum of
    microbatch losses equals the full-batch loss exactly (train/loop.py)."""
    V = logp.shape[-1]
    if norm_override is not None:
        ntokens, qntokens = norm_override
    else:
        ntokens = torch.sum(batch.trg_y != PAD)
        qntokens = torch.sum(batch.query != PAD)
    n = torch.clamp(ntokens, min=1).to(logp.dtype)
    qn = torch.clamp(qntokens, min=1).to(logp.dtype)

    out_sum = label_smoothing_kl(logp.reshape(-1, V), batch.trg_y.reshape(-1),
                                 smoothing)
    loss = out_sum / n
    zero = torch.zeros((), device=logp.device)
    metrics = {"out": out_sum, "ntokens": ntokens, "qntokens": qntokens,
               "temporal_ae": zero, "spatial_ae": zero, "cap_ae": zero,
               "audio_ae": zero}

    if cfg.auto_encoder:
        query_flat = batch.query.reshape(-1)

        def ae(key: str) -> torch.Tensor:
            ae_logp = vocab_log_softmax(lut, ft[key])
            return label_smoothing_kl(ae_logp.reshape(-1, V), query_flat, smoothing)

        slots = []
        if cfg.use_cap_layers:
            slots.append(("cap_ae", "cap_ft"))
        if cfg.nb_aenc_blocks > 0:
            slots.append(("audio_ae", "audio_ft"))
        if cfg.nb_venc_blocks > 0:
            if cfg.enc_st_combine == "none" or not cfg.both_directions:
                if cfg.s2t:
                    slots.append(("temporal_ae", "temporal_ft"))
                if cfg.t2s:
                    slots.append(("spatial_ae", "spatial_ft"))
            else:
                # the reference logs the fused loss under the spatial slot
                slots.append(("spatial_ae", "st_fused"))
        for name, key in slots:
            s = ae(key)
            loss = loss + s / qn
            metrics[name] = s
    return loss, metrics
