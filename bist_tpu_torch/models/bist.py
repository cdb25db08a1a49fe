"""BiST factorized bi-directional spatio-temporal reasoning + multimodal
decoder (after `bist_tpu.models.bist`; reference model/encoder.py:95-235,
model/decoder.py:11-186).

  * q/k/v projections run once on the unbroadcast tensors; only the score
    products see broadcast shapes.
  * The video grid lives under its own key 'video_grid' and is never
    overwritten by layer outputs.
  * Hop 1 of both directions goes through the fused K1 kernel
    (`ops.bist_kernels.hop1_fused`) whenever `ops.dispatch` allows it, and
    under a gradient through `hop1_trainable` (K1 forward, K2 backward).
  * `cfg.remat` recomputes each decoder round in the backward pass
    (`torch.utils.checkpoint`), with the same dropout masks.
  * Under sequence parallelism (`parallel.sp`) 'video_grid' is this rank's
    T block and FULL_GRID the whole grid: s2t hop 1 (over S, one group a
    temporal step) runs on the block and its output is gathered for hop 2
    (over T); t2s hop 1 (over T) runs on the whole grid.

Per layer, query x (B, Lq, D), grid V (B, T, S, D):
  t2s: self-attn(x) → attend along T per spatial region (temporal mask)
       → attend along S per query token → FFN
  s2t: self-attn(x) → attend along S per temporal step
       → attend along T per query token (temporal mask) → FFN
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from bist_tpu_torch.config import ModelConfig
from bist_tpu_torch.models.layers import (
    Params, dropout, ffn, ffn_init, layer_norm, layer_norm_init, linear,
    linear_init, mha, mha_init, sublayer,
)
from bist_tpu_torch.ops import dispatch
from bist_tpu_torch.ops.bist_kernels import hop1_fused, hop1_trainable
from bist_tpu_torch.parallel import sp

Masks = Dict[str, Optional[torch.Tensor]]
FT = Dict[str, torch.Tensor]
Gen = Optional[torch.Generator]
# the whole video grid under sequence parallelism (`models.model.encode`)
FULL_GRID = "video_grid_full"


# ---------------------------------------------------------------------------
# Video reasoning layer (VidEncoderLayer4, encoder.py:95-201)


def vid_layer_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, h, d_ff = cfg.d_model, cfg.att_h, cfg.d_ff
    p: Params = {}
    for direction, on in (("t2s", cfg.t2s), ("s2t", cfg.s2t)):
        if on:
            for part in ("self", "hop1", "hop2"):
                p[f"{direction}_{part}"] = {"attn": mha_init(gen, h, d),
                                            "norm": layer_norm_init(d)}
            p[f"{direction}_ff"] = {"ff": ffn_init(gen, d, d_ff),
                                    "norm": layer_norm_init(d)}
    if cfg.enc_st_combine in ("early_sum", "early_dyn") and cfg.both_directions:
        p["out_norm"] = layer_norm_init(d)
        if cfg.enc_st_combine == "early_dyn":
            p["st_combine_W"] = linear_init(gen, d * 3, 1)
    return p


def _attn_sublayer(p: Params, h: int, x: torch.Tensor, kv: torch.Tensor,
                   mask, drop: float, adrop: float, rngs: Gen) -> torch.Tensor:
    """Cross-attention sublayer x + dropout(MHA(LN(x), kv, kv, mask)): keys
    and values are the raw memory (decoder.py:22-24)."""
    return x + dropout(
        mha(p["attn"], h, layer_norm(p["norm"], x), kv, kv, mask,
            drop_rate=adrop, rngs=rngs), drop, rngs)


def _self_attn_sublayer(p: Params, h: int, x: torch.Tensor, mask, drop: float,
                        adrop: float, rngs: Gen) -> torch.Tensor:
    """Self-attention sublayer: the normed x feeds q, k and v
    (modules.py:41-44 + encoder.py:176)."""
    normed = layer_norm(p["norm"], x)
    return x + dropout(
        mha(p["attn"], h, normed, normed, normed, mask,
            drop_rate=adrop, rngs=rngs), drop, rngs)


def _hop1(p_hop: Params, h: int, drop: float, adrop: float, rngs: Gen,
          x: torch.Tensor, kv_groups: torch.Tensor, mask,
          seq_sharded: bool = False) -> torch.Tensor:
    """Hop 1: x (B,Lq,D), kv_groups (B,G,Lk,D), mask (B,1,Lk) or None →
    x[:,None] + MHA(LN(x), kv, kv) of shape (B,G,Lq,D).  `seq_sharded`: G
    is this rank's block of a seq-sharded axis (the dropout masks')."""
    normed = layer_norm(p_hop["norm"], x)
    a = p_hop["attn"]
    if dispatch.hop1_uses_kernel(dropout_active=rngs is not None):
        q = linear(a["wq"], normed)
        w = [a[n][k] for n in ("wk", "wv", "wo") for k in ("w", "b")]
        if dispatch.needs_grad(x, q, kv_groups, *w):
            return hop1_trainable.apply(x, q, kv_groups, *w, h, mask)
        return hop1_fused(x, q, kv_groups, a, h, mask)
    seq_dim = 1 if seq_sharded else None
    attn_out = mha(a, h, normed[:, None], kv_groups, kv_groups,
                   mask=None if mask is None else mask[:, None],
                   drop_rate=adrop, rngs=rngs, seq_dim=seq_dim)
    return x[:, None] + dropout(attn_out, drop, rngs, seq_dim=seq_dim)


def temporal2spatial(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     grid: torch.Tensor, temporal_mask: torch.Tensor,
                     rngs: Gen) -> torch.Tensor:
    """Two-hop temporal→spatial attention (encoder.py:109-139).  x (B, Lq, D),
    grid (B, T, S, D), temporal_mask (B, 1, T)."""
    h, drop, adrop = cfg.att_h, cfg.dropout, cfg.attn_dropout
    # hop 1: per spatial region, along T (a strided view, no copy)
    t_out = _hop1(p["t2s_hop1"], h, drop, adrop, rngs, x,
                  grid.transpose(1, 2), temporal_mask)          # (B, S, Lq, D)
    # hop 2: per query token, over its S per-region summaries
    per_tok = t_out.transpose(1, 2)                             # (B, Lq, S, D)
    normed2 = layer_norm(p["t2s_hop2"]["norm"], x)
    attn_out2 = mha(p["t2s_hop2"]["attn"], h, normed2[:, :, None],
                    per_tok, per_tok, mask=None, drop_rate=adrop, rngs=rngs)
    ts_out = x + dropout(attn_out2[:, :, 0], drop, rngs)
    return sublayer(p["t2s_ff"]["norm"], ts_out,
                    lambda y: ffn(p["t2s_ff"]["ff"], y, drop, rngs), drop, rngs)


def spatial2temporal(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     grid: torch.Tensor, temporal_mask: torch.Tensor,
                     rngs: Gen) -> torch.Tensor:
    """Two-hop spatial→temporal attention (encoder.py:141-170).  Under
    sequence parallelism `grid` is this rank's T block and temporal_mask
    the whole one."""
    h, drop, adrop = cfg.att_h, cfg.dropout, cfg.attn_dropout
    # hop 1: per temporal step, along S (spatial positions always valid)
    s_out = _hop1(p["s2t_hop1"], h, drop, adrop, rngs, x, grid, None,
                  seq_sharded=True)                             # (B,T,Lq,D)
    # hop 2: per query token, over the T per-step summaries, temporal mask
    per_tok = sp.gather_seq(s_out, 1).transpose(1, 2)           # (B, Lq, T, D)
    normed2 = layer_norm(p["s2t_hop2"]["norm"], x)
    attn_out2 = mha(p["s2t_hop2"]["attn"], h, normed2[:, :, None],
                    per_tok, per_tok, mask=temporal_mask[:, None],   # (B,1,1,T)
                    drop_rate=adrop, rngs=rngs)
    st_out = x + dropout(attn_out2[:, :, 0], drop, rngs)
    return sublayer(p["s2t_ff"]["norm"], st_out,
                    lambda y: ffn(p["s2t_ff"]["ff"], y, drop, rngs), drop, rngs)


def vid_layer_apply(p: Params, cfg: ModelConfig, in_ft: FT, ft: FT,
                    masks: Masks, rngs: Gen) -> FT:
    """One BiST reasoning layer over in_ft['t2s'] / in_ft['s2t']
    (encoder.py:172-199)."""
    h, drop, adrop = cfg.att_h, cfg.dropout, cfg.attn_dropout
    grid = ft["video_grid"]
    in_ft = dict(in_ft)
    t2s = s2t = None
    if cfg.t2s:
        t2s = _self_attn_sublayer(p["t2s_self"], h, in_ft["t2s"],
                                  masks["query_mask"], drop, adrop, rngs)
        t2s = temporal2spatial(p, cfg, t2s, ft.get(FULL_GRID, grid),
                               masks["temporal_mask"], rngs)
        in_ft["t2s"] = t2s
    if cfg.s2t:
        s2t = _self_attn_sublayer(p["s2t_self"], h, in_ft["s2t"],
                                  masks["query_mask"], drop, adrop, rngs)
        s2t = spatial2temporal(p, cfg, s2t, grid, masks["temporal_mask"], rngs)
        in_ft["s2t"] = s2t

    if cfg.both_directions and cfg.enc_st_combine == "early_sum":
        in_ft["t2s"] = in_ft["s2t"] = layer_norm(p["out_norm"], t2s + s2t)
    elif cfg.both_directions and cfg.enc_st_combine == "early_dyn":
        vec = torch.cat([ft["encoded_query"], t2s, s2t], dim=-1)
        score = torch.sigmoid(linear(p["st_combine_W"], vec))
        in_ft["t2s"] = in_ft["s2t"] = layer_norm(
            p["out_norm"], score * t2s + (1.0 - score) * s2t)
    return in_ft


# ---------------------------------------------------------------------------
# Caption / audio reasoning layers (encoder.py:203-235)


def ctx_layer_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, h, d_ff = cfg.d_model, cfg.att_h, cfg.d_ff
    return {
        "self": {"attn": mha_init(gen, h, d), "norm": layer_norm_init(d)},
        "cross": {"attn": mha_init(gen, h, d), "norm": layer_norm_init(d)},
        "ff": {"ff": ffn_init(gen, d, d_ff), "norm": layer_norm_init(d)},
    }


def ctx_layer_apply(p: Params, cfg: ModelConfig, state: torch.Tensor,
                    memory: torch.Tensor, query_mask, memory_mask,
                    rngs: Gen) -> torch.Tensor:
    """Query self-attn → cross-attn into memory → FFN."""
    h, drop, adrop = cfg.att_h, cfg.dropout, cfg.attn_dropout
    x = _self_attn_sublayer(p["self"], h, state, query_mask, drop, adrop, rngs)
    x = _attn_sublayer(p["cross"], h, x, memory, memory_mask, drop, adrop, rngs)
    return sublayer(p["ff"]["norm"], x,
                    lambda y: ffn(p["ff"]["ff"], y, drop, rngs), drop, rngs)


# ---------------------------------------------------------------------------
# Response decoder layer (MultimodalDecoderLayer12, decoder.py:11-60)


def mm_layer_cross_slots(cfg: ModelConfig):
    """Ordered (slot_name, ft_key, mask_key) of the modality cross-attentions
    after self/his/query (decoder.py:27-57)."""
    slots = []
    if cfg.nb_venc_blocks > 0 and cfg.use_cap_layers and cfg.enc_vc_combine != "none":
        slots.append(("fused", "encoded_ft", "query_mask"))
        return slots
    if cfg.include_caption != "none":
        if cfg.use_cap_layers:
            slots.append(("cap", "cap_ft", "query_mask"))
        else:
            slots.append(("cap", "encoded_cap", "cap_mask"))
    if cfg.nb_venc_blocks > 0:
        if cfg.enc_st_combine == "none":
            if cfg.s2t:
                slots.append(("temporal", "temporal_ft", "query_mask"))
            if cfg.t2s:
                slots.append(("spatial", "spatial_ft", "query_mask"))
        else:
            slots.append(("st", "st_fused", "query_mask"))
    if cfg.nb_aenc_blocks > 0:
        slots.append(("audio", "audio_ft", "query_mask"))
    return slots


def parallel_st(cfg: ModelConfig) -> bool:
    """dec_st_combine='sum': temporal and spatial cross-attentions read the
    same input and their results add (decoder.py:44-51)."""
    return (cfg.nb_venc_blocks > 0 and cfg.enc_st_combine == "none"
            and cfg.dec_st_combine != "seq" and cfg.both_directions)


def mm_layer_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, h, d_ff = cfg.d_model, cfg.att_h, cfg.d_ff
    p: Params = {
        "self": {"attn": mha_init(gen, h, d), "norm": layer_norm_init(d)},
        "his": {"attn": mha_init(gen, h, d), "norm": layer_norm_init(d)},
        "query": {"attn": mha_init(gen, h, d), "norm": layer_norm_init(d)},
        "ff": {"ff": ffn_init(gen, d, d_ff), "norm": layer_norm_init(d)},
    }
    for name, _, _ in mm_layer_cross_slots(cfg):
        p[name] = {"attn": mha_init(gen, h, d), "norm": layer_norm_init(d)}
    return p


def mm_layer_apply(p: Params, cfg: ModelConfig, ft: FT, x: torch.Tensor,
                   masks: Masks, rngs: Gen) -> torch.Tensor:
    """Causal self-attn → history → query → modality cross-attns → FFN."""
    h, drop, adrop = cfg.att_h, cfg.dropout, cfg.attn_dropout
    x = _self_attn_sublayer(p["self"], h, x, masks["trg_mask"], drop, adrop, rngs)
    x = _attn_sublayer(p["his"], h, x, ft["encoded_his"], masks["his_mask"],
                       drop, adrop, rngs)
    x = _attn_sublayer(p["query"], h, x, ft["encoded_query"], masks["query_mask"],
                       drop, adrop, rngs)
    slots = mm_layer_cross_slots(cfg)
    par = parallel_st(cfg)
    i = 0
    while i < len(slots):
        name, ft_key, mask_key = slots[i]
        if par and name == "temporal":
            t = _attn_sublayer(p["temporal"], h, x, ft["temporal_ft"],
                               masks["query_mask"], drop, adrop, rngs)
            s = _attn_sublayer(p["spatial"], h, x, ft["spatial_ft"],
                               masks["query_mask"], drop, adrop, rngs)
            x = t + s
            i += 2
            continue
        x = _attn_sublayer(p[name], h, x, ft[ft_key], masks[mask_key],
                           drop, adrop, rngs)
        i += 1
    return sublayer(p["ff"]["norm"], x,
                    lambda y: ffn(p["ff"]["ff"], y, drop, rngs), drop, rngs)


# ---------------------------------------------------------------------------
# Multimodal decoder (MultimodalDecoder8, decoder.py:62-186)


def decoder_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    N, d = cfg.nb_blocks, cfg.d_model
    p: Params = {
        "mm_layers": [mm_layer_init(gen, cfg) for _ in range(N)],
        "norm": layer_norm_init(d),
    }
    if cfg.nb_venc_blocks > 0:
        p["v_layers"] = [vid_layer_init(gen, cfg) for _ in range(N)]
        if cfg.enc_st_combine == "none" or not cfg.both_directions:
            if cfg.s2t:
                p["temporal_out_norm"] = layer_norm_init(d)
            if cfg.t2s:
                p["spatial_out_norm"] = layer_norm_init(d)
        elif cfg.enc_st_combine in ("sum", "dyn"):
            p["out_norm"] = layer_norm_init(d)
            if cfg.enc_st_combine == "dyn":
                p["st_combine_W"] = linear_init(gen, d * 3, 1)
    if cfg.use_cap_layers:
        p["c_layers"] = [ctx_layer_init(gen, cfg) for _ in range(N)]
        p["cap_out_norm"] = layer_norm_init(d)
    if cfg.nb_aenc_blocks > 0:
        p["a_layers"] = [ctx_layer_init(gen, cfg) for _ in range(N)]
        p["a_out_norm"] = layer_norm_init(d)
    if cfg.nb_venc_blocks > 0 and cfg.use_cap_layers and cfg.enc_vc_combine == "dyn":
        if cfg.enc_st_combine != "none" and cfg.both_directions:
            p["vc_combine_W"] = linear_init(gen, d * 3, 1)
        else:
            factor = 1 + (1 if cfg.include_caption != "none" else 0) \
                + (1 if cfg.t2s else 0) + (1 if cfg.s2t else 0) \
                + (1 if cfg.nb_aenc_blocks > 0 else 0)
            p["vc_combine_W"] = linear_init(gen, d * factor, factor - 1)
    return p


def modality_step(p: Params, cfg: ModelConfig, layer_idx: int, in_ft: FT,
                  ft: FT, masks: Masks, rngs: Gen):
    """Advance the per-layer modality reasoning (v/c/a layers) and compute the
    fusion features the response layer reads (decoder.py:114-181).  Returns
    (ft, in_ft).  Target-independent, so decoding runs it once per batch."""
    ft = dict(ft)
    if cfg.nb_venc_blocks > 0:
        in_ft = vid_layer_apply(p["v_layers"][layer_idx], cfg, in_ft, ft, masks, rngs)
        if cfg.both_directions and cfg.enc_st_combine == "sum":
            ft["st_fused"] = layer_norm(p["out_norm"], in_ft["s2t"] + in_ft["t2s"])
        elif cfg.both_directions and cfg.enc_st_combine == "dyn":
            vec = torch.cat([ft["encoded_query"], in_ft["s2t"], in_ft["t2s"]], dim=-1)
            g = torch.sigmoid(linear(p["st_combine_W"], vec))
            ft["st_fused"] = layer_norm(
                p["out_norm"], g * in_ft["s2t"] + (1.0 - g) * in_ft["t2s"])
        elif cfg.both_directions and cfg.enc_st_combine in ("early_sum", "early_dyn"):
            ft["st_fused"] = in_ft["s2t"]
        else:
            if cfg.s2t:
                ft["temporal_ft"] = layer_norm(p["temporal_out_norm"], in_ft["s2t"])
            if cfg.t2s:
                ft["spatial_ft"] = layer_norm(p["spatial_out_norm"], in_ft["t2s"])
    if cfg.use_cap_layers:
        in_ft = dict(in_ft)
        in_ft["cap"] = ctx_layer_apply(p["c_layers"][layer_idx], cfg, in_ft["cap"],
                                       ft["encoded_cap"], masks["query_mask"],
                                       masks["cap_mask"], rngs)
        ft["cap_ft"] = layer_norm(p["cap_out_norm"], in_ft["cap"])
    if cfg.nb_aenc_blocks > 0:
        in_ft = dict(in_ft)
        in_ft["audio"] = ctx_layer_apply(p["a_layers"][layer_idx], cfg,
                                         in_ft["audio"], ft["encoded_audio"],
                                         masks["query_mask"], masks["audio_mask"],
                                         rngs)
        ft["audio_ft"] = layer_norm(p["a_out_norm"], in_ft["audio"])

    # visual/caption fusion (decoder.py:137-181)
    if cfg.nb_venc_blocks > 0 and cfg.use_cap_layers:
        st_combined = cfg.both_directions and cfg.enc_st_combine != "none"
        if cfg.enc_vc_combine == "sum":
            if st_combined:
                ft["encoded_ft"] = ft["st_fused"] + ft["cap_ft"]
            else:
                ft["encoded_ft"] = ft["temporal_ft"] + ft["spatial_ft"] + ft["cap_ft"]
        elif cfg.enc_vc_combine == "dyn":
            if st_combined:
                # gate st_fused against cap_ft (the early_* modes too)
                vec = torch.cat([ft["encoded_query"], ft["st_fused"], ft["cap_ft"]],
                                dim=-1)
                g = torch.sigmoid(linear(p["vc_combine_W"], vec))
                ft["encoded_ft"] = g * ft["st_fused"] + (1.0 - g) * ft["cap_ft"]
            else:
                # softmax gate; concat order (query, cap, spatial, temporal,
                # audio) with score assignment (temporal, spatial, cap, audio),
                # as decoder.py:152-181
                parts = [ft["encoded_query"], ft["cap_ft"]]
                if cfg.t2s:
                    parts.append(ft["spatial_ft"])
                if cfg.s2t:
                    parts.append(ft["temporal_ft"])
                if cfg.nb_aenc_blocks > 0:
                    parts.append(ft["audio_ft"])
                scores = torch.softmax(
                    linear(p["vc_combine_W"], torch.cat(parts, dim=-1)), dim=-1)
                if cfg.both_directions:
                    enc = (scores[..., 0:1] * ft["temporal_ft"]
                           + scores[..., 1:2] * ft["spatial_ft"]
                           + scores[..., 2:3] * ft["cap_ft"])
                elif not cfg.t2s:
                    enc = (scores[..., 0:1] * ft["temporal_ft"]
                           + scores[..., 1:2] * ft["cap_ft"])
                else:
                    enc = (scores[..., 0:1] * ft["spatial_ft"]
                           + scores[..., 1:2] * ft["cap_ft"])
                if cfg.nb_aenc_blocks > 0:
                    enc = enc + scores[..., 3:4] * ft["audio_ft"]
                ft["encoded_ft"] = enc
    return ft, in_ft


def _cloned(gen: torch.Generator, state: torch.Tensor) -> torch.Generator:
    clone = torch.Generator(device=gen.device)
    clone.set_state(state)
    return clone


def decoder_apply(p: Params, cfg: ModelConfig, ft: FT, x: torch.Tensor,
                  masks: Masks, rngs: Gen) -> FT:
    """Training-path decoder: N rounds of modality reasoning + response layer
    (decoder.py:107-186).  Returns ft with 'decoded_text' and the final-round
    modality features.

    cfg.remat wraps each round in `torch.utils.checkpoint`: its activations
    are recomputed in the backward pass instead of stored.  Dropout draws
    from the explicit generator `rngs`, which checkpoint does not restore,
    so each round draws from a clone of the generator's state at the round's
    start, the recomputation from a fresh clone of that same state (the same
    masks), and `rngs` is then advanced to where the round left its clone,
    as if the round had drawn from it directly."""
    in_ft: FT = {k: ft["encoded_query"] for k in ("t2s", "s2t", "audio", "cap")}
    for n in range(cfg.nb_blocks):
        def round_body(ft, in_ft, x, gen, _n=n):
            ft2, in_ft2 = modality_step(p, cfg, _n, in_ft, ft, masks, gen)
            return ft2, in_ft2, mm_layer_apply(p["mm_layers"][_n], cfg, ft2, x,
                                               masks, gen)

        if not cfg.remat:
            ft, in_ft, x = round_body(ft, in_ft, x, rngs)
            continue
        start = None if rngs is None else rngs.get_state()
        last = []

        def drawn(ft, in_ft, x, _start=start, _last=last, _body=round_body):
            gen = None if _start is None else _cloned(rngs, _start)
            out = _body(ft, in_ft, x, gen)
            _last[:] = [None if gen is None else gen.get_state()]
            return out

        ft, in_ft, x = checkpoint(drawn, ft, in_ft, x, use_reentrant=False)
        if rngs is not None:
            rngs.set_state(last[0])
    ft = dict(ft)
    ft["decoded_text"] = layer_norm(p["norm"], x)
    return ft
