"""Full BiST model: parameter init, masks, training forward, and the
incremental (KV-cached) decode path (after `bist_tpu.models.model`;
reference model/mtn.py:14-167).

  * text "encoder" = 3 LayerNorms over the embedded query/cap/his, with the
    reference's index-advance-on-non-None rule (encoder.py:11-41);
  * video/audio input projection Linear+ReLU+LayerNorm (encoder.py:55-93),
    no positional encoding over video;
  * one embedding table for query/cap/his/target, ×√d_model, tied into the
    generator.

Incremental decoding: the modality reasoning stack depends only on the
sources, so `precompute_decode_ctx` runs it once per batch and pre-projects
every cross-attention K/V; `decode_step` advances one token with a growing
self-attention KV cache and folds the beam into the cross-attention query
axis, so the context stays at B rows.  Three precision knobs, as in
`bist_tpu`: the storage of the decode memory (`precompute_decode_ctx`'s and
`init_cache`'s dtype, float8 read as bfloat16), the precompute's activations
(`encode_cfg`) and the step's activations (`decode_step`'s compute_dtype).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from bist_tpu_torch import resolve_device
from bist_tpu_torch.config import ModelConfig
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.models import bist
from bist_tpu_torch.models.generator import (
    _source, apply_generator, apply_generator_step, generator_init, one_hot,
    pointer_k,
)
from bist_tpu_torch.models.layers import (
    Params, add_positional, attention_weights, embed, embedding_init, ffn,
    layer_norm, layer_norm_init, linear, linear_init, matmul, merge_heads,
    positional_encoding_table, split_heads, subsequent_mask, upcast_fp8,
)
from bist_tpu_torch.vocab import PAD
from bist_tpu_torch.weights import tree_map

FT = Dict[str, torch.Tensor]
Gen = Optional[torch.Generator]


# ---------------------------------------------------------------------------
# Init


def init_model(seed: int, cfg: ModelConfig, device=None) -> Params:
    """Random parameters with the tree, names and shapes of
    `bist_tpu.models.model.init_model`: xavier-uniform weights and U(±1/√fan_in)
    biases drawn from `torch.Generator().manual_seed(seed)` on the CPU, then
    moved to `device` (default cuda; raises without it)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: Params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model),
        "text_enc": {"norms": [layer_norm_init(cfg.d_model) for _ in range(3)]},
        "decoder": bist.decoder_init(gen, cfg),
        "gen": generator_init(gen, cfg),
    }
    vid_enc: Params = {}
    if cfg.has_video:
        vid_enc["W"] = linear_init(gen, cfg.ft_sizes[0], cfg.d_model)
        vid_enc["in_norm"] = layer_norm_init(cfg.d_model)
    if cfg.has_audio:
        vid_enc["a_W"] = linear_init(gen, cfg.ft_sizes[1], cfg.d_model)
        vid_enc["a_in_norm"] = layer_norm_init(cfg.d_model)
    params["vid_enc"] = vid_enc
    return tree_map(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# Masks (reference Batch, data/dataset.py:59-105)


def _valid(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)[:, None, :]


def build_masks(cfg: ModelConfig, batch: Batch) -> Dict[str, Optional[torch.Tensor]]:
    """(B, 1, L) int32 validity masks; the feature masks come from feature
    sums, so zero-padded clips and regions are masked (int8 grids: |max|)."""
    masks: Dict[str, Optional[torch.Tensor]] = {
        "query_mask": _valid(batch.query != PAD),
        "his_mask": _valid(batch.his != PAD),
        "cap_mask": _valid(batch.cap != PAD) if batch.cap is not None else None,
    }
    Lt = batch.trg.shape[-1]
    masks["trg_mask"] = _valid(batch.trg != PAD) & subsequent_mask(Lt, batch.trg.device)
    if batch.fts is not None:
        f = batch.fts
        if not torch.is_floating_point(f):
            a = f.abs().to(torch.int32)
            masks["spatial_mask"] = _valid(a.amax(dim=(1, 3)) != 0)
            masks["temporal_mask"] = _valid(a.amax(dim=(2, 3)) != 0)
        else:
            masks["spatial_mask"] = _valid(f.sum(dim=(1, 3)) != 0)
            masks["temporal_mask"] = _valid(f.sum(dim=(2, 3)) != 0)
    else:
        masks["spatial_mask"] = masks["temporal_mask"] = None
    masks["audio_mask"] = (_valid(batch.audio_fts.sum(dim=-1) != 0)
                           if batch.audio_fts is not None else None)
    return masks


# ---------------------------------------------------------------------------
# Encode (MTN.encode, mtn.py:36-51)


def activation_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _embed_seq(params: Params, cfg: ModelConfig, pe: torch.Tensor,
               ids: Optional[torch.Tensor], rngs: Gen) -> Optional[torch.Tensor]:
    if ids is None:
        return None
    x = embed(params["embed"], ids, cfg.d_model).to(activation_dtype(cfg))
    return add_positional(pe, x, cfg.dropout, rngs)


def _pe(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return positional_encoding_table(cfg.d_model, cfg.max_pos,
                                     params["embed"]["lut"].device)


def encode(params: Params, cfg: ModelConfig, batch: Batch, rngs: Gen = None) -> FT:
    """Text norms + video/audio input projections."""
    pe = _pe(params, cfg)
    q_emb = _embed_seq(params, cfg, pe, batch.query, rngs)
    c_emb = _embed_seq(params, cfg, pe, batch.cap, rngs)
    h_emb = _embed_seq(params, cfg, pe, batch.his, rngs)
    # the norm index advances only over present inputs (encoder.py:19-41)
    norms = params["text_enc"]["norms"]
    ft: FT = {"encoded_query": layer_norm(norms[0], q_emb)}
    i = 1
    if c_emb is not None:
        ft["encoded_cap"] = layer_norm(norms[i], c_emb)
        i += 1
    ft["encoded_his"] = layer_norm(norms[i], h_emb)

    adt = activation_dtype(cfg)
    if cfg.has_video and batch.fts is not None:
        fts = batch.fts
        if batch.fts_scale is not None:       # int8 transfer → dequant on device
            fts = fts.to(adt) * batch.fts_scale.to(adt)
        v = torch.relu(linear(params["vid_enc"]["W"], fts.to(adt)))
        ft["video_grid"] = layer_norm(params["vid_enc"]["in_norm"], v)
    if cfg.has_audio and batch.audio_fts is not None:
        a = torch.relu(linear(params["vid_enc"]["a_W"], batch.audio_fts.to(adt)))
        ft["encoded_audio"] = layer_norm(params["vid_enc"]["a_in_norm"], a)
    return ft


def generator_tokens(batch: Batch, masks) -> Dict[str, torch.Tensor]:
    toks = {"query": batch.query, "query_mask": masks["query_mask"],
            "his": batch.his, "his_mask": masks["his_mask"]}
    if batch.cap is not None:
        toks["cap"] = batch.cap
        toks["cap_mask"] = masks["cap_mask"]
    return toks


# ---------------------------------------------------------------------------
# Training forward (MTN.forward, mtn.py:31-61)


def apply_model(params: Params, cfg: ModelConfig, batch: Batch,
                rngs: Gen = None) -> FT:
    """Full forward: ft with 'decoded_text', 'encoded_tgt' and the final-layer
    modality features."""
    masks = build_masks(cfg, batch)
    ft = encode(params, cfg, batch, rngs)
    tgt = _embed_seq(params, cfg, _pe(params, cfg), batch.trg, rngs)
    ft["encoded_tgt"] = tgt
    return bist.decoder_apply(params["decoder"], cfg, ft, tgt, masks, rngs)


def forward_logprobs(params: Params, cfg: ModelConfig, batch: Batch,
                     rngs: Gen = None) -> Tuple[torch.Tensor, FT]:
    """Forward + generator → (B, Lt, V) log-probs."""
    masks = build_masks(cfg, batch)
    ft = apply_model(params, cfg, batch, rngs)
    logp = apply_generator(params["gen"], cfg, params["embed"]["lut"], ft,
                           generator_tokens(batch, masks))
    return logp, ft


# ---------------------------------------------------------------------------
# Incremental decoding


class PtrSource(NamedTuple):
    """One pointer-generator source, precomputed at B rows for decoding."""
    text: torch.Tensor      # (B, Ltext) int
    enc: torch.Tensor       # (B, Ltext, D)
    mask: torch.Tensor      # (B, 1, Ltext) int32, <unk> banned if cfg.mask_unk
    k: torch.Tensor         # (B, 1, Ltext, D) pointer keys
    onehot: torch.Tensor    # (B, Ltext, V)


class DecodeCtx(NamedTuple):
    """Target-independent decode memory, once per batch: per-layer
    cross-attention K/V (B, h, Lk, d_k), masks, pointer sources."""
    layer_kv: Tuple[Dict[str, Tuple[torch.Tensor, torch.Tensor]], ...]
    masks: Dict[str, Optional[torch.Tensor]]
    ptr_src: Tuple[PtrSource, ...]


class DecodeCache(NamedTuple):
    """Per-layer self-attention KV cache: tuples of (rows, h, Lmax, d_k)."""
    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


def encode_cfg(cfg: ModelConfig, encode_dtype: str) -> ModelConfig:
    """The configuration of the context precompute for
    GenerateConfig.encode_dtype: '' (or the model's own dtype) keeps `cfg`;
    'float32' or 'bfloat16' sets the activation dtype of the precompute only
    (the decode step has its own knob, compute_dtype)."""
    if not encode_dtype or encode_dtype == cfg.dtype:
        return cfg
    if encode_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"encode_dtype {encode_dtype!r}: expected '' "
                         "(inherit), 'float32' or 'bfloat16'")
    return cfg.replace(dtype=encode_dtype)


def step_dtype(name: str) -> torch.dtype:
    """GenerateConfig.compute_dtype → torch dtype."""
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {name!r}: expected 'float32' or 'bfloat16'")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _cross_kv(p_attn: Params, h: int, memory: torch.Tensor):
    return (split_heads(linear(p_attn["wk"], memory), h),
            split_heads(linear(p_attn["wv"], memory), h))


def precompute_decode_ctx(params: Params, cfg: ModelConfig, batch: Batch,
                          dtype=torch.float32) -> DecodeCtx:
    """Run encode + the modality reasoning stack once and pre-project every
    response-layer cross-attention K/V.  `dtype` is the storage precision of
    the decode memory (K/V, pointer keys/encodings/one-hot); masks and ids
    stay integer."""
    masks = build_masks(cfg, batch)
    ft = encode(params, cfg, batch, None)
    dec = params["decoder"]
    in_ft: FT = {k: ft["encoded_query"] for k in ("t2s", "s2t", "audio", "cap")}
    layer_kv = []
    for n in range(cfg.nb_blocks):
        ft, in_ft = bist.modality_step(dec, cfg, n, in_ft, ft, masks, None)
        lp = dec["mm_layers"][n]
        kv = {"his": _cross_kv(lp["his"]["attn"], cfg.att_h, ft["encoded_his"]),
              "query": _cross_kv(lp["query"]["attn"], cfg.att_h, ft["encoded_query"])}
        for name, ft_key, _ in bist.mm_layer_cross_slots(cfg):
            kv[name] = _cross_kv(lp[name]["attn"], cfg.att_h, ft[ft_key])
        layer_kv.append({name: (k.to(dtype).contiguous(), v.to(dtype).contiguous())
                         for name, (k, v) in kv.items()})
    toks = generator_tokens(batch, masks)
    ptr_src = []
    if cfg.ptr_gen:
        for i, name in enumerate(cfg.ptr_ft_list):
            text, enc, mask = _source(name, ft, toks)
            if cfg.mask_unk:
                mask = mask & (text != 0)[:, None, :].to(mask.dtype)
            ptr_src.append(PtrSource(
                text=text, enc=enc.to(dtype), mask=mask,
                k=pointer_k(params["gen"]["pointer_attn"][i], enc).to(dtype),
                onehot=one_hot(text, cfg.vocab_size, dtype)))
    return DecodeCtx(layer_kv=tuple(layer_kv), masks=masks, ptr_src=tuple(ptr_src))


def init_cache(cfg: ModelConfig, rows: int, max_len: int,
               dtype=torch.float32, device=None) -> DecodeCache:
    shape = (rows, cfg.att_h, max_len, cfg.d_model // cfg.att_h)
    return DecodeCache(
        k=tuple(torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(cfg.nb_blocks)),
        v=tuple(torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(cfg.nb_blocks)))


def _mha_cached_self(p_attn: Params, h: int, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int):
    """Single-position self-attention against the KV cache, which is written
    in place at `pos` (rounded to its storage dtype, and read back so).
    x (rows, 1, D) normed; cache (rows, h, Lmax, d_k).  Products in the
    promoted dtype of the activations and the stored values, as jnp's."""
    Q = split_heads(linear(p_attn["wq"], x), h)                   # (rows, h, 1, dk)
    cache_k[:, :, pos:pos + 1] = split_heads(linear(p_attn["wk"], x), h)
    cache_v[:, :, pos:pos + 1] = split_heads(linear(p_attn["wv"], x), h)
    L = pos + 1                        # positions > pos are masked out exactly
    attn = attention_weights(Q, upcast_fp8(cache_k[:, :, :L]), None, 0.0, None)
    return linear(p_attn["wo"], merge_heads(
        matmul(attn, upcast_fp8(cache_v[:, :, :L]))))


def _mha_cross_cached(p_attn: Params, h: int, x: torch.Tensor, KV, mask,
                      beam: int) -> torch.Tensor:
    """Cross-attention of `beam` hypothesis rows per batch element against a
    shared precomputed K/V: x (B·beam, 1, D), KV (B, h, Lk, d_k), mask
    (B, 1, Lk).  The beam folds into the query-position axis."""
    K, V = upcast_fp8(KV[0]), upcast_fp8(KV[1])
    B = K.shape[0]
    q = linear(p_attn["wq"], x.reshape(B, beam, x.shape[-1]))    # (B, beam, D)
    Q = split_heads(q, h)                                         # (B, h, beam, dk)
    attn = attention_weights(Q, K, None if mask is None else mask[:, None], 0.0, None)
    out = linear(p_attn["wo"], merge_heads(matmul(attn, V)))
    return out.reshape(x.shape)


def decode_step(params: Params, cfg: ModelConfig, ctx: DecodeCtx,
                cache: DecodeCache, token: torch.Tensor, pos: int,
                beam: int = 1, compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, DecodeCache]:
    """Advance one token for B·beam hypothesis rows: token (B·beam,) ids at
    absolute position `pos` (0 = <sos>).  `ctx` stays at B rows; `cache` has
    B·beam rows and receives this position's K/V in place.  Returns
    (log-probs (B·beam, V), cache).  Eval mode.

    `compute_dtype` (torch.bfloat16) runs the step's activations, and with
    them the projections, in bfloat16; scores and softmax stay float32 and
    the generator head takes float32 inputs."""
    pe = _pe(params, cfg)
    x = add_positional(pe, embed(params["embed"], token[:, None], cfg.d_model),
                       0.0, None, offset=pos).to(compute_dtype)   # (B·beam, 1, D)
    encoded_tgt = x
    dec = params["decoder"]
    slots = bist.mm_layer_cross_slots(cfg)
    par = bist.parallel_st(cfg)
    h = cfg.att_h
    for n in range(cfg.nb_blocks):
        lp = dec["mm_layers"][n]
        kv = ctx.layer_kv[n]
        x = x + _mha_cached_self(lp["self"]["attn"], h,
                                 layer_norm(lp["self"]["norm"], x),
                                 cache.k[n], cache.v[n], pos)
        for name in ("his", "query"):
            x = x + _mha_cross_cached(lp[name]["attn"], h,
                                      layer_norm(lp[name]["norm"], x), kv[name],
                                      ctx.masks[f"{name}_mask"], beam)
        i = 0
        while i < len(slots):
            name, _, mask_key = slots[i]
            if par and name == "temporal":
                t, s = (_mha_cross_cached(lp[nm]["attn"], h,
                                          layer_norm(lp[nm]["norm"], x), kv[nm],
                                          ctx.masks["query_mask"], beam)
                        for nm in ("temporal", "spatial"))
                x = (x + t) + (x + s)    # in_x = sublayer_t(x) + sublayer_s(x)
                i += 2
                continue
            x = x + _mha_cross_cached(lp[name]["attn"], h,
                                      layer_norm(lp[name]["norm"], x), kv[name],
                                      ctx.masks[mask_key], beam)
            i += 1
        x = x + ffn(lp["ff"]["ff"], layer_norm(lp["ff"]["norm"], x), 0.0, None)

    # the generator head in float32, whatever the step's compute dtype
    decoded = layer_norm(dec["norm"], x).float()                  # (B·beam, 1, D)
    B = decoded.shape[0] // beam
    logp = apply_generator_step(
        params["gen"], cfg, params["embed"]["lut"],
        decoded.reshape(B, beam, -1), encoded_tgt.float().reshape(B, beam, -1),
        ctx.ptr_src)                                              # (B, beam, V)
    return logp.reshape(B * beam, -1), cache
