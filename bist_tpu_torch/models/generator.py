"""Output generators: tied-projection softmax, pointer-generator and
multi-source pointer-generator (after `bist_tpu.models.generator`; reference
model/generator.py:11-127).

The copy distribution is a one-hot product (attn @ onehot(text)), as in the
JAX package.  EPS_LOG = 0: the mixture's log is a bare log, as the
reference's `torch.log`, so a word with zero probability gets -inf (never
NaN: nothing downstream subtracts two infinities).

Under tensor parallelism (`parallel.tp`) the pointer attention's wq/wk are
column shards of its one head: Q and K hold this rank's block of the width,
and the score is the sum of the ranks' partial products
(`attention_weights(width_sharded=True)`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from bist_tpu_torch.config import ModelConfig
from bist_tpu_torch.models.layers import (
    Params, attention_weights, linear, linear_init, matmul, mha_init,
    split_heads, upcast_fp8,
)
from bist_tpu_torch.parallel import tp

EPS_LOG = 0.0


def generator_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """ptr_gen with >1 source: per-source 1-head pointer attention + switch
    Linear(d·(n+2) → n+1); with 1 source: switch Linear(3d → 1); otherwise
    the tied projection (no params)."""
    if not cfg.ptr_gen:
        return {}
    n = len(cfg.ptr_ft_list)
    p: Params = {"pointer_attn": [mha_init(gen, 1, cfg.d_model) for _ in range(n)]}
    if n > 1:
        p["pointer_gen_W"] = linear_init(gen, cfg.d_model * (n + 2), n + 1)
    else:
        p["pointer_gen_W"] = linear_init(gen, cfg.d_model * 3, 1)
    return p


def vocab_log_softmax(lut: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied generator: log_softmax(x @ lutᵀ), softmax in float32."""
    logits = torch.matmul(x, lut.to(x.dtype).T).float()
    return torch.log_softmax(logits, dim=-1)


def _source(name: str, ft, tokens):
    """Pointer source name → (text_ids, encoded_text, mask (B, 1, Ltext))."""
    if name == "query":
        return tokens["query"], ft["encoded_query"], tokens["query_mask"]
    if name == "his":
        return tokens["his"], ft["encoded_his"], tokens["his_mask"]
    if name == "cap":
        return tokens["cap"], ft["encoded_cap"], tokens["cap_mask"]
    if name == "query+cap":
        text = torch.cat([tokens["query"], tokens["cap"]], dim=1)
        enc = torch.cat([ft["encoded_query"], ft["encoded_cap"]], dim=1)
        mask = torch.cat([tokens["query_mask"], tokens["cap_mask"]], dim=2)
        return text, enc, mask
    raise ValueError(f"unknown ptr_ft source {name!r}")


def pointer_k(p_attn: Params, encoded_text: torch.Tensor) -> torch.Tensor:
    """Pre-projected pointer keys (B, 1, Ltext, d), computed once per batch
    by incremental decoding."""
    return split_heads(linear(p_attn["wk"], tp.copy_to(encoded_text)), 1)


def one_hot(text: torch.Tensor, vocab: int, dtype) -> torch.Tensor:
    return F.one_hot(text.long(), vocab).to(dtype)


def _mix(p: Params, n_src: int, p_vocab, copy_dists, gen_vec_parts, x,
         encoded_tgt) -> torch.Tensor:
    """log of the switch-weighted mixture of vocab and copy distributions."""
    if n_src > 1:
        # MultiPointerGenerator: softmax switch over [sources..., vocab]
        switch = torch.softmax(
            linear(p["pointer_gen_W"], torch.cat(gen_vec_parts, dim=-1)).float(), -1)
        p_out = switch[..., -1:] * p_vocab
        for idx in range(n_src):
            p_out = p_out + switch[..., idx:idx + 1] * copy_dists[idx]
    else:
        # PointerGenerator: sigmoid switch; gen_vec = (x, text_vec, encoded_in)
        gen_vec = torch.cat([x, gen_vec_parts[2], encoded_tgt], dim=-1)
        g = torch.sigmoid(linear(p["pointer_gen_W"], gen_vec).float())
        p_out = (1.0 - g) * copy_dists[0] + g * p_vocab
    return torch.log(p_out)


def apply_generator_step(p: Params, cfg: ModelConfig, lut: torch.Tensor,
                         decoded: torch.Tensor, encoded_tgt: torch.Tensor,
                         ptr_src) -> torch.Tensor:
    """Incremental-decoding generator over (B, K, D) hypothesis rows: the
    pointer keys and copy one-hots come precomputed at B rows
    (model.PtrSource) and are shared by the K hypotheses of each row."""
    if not cfg.ptr_gen:
        return vocab_log_softmax(lut, decoded)
    p_vocab = torch.softmax(
        torch.matmul(decoded, lut.to(decoded.dtype).T).float(), dim=-1)
    gen_vec_parts = [decoded, encoded_tgt]
    copy_dists = []
    for idx, src in enumerate(ptr_src):
        Q = split_heads(linear(p["pointer_attn"][idx]["wq"], tp.copy_to(decoded)), 1)
        attn = attention_weights(Q, upcast_fp8(src.k), src.mask[:, None],
                                 0.0, None, width_sharded=True)[:, 0]   # (B, K, L)
        copy_dists.append(torch.matmul(attn.float(), src.onehot.float()))
        gen_vec_parts.append(torch.matmul(attn.to(decoded.dtype),
                                          src.enc.to(decoded.dtype)))
    return _mix(p, len(ptr_src), p_vocab, copy_dists, gen_vec_parts, decoded,
                encoded_tgt)


def apply_generator(p: Params, cfg: ModelConfig, lut: torch.Tensor,
                    ft: Dict[str, torch.Tensor], tokens: Dict[str, torch.Tensor],
                    ft_key: str = "decoded_text") -> torch.Tensor:
    """Log-probabilities over the vocabulary (B, Lt, V), the training path.
    tokens holds query/his/cap ids and their (B,1,L) masks."""
    x = ft[ft_key]
    if not cfg.ptr_gen:
        return vocab_log_softmax(lut, x)
    vocab = lut.shape[0]
    p_vocab = torch.softmax(torch.matmul(x, lut.to(x.dtype).T).float(), dim=-1)
    sources = cfg.ptr_ft_list
    encoded_in = ft["encoded_tgt"]
    gen_vec_parts = [x, encoded_in]
    copy_dists = []
    for idx, name in enumerate(sources):
        text, enc_text, mask = _source(name, ft, tokens)
        if cfg.mask_unk:
            mask = mask & (text != 0)[:, None, :].to(mask.dtype)   # ban <unk>
        pa = p["pointer_attn"][idx]
        Q = split_heads(linear(pa["wq"], tp.copy_to(x)), 1)
        attn = attention_weights(Q, pointer_k(pa, enc_text), mask[:, None],
                                 0.0, None, width_sharded=True)[:, 0].float()  # (B, Lt, Ltext)
        copy_dists.append(torch.matmul(attn, one_hot(text, vocab, attn.dtype)))
        gen_vec_parts.append(matmul(attn.to(x.dtype), enc_text))
    return _mix(p, len(sources), p_vocab, copy_dists, gen_vec_parts, x, encoded_in)
