"""Transformer primitives as plain functions on parameter dicts of tensors
(the names and layouts of `bist_tpu.models.layers`; a linear weight is
(in, out)).

Numerical targets (reference model/modules.py):
  * LayerNorm divides by (std + eps), std with Bessel's correction, stats in
    float32 (modules.py:20-31) — not `nn.LayerNorm`;
  * pre-norm residual x + dropout(sublayer(LN(x))) (modules.py:33-44);
  * scaled-dot attention with -1e9 where mask == 0, softmax in float32
    (modules.py:54-64);
  * multi-head attention with q/k/v/out linears, d_k = d_model / h;
  * W2(dropout(relu(W1 x))) feed-forward, ×√d_model embedding, sinusoidal
    positional encoding.

Init parity (mtn.py:163-165): xavier-uniform for every weight with ndim > 1
(the embedding too), U(±1/√fan_in) biases, LayerNorm scale 1 / bias 0.
Params are created on the CPU from a `torch.Generator` and moved by the
caller.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from bist_tpu_torch.ops import dispatch
from bist_tpu_torch.ops.flash_attention import flash_attention

Params = Dict[str, Any]

NEG_INF = -1e9

# Decode-memory storage dtypes (GenerateConfig.cache_dtype).  float8 is
# storage only: every read site takes it through `upcast_fp8` to bfloat16,
# as `bist_tpu` does; scores, softmax and the generator stay float32.
STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float8_e4m3fn": torch.float8_e4m3fn,
                  "float8_e5m2": torch.float8_e5m2}
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def storage_dtype(name: str) -> torch.dtype:
    """GenerateConfig.cache_dtype → torch dtype."""
    try:
        return STORAGE_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"cache_dtype {name!r}: expected one of {sorted(STORAGE_DTYPES)}"
        ) from None


def upcast_fp8(x: torch.Tensor) -> torch.Tensor:
    """A decode-memory tensor as compute reads it: float8 → bfloat16 (exact),
    any other dtype unchanged."""
    return x.to(torch.bfloat16) if x.dtype in FP8_DTYPES else x


def dropout(x: torch.Tensor, rate: float,
            rngs: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout; identity when rngs is None or rate == 0."""
    if rngs is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    m = torch.rand(x.shape, generator=rngs, device=rngs.device) < keep
    return torch.where(m.to(x.device), x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Inits (CPU tensors from a torch.Generator)


def xavier_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2 - 1) * bound


def linear_init(gen: torch.Generator, d_in: int, d_out: int) -> Params:
    bound = 1.0 / math.sqrt(d_in)
    return {"w": xavier_uniform(gen, (d_in, d_out)),
            "b": (torch.rand((d_out,), generator=gen) * 2 - 1) * bound}


def layer_norm_init(d: int) -> Params:
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def embedding_init(gen: torch.Generator, vocab: int, d_model: int) -> Params:
    return {"lut": xavier_uniform(gen, (vocab, d_model))}


def mha_init(gen: torch.Generator, h: int, d_model: int) -> Params:
    return {n: linear_init(gen, d_model, d_model) for n in ("wq", "wk", "wv", "wo")}


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int) -> Params:
    return {"w1": linear_init(gen, d_model, d_ff),
            "w2": linear_init(gen, d_ff, d_model)}


# ---------------------------------------------------------------------------
# Apply


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted type of the two, as jnp.einsum promotes (a
    bfloat16 model mixes bfloat16 features with float32 text states)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    w, b = p["w"], p["b"]
    if x.dtype != w.dtype:
        w, b = w.to(x.dtype), b.to(x.dtype)
    return torch.matmul(x, w) + b


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(x - mean) / (std + eps), Bessel-corrected std, stats in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    d = x.shape[-1]
    var = torch.sum(torch.square(xf - mean), dim=-1, keepdim=True) / max(d - 1, 1)
    out = p["scale"] * (xf - mean) / (torch.sqrt(var) + eps) + p["bias"]
    return out.to(x.dtype)


def embed(p: Params, ids: torch.Tensor, d_model: int) -> torch.Tensor:
    return p["lut"][ids.long()] * math.sqrt(d_model)


_pe_tables: Dict[tuple, torch.Tensor] = {}


def positional_encoding_table(d_model: int, max_len: int,
                              device) -> torch.Tensor:
    """Sinusoidal table (max_len, d_model) (modules.py:125-144), computed in
    float64 and stored float32, once per (d_model, max_len, device)."""
    key = (d_model, max_len, str(device))
    pe = _pe_tables.get(key)
    if pe is None:
        position = torch.arange(0.0, max_len, dtype=torch.float64)[:, None]
        div_term = torch.exp(torch.arange(0.0, d_model, 2, dtype=torch.float64)
                             * -(math.log(10000.0) / d_model))
        pe = torch.zeros((max_len, d_model), dtype=torch.float32)
        pe[:, 0::2] = torch.sin(position * div_term).float()
        pe[:, 1::2] = torch.cos(position * div_term).float()
        pe = _pe_tables[key] = pe.to(device)
    return pe


def add_positional(pe: torch.Tensor, x: torch.Tensor, rate: float,
                   rngs: Optional[torch.Generator], offset: int = 0) -> torch.Tensor:
    """x + pe[offset:offset+L] then dropout."""
    L = x.shape[-2]
    return dropout(x + pe[offset:offset + L], rate, rngs)


def split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(..., L, d_model) → (..., h, L, d_k)."""
    *lead, L, d = x.shape
    return x.reshape(*lead, L, h, d // h).transpose(-2, -3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., h, L, d_k) → (..., L, h*d_k)."""
    x = x.transpose(-2, -3)
    *lead, L, h, dk = x.shape
    return x.reshape(*lead, L, h * dk)


def attention_weights(q: torch.Tensor, k: torch.Tensor,
                      mask: Optional[torch.Tensor], drop_rate: float,
                      rngs: Optional[torch.Generator]) -> torch.Tensor:
    """softmax(QKᵀ/√d_k) with -1e9 where mask == 0; scores and softmax in
    float32.  q (..., h, Lq, d_k), k (..., h, Lk, d_k), leading dims
    broadcast; mask broadcastable to (..., 1, Lq, Lk)."""
    d_k = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d_k)
    if mask is not None:
        scores = torch.where(mask == 0, NEG_INF, scores)
    p_attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return dropout(p_attn, drop_rate, rngs)


def _flash_path(Q, K, V, mask):
    """Flatten the leading dims (heads included) and run the K3 wrapper in
    the promoted dtype of Q, K and V (the plain path's result dtype)."""
    lead = torch.broadcast_shapes(Q.shape[:-2], K.shape[:-2])
    Lq, dk = Q.shape[-2:]
    Lk = K.shape[-2]
    dt = torch.promote_types(torch.promote_types(Q.dtype, K.dtype), V.dtype)
    Qb = Q.to(dt).expand(lead + (Lq, dk)).reshape(-1, Lq, dk).contiguous()
    Kb = K.to(dt).expand(lead + (Lk, dk)).reshape(-1, Lk, dk).contiguous()
    Vb = V.to(dt).expand(lead + (Lk, dk)).reshape(-1, Lk, dk).contiguous()
    mb = None
    if mask is not None:
        # kv-validity rows broadcast over Lq and heads
        mb = mask[..., 0, :].expand(lead + (Lk,)).reshape(-1, Lk) \
            .to(torch.int32).contiguous()
    out = flash_attention(Qb, Kb, Vb, mb)
    return out.reshape(lead + (Lq, dk))


def mha(p: Params, h: int, query: torch.Tensor, key: torch.Tensor,
        value: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
        drop_rate: float = 0.1, rngs: Optional[torch.Generator] = None,
        return_attn: bool = False, allow_flash: bool = True):
    """Multi-head attention with broadcastable leading batch dims.

    query (..., Lq, D), key/value (..., Lk, D).  The projections run on the
    unbroadcast inputs; only the score product sees broadcast shapes.  mask
    broadcastable to (..., Lq, Lk) (a head axis is inserted); 0 = masked.
    Long kv axes go to the K3 kernel (`ops.dispatch.mha_uses_flash`)."""
    Q = split_heads(linear(p["wq"], query), h)
    K = split_heads(linear(p["wk"], key), h)
    V = split_heads(linear(p["wv"], value), h)
    if mask is not None:
        mask = mask[..., None, :, :]                 # head axis
    if allow_flash and dispatch.mha_uses_flash(
            kv_len=K.shape[-2], dropout_active=rngs is not None,
            grad=dispatch.needs_grad(query, key, value, p["wq"]["w"]),
            return_attn=return_attn,
            mask_is_kv_validity=mask is None or mask.shape[-2] == 1):
        x = _flash_path(Q, K, V, mask)
        return linear(p["wo"], merge_heads(x))
    attn = attention_weights(Q, K, mask, drop_rate, rngs)
    out = linear(p["wo"], merge_heads(matmul(attn, V)))
    if return_attn:
        return out, attn
    return out


def ffn(p: Params, x: torch.Tensor, drop_rate: float,
        rngs: Optional[torch.Generator]) -> torch.Tensor:
    return linear(p["w2"], dropout(torch.relu(linear(p["w1"], x)), drop_rate, rngs))


def sublayer(p_norm: Params, x: torch.Tensor, fn, drop_rate: float,
             rngs: Optional[torch.Generator]) -> torch.Tensor:
    """x + dropout(fn(LN(x))); `fn` sees the normed x."""
    return x + dropout(fn(layer_norm(p_norm, x)), drop_rate, rngs)


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """(1, L, L) lower-triangular causal mask, 1 = attend."""
    return torch.tril(torch.ones((1, size, size), dtype=torch.int32, device=device))
