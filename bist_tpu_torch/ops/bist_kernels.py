"""BiST hop 1: the wrappers of the CUDA kernels `csrc/hop1_fwd.cu` (K1, the
fused forward) and `csrc/hop1_bwd.cu` (K2, its backward), their plain
PyTorch versions, and `hop1_trainable`, the differentiable hop 1 built from
both.

Hop 1 attends the query against every group of the video grid (a spatial
region in t2s, a temporal step in s2t):

    out[b, g] = x[b] + MHA(q_proj[b], kv[b, g], kv[b, g], mask[b])

with the query projection `q_proj` = LN(x) Wq + bq computed once outside
(it is group-invariant).  K1 keeps the projected K/V and the scores on chip
and, for training, also writes the residuals `concat` (the attention output
before Wo) and per-head `lse`; K2 recomputes K/V from them and returns the
gradients of q_proj, kv and the K/V weights.  See the sources for their
designs and bounds.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from bist_tpu_torch.ops import _build

NEG_INF = -1e9
MAX_D = 512
GRID_DTYPES = (torch.float32, torch.bfloat16)


def hop1_supports(D: int, h: int) -> bool:
    """Widths the kernels take: D <= 512, a multiple of 8, and a head width
    D / h that is a multiple of 4 (their p·v tiles are 4 columns of one
    head).  The launchers in the sources check the same and plan the tiles."""
    return D <= MAX_D and D % 8 == 0 and D % h == 0 and (D // h) % 4 == 0


def _valid_columns(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, 1, 1, 1, Lk) bool, broadcasting over (B, G, h, Lq, Lk) scores."""
    return None if mask is None else (mask != 0)[:, None, None]


def hop1_plain(x: torch.Tensor, q_proj: torch.Tensor, kv: torch.Tensor,
               attn_params, h: int, mask: Optional[torch.Tensor] = None,
               return_residuals: bool = False):
    """Plain PyTorch hop 1, the semantics of `bist_tpu`'s `hop1_reference`:
    x (B,Lq,D), q_proj (B,Lq,D), kv (B,G,Lk,D), mask (B,1,Lk) or None →
    (B,G,Lq,D) in x's dtype, computed in float32 from any input dtype (a
    bfloat16 grid is projected by the float32 weights, as the Pallas kernel
    does).  A fully masked row attends uniformly over the Lk columns.

    With return_residuals, returns (out, concat, lse): the attention output
    before Wo (B,G,Lq,D) and the per-head log-sum-exp of the scores as the
    softmax saw them (B,G,Lq,h), both float32, as K1 writes them."""
    out_dtype = x.dtype
    x, q_proj, kv = x.float(), q_proj.float(), kv.float()
    B, G, Lk, D = kv.shape
    Lq = x.shape[1]
    dk = D // h
    q = q_proj.reshape(B, 1, Lq, h, dk).transpose(2, 3)            # (B,1,h,Lq,dk)
    k = (kv @ attn_params["wk"]["w"] + attn_params["wk"]["b"]) \
        .reshape(B, G, Lk, h, dk).transpose(2, 3)                    # (B,G,h,Lk,dk)
    v = (kv @ attn_params["wv"]["w"] + attn_params["wv"]["b"]) \
        .reshape(B, G, Lk, h, dk).transpose(2, 3)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(dk)                    # (B,G,h,Lq,Lk)
    if mask is not None:
        s = torch.where(_valid_columns(mask), s, NEG_INF)
    o = torch.softmax(s, dim=-1) @ v                                  # (B,G,h,Lq,dk)
    concat = o.transpose(2, 3).reshape(B, G, Lq, D)
    out = (x[:, None] + (concat @ attn_params["wo"]["w"]
                         + attn_params["wo"]["b"])).to(out_dtype)
    if not return_residuals:
        return out
    return out, concat, torch.logsumexp(s, dim=-1).transpose(2, 3).contiguous()


def hop1_bwd_plain(q_proj: torch.Tensor, kv: torch.Tensor,
                   mask: Optional[torch.Tensor], d_concat: torch.Tensor,
                   dh: torch.Tensor, lse: torch.Tensor, wk: torch.Tensor,
                   bk: torch.Tensor, wv: torch.Tensor, bv: torch.Tensor, h: int):
    """Plain PyTorch hop-1 backward, the interface of `bist_tpu`'s
    `_hop1_bwd_pallas` without its Lq padding, and the semantics of autograd
    through `hop1_plain`: q_proj (B,Lq,D), kv (B,G,Lk,D), mask (B,1,Lk) or
    None, d_concat (B,G,Lq,D), dh and lse (B,G,Lq,h) → (dq (B,Lq,D), dkv in
    kv's dtype, dWk, dWv (D,D), dbk, dbv (D,)).

    p = exp(s − lse) (0 at masked columns), except on a fully masked row,
    which attends uniformly (p = 1/Lk: its lse, −1e9 + log Lk, rounds to
    −1e9 in float32); ds = p (dp − dh) / √d_k at valid columns and 0 at
    masked ones (where the Pallas kernel differs)."""
    B, G, Lk, D = kv.shape
    Lq = q_proj.shape[1]
    dk = D // h
    scale = 1.0 / math.sqrt(dk)
    kvf = kv.float()
    heads = lambda t, L: t.reshape(B, -1, L, h, dk).transpose(2, 3)    # (B,*,h,L,dk)
    q = heads(q_proj.float(), Lq)                                      # (B,1,h,Lq,dk)
    k = heads(kvf @ wk + bk, Lk)                                       # (B,G,h,Lk,dk)
    v = heads(kvf @ wv + bv, Lk)
    dcc = heads(d_concat.float(), Lq)                                  # (B,G,h,Lq,dk)
    s = (q @ k.transpose(-1, -2)) * scale                              # (B,G,h,Lq,Lk)
    p = torch.exp(s - lse.transpose(2, 3)[..., None])
    valid = _valid_columns(mask)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
        uniform = ~valid.any(dim=-1, keepdim=True)                     # (B,1,1,1,1)
        p = torch.where(uniform, 1.0 / Lk, p)
    dp = dcc @ v.transpose(-1, -2)
    ds = p * (dp - dh.transpose(2, 3)[..., None]) * scale
    if valid is not None:
        ds = torch.where(valid, ds, 0.0)
    merge = lambda t: t.transpose(2, 3).reshape(B, -1, t.shape[-2], D)
    dq = merge(ds @ k).sum(1)                                          # (B,Lq,D)
    dk_ = merge(ds.transpose(-1, -2) @ q)                              # (B,G,Lk,D)
    dv_ = merge(p.transpose(-1, -2) @ dcc)
    dkv = (dk_ @ wk.t() + dv_ @ wv.t()).to(kv.dtype)
    rows = kvf.reshape(-1, D)
    dk_, dv_ = dk_.reshape(-1, D), dv_.reshape(-1, D)
    return dq, dkv, rows.t() @ dk_, rows.t() @ dv_, dk_.sum(0), dv_.sum(0)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _lib(name: str, fn_name: str, argtypes, restype=ctypes.c_int) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _fwd_lib() -> ctypes.CDLL:
    return _lib("hop1_fwd", "bist_hop1_fwd",
                [_P, _P, _P, _I, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _P, _I, _I, _I, _I, _I, _I, _F, _P])


def _bwd_lib() -> ctypes.CDLL:
    lib = _lib("hop1_bwd", "bist_hop1_bwd",
               [_P, _P, _I, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P])
    _lib("hop1_bwd", "bist_hop1_bwd_workspace", [_I, _I, _I, _I, _I], _L)
    return lib


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32,
           contiguous: bool = True, who: str = "hop1_fused") -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _check_grid(kv: torch.Tensor, h: int, who: str) -> None:
    """The checks K1 and K2 share: a CUDA grid of a width and dtype they
    take, its last axis contiguous and its rows of 4 aligned."""
    if kv.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {kv.device}")
    D = kv.shape[-1]
    if not hop1_supports(D, h):
        raise ValueError(f"{who}: the kernel takes D <= {MAX_D}, a multiple "
                         f"of 8, with D / h a multiple of 4; got D={D}, h={h}")
    if kv.dtype not in GRID_DTYPES:
        raise ValueError(f"{who}: kv must be float32 or bfloat16; got {kv.dtype}")
    if kv.stride(-1) != 1:
        raise ValueError(f"{who}: kv's last axis must be contiguous")
    if kv.data_ptr() % (4 * kv.element_size()) or any(st % 4 for st in kv.stride()[:3]):
        raise ValueError(f"{who}: kv's rows of 4 must be aligned to their vector loads")


def _launch_failed(who: str, rc: int, kv: torch.Tensor, Lq: int, h: int):
    B, G, Lk, D = kv.shape
    return RuntimeError(f"{who}: kernel launch failed with CUDA error {rc} "
                        f"(B={B} G={G} Lq={Lq} Lk={Lk} D={D} h={h} kv {kv.dtype})")


def hop1_fused(x: torch.Tensor, q_proj: torch.Tensor, kv: torch.Tensor,
               attn_params, h: int, mask: Optional[torch.Tensor] = None,
               return_residuals: bool = False):
    """Fused hop 1 (same arguments and results as `hop1_plain`).

    On a CUDA tensor it launches the K1 kernel, or raises (for widths outside
    `hop1_supports`, other dtypes, misaligned or non-contiguous inputs); on a
    CPU tensor it runs `hop1_plain`.  kv is float32 or bfloat16 and may be a
    strided view (the t2s direction passes the grid with T and S swapped) as
    long as its last axis is contiguous; x, q_proj, the weights and the mask
    must be contiguous, float32 (mask int32), on kv's device.  The results
    are float32.  `hop1_fused.launches` counts kernel launches."""
    if kv.device.type == "cpu":
        return hop1_plain(x, q_proj, kv, attn_params, h, mask, return_residuals)
    _check_grid(kv, h, "hop1_fused")
    dev = kv.device
    B, G, Lk, D = kv.shape
    Lq = x.shape[1]
    _check("x", x, (B, Lq, D), dev)
    _check("q_proj", q_proj, (B, Lq, D), dev)
    w = [attn_params[n][p] for n in ("wk", "wv", "wo") for p in ("w", "b")]
    for n, t in zip(("wk", "bk", "wv", "bv", "wo", "bo"), w):
        _check(n, t, (D, D) if n[0] == "w" else (D,), dev)
    if any(t.data_ptr() % 16 for t in [x, q_proj] + w):
        raise ValueError("hop1_fused: x, q_proj, weights and biases must be "
                         "aligned to their vector loads")
    if mask is not None:
        _check("mask", mask, (B, 1, Lk), dev, dtype=torch.int32)
    out = torch.empty((B, G, Lq, D), device=dev, dtype=torch.float32)
    concat = lse = None
    if return_residuals:
        concat = torch.empty((B, G, Lq, D), device=dev, dtype=torch.float32)
        lse = torch.empty((B, G, Lq, h), device=dev, dtype=torch.float32)
    lib = _fwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bist_hop1_fwd(
            x.data_ptr(), q_proj.data_ptr(), kv.data_ptr(),
            int(kv.dtype == torch.bfloat16),
            kv.stride(0), kv.stride(1), kv.stride(2),
            None if mask is None else mask.data_ptr(),
            *[t.data_ptr() for t in w], out.data_ptr(),
            None if concat is None else concat.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, G, Lq, Lk, D, h, 1.0 / math.sqrt(D // h), stream)
    if rc != 0:
        raise _launch_failed("hop1_fused", rc, kv, Lq, h)
    hop1_fused.launches += 1
    return (out, concat, lse) if return_residuals else out


hop1_fused.launches = 0


def hop1_bwd(q_proj: torch.Tensor, kv: torch.Tensor, mask: Optional[torch.Tensor],
             d_concat: torch.Tensor, dh: torch.Tensor, lse: torch.Tensor,
             wk: torch.Tensor, bk: torch.Tensor, wv: torch.Tensor, bv: torch.Tensor,
             h: int):
    """Hop-1 backward (same arguments and results as `hop1_bwd_plain`).

    On a CUDA tensor it launches the K2 kernel (its three passes), or raises
    as `hop1_fused` does; on a CPU tensor it runs `hop1_bwd_plain`.  kv is
    float32 or bfloat16 and may be a strided view; every other tensor must be
    contiguous float32 (mask int32) on kv's device.  dkv comes back
    contiguous in kv's dtype.  `hop1_bwd.launches` counts kernel launches."""
    if kv.device.type == "cpu":
        return hop1_bwd_plain(q_proj, kv, mask, d_concat, dh, lse, wk, bk, wv, bv, h)
    who = "hop1_bwd"
    _check_grid(kv, h, who)
    dev = kv.device
    B, G, Lk, D = kv.shape
    Lq = q_proj.shape[1]
    _check("q_proj", q_proj, (B, Lq, D), dev, who=who)
    _check("d_concat", d_concat, (B, G, Lq, D), dev, who=who)
    _check("dh", dh, (B, G, Lq, h), dev, who=who)
    _check("lse", lse, (B, G, Lq, h), dev, who=who)
    for n, t in (("wk", wk), ("bk", bk), ("wv", wv), ("bv", bv)):
        _check(n, t, (D, D) if n[0] == "w" else (D,), dev, who=who)
    if mask is not None:
        _check("mask", mask, (B, 1, Lk), dev, dtype=torch.int32, who=who)
    wkv_t = torch.cat([wk.t(), wv.t()]).contiguous()          # [Wkᵀ ; Wvᵀ] (2D, D)
    if any(t.data_ptr() % 16 for t in (q_proj, d_concat, wk, bk, wv, bv, wkv_t)):
        raise ValueError("hop1_bwd: q_proj, d_concat, weights and biases must be "
                         "aligned to their vector loads")
    lib = _bwd_lib()
    dkv = torch.empty((B, G, Lk, D), device=dev, dtype=kv.dtype)
    dq = torch.empty((B, Lq, D), device=dev, dtype=torch.float32)
    wgrad = torch.empty(2 * D * D + 2 * D, device=dev, dtype=torch.float32)
    ws = torch.empty(lib.bist_hop1_bwd_workspace(B, G, Lq, Lk, D), device=dev,
                     dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bist_hop1_bwd(
            q_proj.data_ptr(), kv.data_ptr(), int(kv.dtype == torch.bfloat16),
            kv.stride(0), kv.stride(1), kv.stride(2),
            None if mask is None else mask.data_ptr(),
            d_concat.data_ptr(), dh.data_ptr(), lse.data_ptr(),
            wk.data_ptr(), bk.data_ptr(), wv.data_ptr(), bv.data_ptr(),
            wkv_t.data_ptr(), dkv.data_ptr(), dq.data_ptr(), wgrad.data_ptr(),
            ws.data_ptr(), B, G, Lq, Lk, D, h, 1.0 / math.sqrt(D // h), stream)
    if rc != 0:
        raise _launch_failed(who, rc, kv, Lq, h)
    hop1_bwd.launches += 1
    dwk, dwv = wgrad[:2 * D * D].view(2, D, D)
    dbk, dbv = wgrad[2 * D * D:].view(2, D)
    return dq, dkv, dwk, dwv, dbk, dbv


hop1_bwd.launches = 0


class hop1_trainable(torch.autograd.Function):
    """Differentiable hop 1, `bist_tpu`'s `hop1_trainable` (its custom VJP):
    `hop1_trainable.apply(x, q_proj, kv, wk, bk, wv, bv, wo, bo, h, mask)`
    gives `hop1_plain`'s result.  The forward runs K1 with residuals (on a
    CPU tensor, `hop1_plain`); the backward computes dx, dWo, dbo, d_concat =
    g Woᵀ and the row statistic Dh with plain products and sums, as the JAX
    glue does outside Pallas, then K2 (on a CPU tensor, `hop1_bwd_plain`)
    for dq_proj, dkv and the K/V weights.  mask and h get no gradient."""

    @staticmethod
    def forward(ctx, x, q_proj, kv, wk, bk, wv, bv, wo, bo, h, mask=None):
        p = {"wk": {"w": wk, "b": bk}, "wv": {"w": wv, "b": bv},
             "wo": {"w": wo, "b": bo}}
        out, concat, lse = hop1_fused(x, q_proj, kv, p, h, mask,
                                      return_residuals=True)
        ctx.save_for_backward(q_proj, kv, wk, bk, wv, bv, wo, mask, concat, lse)
        ctx.h, ctx.x_dtype = h, x.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        q_proj, kv, wk, bk, wv, bv, wo, mask, concat, lse = ctx.saved_tensors
        h = ctx.h
        B, G, Lq, D = g.shape
        gf = g.float()
        dx = gf.sum(1).to(ctx.x_dtype)                                 # (B, Lq, D)
        dbo = gf.sum((0, 1, 2))
        dwo = concat.reshape(-1, D).t() @ gf.reshape(-1, D)
        d_concat = (gf @ wo.t()).contiguous()                          # g Woᵀ
        # per-head row statistic Dh = Σ_dk d_concat ⊙ concat → (B, G, Lq, h)
        dh = (d_concat * concat).reshape(B, G, Lq, h, D // h).sum(-1)
        dq, dkv, dwk, dwv, dbk, dbv = hop1_bwd(
            q_proj, kv, mask, d_concat, dh, lse, wk, bk, wv, bv, h)
        return dx, dq, dkv, dwk, dbk, dwv, dbv, dwo, dbo, None, None
