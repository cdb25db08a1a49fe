"""BiST hop 1, fused: the wrapper of the CUDA kernel `csrc/hop1_fwd.cu` (K1)
and its plain PyTorch version.

Hop 1 attends the query against every group of the video grid (a spatial
region in t2s, a temporal step in s2t):

    out[b, g] = x[b] + MHA(q_proj[b], kv[b, g], kv[b, g], mask[b])

with the query projection `q_proj` = LN(x) Wq + bq computed once outside
(it is group-invariant).  The kernel keeps the projected K/V and the scores
on chip; see the source for its design and bound.  Forward only: the
backward kernel (K2) belongs to the training slice.
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
    """Widths the kernel takes: D <= 512, a multiple of 8, and a head width
    D / h that is a multiple of 4 (its p·v tiles are 4 columns of one head).
    The launcher in the source checks the same and plans the tiles."""
    return D <= MAX_D and D % 8 == 0 and D % h == 0 and (D // h) % 4 == 0


def hop1_plain(x: torch.Tensor, q_proj: torch.Tensor, kv: torch.Tensor,
               attn_params, h: int,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch hop 1, the semantics of `bist_tpu`'s `hop1_reference`:
    x (B,Lq,D), q_proj (B,Lq,D), kv (B,G,Lk,D), mask (B,1,Lk) or None →
    (B,G,Lq,D) in x's dtype, computed in float32 from any input dtype (a
    bfloat16 grid is projected by the float32 weights, as the Pallas kernel
    does).  A fully masked row attends uniformly over the Lk columns."""
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
        s = torch.where(mask[:, None, None] != 0, s, NEG_INF)
    o = torch.softmax(s, dim=-1) @ v                                  # (B,G,h,Lq,dk)
    concat = o.transpose(2, 3).reshape(B, G, Lq, D)
    out = x[:, None] + (concat @ attn_params["wo"]["w"] + attn_params["wo"]["b"])
    return out.to(out_dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("hop1_fwd")
    fn = lib.bist_hop1_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P,
                       _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32,
           contiguous: bool = True) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"hop1_fused: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"hop1_fused: {name} must be contiguous")


def hop1_fused(x: torch.Tensor, q_proj: torch.Tensor, kv: torch.Tensor,
               attn_params, h: int,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused hop 1 (same arguments and result as `hop1_plain`).

    On a CUDA tensor it launches the K1 kernel, or raises (for widths outside
    `hop1_supports`, other dtypes, misaligned or non-contiguous inputs); on a
    CPU tensor it runs `hop1_plain`.  kv is float32 or bfloat16 and may be a
    strided view (the t2s direction passes the grid with T and S swapped) as
    long as its last axis is contiguous; x, q_proj, the weights and the mask
    must be contiguous, float32 (mask int32), on kv's device.  The result is
    float32.  `hop1_fused.launches` counts kernel launches."""
    if kv.device.type == "cpu":
        return hop1_plain(x, q_proj, kv, attn_params, h, mask)
    if kv.device.type != "cuda":
        raise ValueError(f"hop1_fused: unsupported device {kv.device}")
    dev = kv.device
    B, G, Lk, D = kv.shape
    Lq = x.shape[1]
    if not hop1_supports(D, h):
        raise ValueError(f"hop1_fused: the kernel takes D <= {MAX_D}, a multiple "
                         f"of 8, with D / h a multiple of 4; got D={D}, h={h}")
    if kv.dtype not in GRID_DTYPES:
        raise ValueError(f"hop1_fused: kv must be float32 or bfloat16; got {kv.dtype}")
    _check("kv", kv, (B, G, Lk, D), dev, dtype=kv.dtype, contiguous=False)
    if kv.stride(-1) != 1:
        raise ValueError("hop1_fused: kv's last axis must be contiguous")
    _check("x", x, (B, Lq, D), dev)
    _check("q_proj", q_proj, (B, Lq, D), dev)
    w = [attn_params[n][p] for n in ("wk", "wv", "wo") for p in ("w", "b")]
    for n, t in zip(("wk", "bk", "wv", "bv", "wo", "bo"), w):
        _check(n, t, (D, D) if n[0] == "w" else (D,), dev)
    if (any(t.data_ptr() % 16 for t in [x, q_proj] + w)
            or kv.data_ptr() % (4 * kv.element_size())
            or any(st % 4 for st in kv.stride()[:3])):
        raise ValueError("hop1_fused: x, q_proj, kv's rows of 4, weights and "
                         "biases must be aligned to their vector loads")
    if mask is not None:
        _check("mask", mask, (B, 1, Lk), dev, dtype=torch.int32)
    out = torch.empty((B, G, Lq, D), device=dev, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bist_hop1_fwd(
            x.data_ptr(), q_proj.data_ptr(), kv.data_ptr(),
            int(kv.dtype == torch.bfloat16),
            kv.stride(0), kv.stride(1), kv.stride(2),
            None if mask is None else mask.data_ptr(),
            *[t.data_ptr() for t in w], out.data_ptr(),
            B, G, Lq, Lk, D, h, 1.0 / math.sqrt(D // h), stream)
    if rc != 0:
        raise RuntimeError(f"hop1_fused: kernel launch failed with CUDA error {rc} "
                           f"(B={B} G={G} Lq={Lq} Lk={Lk} D={D} h={h} "
                           f"kv {kv.dtype})")
    hop1_fused.launches += 1
    return out


hop1_fused.launches = 0
