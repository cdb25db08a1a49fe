"""Streaming-softmax attention: the wrapper of the CUDA kernel
`csrc/flash_fwd.cu` (K3) and its plain PyTorch version.

`models.layers.mha` sends long kv axes here (`ops.dispatch`); the kernel
never materialises the (G, Lq, Lk) scores.  See the source for its design
and bound.  Forward only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from bist_tpu_torch.ops import _build

NEG_INF = -1e9
DTYPES = (torch.float32, torch.bfloat16)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale, -1e9 where mask == 0) v for q (G,Lq,d), k/v
    (G,Lk,d), mask (G,Lk): the semantics of `bist_tpu`'s
    `attention_reference`, computed in float32 and returned in q's dtype, as
    the kernel does.  A fully masked row attends uniformly over Lk."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out_dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    s = (q @ k.transpose(-1, -2)) * sm_scale
    if mask is not None:
        s = torch.where(mask[:, None, :] != 0, s, NEG_INF)
    return (torch.softmax(s, dim=-1) @ v).to(out_dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    fn = lib.bist_flash_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I] * 7 + [ctypes.c_float, P]
        fn.restype = ctypes.c_int
        plan = lib.bist_flash_plan
        plan.argtypes = [I] * 4 + [ctypes.POINTER(I)] * 2
        plan.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention without materialised scores (same arguments and result as
    `attention_plain`).

    On a CUDA tensor it launches the K3 kernel, or raises (other dtypes,
    non-contiguous inputs); on a CPU tensor it runs `attention_plain`.  q,
    k, v: contiguous, one dtype, float32 or bfloat16 (the result has it
    too), any head dim and alignment; mask: contiguous int32 (G, Lk) or
    None.  `flash_attention.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    G, Lq, d = q.shape
    Lk = k.shape[1]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: q must be float32 or bfloat16; got {q.dtype}")
    want = {"k": (k, (G, Lk, d), q.dtype), "v": (v, (G, Lk, d), q.dtype),
            "q": (q, (G, Lq, d), q.dtype)}
    if mask is not None:
        want["mask"] = (mask, (G, Lk), torch.int32)
    for name, (t, shape, dtype) in want.items():
        if (t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"flash_attention: {name} must be contiguous {dtype} {shape} on "
                f"{q.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dev = q.device
    lib = _lib()
    chunk, nsplit = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(dev):
        rc = lib.bist_flash_plan(G, Lq, Lk, d, ctypes.byref(chunk), ctypes.byref(nsplit))
        if rc != 0:
            raise RuntimeError(f"flash_attention: planning failed with CUDA error {rc}")
        chunk, nsplit = chunk.value, nsplit.value
        out = torch.empty_like(q)
        parts = [None] * 3
        if nsplit > 1:    # per-split running max, sum and accumulator
            parts = [torch.empty((G, nsplit, Lq), device=dev, dtype=torch.float32),
                     torch.empty((G, nsplit, Lq), device=dev, dtype=torch.float32),
                     torch.empty((G, nsplit, Lq, d), device=dev, dtype=torch.float32)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bist_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                None if mask is None else mask.data_ptr(),
                                out.data_ptr(),
                                *[None if t is None else t.data_ptr() for t in parts],
                                int(q.dtype == torch.bfloat16),
                                G, Lq, Lk, d, chunk, nsplit, sm_scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc} (G={G} Lq={Lq} Lk={Lk} d={d} {q.dtype} "
                           f"splits={nsplit}x{chunk})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
