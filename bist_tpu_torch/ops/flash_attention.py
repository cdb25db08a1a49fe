"""Streaming-softmax attention: the wrapper of the CUDA kernel
`csrc/flash_fwd.cu` (K3) and its plain PyTorch version.

`models.layers.mha` sends long kv axes here (`ops.dispatch`); the kernel
never materialises the (G, Lq, Lk) scores.  One kernel takes every head
dim: every product on the tensor cores in 3xTF32, 16 query rows a warp, K
and V streamed through a cp.async ring; up to d 128 the warps split the kv
rows of a tile, above it d's columns, and above d 1024 the output columns
go to blocks of up to 1024.  At `mha`'s shape on the H100 (128 head rows
of 32 queries, kv 32768, d 64) the work is bound by bytes: K and V read
once, 0.647 ms at 3.35 TB/s, against 0.21 ms of 3xTF32 products (H100 SXM
data sheet).  See the source for the design.  Forward only.
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
    if lib.bist_flash_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn, argtypes in (
                ("bist_flash_fwd", [P] * 8 + [I] * 7 + [ctypes.c_float, P]),
                ("bist_flash_plan", [I] * 5 + [ctypes.POINTER(I)] * 2),
                ("bist_flash_resources", [I] * 5 + [P])):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def flash_resources(G: int, Lq: int, Lk: int, d: int, bf16: bool = False) -> dict:
    """What a K3 launch at these widths takes on the current CUDA device:
    its mode ("kv split" up to head dim 128, "column split" above), dynamic
    shared memory, registers and local memory (spills, stack) a thread,
    resident blocks an SM, threads a block, kv rows a tile, query rows a
    block, ring slots, whether q is staged split, column blocks (above head
    dim 1024) and the kv split."""
    info = (ctypes.c_int * 13)()
    rc = _lib().bist_flash_resources(G, Lq, Lk, d, int(bf16), info)
    if rc != 0:
        raise RuntimeError(f"flash_resources: CUDA error {rc} (Lq={Lq} Lk={Lk} d={d})")
    keys = ("smem_bytes", "registers", "local_bytes", "blocks_per_sm", "threads",
            "kv_tile", "query_rows", "ring_slots", "q_split", "column_blocks", "split_kv",
            "splits")
    return {"mode": "kv split" if info[0] else "column split", **dict(zip(keys, info[1:]))}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention without materialised scores (same arguments and result as
    `attention_plain`), through the registered op
    `torch.ops.bist_tpu_torch.flash_fwd` (`flash_fwd_op`).

    On a CUDA tensor it launches the K3 kernel, or raises (other dtypes,
    non-contiguous inputs); on a CPU tensor it runs `attention_plain`.  q,
    k, v: contiguous, one dtype, float32 or bfloat16 (the result has it
    too), any head dim, any alignment; mask: contiguous int32 (G, Lk) or
    None.  `flash_attention.launches` counts the kernel's launches, a
    launch recorded into a CUDA graph's capture included (a replay does not
    pass through the op)."""
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_fwd_op(q, k, v, mask, 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None
                        else float(sm_scale))


@torch.library.custom_op("bist_tpu_torch::flash_fwd", mutates_args=(), device_types="cuda")
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], sm_scale: float) -> torch.Tensor:
    """K3 as a registered op.  Its CUDA implementation checks the inputs,
    plans the kv split and launches; its CPU implementation is
    `attention_plain`; its fake gives q's shape and dtype and touches no
    library."""
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
    bf16 = int(q.dtype == torch.bfloat16)
    dev = q.device
    lib = _lib()
    chunk, nsplit = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(dev):
        rc = lib.bist_flash_plan(G, Lq, Lk, d, bf16, ctypes.byref(chunk),
                                 ctypes.byref(nsplit))
        if rc != 0:
            raise RuntimeError(f"flash_attention: planning failed with CUDA error {rc} "
                               f"(G={G} Lq={Lq} Lk={Lk} d={d})")
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
                                bf16, G, Lq, Lk, d, chunk, nsplit, sm_scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc} (G={G} Lq={Lq} Lk={Lk} d={d} {q.dtype} "
                           f"splits={nsplit}x{chunk})")
    flash_attention.launches += 1
    return out


@flash_fwd_op.register_kernel("cpu")
def _flash_fwd_cpu(q, k, v, mask, sm_scale):
    return attention_plain(q, k, v, mask, sm_scale)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, mask, sm_scale):
    return torch.empty_like(q)


flash_attention.launches = 0
