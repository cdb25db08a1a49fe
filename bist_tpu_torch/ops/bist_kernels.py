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
gradients of q_proj, kv and the K/V weights.  K1 and K2 have two kernels
each, which their launchers choose by shape (`hop1_variant`,
`hop1_bwd_variant`): "whole" at the main path's widths (every product on
the tensor cores as 3xTF32, which keeps float32 accuracy) and "tiled" at
every other width with D % h == 0.  The kernels
hold each head's columns padded with zeros to a multiple of 4; the wrappers
hand q, the weights and d_concat over in that layout (`_pad_heads`) and take
the padding off what comes back, which changes no number.  See the sources
for their designs and bounds.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from bist_tpu_torch.ops import _build

NEG_INF = -1e9
GRID_DTYPES = (torch.float32, torch.bfloat16)


def hop1_supports(D: int, h: int) -> bool:
    """Widths the kernels take: every D with D % h == 0, as the model's
    config allows (the launchers in the sources plan the tiles)."""
    return D >= 1 and h >= 1 and D % h == 0


def _pad_heads(t: torch.Tensor, h: int, dim: int = -1) -> torch.Tensor:
    """`t` with axis `dim` (h heads of d_k columns) in the kernels' padded
    head layout: each head's columns followed by zeros up to a multiple of
    4 (csrc/hop1_tiles.cuh); `t` itself when d_k is one already."""
    dk = t.shape[dim] // h
    pad = -dk % 4
    if pad == 0:
        return t
    t = t.movedim(dim, -1)
    t = torch.nn.functional.pad(t.reshape(*t.shape[:-1], h, dk), (0, pad))
    return t.reshape(*t.shape[:-2], h * (dk + pad)).movedim(-1, dim).contiguous()


def _unpad_heads(t: torch.Tensor, h: int, D: int) -> torch.Tensor:
    """The inverse of `_pad_heads` on the last axis, back to D columns."""
    if t.shape[-1] == D:
        return t
    return t.reshape(*t.shape[:-1], h, -1)[..., :D // h].reshape(*t.shape[:-1], D)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy at a fresh allocation where `t` does not start on the
    16 bytes the kernels' vector loads need."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_cols4(t: torch.Tensor) -> torch.Tensor:
    """`t` with its columns padded with zeros to a multiple of 4."""
    pad = -t.shape[-1] % 4
    return t if pad == 0 else torch.nn.functional.pad(t, (0, pad))


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


def bind_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from csrc/hop1_fwd.cu."""
    args = [_P, _P, _P, _I, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _I, _F, _P]
    for fn, argtypes in (("bist_hop1_fwd", args), ("bist_hop1_fwd_as", [_I] + args),
                         ("bist_hop1_fwd_variant", [_I] * 5),
                         ("bist_hop1_fwd_resources", [_I] * 6 + [_P])):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("hop1_fwd")
    return lib if lib.bist_hop1_fwd.argtypes else bind_fwd(lib)


# K1's two kernels (csrc/hop1_fwd.cu), by the code its launcher's choice returns
HOP1_VARIANTS = {1: "tiled", 2: "whole"}


def _rows_vec4(kv: torch.Tensor) -> bool:
    """Whether kv's rows are whole, aligned 4-element vectors (the test the
    launcher makes before it may choose "whole")."""
    return (kv.shape[-1] % 4 == 0 and all(st % 4 == 0 for st in kv.stride()[:3])
            and kv.data_ptr() % (4 * kv.element_size()) == 0)


@functools.lru_cache(maxsize=None)
def hop1_variant(Lq: int, Lk: int, D: int, h: int, kv_vec: bool = True) -> str:
    """The K1 kernel a launch at these widths takes, as the launcher chooses
    it from the shape and kv's alignment (`kv_vec`: rows of aligned
    4-element vectors) alone: "whole" (all kv rows of a group in one tile,
    every product on the tensor cores in 3xTF32; D 64 or 128, d_k a multiple
    of 8 up to 32, Lk <= 64, aligned rows) or "tiled" (head groups, kv tiles
    with an online softmax, FMAs; every other width); ValueError for widths
    neither takes.  Builds the library on first use."""
    code = _fwd_lib().bist_hop1_fwd_variant(Lq, Lk, D, h, int(kv_vec))
    if code not in HOP1_VARIANTS:
        raise ValueError(f"hop1_fused: no kernel takes Lq={Lq} Lk={Lk} D={D} h={h}")
    return HOP1_VARIANTS[code]


def hop1_resources(G: int, Lq: int, Lk: int, D: int, h: int, bf16: bool = False) -> dict:
    """What the K1 kernel chosen at these widths takes on the current CUDA
    device: its variant, dynamic shared memory, registers and local memory
    (spills, stack) a thread, resident blocks per SM, groups a block and
    heads a head group."""
    info = (ctypes.c_int * 7)()
    rc = _fwd_lib().bist_hop1_fwd_resources(G, Lq, Lk, D, h, int(bf16), info)
    if rc != 0:
        raise RuntimeError(f"hop1_resources: CUDA error {rc} (Lq={Lq} Lk={Lk} "
                           f"D={D} h={h})")
    return {"variant": HOP1_VARIANTS[info[0]], "smem_bytes": info[1],
            "registers": info[2], "local_bytes": info[3], "blocks_per_sm": info[4],
            "groups_per_block": info[5], "heads_per_group": info[6]}


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from csrc/hop1_bwd.cu."""
    args = [_P, _P, _I, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]
    for fn, argtypes, restype in (
            ("bist_hop1_bwd", args, _I), ("bist_hop1_bwd_as", [_I] + args, _I),
            ("bist_hop1_bwd_variant", [_I] * 5, _I),
            ("bist_hop1_bwd_workspace", [_I] * 6, _L),
            ("bist_hop1_bwd_resources", [_I] * 6 + [_P], _I)):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("hop1_bwd")
    return lib if lib.bist_hop1_bwd.argtypes else bind_bwd(lib)


@functools.lru_cache(maxsize=None)
def hop1_bwd_variant(Lq: int, Lk: int, D: int, h: int, kv_vec: bool = True) -> str:
    """The K2 kernel a launch at these widths takes, as its launcher chooses
    it from the shape and kv's alignment alone, by K1's rule
    (`hop1_variant`): "whole" (all kv rows of a group in one block, every
    product on the tensor cores in 3xTF32, and a tensor-core dW pass; D 64
    or 128, d_k a multiple of 8 up to 32, Lk <= 64, aligned rows, any Lq) or
    "tiled" (FMA passes; every other width); ValueError for widths neither
    takes.  Builds the library on first use."""
    code = _bwd_lib().bist_hop1_bwd_variant(Lq, Lk, D, h, int(kv_vec))
    if code not in HOP1_VARIANTS:
        raise ValueError(f"hop1_bwd: no kernel takes Lq={Lq} Lk={Lk} D={D} h={h}")
    return HOP1_VARIANTS[code]


def hop1_bwd_resources(G: int, Lq: int, Lk: int, D: int, h: int,
                       bf16: bool = False) -> dict:
    """What the K2 kernels chosen at these widths take on the current CUDA
    device: the variant and, for its first pass (`pass1`) and its dW pass
    (`dw`), dynamic shared memory, registers and local memory (spills,
    stack) a thread and resident blocks per SM."""
    info = (ctypes.c_int * 9)()
    rc = _bwd_lib().bist_hop1_bwd_resources(G, Lq, Lk, D, h, int(bf16), info)
    if rc != 0:
        raise RuntimeError(f"hop1_bwd_resources: CUDA error {rc} (Lq={Lq} Lk={Lk} "
                           f"D={D} h={h})")
    keys = ("smem_bytes", "registers", "local_bytes", "blocks_per_sm")
    return {"variant": HOP1_VARIANTS[info[0]],
            "pass1": dict(zip(keys, info[1:5])), "dw": dict(zip(keys, info[5:9]))}


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32,
           contiguous: bool = True, who: str = "hop1_fused") -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _check_grid(kv: torch.Tensor, h: int, who: str) -> None:
    """The checks K1 and K2 share: a CUDA grid of a dtype they take, heads
    that divide its width and its last axis contiguous (a strided view of
    any alignment is taken)."""
    if kv.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {kv.device}")
    D = kv.shape[-1]
    if not hop1_supports(D, h):
        raise ValueError(f"{who}: D must be a multiple of h; got D={D}, h={h}")
    if kv.dtype not in GRID_DTYPES:
        raise ValueError(f"{who}: kv must be float32 or bfloat16; got {kv.dtype}")
    if kv.stride(-1) != 1:
        raise ValueError(f"{who}: kv's last axis must be contiguous")


def _launch_failed(who: str, rc: int, kv: torch.Tensor, Lq: int, h: int):
    B, G, Lk, D = kv.shape
    return RuntimeError(f"{who}: kernel launch failed with CUDA error {rc} "
                        f"(B={B} G={G} Lq={Lq} Lk={Lk} D={D} h={h} kv {kv.dtype})")


def hop1_fused(x: torch.Tensor, q_proj: torch.Tensor, kv: torch.Tensor,
               attn_params, h: int, mask: Optional[torch.Tensor] = None,
               return_residuals: bool = False):
    """Fused hop 1 (same arguments and results as `hop1_plain`).

    On a CUDA tensor it launches the K1 kernel, or raises (for D not a
    multiple of h, other dtypes or shapes); on a CPU tensor it runs
    `hop1_plain`.  kv is float32 or bfloat16 and may be a strided view of
    any alignment (the t2s direction passes the grid with T and S swapped);
    x, q_proj, the weights and the mask must be float32 (mask int32), on
    kv's device, and contiguous.  The results are float32.

    Without residuals the call goes through the registered op
    `torch.ops.bist_tpu_torch.hop1_fwd` (`hop1_fwd_op`), so that eager runs,
    CUDA graph captures and `torch.export` programs all hold the same op;
    with them (the training forward, `hop1_trainable`) it launches directly.
    `hop1_fused.launches` counts the launches of K1 and
    `hop1_fused.variants` counts them by kernel (`hop1_variant`), a launch
    recorded into a CUDA graph's capture included; a graph's replay does not
    pass through the op, so its K1 kernels are counted from a profiler's
    trace by kernel name."""
    if not return_residuals:
        w = [attn_params[n][p] for n in ("wk", "wv", "wo") for p in ("w", "b")]
        return hop1_fwd_op(x, q_proj, kv, *w, mask, h)
    if kv.device.type == "cpu":
        return hop1_plain(x, q_proj, kv, attn_params, h, mask, return_residuals)
    return _hop1_launch(_fwd_lib().bist_hop1_fwd, None, x, q_proj, kv, attn_params, h,
                        mask, return_residuals)


def _attn_params(wk, bk, wv, bv, wo, bo):
    return {"wk": {"w": wk, "b": bk}, "wv": {"w": wv, "b": bv}, "wo": {"w": wo, "b": bo}}


@torch.library.custom_op("bist_tpu_torch::hop1_fwd", mutates_args=(), device_types="cuda")
def hop1_fwd_op(x: torch.Tensor, q_proj: torch.Tensor, kv: torch.Tensor,
                wk: torch.Tensor, bk: torch.Tensor, wv: torch.Tensor, bv: torch.Tensor,
                wo: torch.Tensor, bo: torch.Tensor, mask: Optional[torch.Tensor],
                h: int) -> torch.Tensor:
    """K1 as a registered op, the inference forward of `hop1_fused` with the
    attention weights flat.  Its CUDA implementation is the launch (the
    variant choice and every check run there, at call time); its CPU
    implementation is `hop1_plain`; its fake gives (B, G, Lq, D) in x's
    dtype and touches no library, so tracing builds no kernel."""
    return _hop1_launch(_fwd_lib().bist_hop1_fwd, None, x, q_proj, kv,
                        _attn_params(wk, bk, wv, bv, wo, bo), h, mask, False)


@hop1_fwd_op.register_kernel("cpu")
def _hop1_fwd_cpu(x, q_proj, kv, wk, bk, wv, bv, wo, bo, mask, h):
    return hop1_plain(x, q_proj, kv, _attn_params(wk, bk, wv, bv, wo, bo), h, mask)


@hop1_fwd_op.register_fake
def _hop1_fwd_fake(x, q_proj, kv, wk, bk, wv, bv, wo, bo, mask, h):
    B, G, _, D = kv.shape
    return x.new_empty((B, G, x.shape[1], D))


def _hop1_fused_as(variant: str, x, q_proj, kv, attn_params, h, mask=None,
                   return_residuals=False, lib: Optional[ctypes.CDLL] = None):
    """`hop1_fused` on a CUDA tensor through the named kernel ("tiled" or
    "whole"), for measurements that hold the two against each other, from
    `lib` (a library built from csrc/hop1_fwd.cu and bound by `bind_fwd`;
    default the port's own).  Raises where that kernel does not take the
    widths."""
    code = {n: c for c, n in HOP1_VARIANTS.items()}[variant]
    launch = (lib or _fwd_lib()).bist_hop1_fwd_as
    return _hop1_launch(lambda *a: launch(code, *a), variant, x, q_proj, kv, attn_params,
                        h, mask, return_residuals)


def _hop1_launch(launch, variant: Optional[str], x, q_proj, kv, attn_params, h, mask,
                 return_residuals):
    """Check K1's inputs, put q and the weights into the padded head layout,
    allocate the results and launch the kernel by `launch` (the C entry's
    arguments after any variant code); counts the launch under `variant` (by
    default the launcher's choice, `hop1_variant`)."""
    _check_grid(kv, h, "hop1_fused")
    dev = kv.device
    B, G, Lk, D = kv.shape
    Lq = x.shape[1]
    _check("x", x, (B, Lq, D), dev)
    _check("q_proj", q_proj, (B, Lq, D), dev)
    w = [attn_params[n][p] for n in ("wk", "wv", "wo") for p in ("w", "b")]
    for n, t in zip(("wk", "bk", "wv", "bv", "wo", "bo"), w):
        _check(n, t, (D, D) if n[0] == "w" else (D,), dev)
    if mask is not None:
        _check("mask", mask, (B, 1, Lk), dev, dtype=torch.int32)
    if (D // h) % 4 or D % 4:
        # the padded head layout (csrc/hop1_tiles.cuh): q, Wk, bk, Wv, bv by
        # their columns, Wo by its rows (and its columns to a multiple of 4)
        q_proj = _pad_heads(q_proj, h)
        w = [_pad_heads(t, h) for t in w[:4]] + [_pad_cols4(_pad_heads(w[4], h, dim=0)), w[5]]
    args = [_aligned(t) for t in [x, q_proj] + w]
    Dp = q_proj.shape[-1]
    variant = variant or hop1_variant(Lq, Lk, D, h, _rows_vec4(kv))
    out = torch.empty((B, G, Lq, D), device=dev, dtype=torch.float32)
    concat = lse = None
    if return_residuals:
        concat = torch.empty((B, G, Lq, Dp), device=dev, dtype=torch.float32)
        lse = torch.empty((B, G, Lq, h), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            args[0].data_ptr(), args[1].data_ptr(), kv.data_ptr(),
            int(kv.dtype == torch.bfloat16),
            kv.stride(0), kv.stride(1), kv.stride(2),
            None if mask is None else mask.data_ptr(),
            *[t.data_ptr() for t in args[2:]], out.data_ptr(),
            None if concat is None else concat.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, G, Lq, Lk, D, h, 1.0 / math.sqrt(D // h), stream)
    if rc != 0:
        raise _launch_failed("hop1_fused", rc, kv, Lq, h)
    hop1_fused.launches += 1
    hop1_fused.variants[variant] = hop1_fused.variants.get(variant, 0) + 1
    return (out, _unpad_heads(concat, h, D), lse) if return_residuals else out


hop1_fused.launches = 0
hop1_fused.variants = {}


def hop1_bwd(q_proj: torch.Tensor, kv: torch.Tensor, mask: Optional[torch.Tensor],
             d_concat: torch.Tensor, dh: torch.Tensor, lse: torch.Tensor,
             wk: torch.Tensor, bk: torch.Tensor, wv: torch.Tensor, bv: torch.Tensor,
             h: int):
    """Hop-1 backward (same arguments and results as `hop1_bwd_plain`).

    On a CUDA tensor it launches the K2 kernel (its passes), or raises as
    `hop1_fused` does; on a CPU tensor it runs `hop1_bwd_plain`.  kv is
    float32 or bfloat16 and may be a strided view of any alignment; every
    other tensor must be contiguous float32 (mask int32) on kv's device.
    dkv comes back contiguous in kv's dtype.  `hop1_bwd.launches` counts
    kernel launches and `hop1_bwd.variants` counts them by kernel
    (`hop1_bwd_variant`)."""
    if kv.device.type == "cpu":
        return hop1_bwd_plain(q_proj, kv, mask, d_concat, dh, lse, wk, bk, wv, bv, h)
    lib = _bwd_lib()
    return _hop1_bwd_launch(lib.bist_hop1_bwd, None, lib, q_proj, kv, mask, d_concat, dh,
                            lse, wk, bk, wv, bv, h)


def _hop1_bwd_as(variant: str, q_proj, kv, mask, d_concat, dh, lse, wk, bk, wv, bv, h,
                 lib: Optional[ctypes.CDLL] = None):
    """`hop1_bwd` on a CUDA tensor through the named kernel ("tiled" or
    "whole"), for measurements that hold the two against each other, from
    `lib` (a library built from csrc/hop1_bwd.cu and bound by `bind_bwd`;
    default the port's own).  Raises where that kernel does not take the
    widths."""
    code = {n: c for c, n in HOP1_VARIANTS.items()}[variant]
    lib = lib or _bwd_lib()
    return _hop1_bwd_launch(lambda *a: lib.bist_hop1_bwd_as(code, *a), variant, lib,
                            q_proj, kv, mask, d_concat, dh, lse, wk, bk, wv, bv, h)


def _hop1_bwd_launch(launch, variant: Optional[str], lib: ctypes.CDLL, q_proj, kv, mask,
                     d_concat, dh, lse, wk, bk, wv, bv, h):
    """Check K2's inputs, put them into the padded head layout, allocate the
    results and the workspace and launch the passes by `launch` (the C
    entry's arguments after any variant code); counts the launch under
    `variant` (by default the launcher's choice, `hop1_bwd_variant`); `lib`
    sizes the workspace."""
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
    args = (q_proj, d_concat, wk, bk, wv, bv)
    if (D // h) % 4:
        args = [_pad_heads(t, h) for t in args]      # the padded head layout
    q_p, dcc_p, wk_p, bk_p, wv_p, bv_p = (_aligned(t) for t in args)
    Dp = q_p.shape[-1]
    wkv_t = _pad_cols4(torch.cat([wk_p.t(), wv_p.t()])).contiguous()   # (2Dp, Do)
    variant = variant or hop1_bwd_variant(Lq, Lk, D, h, _rows_vec4(kv))
    dkv = torch.empty((B, G, Lk, D), device=dev, dtype=kv.dtype)
    dq = torch.empty((B, Lq, Dp), device=dev, dtype=torch.float32)
    wgrad = torch.empty(2 * D * Dp + 2 * Dp, device=dev, dtype=torch.float32)
    ws = torch.empty(lib.bist_hop1_bwd_workspace(B, G, Lq, Lk, D, h), device=dev,
                     dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            q_p.data_ptr(), kv.data_ptr(), int(kv.dtype == torch.bfloat16),
            kv.stride(0), kv.stride(1), kv.stride(2),
            None if mask is None else mask.data_ptr(),
            dcc_p.data_ptr(), dh.data_ptr(), lse.data_ptr(),
            wk_p.data_ptr(), bk_p.data_ptr(), wv_p.data_ptr(), bv_p.data_ptr(),
            wkv_t.data_ptr(), dkv.data_ptr(), dq.data_ptr(), wgrad.data_ptr(),
            ws.data_ptr(), B, G, Lq, Lk, D, h, 1.0 / math.sqrt(D // h), stream)
    if rc != 0:
        raise _launch_failed(who, rc, kv, Lq, h)
    hop1_bwd.launches += 1
    hop1_bwd.variants[variant] = hop1_bwd.variants.get(variant, 0) + 1
    dwk, dwv = (_unpad_heads(a, h, D) for a in wgrad[:2 * D * Dp].view(2, D, Dp))
    dbk, dbv = (_unpad_heads(a, h, D) for a in wgrad[2 * D * Dp:].view(2, Dp))
    return _unpad_heads(dq, h, D), dkv, dwk, dwv, dbk, dbv


hop1_bwd.launches = 0
hop1_bwd.variants = {}


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
