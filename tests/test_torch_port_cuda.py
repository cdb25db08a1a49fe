"""The port's CUDA kernels on the card, against their plain PyTorch versions
(float32 arithmetic, TF32 off, 2e-4; a bfloat16 output within its rounding).  Marked `cuda`: each test skips without a CUDA
device.  This file imports neither JAX nor the repository's conftest, so on
a machine with a card and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from bist_tpu_torch.config import ModelConfig
from bist_tpu_torch.data.batching import Batch, to_device
from bist_tpu_torch.models.layers import mha, mha_init
from bist_tpu_torch.models.model import init_model, precompute_decode_ctx
from bist_tpu_torch.ops import bist_kernels as K1
from bist_tpu_torch.ops import dispatch
from bist_tpu_torch.ops import flash_attention as K3

TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def tensor(rng, shape, dev):
    return torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)


def prefix_mask(rng, rows, L, dev):
    lengths = rng.integers(1, L + 1, size=rows)
    m = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    m[0] = 0                                        # a fully masked row
    return torch.tensor(m, device=dev)


def close(got, want, what, rtol=TOL):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert torch.allclose(got, want, rtol=rtol, atol=TOL), f"{what}: {err:.3e}"


BF16_RTOL = 4e-3      # a bfloat16 result: one rounding of a float32 value
BF16_ULP = 8e-3       # two float32 values a hair apart may round one bfloat16
                      # step apart (2^-7 relative)


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,Lq,Lk,D,h", [
    (2, 4, 5, 7, 32, 2), (2, 3, 33, 130, 128, 8), (2, 2, 8, 75, 512, 8),
    (3, 16, 32, 40, 128, 8),
])
def test_hop1_kernel_matches_plain(cuda, B, G, Lq, Lk, D, h):
    rng = np.random.default_rng(0)
    p = {n: {k: t.to(cuda) for k, t in w.items()}
         for n, w in mha_init(torch.Generator().manual_seed(0), h, D).items()}
    x, q = tensor(rng, (B, Lq, D), cuda), tensor(rng, (B, Lq, D), cuda)
    kv = tensor(rng, (B, Lk, G, D), cuda).transpose(1, 2)    # strided, as t2s
    mask = prefix_mask(rng, B, Lk, cuda)[:, None, :].contiguous()
    before = K1.hop1_fused.launches
    for m in (mask, None):
        close(K1.hop1_fused(x, q, kv, p, h, m), K1.hop1_plain(x, q, kv, p, h, m),
              f"hop1 {B, G, Lq, Lk, D, h} mask={m is not None}")
    # a bfloat16 model's grid: both sides compute in float32 from its values
    kv16 = kv.to(torch.bfloat16)
    got = K1.hop1_fused(x, q, kv16, p, h, mask)
    assert got.dtype == torch.float32
    close(got, K1.hop1_plain(x, q, kv16, p, h, mask), f"hop1 {B, G, Lq, Lk, D, h} bf16")
    assert K1.hop1_fused.launches == before + 3
    with pytest.raises(ValueError, match="float32"):
        K1.hop1_fused(x.double(), q, kv, p, h, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,B,G,Lq,Lk,D,h,strided,bf16", [
    ("whole", 4, 16, 32, 40, 128, 8, True, False),     # flagship t2s
    ("whole", 4, 40, 32, 16, 128, 8, False, False),    # flagship s2t
    ("whole", 3, 16, 5, 37, 128, 8, True, False),      # rows that fill no MMA tile
    ("whole", 3, 7, 12, 1, 128, 8, False, False),      # odd G: a block with one group
    ("whole", 4, 16, 32, 40, 64, 4, True, False),
    ("whole", 4, 16, 32, 40, 128, 8, True, True),      # a bfloat16 grid
    ("whole", 2, 5, 20, 64, 128, 8, True, False),      # Lk 64: one query tile a warp
    ("whole", 2, 7, 32, 16, 128, 4, False, False),     # heads 32 wide, odd G
    ("whole", 2, 5, 33, 23, 64, 2, True, False),       # two weight chunks, heads 32 wide
    ("tiled", 2, 5, 33, 23, 96, 4, True, False),       # widths "whole" is not built for
    ("tiled", 2, 9, 17, 9, 32, 4, False, True),
    ("tiled", 2, 16, 32, 40, 256, 8, True, False),
    ("tiled", 2, 16, 32, 40, 512, 8, True, False),
])
def test_hop1_variants_match_plain(cuda, variant, B, G, Lq, Lk, D, h, strided, bf16):
    """K1's two kernels at the main path's widths and around them, in the
    evaluation and the training (residual) mode, a fully masked batch row
    included: each case runs the kernel the launcher chooses for it."""
    rng = np.random.default_rng(7)
    p = {n: {k: t.to(cuda) for k, t in w.items()}
         for n, w in mha_init(torch.Generator().manual_seed(2), h, D).items()}
    x, q = tensor(rng, (B, Lq, D), cuda), tensor(rng, (B, Lq, D), cuda)
    kv = (tensor(rng, (B, Lk, G, D), cuda).transpose(1, 2) if strided
          else tensor(rng, (B, G, Lk, D), cuda))
    if bf16:
        kv = kv.to(torch.bfloat16)
    mask = prefix_mask(rng, B, Lk, cuda)[:, None, :].contiguous()
    assert K1.hop1_variant(Lq, Lk, D, h) == variant
    before = dict(K1.hop1_fused.variants)
    for res in (False, True):
        got = K1.hop1_fused(x, q, kv, p, h, mask, return_residuals=res)
        want = K1.hop1_plain(x, q, kv, p, h, mask, return_residuals=res)
        for a, b, n in zip(got if res else [got], want if res else [want],
                           ("out", "concat", "lse")):
            close(a, b, f"hop1 {variant} {B, G, Lq, Lk, D, h} {n}")
    assert K1.hop1_fused.variants[variant] == before.get(variant, 0) + 2
    assert sum(K1.hop1_fused.variants.values()) == sum(before.values()) + 2


@pytest.mark.cuda
def test_hop1_forced_variants_agree(cuda):
    """The measurement path (`_hop1_fused_as`): "tiled" takes the flagship
    widths too and agrees with "whole"; "whole" refuses widths it does not
    take; both count their launches by kernel."""
    rng = np.random.default_rng(8)
    p = {n: {k: t.to(cuda) for k, t in w.items()}
         for n, w in mha_init(torch.Generator().manual_seed(3), 8, 128).items()}
    x, q = tensor(rng, (2, 32, 128), cuda), tensor(rng, (2, 32, 128), cuda)
    kv = tensor(rng, (2, 16, 40, 128), cuda)
    before = dict(K1.hop1_fused.variants)
    close(K1._hop1_fused_as("tiled", x, q, kv, p, 8),
          K1._hop1_fused_as("whole", x, q, kv, p, 8), "tiled vs whole")
    for v in ("tiled", "whole"):
        assert K1.hop1_fused.variants[v] == before.get(v, 0) + 1
    wide = tensor(rng, (2, 4, 70, 128), cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        K1._hop1_fused_as("whole", x, q, wide, p, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("G,Lq,Lk,d", [
    (4, 16, 300, 64), (3, 1, 40, 16), (2, 40, 70, 128), (2, 5, 65, 32),
    (3, 7, 90, 8), (2, 9, 70, 6), (2, 33, 100, 96), (2, 4, 1000, 256),
    (2, 5, 300, 264), (3, 33, 2000, 320), (2, 3, 70, 600),   # the column split
    # a partial 16-row query tile (17, 65), a partial kv tile (1001), head
    # dims 8, 72 and 1024 (16 warps a query tile), kv 32768 at d 320
    (2, 17, 1001, 72), (2, 65, 300, 8), (1, 5, 50, 1024), (1, 17, 32768, 320),
    # column blocks: two of 520 columns (one with a kv split), three with a
    # narrower last one
    (2, 5, 300, 1032), (1, 17, 4096, 1032), (1, 3, 70, 2100),
])
def test_flash_kernel_matches_plain(cuda, G, Lq, Lk, d):
    """K3 agrees with `attention_plain` (with a fully masked row, without a
    mask, and on a bfloat16 grid within its rounding) in the mode its plan
    gives the head dim (`flash_resources`): kv split up to 128, column
    split above, column blocks above 1024."""
    rng = np.random.default_rng(1)
    q, k, v = (tensor(rng, s, cuda) for s in ((G, Lq, d), (G, Lk, d), (G, Lk, d)))
    mask = prefix_mask(rng, G, Lk, cuda)
    info = K3.flash_resources(G, Lq, Lk, d)
    assert info["mode"] == ("kv split" if d <= 128 else "column split"), info
    assert (info["column_blocks"] > 1) == (d > 1024), info
    before = K3.flash_attention.launches
    for m in (mask, None):
        close(K3.flash_attention(q, k, v, m), K3.attention_plain(q, k, v, m),
              f"flash {G, Lq, Lk, d} mask={m is not None}")
    q16, k16, v16 = (a.to(torch.bfloat16) for a in (q, k, v))
    got = K3.flash_attention(q16, k16, v16, mask)
    assert got.dtype == torch.bfloat16
    close(got, K3.attention_plain(q16.float(), k16.float(), v16.float(), mask),
          f"flash {G, Lq, Lk, d} bf16", rtol=BF16_RTOL)
    assert K3.flash_attention.launches == before + 3


@pytest.mark.cuda
def test_flash_kv_split_alignment_and_column_blocks(cuda):
    """K3 with and without a kv split (the launcher's plan,
    `flash_resources`), on grids whose rows are not 16-byte vectors or
    start off 16 bytes (narrower cp.async, or element loads for a bfloat16
    grid of odd rows), and above head dim 1024 (column blocks) at mha's
    query count."""
    rng = np.random.default_rng(9)
    for G, Lq, Lk, d, splits in ((2, 32, 4096, 64, True), (512, 32, 128, 64, False),
                                 (4, 32, 2000, 1032, True)):
        info = K3.flash_resources(G, Lq, Lk, d)
        assert (info["splits"] > 1) == splits, info
        q, k, v = (tensor(rng, s, cuda) for s in ((G, Lq, d), (G, Lk, d), (G, Lk, d)))
        mask = prefix_mask(rng, G, Lk, cuda)
        close(K3.flash_attention(q, k, v, mask), K3.attention_plain(q, k, v, mask),
              f"flash G={G} Lk={Lk} d={d} splits={info['splits']}")
    for d, dtype in ((6, torch.float32), (72, torch.float32), (7, torch.bfloat16),
                     (72, torch.bfloat16), (1030, torch.float32), (1033, torch.bfloat16)):
        G, Lq, Lk = 2, 17, 300
        raw = tensor(rng, (2 * G * Lk * d + 1,), cuda).to(dtype)
        k, v = raw[1:G * Lk * d + 1].view(G, Lk, d), raw[G * Lk * d + 1:].view(G, Lk, d)
        q = tensor(rng, (G, Lq, d), cuda).to(dtype)
        mask = prefix_mask(rng, G, Lk, cuda)
        want = K3.attention_plain(q.float(), k.float(), v.float(), mask)
        close(K3.flash_attention(q, k, v, mask), want, f"flash d={d} {dtype} offset",
              rtol=BF16_RTOL if dtype == torch.bfloat16 else TOL)


@pytest.mark.cuda
def test_mha_flash_branch_and_model_context(cuda, monkeypatch):
    """mha's flash branch and a small model's decode context, kernels on vs
    forced off."""
    rng = np.random.default_rng(2)
    p = {n: {k: t.to(cuda) for k, t in w.items()}
         for n, w in mha_init(torch.Generator().manual_seed(1), 4, 64).items()}
    x, mem = tensor(rng, (2, 6, 64), cuda), tensor(rng, (2, 50, 64), cuda)
    mask = prefix_mask(rng, 2, 50, cuda)[:, None, :]
    monkeypatch.setattr(dispatch, "FLASH_MIN_KV", 0)
    before = K3.flash_attention.launches
    with torch.no_grad():
        out = mha(p, 4, x, mem, mem, mask, drop_rate=0.0)
        with dispatch.force_plain():
            ref = mha(p, 4, x, mem, mem, mask, drop_rate=0.0)
    assert K3.flash_attention.launches == before + 1
    close(out, ref, "mha flash branch")
    monkeypatch.undo()

    cfg = ModelConfig(vocab_size=40, nb_blocks=2, nb_venc_blocks=2,
                      nb_cenc_blocks=2, d_model=32, att_h=4, ft_sizes=(24,),
                      include_caption="summary", separate_caption=True)
    params = init_model(0, cfg, device=cuda)
    toks = rng.integers(4, 40, size=(3, 7)).astype(np.int32)
    fts = rng.standard_normal((3, 5, 4, 24)).astype(np.float32)
    fts[0, 2:] = 0.0
    batch = to_device(Batch(query=toks, his=toks, trg=toks[:, :1], trg_y=toks[:, :1],
                            cap=toks, fts=fts), cuda)
    before = K1.hop1_fused.launches
    with torch.no_grad():
        ctx = precompute_decode_ctx(params, cfg, batch)
        with dispatch.force_plain():
            ctx_plain = precompute_decode_ctx(params, cfg, batch)
    assert K1.hop1_fused.launches == before + 4          # 2 layers x t2s, s2t
    for kv, kv_plain in zip(ctx.layer_kv, ctx_plain.layer_kv):
        for name in kv:
            for a, b in zip(kv[name], kv_plain[name]):
                close(a, b, f"decode context {name}")


WIDE_HOP1 = [(12, 3), (30, 3), (120, 8), (520, 8), (1024, 8)]


@pytest.mark.cuda
def test_bf16_model_and_wide_hop1_launch_or_raise(cuda, monkeypatch):
    """On the card a call that meets the dispatch rule launches its kernel;
    it never runs the plain version: a bfloat16 model's hop 1 and long-kv
    mha launch K1 and K3; hop 1 (K1, K1 with residuals, K2) at widths
    "whole" does not take (D not a multiple of 8, d_k not one of 4, D above
    512, a misaligned grid), float32 and bfloat16 grids with a fully masked
    row, and K3 at head dim 320, launch and agree with the plain versions
    within 2e-4 + 2e-4·|plain| (a bfloat16 dkv within one rounding)."""
    plain_fwd, plain_bwd, plain_attn = K1.hop1_plain, K1.hop1_bwd_plain, K3.attention_plain

    def plain_called(*a, **kw):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(K1, "hop1_plain", plain_called)
    monkeypatch.setattr(K1, "hop1_bwd_plain", plain_called)
    monkeypatch.setattr(K3, "attention_plain", plain_called)
    monkeypatch.setattr(dispatch, "FLASH_MIN_KV", 0)
    rng = np.random.default_rng(3)
    cfg = ModelConfig(vocab_size=40, nb_blocks=2, nb_venc_blocks=2,
                      nb_cenc_blocks=2, d_model=32, att_h=4, ft_sizes=(24,),
                      include_caption="summary", separate_caption=True,
                      dtype="bfloat16")
    params = init_model(0, cfg, device=cuda)
    toks = rng.integers(4, 40, size=(3, 7)).astype(np.int32)
    fts = rng.standard_normal((3, 5, 4, 24)).astype(np.float32)
    batch = to_device(Batch(query=toks, his=toks, trg=toks[:, :1], trg_y=toks[:, :1],
                            cap=toks, fts=fts), cuda)
    hop1_before, flash_before = K1.hop1_fused.launches, K3.flash_attention.launches
    with torch.no_grad():
        ctx = precompute_decode_ctx(params, cfg, batch)
    torch.cuda.synchronize()
    assert K1.hop1_fused.launches == hop1_before + 4     # 2 layers x t2s, s2t
    assert K3.flash_attention.launches > flash_before    # d_k 8
    for kv in ctx.layer_kv:
        for k, v in kv.values():
            assert torch.isfinite(k).all() and torch.isfinite(v).all()

    from bist_tpu_torch.models import bist as torch_bist
    B, G, Lq, Lk = 2, 3, 5, 9
    for D, h in WIDE_HOP1 + [(128, 8)]:
        p = {n: {k: t.to(cuda) for k, t in w.items()}
             for n, w in mha_init(torch.Generator().manual_seed(0), h, D).items()}
        x, q = tensor(rng, (B, Lq, D), cuda), tensor(rng, (B, Lq, D), cuda)
        mask = prefix_mask(rng, B, Lk, cuda)[:, None, :].contiguous()
        raw = tensor(rng, (B * Lk * G * D + 1,), cuda)
        # a t2s-style strided view, its rows one element off the 16 bytes
        grid = raw[1:].view(B, Lk, G, D).transpose(1, 2)
        if D == 128:
            assert K1.hop1_variant(Lq, Lk, D, h, K1._rows_vec4(grid)) == "tiled"
        for kv in (grid, grid.to(torch.bfloat16)):
            what = f"D={D} h={h} {kv.dtype}"
            before = (K1.hop1_fused.launches, K1.hop1_bwd.launches)
            close(K1.hop1_fused(x, q, kv, p, h, mask), plain_fwd(x, q, kv, p, h, mask),
                  f"hop1 {what}")
            got = K1.hop1_fused(x, q, kv, p, h, mask, return_residuals=True)
            want = plain_fwd(x, q, kv, p, h, mask, return_residuals=True)
            for a, b, n in zip(got, want, ("out", "concat", "lse")):
                close(a, b, f"hop1 {n} {what}")
            dcc = (tensor(rng, (B, G, Lq, D), cuda) @ p["wo"]["w"].t()).contiguous()
            dh = (dcc * want[1]).reshape(B, G, Lq, h, D // h).sum(-1)
            args = (q, kv, mask, dcc, dh, want[2], p["wk"]["w"], p["wk"]["b"],
                    p["wv"]["w"], p["wv"]["b"], h)
            for a, b, n in zip(K1.hop1_bwd(*args), plain_bwd(*args),
                               ("dq", "dkv", "dWk", "dWv", "dbk", "dbv")):
                close(a, b, f"hop1_bwd {n} {what}",
                      rtol=BF16_ULP if n == "dkv" and kv.dtype == torch.bfloat16 else TOL)
            assert (K1.hop1_fused.launches, K1.hop1_bwd.launches) == \
                (before[0] + 2, before[1] + 1)
        hop = {"attn": p, "norm": {"scale": torch.ones(D, device=cuda),
                                   "bias": torch.zeros(D, device=cuda)}}
        with torch.no_grad():
            out = torch_bist._hop1(hop, h, 0.0, 0.0, None, x, grid, mask)
        assert out.shape == (B, G, Lq, D) and torch.isfinite(out).all()

    q, k, v = (tensor(rng, s, cuda) for s in ((4, 9, 320), (4, 300, 320), (4, 300, 320)))
    mask = prefix_mask(rng, 4, 300, cuda)
    before = K3.flash_attention.launches
    for m in (mask, None):
        close(K3.flash_attention(q, k, v, m), plain_attn(q, k, v, m),
              f"flash d=320 mask={m is not None}")
    assert K3.flash_attention.launches == before + 2


def bwd_inputs(rng, B, G, Lq, Lk, D, h, dev, full_row):
    """K2's inputs as hop1_trainable's glue makes them, from the plain
    forward's residuals; kv a strided (B, Lk, G, D) view, as t2s passes it."""
    p = {n: {k: t.to(dev) for k, t in w.items()}
         for n, w in mha_init(torch.Generator().manual_seed(4), h, D).items()}
    x, q = tensor(rng, (B, Lq, D), dev), tensor(rng, (B, Lq, D), dev)
    kv = tensor(rng, (B, Lk, G, D), dev).transpose(1, 2)
    mask = prefix_mask(rng, B, Lk, dev)
    if not full_row:
        mask[0, 0] = 1
    mask = mask[:, None, :].contiguous()
    _, concat, lse = K1.hop1_plain(x, q, kv, p, h, mask, return_residuals=True)
    dcc = (tensor(rng, (B, G, Lq, D), dev) @ p["wo"]["w"].t()).contiguous()
    dh = (dcc * concat).reshape(B, G, Lq, h, D // h).sum(-1)
    return p, x, q, kv, mask, dcc, dh, lse


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,Lq,Lk,D,h,full_row", [
    (2, 4, 5, 7, 32, 2, True), (2, 3, 33, 130, 128, 8, False),
    (2, 2, 8, 75, 512, 8, True), (4, 16, 32, 40, 128, 8, False),
])
def test_hop1_residuals_and_backward_match_plain(cuda, B, G, Lq, Lk, D, h, full_row):
    """K1's residuals and K2's six gradients against their plain versions:
    float32 and a bfloat16 grid, kv a strided view, a fully masked row."""
    rng = np.random.default_rng(5)
    p, x, q, kv, mask, dcc, dh, lse = bwd_inputs(rng, B, G, Lq, Lk, D, h, cuda,
                                                 full_row)
    for grid in (kv, kv.to(torch.bfloat16)):
        for a, b, n in zip(K1.hop1_fused(x, q, grid, p, h, mask, return_residuals=True),
                           K1.hop1_plain(x, q, grid, p, h, mask, return_residuals=True),
                           ("out", "concat", "lse")):
            close(a, b, f"hop1 {n} {grid.dtype}")
        args = (q, grid, mask, dcc, dh, lse, p["wk"]["w"], p["wk"]["b"],
                p["wv"]["w"], p["wv"]["b"], h)
        before = K1.hop1_bwd.launches
        got = K1.hop1_bwd(*args)
        assert K1.hop1_bwd.launches == before + 1
        assert got[1].dtype == grid.dtype and got[1].shape == (B, G, Lk, D)
        for a, b, n in zip(got, K1.hop1_bwd_plain(*args),
                           ("dq", "dkv", "dWk", "dWv", "dbk", "dbv")):
            close(a, b, f"hop1_bwd {n} {grid.dtype}",
                  rtol=BF16_ULP if n == "dkv" and grid.dtype == torch.bfloat16 else TOL)
    with pytest.raises(ValueError, match="contiguous"):
        K1.hop1_bwd(q, kv, mask, dcc, dh.transpose(2, 3).contiguous().transpose(2, 3),
                    lse, p["wk"]["w"], p["wk"]["b"], p["wv"]["w"], p["wv"]["b"], h)


def bwd_grads_agree(got, want, kv, what):
    for a, b, n in zip(got, want, ("dq", "dkv", "dWk", "dWv", "dbk", "dbv")):
        close(a, b, f"{what} {n}",
              rtol=BF16_ULP if n == "dkv" and kv.dtype == torch.bfloat16 else TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,B,G,Lq,Lk,D,h,strided,bf16", [
    ("whole", 4, 16, 32, 40, 128, 8, True, False),     # flagship t2s (a strided view)
    ("whole", 4, 40, 32, 16, 128, 8, False, False),    # flagship s2t (two groups a block)
    ("whole", 4, 16, 32, 40, 128, 8, True, True),      # a bfloat16 grid
    ("whole", 4, 40, 32, 16, 128, 8, False, True),
    ("whole", 3, 16, 5, 37, 128, 8, True, False),      # rows that fill no MMA tile
    ("whole", 3, 7, 37, 1, 128, 8, False, False),      # two query chunks, odd G
    ("whole", 4, 16, 32, 40, 64, 4, True, False),
    ("whole", 2, 5, 20, 64, 128, 4, True, False),      # Lk 64, heads 32 wide
    ("tiled", 2, 5, 33, 23, 96, 4, True, False),       # widths "whole" does not take
    ("tiled", 2, 9, 17, 9, 32, 4, False, True),
    ("tiled", 2, 16, 32, 40, 120, 8, True, False),
])
def test_hop1_bwd_variants_match_plain(cuda, variant, B, G, Lq, Lk, D, h, strided, bf16):
    """K2's two kernels at the training step's widths and around them, batch
    row 0 fully masked: each case runs the kernel the launcher chooses for
    it and agrees with `hop1_bwd_plain` on all six gradients."""
    rng = np.random.default_rng(9)
    p = {n: {k: t.to(cuda) for k, t in w.items()}
         for n, w in mha_init(torch.Generator().manual_seed(6), h, D).items()}
    x, q = tensor(rng, (B, Lq, D), cuda), tensor(rng, (B, Lq, D), cuda)
    kv = (tensor(rng, (B, Lk, G, D), cuda).transpose(1, 2) if strided
          else tensor(rng, (B, G, Lk, D), cuda))
    if bf16:
        kv = kv.to(torch.bfloat16)
    mask = prefix_mask(rng, B, Lk, cuda)[:, None, :].contiguous()
    _, concat, lse = K1.hop1_plain(x, q, kv, p, h, mask, return_residuals=True)
    dcc = (tensor(rng, (B, G, Lq, D), cuda) @ p["wo"]["w"].t()).contiguous()
    dh = (dcc * concat).reshape(B, G, Lq, h, D // h).sum(-1)
    args = (q, kv, mask, dcc, dh, lse, p["wk"]["w"], p["wk"]["b"], p["wv"]["w"],
            p["wv"]["b"], h)
    assert K1.hop1_bwd_variant(Lq, Lk, D, h) == variant
    before = dict(K1.hop1_bwd.variants)
    got = K1.hop1_bwd(*args)
    assert got[1].dtype == kv.dtype and got[1].shape == (B, G, Lk, D)
    bwd_grads_agree(got, K1.hop1_bwd_plain(*args), kv, f"hop1_bwd {variant} {B, G, Lq, Lk, D, h}")
    assert K1.hop1_bwd.variants[variant] == before.get(variant, 0) + 1
    assert sum(K1.hop1_bwd.variants.values()) == sum(before.values()) + 1


@pytest.mark.cuda
def test_hop1_bwd_forced_variants_agree(cuda):
    """The measurement path (`_hop1_bwd_as`): "tiled" takes the flagship
    widths too and agrees with "whole"; "whole" refuses widths it does not
    take (Lk 70, D 96, a misaligned grid); both count their launches by
    kernel."""
    rng = np.random.default_rng(10)
    B, G, Lq, Lk, D, h = 2, 16, 32, 40, 128, 8
    p, x, q, kv, mask, dcc, dh, lse = bwd_inputs(rng, B, G, Lq, Lk, D, h, cuda, True)
    args = (q, kv, mask, dcc, dh, lse, p["wk"]["w"], p["wk"]["b"], p["wv"]["w"],
            p["wv"]["b"], h)
    before = dict(K1.hop1_bwd.variants)
    bwd_grads_agree(K1._hop1_bwd_as("tiled", *args), K1._hop1_bwd_as("whole", *args), kv,
                    "tiled vs whole")
    for v in ("tiled", "whole"):
        assert K1.hop1_bwd.variants[v] == before.get(v, 0) + 1
    for B_, G_, Lq_, Lk_, D_, h_ in ((2, 4, 8, 70, 128, 8), (2, 4, 8, 16, 96, 4)):
        p, x, q, kv, mask, dcc, dh, lse = bwd_inputs(rng, B_, G_, Lq_, Lk_, D_, h_, cuda, True)
        with pytest.raises(RuntimeError, match="launch failed"):
            K1._hop1_bwd_as("whole", q, kv, mask, dcc, dh, lse, p["wk"]["w"], p["wk"]["b"],
                            p["wv"]["w"], p["wv"]["b"], h_)
    p, x, q, kv, mask, dcc, dh, lse = bwd_inputs(rng, 2, 4, 8, 16, 128, 8, cuda, True)
    odd = torch.empty(kv.numel() + 1, device=cuda)[1:].view(kv.shape).copy_(kv)
    assert K1.hop1_bwd_variant(8, 16, 128, 8, K1._rows_vec4(odd)) == "tiled"
    with pytest.raises(RuntimeError, match="launch failed"):
        K1._hop1_bwd_as("whole", q, odd, mask, dcc, dh, lse, p["wk"]["w"], p["wk"]["b"],
                        p["wv"]["w"], p["wv"]["b"], 8)


@pytest.mark.cuda
def test_flagship_train_step_launches_k1_and_k2_only(cuda, monkeypatch):
    """A flagship-width train step without dropout: hop 1 of every video
    layer through K1 (with residuals) and K2, 6 launches each, K2 always on
    "whole", and never their plain versions; the loss falls on a repeated
    batch."""
    from bist_tpu_torch.config import TrainConfig
    from bist_tpu_torch.train.loop import create_train_state, make_train_step

    def plain_called(*a, **kw):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(K1, "hop1_plain", plain_called)
    monkeypatch.setattr(K1, "hop1_bwd_plain", plain_called)
    cfg = ModelConfig(vocab_size=200, nb_blocks=3, nb_venc_blocks=3, nb_cenc_blocks=3,
                      d_model=128, att_h=8, dropout=0.0, attn_dropout=0.0,
                      ft_sizes=(64,), include_caption="summary", separate_caption=True)
    rng = np.random.default_rng(6)
    toks = rng.integers(4, 200, size=(4, 9)).astype(np.int32)
    toks[:, -2:] = 1
    fts = rng.standard_normal((4, 12, 16, 64)).astype(np.float32)
    fts[0, 5:] = 0.0
    batch = to_device(Batch(query=toks, his=toks, trg=toks, trg_y=toks[:, ::-1].copy(),
                            cap=toks, fts=fts), cuda)
    tcfg = TrainConfig(warmup_steps=10)
    state, tx = create_train_state(0, cfg, tcfg, device=cuda)
    step = make_train_step(cfg, tcfg, tx)
    fwd, bwd = K1.hop1_fused.launches, K1.hop1_bwd.launches
    whole = K1.hop1_bwd.variants.get("whole", 0)
    losses = []
    for _ in range(3):
        state, m = step(state, batch, None)
        losses.append(float(m["loss"]))
    assert (K1.hop1_fused.launches - fwd, K1.hop1_bwd.launches - bwd) == (18, 18)
    assert K1.hop1_bwd.variants.get("whole", 0) - whole == 18     # every K2 on "whole"
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.cuda
def test_hop1_launches_on_the_calling_threads_stream(cuda):
    """K1's launcher takes the current stream of the thread that calls it (a
    serving batcher's thread): on a side stream, behind a long sleep and
    the copy of its input, K1 reads the copied input, not the stale one."""
    import threading

    rng = np.random.default_rng(7)
    B, G, Lq, Lk, D, h = 2, 16, 32, 40, 128, 8
    p = {n: {k: t.to(cuda) for k, t in w.items()}
         for n, w in mha_init(torch.Generator().manual_seed(7), h, D).items()}
    x, q = tensor(rng, (B, Lq, D), cuda), tensor(rng, (B, Lq, D), cuda)
    kv = tensor(rng, (B, Lk, G, D), cuda).transpose(1, 2)
    want = K1.hop1_plain(x, q, kv, p, h, None)
    torch.cuda.synchronize()
    got = {}

    def work():
        side = torch.cuda.Stream(cuda)
        with torch.cuda.stream(side):
            stale = torch.zeros_like(x)
            torch.cuda._sleep(100_000_000)          # keeps the side stream busy
            stale.copy_(x)
            got["out"] = K1.hop1_fused(stale, q, kv, p, h, None).cpu()

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    close(got["out"], want.cpu(), "hop1 on a side stream in another thread")


@pytest.mark.cuda
def test_precision_knobs_on_the_card(cuda, monkeypatch):
    """The decode precision knobs on the card: a bfloat16 precompute gives
    K1 bfloat16 grids (it launches, never its plain version), and beam
    search and greedy decoding with each float8 cache and a bfloat16 step
    give finite first-best scores and in-vocabulary tokens."""
    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.decode.beam import beam_search, greedy_decode

    def plain_called(*a, **kw):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(K1, "hop1_plain", plain_called)
    cfg = ModelConfig(vocab_size=60, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2,
                      d_model=128, att_h=8, dropout=0.0, ft_sizes=(48,),
                      include_caption="summary", separate_caption=True)
    params = init_model(0, cfg, device=cuda)
    rng = np.random.default_rng(8)
    toks = rng.integers(4, 60, size=(3, 9)).astype(np.int32)
    toks[:, -2:] = 1
    fts = rng.standard_normal((3, 10, 16, 48)).astype(np.float32)
    batch = to_device(Batch(query=toks, his=toks, trg=toks[:, :1], trg_y=toks[:, :1],
                            cap=toks, fts=fts), cuda)
    for cache in ("float8_e4m3fn", "float8_e5m2"):
        before, variants = K1.hop1_fused.launches, dict(K1.hop1_fused.variants)
        g = GenerateConfig(maxlen=6, beam=3, nbest=2, cache_dtype=cache,
                           compute_dtype="bfloat16", encode_dtype="bfloat16")
        res = beam_search(params, cfg, batch, g)
        out = greedy_decode(params, cfg, batch, 6, cache_dtype=cache, encode_dtype="bfloat16",
                            compute_dtype="bfloat16")
        torch.cuda.synchronize()
        assert K1.hop1_fused.launches == before + 8           # 2 decodes x 2 layers x 2
        assert K1.hop1_fused.variants.get("whole", 0) - variants.get("whole", 0) == 8
        assert torch.isfinite(res.scores[:, 0]).all() and (res.lengths[:, 0] >= 1).all()
        assert ((out >= 0) & (out < 60)).all() and ((res.tokens >= 0) & (res.tokens < 60)).all()


@pytest.mark.cuda
def test_served_batches_ship_from_pinned_memory(cuda):
    """On the card a Responder assembles the feature grid straight into
    pinned memory and hands every array to its program pinned and unchanged;
    two batches dispatched before either is finished answer as respond()
    does them one at a time."""
    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.serving import Responder
    from bist_tpu_torch.vocab import SPECIALS

    vocab = dict(SPECIALS)
    for i in range(60 - len(vocab)):
        vocab[f"w{i}"] = len(vocab)
    cfg = ModelConfig(vocab_size=len(vocab), nb_blocks=2, nb_venc_blocks=2,
                      nb_cenc_blocks=2, d_model=128, att_h=8, dropout=0.0, ft_sizes=(48,),
                      include_caption="summary", separate_caption=True)
    rsp = Responder(init_model(0, cfg, device=cuda), cfg, vocab,
                    GenerateConfig(maxlen=6, beam=3, nbest=2), max_batch=8,
                    time_buckets=(8, 16), feat_tail=(16, 48))
    rng = np.random.default_rng(9)
    words = list(vocab)[len(SPECIALS):]

    def text(n):
        return " ".join(rng.choice(words, size=n))

    def group(n):
        return [dict(question=text(5), history=text(9), caption=text(4),
                     features=rng.standard_normal((int(rng.integers(3, 16)), 16, 48))
                     .astype(np.float32)) for _ in range(n)]

    groups = [group(5), group(8)]
    host = rsp.make_batch([rsp.make_request(**f) for f in groups[0]])
    assert torch.from_numpy(host.fts).is_pinned()
    pinned = rsp._pinned(host)
    for h, d in zip(host, pinned):
        if h is not None:
            assert d.is_pinned() and np.array_equal(d.numpy(), h)
    direct = []
    for g in groups:
        reqs = [rsp.make_request(**f) for f in g]
        rsp.respond(reqs)
        direct.append([r._answer for r in reqs])
    served = [[rsp.make_request(**f) for f in g] for g in groups]
    pending = [rsp.dispatch(reqs) for reqs in served]
    for p in pending:
        rsp.finish(p)
    assert [[r._answer for r in reqs] for reqs in served] == direct


# ---------------------------------------------------------------------------
# compiled decoding: one CUDA graph per geometry (decode.compiled)


def small_model(cuda, seed=0):
    """A 60-word vocabulary and a model at the flagship's head width (d_model
    128, 8 heads: K1 "whole"), 2 blocks, 16 x 48 features."""
    from bist_tpu_torch.vocab import SPECIALS

    vocab = dict(SPECIALS)
    for i in range(60 - len(vocab)):
        vocab[f"w{i}"] = len(vocab)
    cfg = ModelConfig(vocab_size=len(vocab), nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2,
                      d_model=128, att_h=8, dropout=0.0, ft_sizes=(48,),
                      include_caption="summary", separate_caption=True)
    return vocab, cfg, init_model(seed, cfg, device=cuda)


def host_batch(rng, B=4, L=9, T=10):
    toks = rng.integers(4, 60, size=(B, L)).astype(np.int32)
    toks[:, -2:] = 1
    fts = rng.standard_normal((B, T, 16, 48)).astype(np.float32)
    fts[0, T // 2:] = 0.0
    return Batch(query=toks, his=toks[:, ::-1].copy(), trg=toks[:, :1], trg_y=toks[:, :1],
                 cap=toks[:, :6].copy(), fts=fts)


def same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_graph_replays_equal_eager(cuda, cache_dtype):
    """Beam search, greedy and sampling (same row seeds) replayed from one
    graph on two alternating batches of one geometry: each result identical
    to the eager function's on the same batch (a value frozen into the graph
    at capture would show on the second batch); one capture each, one eager
    warm-up each, nothing eager after."""
    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.decode.beam import beam_search, greedy_decode
    from bist_tpu_torch.decode.compiled import DecodeProgram
    from bist_tpu_torch.decode.sample import sample_decode

    _, cfg, params = small_model(cuda)
    rng = np.random.default_rng(3)
    batches = [host_batch(rng), host_batch(rng)]
    g = GenerateConfig(maxlen=6, beam=3, nbest=2, cache_dtype=cache_dtype,
                       temperature=0.8, top_k=20, top_p=0.9, sample_seed=5)
    seeds = [[1, 2, 3, 4], [5, 6, 7, 8]]
    eager = {
        "beam_search": lambda b, i: beam_search(params, cfg, b, g),
        "greedy": lambda b, i: greedy_decode(params, cfg, b, g.maxlen, cache_dtype=cache_dtype),
        "sample": lambda b, i: sample_decode(params, cfg, b, g.maxlen, g.sample_seed,
                                             temperature=g.temperature, top_k=g.top_k,
                                             top_p=g.top_p, cache_dtype=cache_dtype,
                                             row_seeds=seeds[i]),
    }
    for style, fn in eager.items():
        prog = DecodeProgram(params, cfg, GenerateConfig(**dict(vars(g), decode_style=style)))
        for i in (0, 1, 0, 1):
            kw = {"row_seeds": seeds[i]} if style == "sample" else {}
            got = prog(batches[i], **kw)
            torch.cuda.synchronize()
            assert same(got, fn(to_device(batches[i], cuda), i)), (style, i)
        stats = prog.stats()
        assert stats["captures"] == stats["eager_runs"] == stats["geometries"] == 1
        assert stats["pool_bytes"] > 0
    early = GenerateConfig(**dict(vars(g), early_exit=True, penalty=-1.0, maxlen=10))
    prog = DecodeProgram(params, cfg, early)
    for i in (0, 1, 0):
        got = prog(batches[i])
        assert same(got, beam_search(params, cfg, to_device(batches[i], cuda), early))


@pytest.mark.cuda
def test_k1_runs_inside_replays(cuda):
    """K1 is captured inside the graph: a replay launches nothing through the
    wrapper (its count means launches issued by the wrapper, captures
    included) while the profiler's trace shows K1's "whole" kernel 4 times
    a replay (2 layers, t2s and s2t)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.decode.compiled import DecodeProgram

    _, cfg, params = small_model(cuda)
    rng = np.random.default_rng(4)
    prog = DecodeProgram(params, cfg, GenerateConfig(maxlen=5, beam=3, nbest=2))
    batch = host_batch(rng)
    before = K1.hop1_fused.launches
    prog(batch)                          # warm-up (4 launches) and capture (4)
    torch.cuda.synchronize()
    assert K1.hop1_fused.launches == before + 8
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            prog(batch)
        torch.cuda.synchronize()
    assert K1.hop1_fused.launches == before + 8
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert sum("hop1_fwd_whole_kernel" in n for n in names) == 12, names[:40]
    assert not any("hop1_fwd_tiles_kernel" in n for n in names)


@pytest.mark.cuda
def test_k3_captured_through_mha(cuda, monkeypatch):
    """K3 inside a CUDA graph through `mha` at phase 4's shape (d_model 512, 8
    heads, 32 queries, 32768 keys, a key-padding mask): replays on two
    inputs copied into the static ones agree with eager calls within 2e-4."""
    rng = np.random.default_rng(6)
    B, Lq, Lk, D, h = 16, 32, 32768, 512, 8
    p = {n: {k: t.to(cuda) for k, t in w.items()}
         for n, w in mha_init(torch.Generator().manual_seed(6), h, D).items()}

    def inputs():
        lengths = rng.integers(Lk // 2, Lk + 1, size=B)
        mask = (np.arange(Lk)[None, None, :] < lengths[:, None, None]).astype(np.int32)
        return (tensor(rng, (B, Lq, D), cuda), tensor(rng, (B, Lk, D), cuda),
                torch.tensor(mask, device=cuda))

    static = inputs()
    run = lambda q, k, m: mha(p, h, q, k, k, m, drop_rate=0.0)
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(*static)                                 # warm-up
        torch.cuda.current_stream().wait_stream(side)
        before = K3.flash_attention.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = run(*static)
        assert K3.flash_attention.launches == before + 1
        for _ in range(2):
            new = inputs()
            for dst, src in zip(static, new):
                dst.copy_(src)
            graph.replay()
            torch.cuda.synchronize()
            close(out, run(*new), "mha through K3, replayed against eager")
    assert K3.flash_attention.launches == before + 3


@pytest.mark.cuda
def test_capture_in_the_batchers_thread_while_clients_post(cuda):
    """A geometry first seen at serve time is captured in the batcher's
    thread while client threads submit and another thread allocates pinned
    memory and queries events on its own stream (thread-local capture): no
    error, and every answer equal to the eager beam_search answer."""
    import threading

    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.decode.beam import beam_search, extract_hyps
    from bist_tpu_torch.serving import DynamicBatcher, Responder

    vocab, cfg, params = small_model(cuda)
    g = GenerateConfig(maxlen=6, beam=3, nbest=2)
    rsp = Responder(params, cfg, vocab, g, max_batch=8, batch_buckets=(8,),
                    len_buckets=(16,), time_buckets=(16,), feat_tail=(16, 48))
    rng = np.random.default_rng(10)
    words = [w for w in vocab if w.startswith("w")]
    fields = [dict(question=" ".join(rng.choice(words, 5)), history=" ".join(rng.choice(words, 9)),
                   caption=" ".join(rng.choice(words, 4)),
                   features=rng.standard_normal((int(rng.integers(3, 16)), 16, 48))
                   .astype(np.float32)) for _ in range(24)]
    batcher = DynamicBatcher(rsp, max_batch=8, max_wait_ms=20)
    batcher.start()
    stop, answers, errors = threading.Event(), {}, []

    def noise():
        s = torch.cuda.Stream()
        while not stop.is_set():
            with torch.cuda.stream(s):
                x = torch.empty(1 << 16, pin_memory=True)
                e = torch.cuda.Event()
                x.to(cuda, non_blocking=True)
                e.record(s)
                e.query()

    def client(c):
        for i in range(c, len(fields), 6):
            try:
                answers[i] = batcher.submit(**fields[i], timeout=300)
            except Exception as e:
                errors.append(repr(e))

    threads = [threading.Thread(target=noise)] + [
        threading.Thread(target=client, args=(c,)) for c in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads[1:]:
            t.join(timeout=300)
    finally:
        stop.set()
        threads[0].join(timeout=60)
        batcher.stop()
    assert not errors and len(answers) == len(fields)
    stats = rsp.program.stats()
    assert stats["captures"] >= 1 and stats["eager_runs"] == stats["captures"]
    for i, f in enumerate(fields):
        reqs = [rsp.make_request(**f)]
        res = beam_search(params, cfg, rsp.make_batch(reqs), g)
        hyps = extract_hyps(res, rsp.id2word, 0, g.nbest)
        assert answers[i] == (" ".join(hyps[0][0]) if hyps else ""), i


@pytest.mark.cuda
def test_decode_paths_do_not_sync_the_host(cuda):
    """No host sync in the eager decode functions on a device batch (a
    graph cannot hold one), nor in a replay's copy-in, replay and copy-out:
    each runs under torch.cuda.set_sync_debug_mode("error")."""
    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.decode.beam import beam_search, greedy_decode, oracle_decode
    from bist_tpu_torch.decode.compiled import DecodeProgram
    from bist_tpu_torch.decode.sample import sample_decode

    _, cfg, params = small_model(cuda)
    rng = np.random.default_rng(11)
    host = host_batch(rng)
    batch = to_device(host, cuda)
    g = GenerateConfig(maxlen=5, beam=3, nbest=2, cache_dtype="bfloat16")
    prog = DecodeProgram(params, cfg, g)
    pinned = Batch(*[None if x is None else torch.from_numpy(x).pin_memory() for x in host])
    prog(pinned)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        beam_search(params, cfg, batch, g)
        greedy_decode(params, cfg, batch, 5)
        oracle_decode(params, cfg, batch)
        sample_decode(params, cfg, batch, 5, 1, top_k=5, top_p=0.9, row_seeds=[1, 2, 3, 4])
        prog(pinned)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda, monkeypatch):
    """A decode that syncs the host cannot be captured: the program raises,
    naming the geometry, and runs nothing eagerly in its place; the card
    works on after it."""
    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.decode import beam
    from bist_tpu_torch.decode.compiled import DecodeProgram

    _, cfg, params = small_model(cuda)
    rng = np.random.default_rng(12)
    host = host_batch(rng)
    g = GenerateConfig(maxlen=4, beam=3, nbest=2)
    step = beam.decode_step

    def syncing_step(*a, **kw):
        logp, cache = step(*a, **kw)
        float(logp.sum())                               # a host sync
        return logp, cache

    monkeypatch.setattr(beam, "decode_step", syncing_step)
    prog = DecodeProgram(params, cfg, g)
    with pytest.raises(RuntimeError, match=r"capturing the beam_search decode at geometry "
                                           r"beam_search: query \(4, 9\) int32"):
        prog(host)
    assert prog.captures == 0 and prog.stats()["geometries"] == 0
    monkeypatch.undo()
    torch.cuda.synchronize()
    want = beam.beam_search(params, cfg, to_device(host, cuda), g)
    assert same(DecodeProgram(params, cfg, g)(host), want)


def train_batch(rng, B=4, L=9, T=10):
    """host_batch with answers of L tokens as targets."""
    b = host_batch(rng, B, L, T)
    return b._replace(trg=b.query.copy(), trg_y=b.query[:, ::-1].copy())


def train_setup(cuda, **kw):
    from bist_tpu_torch.config import TrainConfig
    from bist_tpu_torch.train.loop import create_train_state

    _, cfg, _ = small_model(cuda)
    cfg = cfg.replace(**dict(dict(attn_dropout=0.0), **kw))
    tcfg = TrainConfig(warmup_steps=10)
    state, tx = create_train_state(0, cfg, tcfg, device=cuda)
    return cfg, tcfg, state, tx


def copied(state):
    from bist_tpu_torch.train.loop import trainable

    opt = state.opt_state
    return state._replace(params=trainable(state.params),
                          opt_state={"count": opt["count"].clone(),
                                     "mu": [t.clone() for t in opt["mu"]],
                                     "nu": [t.clone() for t in opt["nu"]]})


def steps_agree(step_a, state_a, step_b, state_b, batches, dev, gen=None):
    """Both steps over the same batches, as given to step_a and on `dev` to
    step_b (the generator re-seeded from seed_for_step before each step):
    every metric within 5e-4 relative, the
    parameters within 5e-4 + 5e-3·|p| (the key biases, whose gradient is
    analytically zero, within 5e-4 + 2·Σlr)."""
    from bist_tpu_torch.train.loop import seed_for_step
    from bist_tpu_torch.train.schedule import noam_schedule
    from bist_tpu_torch.weights import tree_leaves

    out = []
    for step, state, bs in ((step_a, state_a, batches),
                            (step_b, state_b, [to_device(b, dev) for b in batches])):
        ms = []
        for b in bs:
            if gen is not None:
                gen.manual_seed(seed_for_step(3, state.step))
            state, m = step(state, b, gen)
            ms.append(m)
        torch.cuda.synchronize()
        out.append((state, ms))
    (sa, ma), (sb, mb) = out
    for x, y in zip(ma, mb):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_allclose(float(x[k]), float(y[k]), rtol=5e-4, err_msg=k)
    lr = sum(noam_schedule(128, 10)(i) for i in range(len(batches)))
    bias = {id(p["wk"]["b"]) for p in _attn_params(sa.params)}
    for i, (a, c) in enumerate(zip(tree_leaves(sa.params), tree_leaves(sb.params))):
        if id(a) in bias:
            assert (a - c).abs().max().item() <= 5e-4 + 2 * lr, i
        else:
            assert torch.allclose(a, c, rtol=5e-3, atol=5e-4), i
    return sa, sb


def _attn_params(tree):
    """Every attention parameter dict (one with "wk", "wv", "wo") of a tree."""
    if isinstance(tree, dict):
        if "wk" in tree and "wo" in tree:
            return [tree]
        return [p for v in tree.values() for p in _attn_params(v)]
    if isinstance(tree, (list, tuple)):
        return [p for v in tree for p in _attn_params(v)]
    return []


@pytest.mark.cuda
def test_train_program_replays_equal_eager_steps(cuda):
    """A TrainProgram over two geometries interleaved (one eager warm-up and
    one capture each, then replays) against the eager step from a copy of
    the same state; an EvalProgram on the result against make_eval_step."""
    from bist_tpu_torch.train.compiled import EvalProgram, TrainProgram
    from bist_tpu_torch.train.loop import make_eval_step, make_train_step

    cfg, tcfg, state, tx = train_setup(cuda)
    rng = np.random.default_rng(20)
    batches = [train_batch(rng, T=10 if i % 2 == 0 else 14) for i in range(6)]
    prog = TrainProgram(state, cfg, tcfg, tx)
    eager_state = copied(state)
    sp, _ = steps_agree(prog, state, make_train_step(cfg, tcfg, tx), eager_state,
                        [b if i % 2 else to_device(b, cuda) for i, b in enumerate(batches)],
                        cuda)
    stats = prog.stats()
    assert stats["captures"] == stats["eager_runs"] == stats["geometries"] == 2
    assert stats["pool_bytes"] > 0
    ev, step = EvalProgram(sp.params, cfg, tcfg), make_eval_step(cfg, tcfg)
    for b in batches[:3]:
        got, want = ev(sp.params, b), step(sp.params, to_device(b, cuda))
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=5e-4, err_msg=k)


@pytest.mark.cuda
def test_k1_and_k2_run_inside_train_replays(cuda):
    """K1 (with residuals) and K2 are captured inside the train step's graph:
    a replay launches nothing through the wrappers, and the profiler's trace
    shows 4 K1 and 4 K2 "whole" kernels a replay (2 layers, t2s and s2t)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bist_tpu_torch.train.compiled import TrainProgram

    cfg, tcfg, state, tx = train_setup(cuda)
    batch = train_batch(np.random.default_rng(21))
    prog = TrainProgram(state, cfg, tcfg, tx)
    fwd, bwd = K1.hop1_fused.launches, K1.hop1_bwd.launches
    state, _ = prog(state, batch)                 # warm-up (4 each) and capture (4)
    torch.cuda.synchronize()
    assert (K1.hop1_fused.launches - fwd, K1.hop1_bwd.launches - bwd) == (8, 8)
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(3):
            state, _ = prog(state, batch)
        torch.cuda.synchronize()
    assert (K1.hop1_fused.launches - fwd, K1.hop1_bwd.launches - bwd) == (8, 8)
    names = [e.name() for e in p.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert sum("hop1_fwd_whole_kernel" in n for n in names) == 12, names[:40]
    assert sum("hop1_bwd_whole_kernel" in n for n in names) == 12, names[:40]
    assert not any("hop1_fwd_tiles_kernel" in n or "hop1_bwd_kernel" in n for n in names)


@pytest.mark.cuda
def test_train_program_with_dropout_equals_eager_at_one_seed(cuda):
    """Dropout 0.2 (attention 0.1) from the generator registered with the
    graphs: 3 program calls (a warm-up, two replays) equal 3 eager steps
    from the same state at the same seeds."""
    from bist_tpu_torch.train.compiled import TrainProgram
    from bist_tpu_torch.train.loop import dropout_generator, make_train_step

    cfg, tcfg, state, tx = train_setup(cuda, dropout=0.2, attn_dropout=0.1)
    gen = dropout_generator(cfg, cuda)
    batch = train_batch(np.random.default_rng(22))
    prog = TrainProgram(state, cfg, tcfg, tx, gen=gen)
    steps_agree(prog, state, make_train_step(cfg, tcfg, tx), copied(state), [batch] * 3,
                cuda, gen=gen)


@pytest.mark.cuda
def test_loader_assembles_feature_grids_in_pinned_memory(cuda, tmp_path):
    """AVSDLoader(pin_memory=True), as the CLIs build it on the card: every
    feature grid in pinned memory (the padded tail rows zero), equal to the
    unpinned loader's batches."""
    import os

    import chip_smoke
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.features import build_stores
    from bist_tpu_torch.data.loader import AVSDLoader
    from bist_tpu_torch.vocab import get_vocabulary

    root = str(tmp_path / "data")
    test_set = chip_smoke.write_tiny_dataset(root, 5, dict(d_model=32, att_h=4, nb_blocks=1,
                                                           nb_venc_blocks=1, nb_cenc_blocks=1),
                                             dv=24, s=4, t_max=9)
    vocab = get_vocabulary(test_set, cutoff=0, include_caption="summary")
    data = load_avsd(test_set, vocab, include_caption="summary", separate_caption=True)
    path = os.path.join(root, "<FeaType>", "<ImageID>.npy")
    kw = dict(batch_size=4, shuffle=False, pad_batch_multiple=3, time_buckets=(4, 8, 16))
    plain = AVSDLoader(data, visual_stores=build_stores(["resnext_st"], path, data.vid_set)[0],
                       **kw)
    pinned = AVSDLoader(data, visual_stores=build_stores(["resnext_st"], path, data.vid_set)[0],
                        pin_memory=True, **kw)
    n = 0
    for (a, _), (b, _) in zip(plain, pinned):
        assert torch.from_numpy(b.fts).is_pinned()
        np.testing.assert_array_equal(a.fts, b.fts)
        n += 1
    assert n == len(plain) > 1


@pytest.fixture
def bundle_on_card(cuda, tmp_path):
    """A beam-search bundle of small_model exported on the card at
    host_batch's geometry, loaded into fresh objects, with the model."""
    from bist_tpu_torch.config import GenerateConfig
    from bist_tpu_torch.export import geometry_of, load_bundle, save_bundle

    vocab, cfg, params = small_model(cuda)
    gcfg = GenerateConfig(maxlen=5, beam=3, nbest=2, cache_dtype="bfloat16")
    geom = geometry_of(host_batch(np.random.default_rng(0)))
    save_bundle(str(tmp_path / "b"), params, cfg, gcfg, vocab, [geom])
    return cfg, params, gcfg, load_bundle(str(tmp_path / "b"), cuda)


@pytest.mark.cuda
def test_bundle_replays_equal_decode_program(bundle_on_card):
    """The bundle's program captured by a DecodeProgram (its beam_fn) gives
    the eager-stage DecodeProgram's outputs on two alternating batches of
    its geometry, one capture, nothing eager after; its graph holds K1's op
    (t2s and s2t in each of 2 layers) and no weight."""
    from bist_tpu_torch.decode.compiled import DecodeProgram

    cfg, params, gcfg, bundle = bundle_on_card
    ep = next(iter(bundle.programs.values()))
    assert sum(n.target is torch.ops.bist_tpu_torch.hop1_fwd.default
               for n in ep.graph.nodes) == 4 and len(ep.state_dict) == 0
    rng = np.random.default_rng(5)
    batches = [host_batch(rng), host_batch(rng)]
    prog = DecodeProgram(bundle.params, cfg, gcfg, beam_fn=bundle.beam_fn())
    plain = DecodeProgram(params, cfg, gcfg)
    for i in (0, 1, 0, 1):
        got = prog(batches[i])
        torch.cuda.synchronize()
        assert same(got, plain(batches[i])), i
    stats = prog.stats()
    assert stats["captures"] == stats["eager_runs"] == stats["geometries"] == 1


@pytest.mark.cuda
def test_k1_runs_inside_bundle_replays(bundle_on_card):
    """K1's op is captured inside the bundle's graph: the trace of 3 replays
    shows K1's "whole" kernel 12 times (4 a replay) and no launch passes
    through the op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, _, _, bundle = bundle_on_card
    rsp_prog = bundle.make_responder().program
    batch = host_batch(np.random.default_rng(6))
    rsp_prog(batch)
    torch.cuda.synchronize()
    before = K1.hop1_fused.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a kernel the trace may take late (CUPTI can start recording a
        # moment after the window opens; a run once lost a K1 that way)
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        for _ in range(3):
            rsp_prog(batch)
        torch.cuda.synchronize()
    assert K1.hop1_fused.launches == before
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert sum("hop1_fwd_whole_kernel" in n for n in names) == 12, names[:40]


@pytest.mark.cuda
def test_registered_ops_equal_the_direct_launches(cuda):
    """K1's and K3's registered ops on the card give the direct launch's
    result bit for bit (K1 through `_hop1_launch` as before the op, K3
    through the op twice), and count their launches."""
    rng = np.random.default_rng(7)
    B, G, Lq, Lk, D, h = 3, 16, 32, 40, 128, 8
    p = {n: {k: t.to(cuda) for k, t in w.items()}
         for n, w in mha_init(torch.Generator().manual_seed(1), h, D).items()}
    w = [p[n][k] for n in ("wk", "wv", "wo") for k in ("w", "b")]
    x, q = tensor(rng, (B, Lq, D), cuda), tensor(rng, (B, Lq, D), cuda)
    kv = tensor(rng, (B, Lk, G, D), cuda).transpose(1, 2)
    mask = prefix_mask(rng, B, Lk, cuda)[:, None, :].contiguous()
    for m in (mask, None):
        before = K1.hop1_fused.launches
        got = torch.ops.bist_tpu_torch.hop1_fwd(x, q, kv, *w, m, h)
        want = K1._hop1_launch(K1._fwd_lib().bist_hop1_fwd, None, x, q, kv, p, h, m, False)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and K1.hop1_fused.launches == before + 2
    qf, kf, vf = (tensor(rng, (8, 16, 64), cuda) for _ in range(3))
    fmask = prefix_mask(rng, 8, 16, cuda)
    before = K3.flash_attention.launches
    a = torch.ops.bist_tpu_torch.flash_fwd(qf, kf, vf, fmask, 0.125)
    b = K3.flash_attention(qf, kf, vf, fmask)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and K3.flash_attention.launches == before + 2
    close(a, K3.attention_plain(qf, kf, vf, fmask), "flash op")


# ---------------------------------------------------------------------------
# The video feature extractor (models/resnext3d.py): cuDNN convolutions and
# pools, no kernel of the port.  The card against the port's own CPU forward.

EXTRACT_TOL = 1e-4     # float32 both (TF32 off): max |Δ| over max |f|


def _kinetics_clips(n, seed, hw=64):
    from bist_tpu_torch.models.resnext3d import KINETICS_MEAN

    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(0, 256, (n, 16, hw, hw, 3)).astype(np.float32)
                        - np.asarray(KINETICS_MEAN, np.float32))


def _extract_close(got, want, what):
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= EXTRACT_TOL, f"{what}: {err:.3e} of max |f|"


@pytest.mark.cuda
def test_extractor_float32_block_and_net_match_cpu(cuda, monkeypatch):
    """ResNeXt-50 in float32: one strided bottleneck with its downsample, and
    the whole net in every activation layout, each against the CPU; the
    extractor's TF32 setting does not outlive its call."""
    from bist_tpu_torch.models import resnext3d as rx

    params = rx.init_resnext101(torch.Generator().manual_seed(0), depth=50)
    cpu_net = rx.prepare(params, "cpu")
    xin = torch.tensor(np.random.default_rng(1).standard_normal((2, 256, 8, 16, 16),
                                                                dtype=np.float32))
    want = rx.block_apply(cpu_net.params["stages"][1][0], xin, 2)
    card_net = rx.prepare(params, cuda)
    with rx.conv_precision():
        got = rx.block_apply(card_net.params["stages"][1][0],
                             xin.to(cuda).contiguous(memory_format=rx.MEMORY_FORMAT), 2)
    _extract_close(got, want, "stage 2 block 0")
    x = _kinetics_clips(2, 2)
    want = rx.resnext101_apply(cpu_net, x)
    tf32 = torch.backends.cudnn.allow_tf32
    for fmt in (torch.contiguous_format, torch.channels_last_3d):
        monkeypatch.setattr(rx, "MEMORY_FORMAT", fmt)
        got = rx.resnext101_apply(rx.prepare(params, cuda), x.to(cuda))
        assert got.shape == (2, 4, 2048) and got.device.type == "cuda"
        _extract_close(got, want, f"net, {fmt}")
    assert torch.backends.cudnn.allow_tf32 == tf32


@pytest.mark.cuda
def test_extractor_int8_on_the_card_equals_the_cpu(cuda):
    """int8 stages 3 and 4 (static scales): the integer conv sums exact on
    the card at the real widths, and every int8 block, given the same
    bfloat16 input, the CPU's output bit for bit."""
    from bist_tpu_torch.models import resnext3d as rx

    params = rx.init_resnext101(torch.Generator().manual_seed(0), depth=50)
    x = _kinetics_clips(2, 4)
    scales = rx.collect_act_scales(rx.prepare(params, "cpu"), x.to(torch.bfloat16))
    q = rx.quantize_resnext_int8(params, act_scales=scales, stages=(2, 3))
    cpu_net, card_net = rx.prepare(q, "cpu"), rx.prepare(q, cuda)
    rng = np.random.default_rng(3)
    for c, o, k, s in ((512, 256, 1, 1), (1024, 2048, 1, 2), (512, 512, 3, 2),
                       (1024, 1024, 3, 1)):
        xq = torch.tensor(rng.integers(-127, 128, (2, c, 4, 8, 8)), dtype=torch.int8)
        cin = c // rx.CARDINALITY if k == 3 else c
        w = torch.tensor(rng.integers(-127, 128, (k, k, k, cin, o)), dtype=torch.int8)
        want = torch.nn.functional.conv3d(xq.double(), w.permute(4, 3, 0, 1, 2).double(),
                                          stride=s, padding=k // 2, groups=c // cin)
        with rx.conv_precision():
            got = rx._conv3d_int8(xq.to(cuda).contiguous(memory_format=rx.MEMORY_FORMAT),
                                  rx._prepare_conv(w, cuda), s)
        assert torch.equal(got.double().cpu(), want), (c, o, k, s)
    h = rx.stem_apply(cpu_net, x)
    for s, stage in enumerate(cpu_net.params["stages"]):
        for b, blk in enumerate(stage):
            stride = rx.STAGE_STRIDES[s] if b == 0 else 1
            nxt = rx.block_apply(blk, h, stride)
            if s >= 2:
                with rx.conv_precision():
                    got = rx.block_apply(card_net.params["stages"][s][b],
                                         h.to(cuda).contiguous(memory_format=rx.MEMORY_FORMAT),
                                         stride)
                assert got.dtype == torch.bfloat16
                assert torch.equal(got.cpu(), nxt), f"stage {s + 1} block {b}"
            h = nxt


@pytest.mark.cuda
def test_extract_cli_packed_on_the_card(cuda, tmp_path):
    """The extract CLI on the card (ResNeXt-50, random init, 112 × 112 .npy
    stacks): packed equal to per-video, both near the CPU's run."""
    from bist_tpu_torch.cli import extract_features

    rng = np.random.default_rng(5)
    (tmp_path / "v").mkdir()
    for vid, n in {"a": 8, "b": 20, "c": 40}.items():
        np.save(tmp_path / "v" / f"{vid}.npy",
                rng.integers(0, 256, (n, 112, 112, 3), dtype=np.uint8))
    base = ["--video_root", str(tmp_path / "v"), "--stride", "8", "--batch_size", "4",
            "--model_depth", "50"]
    runs = {"packed": ["--device", "cuda"], "per_video": ["--device", "cuda", "--pack", "0"],
            "cpu": ["--device", "cpu"]}
    for name, extra in runs.items():
        extract_features.main(base + ["--output", str(tmp_path / name)] + extra)
    for vid in ("a", "b", "c"):
        pk, pv, cpu = (torch.from_numpy(np.load(tmp_path / r / f"{vid}.npy")) for r in runs)
        assert pk.shape == cpu.shape and pk.shape[1:] == (16, 2048)
        assert float((pk - pv).abs().max()) <= 1e-5 * float(pv.abs().max()), vid
        _extract_close(pk, cpu, f"CLI {vid}")


TGIF = ["frameqa", "count", "action", "transition"]


def _tgif_setup(cuda, task, B=8, T=32, seed=30):
    """The train_tgif CLI's width (d_model 128, 8 heads, 2 video blocks,
    Dv 2048, S 16), random parameters, one host batch of B questions (B·5
    rows for multiple choice) with a zero clip tail and PAD query tail."""
    import chip_smoke
    from bist_tpu_torch.tasks.tgifqa import TGIFTask, init_tgif_model

    cfg = chip_smoke.tgif_cfg(30)
    params = init_tgif_model(torch.Generator().manual_seed(0), cfg, TGIFTask(task), device=cuda)
    batch = chip_smoke.tgif_batch(np.random.default_rng(seed), task, B, T, 16, 30)
    return cfg, params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("task", TGIF)
def test_tgif_forward_and_train_step_match_plain(cuda, task):
    """`tgif_forward` through K1 (4 launches) against force_plain() within
    5e-4; one train step at dropout 0 (4 K1 with residuals, 4 K2): loss to
    5e-4 relative, gradients to 5e-4 + 5e-3·|g|."""
    import chip_smoke

    cfg, params, batch = _tgif_setup(cuda, task)
    out = chip_smoke.tgif_kernels_against_plain(cuda, task, params, cfg, batch)
    assert out["launches"] == {"forward_k1": 4, "step_k1_k2": [4, 4]}


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["frameqa", "action"])
def test_tgif_step_program_replays_equal_eager_steps(cuda, task):
    """A StepProgram of make_tgif_train_step (one eager warm-up, one
    capture, then replays) against the eager step from the same start:
    losses and metrics to 5e-4 relative, parameters to 5e-4 + 5e-3·|p|
    (the key biases, and for multiple choice the biases that shift a row's
    5 scores alike, to 5e-4 + 2·Σlr); K1 and K2 4 times a replay by name,
    none through the wrappers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from bist_tpu_torch.tasks.tgifqa import (TGIFTask, create_tgif_train_state,
                                             make_tgif_train_step, tgif_optimizer)
    from bist_tpu_torch.train.compiled import StepProgram
    from bist_tpu_torch.weights import tree_leaves

    cfg, params, batch = _tgif_setup(cuda, task)
    tx = tgif_optimizer(1e-3)
    step = make_tgif_train_step(cfg, TGIFTask(task), tx)
    eager = create_tgif_train_state(params, tx)
    state = create_tgif_train_state(params, tx)
    prog = StepProgram(state, step)
    fwd, bwd = K1.hop1_fused.launches, K1.hop1_bwd.launches
    dev_batch = to_device(batch, cuda)
    for i in range(3):
        state, got = prog(state, batch)
        eager, want = step(eager, dev_batch)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=5e-4, err_msg=k)
    # the program's warm-up and capture (4 + 4), the 3 eager steps (12)
    assert (K1.hop1_fused.launches - fwd, K1.hop1_bwd.launches - bwd) == (20, 20)
    shifts = ("head.b", "out_norm_t.bias", "out_norm_s.bias") if task == "action" else ()
    for name, a, b in zip(chip_smoke.leaf_names(state.params), tree_leaves(state.params),
                          tree_leaves(eager.params)):
        if name.endswith("wk.b") or name in shifts:
            assert (a - b).abs().max().item() <= 5e-4 + 2 * 3e-3, name
        else:
            assert torch.allclose(a, b, rtol=5e-3, atol=5e-4), name
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(2):
            state, _ = prog(state, batch)
        torch.cuda.synchronize()
    assert (K1.hop1_fused.launches - fwd, K1.hop1_bwd.launches - bwd) == (20, 20)
    names = [e.name() for e in p.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert sum("hop1_fwd_whole_kernel" in n for n in names) == 8, names[:40]
    assert sum("hop1_bwd_whole_kernel" in n for n in names) == 8, names[:40]
