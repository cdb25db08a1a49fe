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
