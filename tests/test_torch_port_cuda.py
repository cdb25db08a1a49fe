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
@pytest.mark.parametrize("G,Lq,Lk,d", [
    (4, 16, 300, 64), (3, 1, 40, 16), (2, 40, 70, 128), (2, 5, 65, 32),
    (3, 7, 90, 8), (2, 9, 70, 6), (2, 33, 100, 96), (2, 4, 1000, 256),
])
def test_flash_kernel_matches_plain(cuda, G, Lq, Lk, d):
    rng = np.random.default_rng(1)
    q, k, v = (tensor(rng, s, cuda) for s in ((G, Lq, d), (G, Lk, d), (G, Lk, d)))
    mask = prefix_mask(rng, G, Lk, cuda)
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
    wide = torch.zeros((G, Lq, 264), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        K3.flash_attention(wide, wide[:, :1].expand(G, Lk, 264).contiguous(),
                           wide[:, :1].expand(G, Lk, 264).contiguous())


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


@pytest.mark.cuda
def test_bf16_model_and_wide_hop1_launch_or_raise(cuda, monkeypatch):
    """On the card a call that meets the dispatch rule launches its kernel
    or raises; it never runs the plain version: a bfloat16 model's hop 1 and
    long-kv mha launch K1 and K3, and hop 1 at D=520 raises."""
    def plain_called(*a, **kw):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(K1, "hop1_plain", plain_called)
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
    D, h = 520, 8
    p = {n: {k: t.to(cuda) for k, t in w.items()}
         for n, w in mha_init(torch.Generator().manual_seed(0), h, D).items()}
    hop = {"attn": p, "norm": {"scale": torch.ones(D, device=cuda),
                               "bias": torch.zeros(D, device=cuda)}}
    x, grid = tensor(rng, (2, 5, D), cuda), tensor(rng, (2, 3, 4, D), cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="D <= 512"):
        torch_bist._hop1(hop, h, 0.0, 0.0, None, x, grid, None)
