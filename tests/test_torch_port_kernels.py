"""The port's kernel modules: on the CPU, the plain versions of K1 (hop 1)
and K3 (flash attention) against the JAX package's references and its
Pallas kernels in interpret mode (2e-4), and an emulation of the 3xTF32
split that K1's tensor-core products rest on.  The CUDA kernels themselves
are held against these plain versions on the card by
test_torch_port_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bist_tpu.models.layers import linear, mha_init
from bist_tpu.ops.bist_kernels import bist_hop1_fused, hop1_reference
from bist_tpu.ops.flash_attention import attention_reference, flash_attention as jax_flash
from bist_tpu_torch.models.layers import mha_init as torch_mha_init
from bist_tpu_torch.ops import bist_kernels as K1
from bist_tpu_torch.ops import flash_attention as K3
from bist_tpu_torch.weights import params_from_jax
from torch_port_common import CPU, assert_close

TOL = 2e-4


def hop1_inputs(rng, B, G, Lq, Lk, D, h, masked=True):
    p = mha_init(jax.random.PRNGKey(0), h, D)
    x = rng.standard_normal((B, Lq, D)).astype(np.float32)
    kv = rng.standard_normal((B, G, Lk, D)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.uniform(size=(B, 1, Lk)) > 0.25).astype(np.int32)
        mask[:, :, 0] = 1
    q_proj = np.array(linear(p["wq"], jnp.asarray(x)))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, p), CPU)
    return p, tp, x, q_proj, kv, mask


def t(a):
    return None if a is None else torch.from_numpy(a)


def j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("B,G,Lq,Lk,D,h", [
    (2, 4, 5, 7, 32, 2),       # t2s-like, unaligned everything
    (1, 3, 12, 130, 128, 8),   # s2t-like at flagship width, Lk > 128
])
def test_hop1_plain_matches_jax(B, G, Lq, Lk, D, h, masked, rng):
    p, tp, x, q_proj, kv, mask = hop1_inputs(rng, B, G, Lq, Lk, D, h, masked)
    plain = K1.hop1_plain(t(x), t(q_proj), t(kv), tp, h, t(mask))
    assert plain.shape == (B, G, Lq, D)
    assert_close(plain, hop1_reference(j(x), j(q_proj), j(kv), p, h, j(mask)),
                 TOL, "vs hop1_reference")
    pallas = bist_hop1_fused(j(x), j(q_proj), j(kv), p, h, j(mask), interpret=True)
    assert_close(plain, pallas, TOL, "vs the Pallas kernel (interpret)")


def test_hop1_fully_masked_row_is_uniform_over_true_lk(rng):
    """A batch row with no valid kv column attends uniformly over the true
    Lk (hop1_reference); the Pallas kernel also counts its padding columns
    there, so it is compared on the other row only."""
    p, tp, x, q_proj, kv, mask = hop1_inputs(rng, 2, 3, 4, 130, 32, 4)
    mask[0] = 0
    plain = K1.hop1_plain(t(x), t(q_proj), t(kv), tp, 4, t(mask))
    assert_close(plain, hop1_reference(j(x), j(q_proj), j(kv), p, 4, j(mask)),
                 TOL, "fully masked row vs hop1_reference")
    pallas = bist_hop1_fused(j(x), j(q_proj), j(kv), p, 4, j(mask), interpret=True)
    assert_close(plain[1], np.asarray(pallas)[1], TOL, "valid row vs Pallas")


def test_hop1_wrapper_on_cpu_runs_plain_version(rng):
    """On CPU tensors the wrapper is the plain version and launches nothing;
    a strided kv view (the t2s grid with T and S swapped) is accepted."""
    _, tp, x, q_proj, kv, mask = hop1_inputs(rng, 2, 3, 5, 7, 32, 4)
    grid = t(kv).transpose(1, 2)                 # (B, Lk, G, D) strided view
    before = K1.hop1_fused.launches
    got = K1.hop1_fused(t(x), t(q_proj), grid.transpose(1, 2), tp, 4, t(mask))
    want = K1.hop1_plain(t(x), t(q_proj), t(kv), tp, 4, t(mask))
    assert torch.equal(got, want)
    assert K1.hop1_fused.launches == before


@pytest.mark.parametrize("B,G,Lq,Lk,D,h", [(2, 4, 5, 7, 32, 2), (1, 3, 12, 130, 128, 8)])
def test_hop1_plain_bf16_grid_matches_jax(B, G, Lq, Lk, D, h, rng):
    """A bfloat16 model's grid: projected by the float32 weights in float32,
    as the Pallas kernel does (hop1_reference would project in bfloat16, so
    it gets the grid's values in float32); the result is float32."""
    p, tp, x, q_proj, kv, mask = hop1_inputs(rng, B, G, Lq, Lk, D, h)
    kv_bf16 = t(kv).to(torch.bfloat16)
    plain = K1.hop1_plain(t(x), t(q_proj), kv_bf16, tp, h, t(mask))
    assert plain.dtype == torch.float32
    jkv = jnp.asarray(kv, dtype=jnp.bfloat16)
    assert_close(plain, hop1_reference(j(x), j(q_proj), jkv.astype(jnp.float32), p,
                                       h, j(mask)),
                 TOL, "bf16 grid vs hop1_reference")
    pallas = bist_hop1_fused(j(x), j(q_proj), jkv, p, h, j(mask), interpret=True)
    assert_close(plain, pallas, TOL, "bf16 grid vs the Pallas kernel (interpret)")


def test_hop1_supports_widths():
    """The widths the K1 wrapper launches on a card (others raise there)."""
    for D, h in ((32, 4), (128, 8), (512, 8), (512, 128), (16, 1)):
        assert K1.hop1_supports(D, h), (D, h)
    for D, h in ((520, 8), (36, 4), (128, 64), (32, 16), (30, 3)):
        assert not K1.hop1_supports(D, h), (D, h)


def tf32(a, rounding):
    """float32 `a` cut to TF32 (10 mantissa bits) on its low 13 mantissa bits,
    by integer view: to nearest, ties away from zero (cvt.rna.tf32), or
    toward zero (a bit mask, as K1 splits)."""
    bits = np.asarray(a, dtype=np.float32).view(np.uint32)
    if rounding == "nearest":
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("rounding", ["nearest", "toward_zero"])
@pytest.mark.parametrize("rows", [40, 16])      # one group's kv rows: t2s, s2t
def test_3xtf32_split_keeps_float32_accuracy(rows, rounding):
    """Why K1 splits its tensor-core operands: at the flagship K/V
    projection (kv rows x 128 standard normal, [Wk | Wv] as mha_init makes
    them), one TF32 pass is off from the float32 product by more than 2e-4
    abs + 2e-4 rel (~1e-3), while the 3xTF32 split a·b = lo_a·hi_b +
    hi_a·lo_b + hi_a·hi_b agrees within it and is as close to the float64
    product as float32 is.  Products and sums in float64: only the operand
    rounding is emulated."""
    p = torch_mha_init(torch.Generator().manual_seed(1), 8, 128)
    w = torch.cat([p["wk"]["w"], p["wv"]["w"]], 1).numpy()
    kv = np.random.default_rng(1).standard_normal((rows, 128), dtype=np.float32)
    f32 = (torch.from_numpy(kv) @ torch.from_numpy(w)).numpy()
    mm = lambda a, b: a.astype(np.float64) @ b.astype(np.float64)
    exact = mm(kv, w)
    a_hi, b_hi = tf32(kv, rounding), tf32(w, rounding)
    a_lo, b_lo = tf32(kv - a_hi, rounding), tf32(w - b_hi, rounding)
    three = mm(a_lo, b_hi) + mm(a_hi, b_lo) + mm(a_hi, b_hi)
    assert np.allclose(three, f32, rtol=TOL, atol=TOL)
    assert np.abs(three - exact).max() < 2 * np.abs(f32 - exact).max()
    assert not np.allclose(mm(a_hi, b_hi), f32, rtol=TOL, atol=TOL)


def attn_inputs(rng, G, Lq, Lk, d, masked):
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((G, Lq, d), (G, Lk, d), (G, Lk, d)))
    mask = None
    if masked:
        mask = (rng.uniform(size=(G, Lk)) > 0.3).astype(np.int32)
        mask[:, 0] = 1
    return q, k, v, mask


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("G,Lq,Lk,d", [
    (4, 16, 300, 64),      # unaligned kv length
    (2, 7, 1024, 16),      # BiST head dim, unaligned q
])
def test_attention_plain_matches_jax(G, Lq, Lk, d, masked, rng):
    q, k, v, mask = attn_inputs(rng, G, Lq, Lk, d, masked)
    plain = K3.attention_plain(t(q), t(k), t(v), t(mask))
    assert_close(plain, attention_reference(j(q), j(k), j(v), j(mask)), TOL,
                 "vs attention_reference")
    assert_close(plain, jax_flash(j(q), j(k), j(v), j(mask), interpret=True),
                 TOL, "vs the Pallas kernel (interpret)")


@pytest.mark.parametrize("d", [6, 8, 96])
def test_attention_plain_any_head_dim_matches_jax(d, rng):
    """Head dims the kernel pads in shared memory only (6: not a multiple
    of 4, 8: below its smallest tile, 96: between two tiles)."""
    q, k, v, mask = attn_inputs(rng, 3, 5, 200, d, True)
    plain = K3.attention_plain(t(q), t(k), t(v), t(mask))
    assert_close(plain, attention_reference(j(q), j(k), j(v), j(mask)), TOL,
                 f"d={d} vs attention_reference")
    assert_close(plain, jax_flash(j(q), j(k), j(v), j(mask), interpret=True),
                 TOL, f"d={d} vs the Pallas kernel (interpret)")
    low = K3.attention_plain(*(t(a).to(torch.bfloat16) for a in (q, k, v)), t(mask))
    assert low.dtype == torch.bfloat16
    want = K3.attention_plain(*(t(a).to(torch.bfloat16).float() for a in (q, k, v)),
                              t(mask))
    assert_close(low, want, 4e-3, f"d={d} bfloat16 in, float32 arithmetic")


def test_attention_fully_masked_row_and_cpu_wrapper(rng):
    q, k, v, mask = attn_inputs(rng, 3, 4, 300, 32, True)
    mask[1] = 0
    plain = K3.attention_plain(t(q), t(k), t(v), t(mask))
    assert_close(plain, attention_reference(j(q), j(k), j(v), j(mask)), TOL,
                 "fully masked row vs attention_reference")
    before = K3.flash_attention.launches
    assert torch.equal(K3.flash_attention(t(q), t(k), t(v), t(mask)), plain)
    assert K3.flash_attention.launches == before
