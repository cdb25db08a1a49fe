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
from torch_threads import two_threads  # noqa: F401 (autouse)

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
    (2, 3, 5, 7, 12, 3),       # widths K1 "tiled" pads: d_k 4, D % 8 != 0
    (2, 3, 5, 7, 30, 3),       # d_k 10
    (2, 2, 4, 9, 120, 8),      # d_k 15
    (1, 2, 3, 6, 520, 8),      # above 512, d_k 65
    (1, 2, 3, 5, 1024, 8),     # two head groups in K2
    # the widths K1 "wide" takes: D 256 and 512, d_k 32 and 64
    (1, 2, 5, 7, 256, 8),
    (1, 2, 5, 7, 256, 4),
    (1, 2, 5, 7, 512, 8),      # bist_tpu's default d_model and heads
    (1, 2, 5, 7, 512, 16),
    # past 64 kv rows (t2s over a video of more than 64 clips), where K1
    # "wide" streams K and V in tiles of 16 rows: at the reference's width,
    # one row into a last kv tile, and D 64
    (1, 2, 5, 130, 512, 8),
    (1, 2, 5, 65, 256, 4),
    (1, 2, 5, 130, 64, 4),
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


def test_hop1_residuals_past_64_kv_rows_match_pallas(rng):
    """K1's training residuals at Lk 130, D 512 (the residuals K1 "wide"
    writes after its last kv tile and K2 "tiled" reads): concat and lse of
    the valid batch row against the Pallas kernel's (interpret mode; Lq
    padded to 8 there); the fully masked row, which the Pallas kernel
    spreads over its padding columns too, against its uniform attention over
    the true Lk: concat the mean of V's rows, lse -1e9 (+ log Lk, below
    float32's step there)."""
    B, G, Lq, Lk, D, h = 2, 2, 5, 130, 512, 8
    p, tp, x, q_proj, kv, mask = hop1_inputs(rng, B, G, Lq, Lk, D, h)
    mask[0] = 0
    out, concat, lse = K1.hop1_plain(t(x), t(q_proj), t(kv), tp, h, t(mask),
                                     return_residuals=True)
    assert concat.shape == (B, G, Lq, D) and lse.shape == (B, G, Lq, h)
    assert_close(out, hop1_reference(j(x), j(q_proj), j(kv), p, h, j(mask)), TOL,
                 "out vs hop1_reference")
    jout, jconcat, jlse = bist_hop1_fused(j(x), j(q_proj), j(kv), p, h, j(mask),
                                          return_residuals=True, interpret=True)
    assert_close(out[1], np.asarray(jout)[1], TOL, "valid row: out vs Pallas")
    assert_close(concat[1], np.asarray(jconcat)[1, :, :Lq], TOL, "valid row: concat vs Pallas")
    assert_close(lse[1], np.asarray(jlse)[1, :, :Lq], TOL, "valid row: lse vs Pallas")
    v = t(kv)[0] @ tp["wv"]["w"] + tp["wv"]["b"]                      # (G, Lk, D)
    assert_close(concat[0], v.mean(1, keepdim=True).expand(G, Lq, D), TOL,
                 "masked row: concat vs the mean of V")
    assert torch.equal(lse[0], torch.full((G, Lq, h), -1e9))


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
    """The widths the K1 wrapper launches on a card: every D with D % h == 0,
    as the model's config allows (others raise there)."""
    for D, h in ((32, 4), (128, 8), (512, 8), (512, 128), (16, 1), (520, 8),
                 (36, 4), (128, 64), (32, 16), (30, 3), (1024, 8), (7, 7)):
        assert K1.hop1_supports(D, h), (D, h)
    for D, h in ((30, 4), (10, 3), (128, 0)):
        assert not K1.hop1_supports(D, h), (D, h)


@pytest.mark.parametrize("D,h", [(12, 3), (30, 3), (120, 8), (20, 2), (7, 7)])
def test_padded_head_layout_changes_no_number(D, h, rng):
    """What the wrappers hand the kernels: q, Wk, bk, Wv, bv with each head's
    columns zero-padded to a multiple of 4 and Wo with its rows so padded
    (its columns to a multiple of 4) give hop 1's numbers with the scale of
    the true head width, and `_unpad_heads` takes the padding off again."""
    _, tp, x, q_proj, kv, mask = hop1_inputs(rng, 2, 3, 5, 7, D, h)
    x, q, kv, mask = t(x), t(q_proj), t(kv), t(mask)
    w = {n: tp[n] for n in ("wk", "wv", "wo")}
    qp = K1._pad_heads(q, h)
    Dp = qp.shape[-1]
    assert Dp % 4 == 0 and Dp // h >= D // h and (Dp // h) % 4 == 0
    assert torch.equal(K1._unpad_heads(qp, h, D), q)
    kp = kv @ K1._pad_heads(w["wk"]["w"], h) + K1._pad_heads(w["wk"]["b"], h)
    vp = kv @ K1._pad_heads(w["wv"]["w"], h) + K1._pad_heads(w["wv"]["b"], h)
    heads = lambda a: a.reshape(*a.shape[:-1], h, Dp // h).transpose(-2, -3)
    s = heads(qp)[:, None] @ heads(kp).transpose(-1, -2) / (D // h) ** 0.5
    s = torch.where((mask != 0)[:, None, None], s, K1.NEG_INF)
    concat = (torch.softmax(s, -1) @ heads(vp)).transpose(-2, -3).reshape(2, 3, 5, Dp)
    wo = K1._pad_cols4(K1._pad_heads(w["wo"]["w"], h, dim=0))
    assert wo.shape == (Dp, -(-D // 4) * 4)
    out = x[:, None] + (concat @ wo)[..., :D] + w["wo"]["b"]
    want, want_concat, _ = K1.hop1_plain(x, q, kv, tp, h, mask, return_residuals=True)
    assert_close(out, want, 1e-5, "out through the padded layout")
    assert_close(K1._unpad_heads(concat, h, D), want_concat, 1e-5, "concat")
    assert torch.count_nonzero(concat.reshape(2, 3, 5, h, -1)[..., D // h:]) == 0


def tf32(a, rounding):
    """float32 `a` cut to TF32 (10 mantissa bits) on its low 13 mantissa bits,
    by integer view: to nearest, ties away from zero (cvt.rna.tf32), or
    toward zero (a bit mask, as K1 splits)."""
    bits = np.asarray(a, dtype=np.float32).view(np.uint32)
    if rounding == "nearest":
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split_operands(product):
    """The float32 operands (a, b) of a product that the hop-1 kernels run as
    3xTF32: K1's K/V projection of one group's kv rows ("40": t2s, "16":
    s2t) by [Wk | Wv]; K2's dkv, [dk | dv] (40 x 256) by [Wkᵀ ; Wvᵀ], a
    2D-deep contraction; K2's dW, kvᵀ dk over B·G·Lk = 20,480 rows at D 128
    (32 x 16 x 40, the flagship t2s launch); K1 "wide"'s two GEMMs at D 512,
    512 deep: the projection (40 kv rows by [Wk | Wv], 512 x 1024) and Wo
    (32 concat rows by Wo, 512 x 512).  Standard normal activations,
    weights as mha_init makes them."""
    rng = np.random.default_rng(1)
    if product in ("proj512", "wo512"):
        p = torch_mha_init(torch.Generator().manual_seed(1), 8, 512)
        if product == "wo512":
            return rng.standard_normal((32, 512), dtype=np.float32), p["wo"]["w"].numpy()
        return (rng.standard_normal((40, 512), dtype=np.float32),
                np.concatenate([p["wk"]["w"].numpy(), p["wv"]["w"].numpy()], 1))
    p = torch_mha_init(torch.Generator().manual_seed(1), 8, 128)
    wk, wv = p["wk"]["w"].numpy(), p["wv"]["w"].numpy()
    if product == "dkv":
        return (rng.standard_normal((40, 256), dtype=np.float32),
                np.concatenate([wk.T, wv.T]))
    if product == "dW":
        return (rng.standard_normal((128, 20480), dtype=np.float32),
                rng.standard_normal((20480, 128), dtype=np.float32))
    return (rng.standard_normal((int(product), 128), dtype=np.float32),
            np.concatenate([wk, wv], 1))


@pytest.mark.parametrize("rounding", ["nearest", "toward_zero"])
@pytest.mark.parametrize("product", ["40", "16", "dkv", "dW", "proj512", "wo512"])
def test_3xtf32_split_keeps_float32_accuracy(product, rounding):
    """Why the hop-1 kernels split their tensor-core operands: one TF32
    pass is off from the float32 product by more than 2e-4 abs + 2e-4 rel
    (~1e-3 at the flagship K/V projection), while the 3xTF32 split a·b =
    lo_a·hi_b + hi_a·lo_b + hi_a·hi_b agrees within it and is as close to
    the float64 product as float32 is, on K1's projection (and "wide"'s two
    512-deep GEMMs) and on K2's dkv and dW products.  Products and sums in float64: only the operand
    rounding is emulated (K1 splits toward zero, K2 to nearest)."""
    a, b = split_operands(product)
    f32 = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy()
    mm = lambda x, y: x.astype(np.float64) @ y.astype(np.float64)
    exact = mm(a, b)
    a_hi, b_hi = tf32(a, rounding), tf32(b, rounding)
    a_lo, b_lo = tf32(a - a_hi, rounding), tf32(b - b_hi, rounding)
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


@pytest.mark.parametrize("d", [6, 8, 96, 320])
def test_attention_plain_any_head_dim_matches_jax(d, rng):
    """Head dims the kernel pads in shared memory only (6: not a multiple
    of 4, 8: below its smallest tile, 96: between two tiles) and one above
    128 (320: the kernel's column split)."""
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


def test_attention_plain_partial_tiles_and_masked_row_match_jax(rng):
    """The shapes that leave K3's tiles partial (17 query rows: one
    row past a 16-row MMA tile; head dim 72: one 8-column tile past 64; kv
    1001) with a fully masked row: the plain version against
    `attention_reference` and the Pallas kernel in interpret mode."""
    q, k, v, mask = attn_inputs(rng, 2, 17, 1001, 72, True)
    mask[1] = 0
    plain = K3.attention_plain(t(q), t(k), t(v), t(mask))
    assert_close(plain, attention_reference(j(q), j(k), j(v), j(mask)), TOL,
                 "Lq 17 d 72 vs attention_reference")
    assert_close(plain[0], jax_flash(j(q), j(k), j(v), j(mask), interpret=True)[0],
                 TOL, "Lq 17 d 72 vs the Pallas kernel (interpret)")
    assert torch.allclose(plain[1], t(v)[1].mean(0).expand(17, 72), atol=1e-5)


def test_attention_fully_masked_row_and_cpu_wrapper(rng):
    q, k, v, mask = attn_inputs(rng, 3, 4, 300, 32, True)
    mask[1] = 0
    plain = K3.attention_plain(t(q), t(k), t(v), t(mask))
    assert_close(plain, attention_reference(j(q), j(k), j(v), j(mask)), TOL,
                 "fully masked row vs attention_reference")
    before = K3.flash_attention.launches
    assert torch.equal(K3.flash_attention(t(q), t(k), t(v), t(mask)), plain)
    assert K3.flash_attention.launches == before
