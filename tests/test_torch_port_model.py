"""The PyTorch port's model against the JAX package, on the CPU at a tiny
size (d_model 32, 4 heads, 2 blocks): both compute from the same
`init_model(PRNGKey)` tree and the same numpy batch.  Forward tensors must
agree to 5e-4 (float32, different summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bist_tpu.models import bist as jax_bist
from bist_tpu.models import layers as jax_layers
from bist_tpu.models import model as jax_model
from bist_tpu_torch.models import bist as torch_bist
from bist_tpu_torch.models import layers as torch_layers
from bist_tpu_torch.models import model as torch_model
from bist_tpu_torch.ops import dispatch
from bist_tpu_torch.ops.bist_kernels import hop1_fused
from bist_tpu_torch.weights import params_from_jax, params_to_jax
from torch_port_common import (
    CFG_VARIANTS, CPU, assert_close, both_params, configs, np_batch,
    torch_batch, variant_id,
)
from torch_threads import two_threads  # noqa: F401 (autouse)

TOL = 5e-4


def test_params_round_trip():
    """params_from_jax / params_to_jax keep every name, shape and value (no
    transpose: both trees store linear weights (in, out))."""
    jcfg, _ = configs()
    jp, tp = both_params(jcfg)
    back = params_to_jax(tp)
    jleaves, jdef = jax.tree_util.tree_flatten(jp)
    bleaves, bdef = jax.tree_util.tree_flatten(back)
    assert jdef == bdef
    for a, b in zip(jleaves, bleaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert tp["decoder"]["v_layers"][0]["t2s_hop1"]["attn"]["wq"]["w"].shape == (32, 32)


def test_layer_norm_and_attention_primitives(rng):
    jcfg, _ = configs()
    jp, tp = both_params(jcfg)
    attn_j = jp["decoder"]["mm_layers"][0]["his"]["attn"]
    attn_t = tp["decoder"]["mm_layers"][0]["his"]["attn"]
    norm_j = jp["decoder"]["mm_layers"][0]["his"]["norm"]
    norm_t = tp["decoder"]["mm_layers"][0]["his"]["norm"]
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    mem = rng.standard_normal((2, 9, 32)).astype(np.float32)
    mask = (rng.uniform(size=(2, 1, 9)) > 0.3).astype(np.int32)
    mask[1] = 0                                       # a fully masked row
    assert_close(torch_layers.layer_norm(norm_t, torch.from_numpy(x)),
                 jax_layers.layer_norm(norm_j, jnp.asarray(x)), TOL, "layer_norm")
    cross_t = torch_layers.mha(attn_t, 4, torch.from_numpy(x), torch.from_numpy(mem),
                               torch.from_numpy(mem), torch.from_numpy(mask))
    cross_j = jax_layers.mha(attn_j, 4, jnp.asarray(x), jnp.asarray(mem),
                             jnp.asarray(mem), jnp.asarray(mask))
    assert_close(cross_t, cross_j, TOL, "cross-attention mha")
    causal = np.array(jax_layers.subsequent_mask(5))
    self_t = torch_layers.mha(attn_t, 4, *(torch.from_numpy(x),) * 3,
                              torch.from_numpy(causal))
    self_j = jax_layers.mha(attn_j, 4, *(jnp.asarray(x),) * 3, jnp.asarray(causal))
    assert_close(self_t, self_j, TOL, "causal self-attention mha")


def test_mha_flash_branch_matches_jax(rng, monkeypatch):
    """With the kv threshold at 0, mha takes its flash branch (the K3
    wrapper, plain version on the CPU); it must equal the JAX mha."""
    jcfg, _ = configs()
    jp, tp = both_params(jcfg)
    attn_j = jp["decoder"]["mm_layers"][0]["query"]["attn"]
    attn_t = tp["decoder"]["mm_layers"][0]["query"]["attn"]
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    mem = rng.standard_normal((2, 40, 32)).astype(np.float32)
    mask = (rng.uniform(size=(2, 1, 40)) > 0.3).astype(np.int32)
    mask[0] = 0
    real, calls = torch_layers.flash_attention, []

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(dispatch, "FLASH_MIN_KV", 0)
    monkeypatch.setattr(torch_layers, "flash_attention", counting)
    # 2 heads of d_k 16
    out_t = torch_layers.mha(attn_t, 2, torch.from_numpy(x), torch.from_numpy(mem),
                             torch.from_numpy(mem), torch.from_numpy(mask))
    out_j = jax_layers.mha(attn_j, 2, jnp.asarray(x), jnp.asarray(mem),
                           jnp.asarray(mem), jnp.asarray(mask))
    assert_close(out_t, out_j, TOL, "flash-branch mha")
    assert calls == [1]
    assert dispatch.mha_uses_flash(40, False, False, False, True)
    assert not dispatch.mha_uses_flash(40, True, False, False, True)
    assert not dispatch.mha_uses_flash(40, False, True, False, True)
    assert not dispatch.mha_uses_flash(40, False, False, True, True)
    assert not dispatch.mha_uses_flash(40, False, False, False, False)
    with dispatch.force_plain():
        assert not dispatch.mha_uses_flash(40, False, False, False, True)
    monkeypatch.undo()
    assert not dispatch.mha_uses_flash(32767, False, False, False, True)


def test_vid_layer_apply_matches_jax(rng):
    """One BiST reasoning layer (t2s + s2t, hop 1 through the K1 wrapper's
    plain version) against the JAX layer, and against the port's own plain
    mha path with the kernels forced off."""
    jcfg, tcfg = configs(dropout=0.0)
    jp, tp = both_params(jcfg)
    b = np_batch(rng, jcfg)
    b.fts[0, 1:] = 0.0                      # row 0: 1 valid clip of 3
    jmasks = jax_model.build_masks(jcfg, b)
    jft = jax_model.encode(jp, jcfg, b)
    tb = torch_batch(b)
    tmasks = torch_model.build_masks(tcfg, tb)
    tft = torch_model.encode(tp, tcfg, tb)
    for k in tft:
        assert_close(tft[k], jft[k], TOL, f"encode {k}")
    jin = {k: jft["encoded_query"] for k in ("t2s", "s2t")}
    tin = {k: tft["encoded_query"] for k in ("t2s", "s2t")}
    jout = jax_bist.vid_layer_apply(jp["decoder"]["v_layers"][0], jcfg, jin,
                                    jft, jmasks, None)
    launches = hop1_fused.launches
    tout = torch_bist.vid_layer_apply(tp["decoder"]["v_layers"][0], tcfg, tin,
                                      tft, tmasks, None)
    assert hop1_fused.launches == launches          # CPU: plain version only
    with dispatch.force_plain():
        tplain = torch_bist.vid_layer_apply(tp["decoder"]["v_layers"][0], tcfg,
                                            tin, tft, tmasks, None)
    for k in ("t2s", "s2t"):
        assert_close(tout[k], jout[k], TOL, f"vid_layer_apply {k}")
        assert_close(tout[k], tplain[k], 2e-4, f"kernel path vs plain {k}")


@pytest.mark.parametrize("kw", CFG_VARIANTS, ids=variant_id)
def test_modality_step_and_forward_logprobs_match_jax(kw, rng):
    """modality_step (layer 0) and forward_logprobs, with every final-round
    modality feature, for each fusion/pointer/audio variant."""
    jcfg, tcfg = configs(**kw)
    jp, tp = both_params(jcfg)
    b = np_batch(rng, jcfg)
    tb = torch_batch(b)
    with torch.no_grad():
        jmasks = jax_model.build_masks(jcfg, b)
        tmasks = torch_model.build_masks(tcfg, tb)
        for k, m in tmasks.items():
            if m is None:
                assert jmasks[k] is None
            else:
                np.testing.assert_array_equal(m.numpy(), np.asarray(jmasks[k]))
        jft = jax_model.encode(jp, jcfg, b)
        tft = torch_model.encode(tp, tcfg, tb)
        keys = ("t2s", "s2t", "audio", "cap")
        jft1, jin1 = jax_bist.modality_step(
            jp["decoder"], jcfg, 0, {k: jft["encoded_query"] for k in keys},
            jft, jmasks, None)
        tft1, tin1 = torch_bist.modality_step(
            tp["decoder"], tcfg, 0, {k: tft["encoded_query"] for k in keys},
            tft, tmasks, None)
        assert set(tft1) == set(jft1) and set(tin1) == set(jin1)
        for k in tft1:
            assert_close(tft1[k], jft1[k], TOL, f"modality_step ft[{k}]")
        for k in tin1:
            assert_close(tin1[k], jin1[k], TOL, f"modality_step in_ft[{k}]")

        jlogp, jfull = jax_model.forward_logprobs(jp, jcfg, b, rngs=None)
        tlogp, tfull = torch_model.forward_logprobs(tp, tcfg, tb)
    assert tlogp.shape == (2, 6, 50)
    assert_close(tlogp, jlogp, TOL, "forward_logprobs")
    assert set(tfull) == set(jfull)
    for k in tfull:
        assert_close(tfull[k], jfull[k], TOL, f"apply_model ft[{k}]")


@pytest.mark.parametrize("kw", CFG_VARIANTS, ids=variant_id)
def test_incremental_decode_matches_full_forward(kw, rng):
    """The port's precompute_decode_ctx + decode_step over positions equals
    its own full forward (eval mode) on the same prefix, and the
    precomputed context equals the JAX package's."""
    jcfg, tcfg = configs(**kw)
    jp, tp = both_params(jcfg, seed=1)
    B, Lt = 2, 6
    b = np_batch(rng, jcfg, B=B, Lt=Lt)
    trg = rng.integers(4, 50, size=(B, Lt)).astype(np.int32)
    b = b._replace(trg=trg, trg_y=trg)
    tb = torch_batch(b)
    with torch.no_grad():
        full, _ = torch_model.forward_logprobs(tp, tcfg, tb)
        ctx = torch_model.precompute_decode_ctx(tp, tcfg, tb)
        cache = torch_model.init_cache(tcfg, B, Lt)
        steps = []
        for pos in range(Lt):
            lp, cache = torch_model.decode_step(tp, tcfg, ctx, cache,
                                                tb.trg[:, pos], pos)
            steps.append(lp)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-5)
    jctx = jax_model.precompute_decode_ctx(jp, jcfg, b)
    for n, (tkv, jkv) in enumerate(zip(ctx.layer_kv, jctx.layer_kv)):
        assert set(tkv) == set(jkv)
        for name in tkv:
            for t, j in zip(tkv[name], jkv[name]):
                assert_close(t, j, TOL, f"layer {n} cross K/V {name}")
    for ts, js in zip(ctx.ptr_src, jctx.ptr_src):
        for f in ("enc", "k", "onehot"):
            assert_close(getattr(ts, f), getattr(js, f), TOL, f"ptr_src {f}")
        np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))


def test_bf16_model_sends_hop1_and_flash_to_the_kernel_wrappers(rng, monkeypatch):
    """A bfloat16 activation config: hop 1 reaches the K1 wrapper with its
    bfloat16 grid, and with the kv threshold at 0 mha's long-kv branch
    reaches the K3 wrapper at d_k 8: neither dispatch rule looks at the dtype
    or the width.  The log-probs stay close to the float32 config's."""
    jcfg, tcfg = configs(dropout=0.0)
    _, tp = both_params(jcfg)
    tb = torch_batch(np_batch(rng, jcfg))
    grids, flash_dtypes = [], []
    real_hop1, real_flash = torch_bist.hop1_fused, torch_layers.flash_attention

    def hop1_spy(x, q, kv, *a):
        grids.append(kv.dtype)
        return real_hop1(x, q, kv, *a)

    def flash_spy(q, *a, **kw):
        flash_dtypes.append((q.dtype, q.shape[-1]))
        return real_flash(q, *a, **kw)

    monkeypatch.setattr(torch_bist, "hop1_fused", hop1_spy)
    monkeypatch.setattr(torch_layers, "flash_attention", flash_spy)
    monkeypatch.setattr(dispatch, "FLASH_MIN_KV", 0)
    with torch.no_grad():
        low, _ = torch_model.forward_logprobs(tp, tcfg.replace(dtype="bfloat16"), tb)
    assert grids == [torch.bfloat16] * 4            # 2 layers x t2s, s2t
    assert flash_dtypes and all(d == 8 for _, d in flash_dtypes)
    with torch.no_grad():
        ref, _ = torch_model.forward_logprobs(tp, tcfg, tb)
    assert low.dtype == torch.float32
    np.testing.assert_allclose(low.numpy(), ref.numpy(), atol=0.15)


def test_init_model_tree_matches_jax():
    """The port's own init has the JAX tree: same names and shapes."""
    for kw in ({}, {"enc_st_combine": "early_dyn"}, {"nb_aenc_blocks": 2,
                                                     "ft_sizes": (24, 12)}):
        jcfg, tcfg = configs(**kw)
        jp, _ = both_params(jcfg)
        tp = torch_model.init_model(0, tcfg, device=CPU)
        jl, jdef = jax_util_flatten(jp)
        tl, tdef = jax_util_flatten(params_to_jax(tp))
        assert jdef == tdef
        assert [a.shape for a in jl] == [a.shape for a in tl]


def jax_util_flatten(tree):
    return jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, tree))


def test_params_from_jax_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jcfg, tcfg = configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_model.init_model(0, tcfg)


def test_int8_features_bf16_activations_and_dropout(rng, monkeypatch):
    """The int8 feature path (fts_scale dequant) matches the JAX package's;
    a bfloat16 activation config stays close to float32; with a dropout
    generator the forward is stochastic and hop 1 leaves the kernel path."""
    from bist_tpu.data.batching import quantize_features

    jcfg, tcfg = configs(dropout=0.1)
    jp, tp = both_params(jcfg)
    b = np_batch(rng, jcfg)
    q8, scale = quantize_features(b.fts)
    b8 = b._replace(fts=q8, fts_scale=scale)
    jft = jax_model.encode(jp, jcfg, b8)
    tft = torch_model.encode(tp, tcfg, torch_batch(b8))
    assert_close(tft["video_grid"], jft["video_grid"], TOL, "int8 video grid")
    jm, tm = jax_model.build_masks(jcfg, b8), torch_model.build_masks(tcfg, torch_batch(b8))
    np.testing.assert_array_equal(tm["temporal_mask"].numpy(),
                                  np.asarray(jm["temporal_mask"]))

    tb = torch_batch(b)
    with torch.no_grad():
        ref, _ = torch_model.forward_logprobs(tp, tcfg, tb)
        low, _ = torch_model.forward_logprobs(tp, tcfg.replace(dtype="bfloat16"), tb)
        assert low.dtype == torch.float32
        np.testing.assert_allclose(low.numpy(), ref.numpy(), atol=0.15)

        kernel_calls = []
        monkeypatch.setattr(torch_bist, "hop1_fused",
                            lambda *a: kernel_calls.append(1))
        noisy, _ = torch_model.forward_logprobs(tp, tcfg, tb,
                                                rngs=torch.Generator().manual_seed(0))
    assert kernel_calls == [] and torch.isfinite(noisy).all()
    assert not torch.allclose(noisy, ref, atol=1e-3)
    # with or without a gradient: the gradient goes through hop1_trainable
    assert dispatch.hop1_uses_kernel(dropout_active=False)
    assert not dispatch.hop1_uses_kernel(dropout_active=True)
    with dispatch.force_plain():
        assert not dispatch.hop1_uses_kernel(dropout_active=False)
    w = torch.zeros(2, requires_grad=True)
    assert dispatch.needs_grad(w)
    with torch.no_grad():
        assert not dispatch.needs_grad(w)
