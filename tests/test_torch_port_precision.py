"""The decode precision knobs of the port against `bist_tpu` at the same
inputs: GenerateConfig's fields, `encode_cfg`, the decode step with a
bfloat16 step (compute_dtype), a bfloat16 precompute (encode_dtype) and
each float8 cache, `pad_features`, and the generate CLI's choices.

Log-probabilities are compared with limits set from bfloat16 rounding
(bfloat16 keeps 8 significant bits, a relative spacing of 2^-8 to 2^-7):
  * from each package's own precompute, |port - JAX| <= 2^-6·max(|lp|, 1)
    (four spacings; on probabilities at most 2^-6/e, under 1/V at the
    tests' V = 50).  The two packages round their bfloat16 encoders in
    different places, and the context's roundings move a log-probability
    as far as the bfloat16 step itself does;
  * on one context (JAX's, handed to the port exactly), the step alone:
    the same bound, and a mean |port - JAX| <= 2^-10, which the port's
    step at the other compute_dtype must exceed (the control: a port that
    ignored compute_dtype fails it)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bist_tpu.cli import generate as jax_generate
from bist_tpu.config import GenerateConfig as JaxGenerateConfig
from bist_tpu.data import batching as jax_batching
from bist_tpu.models import layers as jax_layers
from bist_tpu.models import model as jax_model
from bist_tpu_torch.cli import generate
from bist_tpu_torch.config import GenerateConfig
from bist_tpu_torch.data import batching
from bist_tpu_torch.decode.beam import beam_search, greedy_decode
from bist_tpu_torch.decode.sample import sample_decode
from bist_tpu_torch.models import bist as torch_bist
from bist_tpu_torch.models import layers
from bist_tpu_torch.models import model as torch_model
from bist_tpu_torch.vocab import SOS
from torch_port_common import both_params, configs, np_batch, torch_batch

# |port - JAX| on log-probabilities, relative to max(|lp|, 1): four
# bfloat16 spacings
LP_REL = 2.0 ** -6
# mean |port - JAX| of the step on one context: a quarter of a spacing
STEP_MEAN = 2.0 ** -10
# mantissa bits of the float8 formats and their smallest subnormal
FP8 = {"float8_e4m3fn": (3, 2.0 ** -9), "float8_e5m2": (2, 2.0 ** -16)}


def test_generate_config_has_bist_tpu_fields_and_defaults():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxGenerateConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(GenerateConfig)}
    assert port_fields == {k: v for k, v in jax_fields.items() if k != "scan_unroll"}
    kw = dict(compute_dtype="bfloat16", encode_dtype="bfloat16", temperature=0.7,
              top_k=5, top_p=0.9, sample_seed=3, cache_dtype="float8_e5m2")
    assert vars(GenerateConfig(**kw)) == {k: v for k, v in
                                          vars(JaxGenerateConfig(**kw)).items()
                                          if k != "scan_unroll"}


@pytest.mark.parametrize("model_dtype", ["float32", "bfloat16"])
def test_encode_cfg_matches_bist_tpu(model_dtype):
    jcfg, tcfg = configs(dtype=model_dtype)
    for enc in ("", "float32", "bfloat16"):
        got = torch_model.encode_cfg(tcfg, enc)
        want = jax_model.encode_cfg(jcfg, enc)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got is tcfg) == (want is jcfg)
    for pkg, cfg in ((torch_model, tcfg), (jax_model, jcfg)):
        with pytest.raises(ValueError, match="encode_dtype"):
            pkg.encode_cfg(cfg, "float16")
    with pytest.raises(ValueError, match="compute_dtype"):
        torch_model.step_dtype("float16")


def test_storage_dtypes_match_bist_tpu():
    assert set(layers.STORAGE_DTYPES) == set(jax_layers._STORAGE_DTYPES)
    for name in layers.STORAGE_DTYPES:
        assert str(layers.storage_dtype(name)).replace("torch.", "") == \
            jnp.dtype(jax_layers.storage_dtype(name)).name
    for pkg in (layers, jax_layers):
        with pytest.raises(ValueError, match="cache_dtype"):
            pkg.storage_dtype("int8")
    x = torch.tensor([0.3, -1.7]).to(torch.float8_e4m3fn)
    assert layers.upcast_fp8(x).dtype == torch.bfloat16
    y = torch.ones(2)
    assert layers.upcast_fp8(y) is y


def fp8_step_close(got, want, fmt, what):
    """|got - want| within one step of the float8 format at their magnitude
    (the two packages round their float32 values, which differ in the last
    bits, to float8 independently)."""
    m, sub = FP8[fmt]
    g = got.detach().float().numpy()
    w = np.asarray(want).astype(np.float32)
    mag = np.maximum(np.abs(g), np.abs(w))
    step = np.where(mag >= 2 * sub * 2 ** m,
                    2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - m), sub)
    bad = np.abs(g - w) > step
    assert not bad.any(), f"{what}: {int(bad.sum())} values more than one {fmt} step apart"


def lp_close(got, want, what):
    """|got - want| <= LP_REL·max(|want|, 1) on log-probabilities."""
    lim = LP_REL * np.maximum(np.abs(want), 1.0)
    bad = np.abs(got - want) > lim
    assert not bad.any(), (f"{what}: {int(bad.sum())} log-probabilities beyond "
                           f"{LP_REL}·max(|lp|, 1), max |diff| {np.abs(got - want).max():.3e}")


KNOBS = [
    # (cache_dtype, compute_dtype, encode_dtype)
    ("float32", "bfloat16", ""),
    ("float32", "float32", "bfloat16"),
    ("bfloat16", "bfloat16", "bfloat16"),
    ("float8_e4m3fn", "float32", ""),
    ("float8_e5m2", "float32", ""),
    ("float8_e4m3fn", "bfloat16", "bfloat16"),
]


@pytest.mark.parametrize("cache,compute,enc", KNOBS, ids=["-".join(k) for k in KNOBS])
def test_decode_steps_match_bist_tpu(rng, cache, compute, enc):
    """Three beam steps (beam 2, the same tokens) from the context the knobs
    give, each package's own: every step's log-probabilities within LP_REL
    of JAX's; the float8 context (and, after float32 steps, the float8
    self-attention cache) within one float8 step of JAX's, stored in the
    float8 type."""
    jcfg, tcfg = configs(dropout=0.0)
    jp, tp = both_params(jcfg)
    b = np_batch(rng, jcfg)
    beam, steps = 2, 3
    jctx = jax_model.precompute_decode_ctx(jp, jax_model.encode_cfg(jcfg, enc), b,
                                           dtype=jax_layers.storage_dtype(cache))
    with torch.no_grad():
        tctx = torch_model.precompute_decode_ctx(tp, torch_model.encode_cfg(tcfg, enc),
                                                 torch_batch(b),
                                                 dtype=layers.storage_dtype(cache))
    sdt = layers.storage_dtype(cache)
    for n, (tkv, jkv) in enumerate(zip(tctx.layer_kv, jctx.layer_kv)):
        for name in tkv:
            for t, j in zip(tkv[name], jkv[name]):
                assert t.dtype == sdt
                if cache in FP8:
                    fp8_step_close(t, j, cache, f"layer {n} {name}")
    for ts, js in zip(tctx.ptr_src, jctx.ptr_src):
        assert ts.k.dtype == ts.enc.dtype == ts.onehot.dtype == sdt
        if cache in FP8:
            fp8_step_close(ts.k, js.k, cache, "pointer keys")
            fp8_step_close(ts.enc, js.enc, cache, "pointer encodings")

    rows = b.query.shape[0] * beam
    jcache = jax_model.init_cache(jcfg, rows, steps + 1, dtype=jax_layers.storage_dtype(cache))
    tcache = torch_model.init_cache(tcfg, rows, steps + 1, dtype=sdt)
    toks = rng.integers(4, jcfg.vocab_size, size=(steps, rows)).astype(np.int32)
    toks[0] = SOS
    jdt = jnp.bfloat16 if compute == "bfloat16" else jnp.float32
    for pos in range(steps):
        jlp, jcache = jax_model.decode_step(jp, jcfg, jctx, jcache, jnp.asarray(toks[pos]),
                                            pos, beam=beam, compute_dtype=jdt)
        with torch.no_grad():
            tlp, tcache = torch_model.decode_step(
                tp, tcfg, tctx, tcache, torch.tensor(toks[pos]), pos, beam=beam,
                compute_dtype=torch_model.step_dtype(compute))
        assert tlp.dtype == torch.float32 and tcache.k[0].dtype == sdt
        got, want = tlp.numpy(), np.asarray(jlp, np.float32)
        assert np.isfinite(got).all()
        lp_close(got, want, f"step {pos}")
    if cache in FP8 and compute == "float32":
        # (a bfloat16 step's cache inputs already differ by bfloat16 roundings)
        for t, j in zip(tcache.k + tcache.v, jcache.k + jcache.v):
            fp8_step_close(t, np.asarray(j.astype(jnp.float32)), cache,
                           "self-attention cache")


def test_precision_knobs_reach_every_decode_style(rng, monkeypatch):
    """beam_search, greedy_decode and sample_decode honour the knobs: with
    encode_dtype bfloat16 hop 1 gets a bfloat16 grid (K1 takes one), and a
    float8 cache decodes to in-vocabulary tokens."""
    jcfg, tcfg = configs(dropout=0.0)
    _, tp = both_params(jcfg)
    tb = torch_batch(np_batch(rng, jcfg))
    grids = []
    real = torch_bist.hop1_fused

    def spy(x, q, kv, *a):
        grids.append(kv.dtype)
        return real(x, q, kv, *a)

    monkeypatch.setattr(torch_bist, "hop1_fused", spy)
    g = GenerateConfig(maxlen=4, beam=2, nbest=2, cache_dtype="float8_e4m3fn",
                       compute_dtype="bfloat16", encode_dtype="bfloat16")
    res = beam_search(tp, tcfg, tb, g)
    assert res.tokens.shape == (2, 2, 4) and torch.isfinite(res.scores[:, 0]).all()
    out = greedy_decode(tp, tcfg, tb, 4, cache_dtype="float8_e5m2", encode_dtype="bfloat16",
                        compute_dtype="bfloat16")
    out2 = sample_decode(tp, tcfg, tb, 4, 0, cache_dtype="float8_e4m3fn",
                         encode_dtype="bfloat16", row_seeds=[1, 2])
    for o in (out, out2):
        assert o.shape == (2, 4) and ((o >= 0) & (o < tcfg.vocab_size)).all()
    assert grids == [torch.bfloat16] * 12          # 3 decodes x 2 layers x t2s, s2t
    grids.clear()
    greedy_decode(tp, tcfg, tb, 2)
    assert grids == [torch.float32] * 4


def test_pad_features_matches_bist_tpu(rng):
    fts = [rng.standard_normal((t, 4, 6)).astype(np.float32) for t in (3, 7, 5)]
    for t_len, tail, pad_rows in ((8, None, 0), (5, (4, 6), 2), (4, None, 1)):
        got = batching.pad_features(fts, t_len, tail=tail, pad_rows=pad_rows)
        want = jax_batching.pad_features(fts, t_len, tail=tail, pad_rows=pad_rows)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_generate_cli_takes_every_choice_of_bist_tpu():
    def choices(parser, flag):
        return next(a.choices for a in parser._actions if flag in a.option_strings)

    port, ref = generate.build_parser(), jax_generate.build_parser()
    for flag in ("--cache-dtype", "--encode-dtype"):
        assert choices(port, flag) == choices(ref, flag), flag
        for value in choices(ref, flag):
            args = port.parse_args([flag, value])
            assert getattr(args, flag[2:].replace("-", "_")) == value
    assert port.parse_args(["--scan-unroll", "8"]).scan_unroll == 8


def port_ctx_from_jax(jctx, tctx):
    """JAX's decode context in the port's structure, exactly: each array in
    the dtype of the port's own tensor at that place (the float8 and
    bfloat16 values are representable there); the masks are the port's,
    made from the same tokens."""
    def conv(j, t):
        out = torch.tensor(np.asarray(j).astype(np.float32)).to(t.dtype)
        assert out.shape == t.shape
        return out

    kv = tuple({name: tuple(conv(j, t) for j, t in zip(jd[name], td[name])) for name in td}
               for jd, td in zip(jctx.layer_kv, tctx.layer_kv))
    ptr = tuple(type(ts)(*[conv(j, t) for j, t in zip(js, ts)])
                for js, ts in zip(jctx.ptr_src, tctx.ptr_src))
    return type(tctx)(layer_kv=kv, masks=tctx.masks, ptr_src=ptr)


@pytest.mark.parametrize("cache,compute,enc", KNOBS, ids=["-".join(k) for k in KNOBS])
def test_decode_step_on_one_context_honours_compute_dtype(rng, cache, compute, enc):
    """The step alone: three beam steps on JAX's context (the knobs'
    precompute and cache dtype), the port's against JAX's, within LP_REL and
    a mean within STEP_MEAN; the port's step at the other compute_dtype on
    the same context beyond STEP_MEAN (the control)."""
    jcfg, tcfg = configs(dropout=0.0)
    jp, tp = both_params(jcfg)
    b = np_batch(rng, jcfg)
    beam, steps = 2, 3
    jdt = jax_layers.storage_dtype(cache)
    jctx = jax_model.precompute_decode_ctx(jp, jax_model.encode_cfg(jcfg, enc), b,
                                           dtype=jdt)
    sdt = layers.storage_dtype(cache)
    with torch.no_grad():
        tctx = torch_model.precompute_decode_ctx(tp, torch_model.encode_cfg(tcfg, enc),
                                                 torch_batch(b), dtype=sdt)
    ctx = port_ctx_from_jax(jctx, tctx)
    rows = b.query.shape[0] * beam
    toks = rng.integers(4, jcfg.vocab_size, size=(steps, rows)).astype(np.int32)
    toks[0] = SOS

    jcache = jax_model.init_cache(jcfg, rows, steps + 1, dtype=jdt)
    want = []
    for pos in range(steps):
        jlp, jcache = jax_model.decode_step(
            jp, jcfg, jctx, jcache, jnp.asarray(toks[pos]), pos, beam=beam,
            compute_dtype=jnp.bfloat16 if compute == "bfloat16" else jnp.float32)
        want.append(np.asarray(jlp, np.float32))
    want = np.stack(want)

    def port_steps(step_dtype):
        cache_t = torch_model.init_cache(tcfg, rows, steps + 1, dtype=sdt)
        out = []
        with torch.no_grad():
            for pos in range(steps):
                lp, cache_t = torch_model.decode_step(
                    tp, tcfg, ctx, cache_t, torch.tensor(toks[pos]), pos, beam=beam,
                    compute_dtype=torch_model.step_dtype(step_dtype))
                out.append(lp.numpy())
        return np.stack(out)

    got = port_steps(compute)
    lp_close(got, want, "the step on JAX's context")
    mean = np.abs(got - want).mean()
    assert mean <= STEP_MEAN, f"mean |diff| {mean:.3e} > {STEP_MEAN}"
    other = port_steps("float32" if compute == "bfloat16" else "bfloat16")
    control = np.abs(other - want).mean()
    assert control > STEP_MEAN, (f"the control: a step at the other compute_dtype "
                                 f"passes too (mean |diff| {control:.3e})")

