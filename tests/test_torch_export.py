"""The port's serving bundles (`bist_tpu_torch.export`) on the CPU at a tiny
size, case by case after `tests/test_export.py`: each bundle is exported
once (module fixtures) and held against the port's `DecodeProgram` (tokens,
scores and lengths identical) and against `bist_tpu`'s jitted decoders on
the same numpy-seeded weights and batch (tokens and lengths identical,
scores to 1e-4: two frameworks' float32 sums).  K1 and K3 are registered
ops: every exported graph holds K1's op (t2s and s2t in each video layer)
and no weight."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from bist_tpu import export as jax_export
from bist_tpu.config import GenerateConfig as JaxGenerateConfig
from bist_tpu.config import ModelConfig as JaxModelConfig
from bist_tpu.decode import beam as jax_beam
from bist_tpu.models.model import init_model as jax_init_model
from bist_tpu_torch import export
from bist_tpu_torch.config import GenerateConfig, ModelConfig
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.decode import beam
from bist_tpu_torch.decode.compiled import DecodeProgram
from bist_tpu_torch.ops import bist_kernels, flash_attention
from bist_tpu_torch.serving import Request, Responder
from bist_tpu_torch.vocab import EOS, PAD, SOS, SPECIALS
from bist_tpu_torch.weights import params_from_jax
from torch_threads import two_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
SCORE_TOL = 1e-4
FIELDS = dict(vocab_size=0, nb_blocks=1, nb_venc_blocks=1, nb_cenc_blocks=1, d_model=16,
              att_h=2, dropout=0.0, include_caption="summary", separate_caption=True,
              ft_sizes=(8,))
GEN = dict(maxlen=4, beam=2, penalty=1.0, nbest=2)
K1 = torch.ops.bist_tpu_torch.hop1_fwd.default


@pytest.fixture(scope="module")
def setup():
    vocab = dict(SPECIALS)
    for w in "a the man is walking what doing he yes no couch dog".split():
        vocab[w] = len(vocab)
    fields = dict(FIELDS, vocab_size=len(vocab))
    jcfg, cfg = JaxModelConfig(**fields), ModelConfig(**fields)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    return vocab, jcfg, cfg, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), CPU)


def geometries(cfg, **kw):
    return export.default_serving_geometries(
        cfg, **dict(dict(batch_buckets=(2,), Lq=8, Lh=(8, 16), Lc=8, T=4, S=4), **kw))


@pytest.fixture(scope="module")
def beam_bundle(setup, tmp_path_factory):
    """A beam-search bundle of two geometries (histories of 8 and 16),
    exported by two worker processes."""
    vocab, _, cfg, _, params = setup
    path = str(tmp_path_factory.mktemp("beam") / "b")
    written = export.save_bundle(path, params, cfg, GenerateConfig(**GEN), vocab,
                                 geometries(cfg), workers=2)
    return path, written, export.load_bundle(path, CPU)


@pytest.fixture(scope="module")
def greedy_bundle(setup, tmp_path_factory):
    vocab, _, cfg, _, params = setup
    path = str(tmp_path_factory.mktemp("greedy") / "g")
    export.save_bundle(path, params, cfg, GenerateConfig(maxlen=4, decode_style="greedy"),
                       vocab, geometries(cfg, Lh=8))
    return export.load_bundle(path, CPU)


def concrete_batch(geom, cfg, seed=0):
    """A numpy batch of geometry `geom` (tests/test_export.py's)."""
    rng = np.random.default_rng(seed)

    def tok(L):
        x = rng.integers(4, cfg.vocab_size, size=(geom["B"], L)).astype(np.int32)
        x[:, 0] = SOS
        if L > 2:
            x[:, -2] = EOS
            x[:, -1] = PAD
        return x

    fts = rng.standard_normal((geom["B"], geom["T"], geom["S"], geom["Dv"])) \
        .astype(np.float32) if "T" in geom else None
    return Batch(query=tok(geom["Lq"]), his=tok(geom["Lh"]), trg=tok(geom["Lt"]),
                 trg_y=tok(geom["Lt"]), cap=tok(geom["Lc"]) if "Lc" in geom else None,
                 fts=fts, audio_fts=None, fts_scale=None)


def as_torch(batch):
    return Batch(*[None if x is None else torch.from_numpy(x) for x in batch])


def identical(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_params_npz_interchangeable_with_bist_tpu(setup, tmp_path):
    """The flat keys and arrays are bist_tpu's, and a params.npz written by
    either package loads into the other's tree."""
    _, jcfg, cfg, jp, params = setup
    flat, jflat = export.flatten_params(params), jax_export.flatten_params(jp)
    assert list(flat) == list(jflat)
    for k in jflat:
        np.testing.assert_array_equal(flat[k], jflat[k], err_msg=k)
    back = export.unflatten_params(flat, cfg, CPU)
    for (k, a), (_, b) in zip(export._paths(back), export._paths(params)):
        assert torch.equal(a, b), k
    np.savez(tmp_path / "port.npz", **flat)
    np.savez(tmp_path / "jax.npz", **jflat)
    with np.load(tmp_path / "port.npz") as z:
        from_port = jax_export.unflatten_params(dict(z), jcfg)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(from_port),
                                jax.tree_util.tree_leaves_with_path(jp)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(tmp_path / "jax.npz") as z:
        from_jax = export.unflatten_params(dict(z), cfg, CPU)
    for (k, a), (_, b) in zip(export._paths(from_jax), export._paths(params)):
        assert torch.equal(a, b), k
    del flat[next(iter(flat))]
    with pytest.raises(KeyError, match="params.npz is missing"):
        export.unflatten_params(flat, cfg, CPU)
    bad = dict(jflat, **{"['embed']['lut']": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="config-implied"):
        export.unflatten_params(bad, cfg, CPU)


def test_bundle_equals_program_and_bist_tpu(setup, beam_bundle):
    """Every geometry's program gives the DecodeProgram's outputs exactly
    and bist_tpu's beam_search_jit tokens on the same weights and batch."""
    _, jcfg, cfg, jp, params = setup
    _, _, bundle = beam_bundle
    assert bundle.cfg == cfg and bundle.gcfg == GenerateConfig(**GEN)
    program = DecodeProgram(params, cfg, GenerateConfig(**GEN))
    for i, geom in enumerate(bundle.geometries.values()):
        b = concrete_batch(geom, cfg, seed=i)
        got = bundle.beam_fn()(bundle.params, as_torch(b))
        identical(got, program(b))
        jr = jax_beam.beam_search_jit(jp, jcfg, b, JaxGenerateConfig(**GEN))
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(jr.tokens))
        np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(jr.lengths))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(jr.scores),
                                   rtol=SCORE_TOL, atol=SCORE_TOL)


def test_exported_graphs_hold_k1_and_no_weights(setup, beam_bundle):
    _, _, cfg, _, _ = setup
    path, written, bundle = beam_bundle
    assert sorted(written) == sorted(f"cpu/{k}" for k in bundle.geometries)
    assert all(os.path.exists(p) for p in written.values())
    for key, ep in bundle.programs.items():
        nodes = [n for n in ep.graph.nodes if n.target is K1]
        assert len(nodes) == 2 * cfg.nb_venc_blocks, key      # t2s and s2t a layer
        assert len(ep.state_dict) == 0, key
        # one constant, the positional table (no host scalar for a graph to copy)
        assert [tuple(t.shape) for t in ep.constants.values()] == [(cfg.max_pos, cfg.d_model)]
        assert not any(tuple(t.shape) == tuple(bundle.params["embed"]["lut"].shape)
                       for t in ep.constants.values())


def test_unknown_geometry_raises(setup, beam_bundle):
    _, _, cfg, _, _ = setup
    _, _, bundle = beam_bundle
    other = dict(next(iter(bundle.geometries.values())), B=4)
    with pytest.raises(KeyError, match="no exported program"):
        bundle.beam_fn()(bundle.params, as_torch(concrete_batch(other, cfg)))
    program = DecodeProgram(bundle.params, cfg, bundle.gcfg, beam_fn=bundle.beam_fn())
    with pytest.raises(KeyError, match="no exported program"):
        program(concrete_batch(other, cfg))
    assert program.stats()["geometries"] == 0


def test_weight_swap_without_reexport(setup, beam_bundle, tmp_path):
    """Parameters are arguments: other weights through the same programs
    give those weights' search, from the call or from a swapped
    params.npz (`reload_params`)."""
    _, _, cfg, _, _ = setup
    path, written, bundle = beam_bundle
    geom = next(iter(bundle.geometries.values()))
    b = as_torch(concrete_batch(geom, cfg))
    base = bundle.beam_fn()(bundle.params, b)
    from bist_tpu_torch.models.model import init_model
    swapped_params = init_model(7, cfg, device=CPU)
    swapped = bundle.beam_fn()(swapped_params, b)
    assert not torch.equal(base.scores, swapped.scores)
    identical(swapped, beam.beam_search(swapped_params, cfg, b, bundle.gcfg))

    import shutil
    copy = str(tmp_path / "swap")
    shutil.copytree(path, copy)
    mtimes = {p: os.path.getmtime(p) for p in written.values()}
    np.savez(os.path.join(copy, "params.npz"), **export.flatten_params(swapped_params))
    again = dataclasses.replace(bundle, path=copy)
    again.reload_params()
    identical(again.make_responder().program(b), swapped)
    assert mtimes == {p: os.path.getmtime(p) for p in written.values()}


def requests(rsp, n, seed=0, t=4, history="a man is walking"):
    rng = np.random.default_rng(seed)
    return [Request(question=rsp.tokenize("what is he doing"),
                    history=rsp.tokenize(history), caption=rsp.tokenize("the dog"),
                    features=rng.standard_normal((t, 4, 8)).astype(np.float32))
            for _ in range(n)]


def test_bundle_responder_end_to_end(setup, beam_bundle):
    """make_responder derives its buckets from the table and serves through
    the programs the answers of a DecodeProgram Responder with the same
    buckets."""
    vocab, _, cfg, _, params = setup
    _, _, bundle = beam_bundle
    rsp = bundle.make_responder()
    assert rsp.batch_buckets == (2,) and rsp.h_buckets == (8, 16)
    assert rsp.q_buckets == (8,) and rsp.feat_tail == (4, 8) and rsp.time_buckets == (4,)
    plain = Responder(params, cfg, vocab, bundle.gcfg, max_batch=2, batch_buckets=(2,),
                      len_buckets={"q": (8,), "h": (8, 16), "c": (8,)},
                      time_buckets=(4,), feat_tail=(4, 8))
    for history in ("a man", "a man is walking " * 3):
        got, want = requests(rsp, 2, history=history), requests(plain, 2, history=history)
        rsp.respond(got)
        plain.respond(want)
        assert [r._nbest for r in got] == [r._nbest for r in want]
        assert all(isinstance(r._answer, str) for r in got)
    assert rsp.program.stats()["geometries"] == 2


def test_warmup_geometries_covers_table(beam_bundle):
    """warmup_geometries runs every program of the table once; serving at
    those geometries then adds none."""
    _, _, bundle = beam_bundle
    rsp = bundle.make_responder()
    rsp.warmup_geometries(bundle.geometries.values())
    assert rsp.program.stats()["geometries"] == len(bundle.geometries)
    for history in ("a man", "a man is walking " * 3):
        rsp.respond(requests(rsp, 1, history=history))
    assert rsp.program.stats()["geometries"] == len(bundle.geometries)


def test_greedy_bundle(setup, greedy_bundle):
    """A greedy bundle's ids equal the DecodeProgram's and bist_tpu's jitted
    greedy_decode's, and its Responder serves."""
    _, jcfg, cfg, jp, params = setup
    bundle = greedy_bundle
    geom = next(iter(bundle.geometries.values()))
    b = concrete_batch(geom, cfg)
    got = bundle.beam_fn()(bundle.params, as_torch(b))
    assert torch.equal(got, DecodeProgram(params, cfg, bundle.gcfg)(b))
    want = jax.jit(lambda p, x: jax_beam.greedy_decode(p, jcfg, x, 4))(jp, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for key, ep in bundle.programs.items():
        assert sum(n.target is K1 for n in ep.graph.nodes) == 2 * cfg.nb_venc_blocks
    rsp = bundle.make_responder()
    reqs = requests(rsp, 1)
    rsp.respond(reqs)
    assert isinstance(reqs[0]._answer, str)


def test_geometries_match_bist_tpu():
    """geometry_key and default_serving_geometries give bist_tpu's keys and
    lists, the audio cross product of time buckets included."""
    fields = dict(FIELDS, vocab_size=8)
    audio = dict(fields, nb_aenc_blocks=1, ft_sizes=(8, 4))
    for kw, cases in ((fields, [dict(batch_buckets=(2,), Lq=8, Lh=(8, 16), Lc=8, T=4, S=4),
                                dict(Lq=(16, 32), Lh=(64, 256), T=(16, 32), feat_int8=True)]),
                      (dict(fields, nb_venc_blocks=0, ft_sizes=()), [dict()]),
                      (audio, [dict(batch_buckets=(2,), Lq=8, Lh=8, Lc=8, T=(4, 8)),
                               dict(batch_buckets=(2,), Lq=8, Lh=8, Lc=8, T=(4, 8), Ta=4)])):
        for case in cases:
            got = export.default_serving_geometries(ModelConfig(**kw), **case)
            want = jax_export.default_serving_geometries(JaxModelConfig(**kw), **case)
            assert got == want
            assert [export.geometry_key(g) for g in got] == \
                [jax_export.geometry_key(g) for g in want]
    geoms = export.default_serving_geometries(ModelConfig(**audio), batch_buckets=(2,),
                                              Lq=8, Lh=8, Lc=8, T=(4, 8))
    assert {(g["T"], g["Ta"]) for g in geoms} == {(4, 4), (4, 8), (8, 4), (8, 8)}
    cfg = ModelConfig(**fields)
    geom = geometries(cfg)[0]
    b = concrete_batch(geom, cfg)
    assert export.geometry_key(export.geometry_of(b)) == export.geometry_key(geom) \
        == jax_export.geometry_key(jax_export.geometry_of(b))
    assert export.geometry_key(export.geometry_of(as_torch(b))) == export.geometry_key(geom)


def test_unsupported_styles_and_dp_raise(setup, tmp_path):
    vocab, _, cfg, _, params = setup
    geoms = geometries(cfg, Lh=8)
    for style in ("sample", "oracle"):
        with pytest.raises(ValueError, match="decode_style"):
            export.save_bundle(str(tmp_path / style), params, cfg,
                               GenerateConfig(decode_style=style), vocab, geoms)
    # data-parallel bundles are ported (tests/test_torch_parallel_cli.py):
    # a dp that does not divide a geometry's rows is refused, and so is a
    # device list that is not the bundle's dp wide
    with pytest.raises(ValueError, match="not divisible by dp=3"):
        export.save_bundle(str(tmp_path / "dp"), params, cfg, GenerateConfig(**GEN), vocab,
                           geoms, dp=3)
    with pytest.raises(ValueError, match="exported data-parallel over 2"):
        Responder(params, cfg, vocab, GenerateConfig(**GEN), beam_fn=lambda p, b: None,
                  beam_fn_devices=2, devices=["cpu"])
    assert not os.listdir(tmp_path)


def test_bundle_style_validated_at_construction(setup):
    """A Responder built around a bundle's programs (beam_fn) validates the
    decode style at construction (tests/test_serving.py's case)."""
    vocab, _, cfg, _, params = setup
    fake_fn = lambda p, b: None  # noqa: E731 — never called
    with pytest.raises(ValueError, match="sample"):
        Responder(params, cfg, vocab, GenerateConfig(maxlen=4, decode_style="sample"),
                  beam_fn=fake_fn)
    with pytest.raises(ValueError, match="decode_style"):
        Responder(params, cfg, vocab, GenerateConfig(maxlen=4, decode_style="bogus"),
                  beam_fn=fake_fn)


def test_load_refuses_other_formats_and_devices(beam_bundle, tmp_path):
    """A bist_tpu bundle is refused by its format, and a device type the
    bundle was not exported on is refused by name."""
    import json
    import shutil

    path, _, _ = beam_bundle
    other = str(tmp_path / "jax")
    shutil.copytree(path, other)
    with open(os.path.join(other, "bundle.json")) as f:
        meta = json.load(f)
    with open(os.path.join(other, "bundle.json"), "w") as f:
        json.dump(dict(meta, format=jax_export.FORMAT), f)
    with pytest.raises(ValueError, match="bist_tpu_torch.bundle.v1"):
        export.load_bundle(other, CPU)
    with pytest.raises(ValueError, match=r"exported on \['cpu'\]"):
        export.load_bundle(path, torch.device("meta"))


def test_registered_ops_hold_their_plain_versions():
    """K1's and K3's ops: on CPU tensors their plain versions, their fakes
    the right shapes, checked by torch.library.opcheck; K3 exports as a
    node of its op."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    B, G, Lq, Lk, D, h = 2, 3, 4, 5, 16, 2
    x, q, kv = t(B, Lq, D), t(B, Lq, D), t(B, G, Lk, D)
    w = [t(D, D) if i % 2 == 0 else t(D) for i in range(6)]
    mask = torch.ones((B, 1, Lk), dtype=torch.int32)
    mask[0, 0, -2:] = 0
    p = bist_kernels._attn_params(*w)
    for m in (mask, None):
        torch.library.opcheck(bist_kernels.hop1_fwd_op, (x, q, kv, *w, m, h))
        assert torch.equal(bist_kernels.hop1_fused(x, q, kv, p, h, m),
                           bist_kernels.hop1_plain(x, q, kv, p, h, m))
    qf, kf, vf = t(3, 4, 8), t(3, 6, 8), t(3, 6, 8)
    fmask = torch.ones((3, 6), dtype=torch.int32)
    torch.library.opcheck(flash_attention.flash_fwd_op, (qf, kf, vf, fmask, 0.25))
    assert torch.equal(flash_attention.flash_attention(qf, kf, vf, fmask),
                       flash_attention.attention_plain(qf, kf, vf, fmask))

    class Attend(torch.nn.Module):
        def forward(self, q, k, v, m):
            return flash_attention.flash_attention(q, k, v, m)

    ep = torch.export.export(Attend(), (qf, kf, vf, fmask), strict=False)
    assert [n.target for n in ep.graph.nodes if n.op == "call_function"] == \
        [torch.ops.bist_tpu_torch.flash_fwd.default]
    assert torch.equal(ep.module()(qf, kf, vf, fmask),
                       flash_attention.attention_plain(qf, kf, vf, fmask))
