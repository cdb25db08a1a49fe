"""The port's compiled decoding (`bist_tpu_torch.decode.compiled`) on the CPU
at a tiny size (d_model 32, 4 heads, 2/2/2 blocks, float32): a
`DecodeProgram` runs its stages eagerly on its static buffers here, with
the copy-in and copy-out it uses around a CUDA graph on the card.  Held
against the JAX package's jitted decoders on the same weights and batch
(tokens and lengths identical, scores to 1e-4: two frameworks' float32
sums) and against the port's eager functions (every output identical)."""

import jax
import numpy as np
import pytest
import torch

from bist_tpu.config import GenerateConfig as JaxGenerateConfig
from bist_tpu.decode import beam as jax_beam
from bist_tpu_torch.config import GenerateConfig
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.decode import beam, sample
from bist_tpu_torch.decode.compiled import DecodeProgram, describe
from torch_port_common import both_params, configs, np_batch, torch_batch

SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = configs(dropout=0.0)
    jp, tp = both_params(jcfg, seed=3)
    return jcfg, tcfg, jp, tp


def identical(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("gkw", [
    dict(maxlen=5, beam=3, penalty=1.0, nbest=4),
    dict(maxlen=6, beam=4, penalty=2.0, nbest=5, dec_eos=True, min_len=2),
    dict(maxlen=12, beam=3, penalty=-1.0, nbest=3, early_exit=True),
], ids=["beam3", "beam4-dec_eos", "early_exit"])
def test_beam_program_matches_bist_tpu_jit(model, gkw, rng):
    jcfg, tcfg, jp, tp = model
    b = np_batch(rng, jcfg, B=3)
    jr = jax_beam.beam_search_jit(jp, jcfg, b, JaxGenerateConfig(**gkw))
    gcfg = GenerateConfig(**gkw)
    prog = DecodeProgram(tp, tcfg, gcfg)
    stops = []
    if gcfg.early_exit:          # record the steps the program got to
        check = prog._stop
        prog._stop = lambda s, i: stops.append(i) or check(s, i)
    tr = prog(b)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    identical(tr, beam.beam_search(tp, tcfg, torch_batch(b), gcfg))
    if gcfg.early_exit:          # the bound stopped it before maxlen steps
        assert stops and stops[-1] < gcfg.maxlen


def test_ensemble_program_matches_bist_tpu_jit(rng):
    jcfg, tcfg = configs(dropout=0.0)
    jp0, tp0 = both_params(jcfg, seed=3)
    jp1, tp1 = both_params(jcfg, seed=4)
    b = np_batch(rng, jcfg, B=3)
    gkw = dict(maxlen=5, beam=3, penalty=1.0, nbest=4)
    jr = jax_beam.beam_search_jit([jp0, jp1], jcfg, b, JaxGenerateConfig(**gkw))
    tr = DecodeProgram([tp0, tp1], tcfg, GenerateConfig(**gkw))(b)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    identical(tr, beam.beam_search([tp0, tp1], tcfg, torch_batch(b), GenerateConfig(**gkw)))


@pytest.mark.parametrize("style", ["greedy", "oracle"])
def test_greedy_and_oracle_programs_match_bist_tpu_jit(model, style, rng):
    jcfg, tcfg, jp, tp = model
    b = np_batch(rng, jcfg, B=3, Lt=8)
    if style == "greedy":
        want = jax.jit(lambda p, x: jax_beam.greedy_decode(p, jcfg, x, 7))(jp, b)
        eager = beam.greedy_decode(tp, tcfg, torch_batch(b), 7)
    else:
        want = jax.jit(lambda p, x: jax_beam.oracle_decode(p, jcfg, x))(jp, b)
        eager = beam.oracle_decode(tp, tcfg, torch_batch(b))
    got = DecodeProgram(tp, tcfg, GenerateConfig(maxlen=7, decode_style=style))(b)
    assert got.dtype == torch.int32 and got.shape == eager.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, eager)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float8_e4m3fn"])
def test_programs_on_low_precision_caches_equal_eager(model, cache_dtype, rng):
    """The decode memory's storage knob: beam search and greedy through the
    program give the eager functions' outputs bit for bit."""
    jcfg, tcfg, _, tp = model
    b = np_batch(rng, jcfg, B=3)
    g = GenerateConfig(maxlen=5, beam=3, penalty=1.0, nbest=3, cache_dtype=cache_dtype)
    identical(DecodeProgram(tp, tcfg, g)(b), beam.beam_search(tp, tcfg, torch_batch(b), g))
    greedy = DecodeProgram(tp, tcfg, GenerateConfig(**dict(vars(g), decode_style="greedy")))(b)
    assert torch.equal(greedy, beam.greedy_decode(tp, tcfg, torch_batch(b), 5,
                                                  cache_dtype=cache_dtype))


def test_sample_program_reproducible_per_row_seed_and_batch_invariant(model, rng):
    """Sampling through the program: the eager sample_decode's tokens from
    the same (seed, row seeds); a row draws the same alone, in another order
    or beside other rows; the seed defaults to gcfg.sample_seed."""
    jcfg, tcfg, _, tp = model
    b = np_batch(rng, jcfg, B=4)
    kw = dict(temperature=2.0, top_k=20, top_p=0.95)
    prog = DecodeProgram(tp, tcfg, GenerateConfig(maxlen=8, decode_style="sample",
                                                  sample_seed=2, **kw))
    seeds = [10, 11, 12, 13]
    full = prog(b, row_seeds=seeds)
    assert torch.equal(full, sample.sample_decode(tp, tcfg, torch_batch(b), 8, 2,
                                                  row_seeds=seeds, **kw))
    assert torch.equal(prog(b, seed=2, row_seeds=seeds), full)
    order = [2, 0, 3, 1]
    perm = Batch(*[None if f is None else f[order] for f in b])
    assert torch.equal(prog(perm, row_seeds=[seeds[i] for i in order]), full[order])
    pair = Batch(*[None if f is None else f[[1, 3]] for f in b])
    assert torch.equal(prog(pair, row_seeds=[11, 13]), full[[1, 3]])
    other = prog(b, row_seeds=[10, 99, 12, 13])
    assert torch.equal(other[[0, 2, 3]], full[[0, 2, 3]])
    assert not torch.equal(prog(b, seed=3, row_seeds=seeds), full)
    assert torch.equal(prog(b, seed=5), sample.sample_decode(tp, tcfg, torch_batch(b), 8,
                                                             5, **kw))
    with pytest.raises(ValueError, match="row seeds"):
        prog(b, row_seeds=[1, 2])


@pytest.mark.parametrize("style", ["beam_search", "greedy"])
def test_results_survive_later_batches(model, style, rng):
    """Two batches of one geometry and one of another: the first batch's
    results, read after the other two ran on the same static buffers, equal
    its direct eager answer; the program keeps two entries."""
    jcfg, tcfg, _, tp = model
    g = GenerateConfig(maxlen=5, beam=3, penalty=1.0, nbest=3, decode_style=style)
    prog = DecodeProgram(tp, tcfg, g)
    first, second = np_batch(rng, jcfg, B=3), np_batch(rng, jcfg, B=3)
    other = np_batch(rng, jcfg, B=2, Lq=9)

    def eager(x):
        if style == "beam_search":
            return beam.beam_search(tp, tcfg, torch_batch(x), g)
        return beam.greedy_decode(tp, tcfg, torch_batch(x), g.maxlen)

    outs = [prog(x) for x in (first, second, other)]
    for out, x in zip(outs, (first, second, other)):
        want = eager(x)
        if style == "beam_search":
            identical(out, want)
        else:
            assert torch.equal(out, want)
    if style == "beam_search":
        assert not torch.equal(outs[0].tokens, outs[1].tokens)
    stats = prog.stats()
    assert stats["geometries"] == 2 and len(prog._entries) == 2
    # nothing is captured on the CPU: the stages run eagerly every call
    assert stats["captures"] == stats["eager_runs"] == 0 and stats["pool_bytes"] == 0


def test_geometry_key_and_shared_static_inputs(model, rng):
    """A geometry is the style and every present field's shape and dtype: a
    numpy batch and the same batch as CPU tensors are one geometry; a new
    token length is another, which shares the grid's static input."""
    jcfg, tcfg, _, tp = model
    prog = DecodeProgram(tp, tcfg, GenerateConfig(maxlen=4, decode_style="greedy"))
    b = np_batch(rng, jcfg, B=2)
    a = prog(b)
    assert torch.equal(prog(torch_batch(b)), a)
    assert prog.stats()["geometries"] == 1
    prog(np_batch(rng, jcfg, B=2, Lh=11))
    assert prog.stats()["geometries"] == 2
    grids = [k for k in prog._buffers if k[0] == "fts"]
    assert len(grids) == 1
    desc = describe(list(prog._entries)[1])
    assert desc.startswith("greedy: ") and "his (2, 11) int32" in desc


def test_geometries_list_what_the_program_entered(model, rng):
    """`geometries()` gives each geometry entered, in order, as
    `export.geometry_of` describes a batch of it."""
    from bist_tpu_torch.export import geometry_of

    jcfg, tcfg, _, tp = model
    prog = DecodeProgram(tp, tcfg, GenerateConfig(maxlen=4, decode_style="greedy"))
    b1, b2 = np_batch(rng, jcfg, B=2), np_batch(rng, jcfg, B=3, Lh=11)
    for b in (b1, b2, b1):
        prog(b)
    assert prog.geometries() == [geometry_of(b1), geometry_of(b2)]
    assert prog.geometries()[1]["Lh"] == 11 and prog.geometries()[1]["B"] == 3


def test_program_rejects_what_it_cannot_decode(model):
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match="decode style"):
        DecodeProgram(tp, tcfg, GenerateConfig(decode_style="bogus"))
    with pytest.raises(ValueError, match="ensemble"):
        DecodeProgram([tp, tp], tcfg, GenerateConfig(decode_style="greedy"))


def test_responder_decodes_through_its_program(rng):
    """The serving Responder's decode is its program: warmup() enters one
    geometry per batch bucket, and a served group of a warmed geometry adds
    none (on the card: no capture and no eager run after warmup)."""
    from bist_tpu_torch.models.model import init_model
    from bist_tpu_torch.serving import Responder
    from bist_tpu_torch.vocab import SPECIALS

    vocab = dict(SPECIALS)
    for w in "a the man is walking what doing he".split():
        vocab[w] = len(vocab)
    _, tcfg = configs(dropout=0.0, vocab_size=len(vocab), nb_blocks=1, nb_venc_blocks=1,
                      nb_cenc_blocks=1, d_model=16, att_h=2, ft_sizes=(8,))
    params = init_model(0, tcfg, device="cpu")
    rsp = Responder(params, tcfg, vocab, GenerateConfig(maxlen=4, beam=2, nbest=2),
                    max_batch=4, len_buckets=(8,), time_buckets=(8,))
    assert isinstance(rsp.program, DecodeProgram) and rsp.program.style == "beam_search"
    rsp.warmup(feature_shape=(4, 8), t_clips=8, lens=(8,))
    assert rsp.program.stats()["geometries"] == len(rsp.batch_buckets)
    fts = rng.standard_normal((6, 4, 8)).astype(np.float32)
    reqs = [rsp.make_request("what is he doing", "a man is walking", "the man", fts)
            for _ in range(3)]
    rsp.respond(reqs)
    assert rsp.program.stats()["geometries"] == len(rsp.batch_buckets)
    # its geometries, given back to warmup_geometries, are the same ones
    rsp.warmup_geometries(rsp.program.geometries())
    assert rsp.program.stats()["geometries"] == len(rsp.batch_buckets)
    want = beam.beam_search(params, tcfg, rsp.make_batch(reqs), rsp.gcfg)
    hyps = beam.extract_hyps(want, rsp.id2word, 0, rsp.gcfg.nbest)
    assert reqs[0]._answer == " ".join(hyps[0][0])


@pytest.mark.parametrize("beam_fn", [None, lambda p, b: None], ids=["stages", "beam_fn"])
def test_unused_program_is_freed_without_the_cyclic_collector(model, beam_fn):
    """A program holds no reference cycle, so dropping it frees its graphs at
    once: left to the cyclic collector, they could be destroyed while
    another program captures, which CUDA forbids (the capture fails)."""
    import gc
    import weakref

    _, tcfg, _, tp = model
    gcfg = GenerateConfig(maxlen=4, beam=2, decode_style="greedy" if beam_fn else "beam_search")
    was = gc.isenabled()
    gc.disable()
    try:
        ref = weakref.ref(DecodeProgram(tp, tcfg, gcfg, beam_fn=beam_fn))
        assert ref() is None
    finally:
        if was:
            gc.enable()
