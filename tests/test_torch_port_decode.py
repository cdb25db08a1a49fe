"""The port's decode styles other than single-model beam search, on the CPU
at a tiny size (d_model 32, 4 heads, 2/2/2 blocks, float32): greedy and
oracle tokens and an ensemble's beam search against the JAX package's on
the same weights and batch (tokens and lengths identical, scores to 5e-4),
`filter_logits` against JAX's, and the port's sampling on its own
(reproducible from its seed, each row's draws independent of the rows
around it under `row_seeds`, top_k=1 greedy).  Torch's random streams are
not JAX's, so sampled tokens are not compared across the packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bist_tpu.config import GenerateConfig as JaxGenerateConfig
from bist_tpu.decode import beam as jax_beam
from bist_tpu.decode import sample as jax_sample
from bist_tpu_torch.config import GenerateConfig
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.decode import beam, sample
from bist_tpu_torch.vocab import PAD, SOS, UNK, ids2words
from torch_port_common import both_params, configs, np_batch, torch_batch

SCORE_TOL = 5e-4


@pytest.fixture
def model():
    jcfg, tcfg = configs(dropout=0.0)
    jp, tp = both_params(jcfg, seed=3)
    return jcfg, tcfg, jp, tp


def test_greedy_identical_to_jax(model, rng):
    jcfg, tcfg, jp, tp = model
    b = np_batch(rng, jcfg, B=3)
    want = np.asarray(jax_beam.greedy_decode(jp, jcfg, b, 7))
    got = beam.greedy_decode(tp, tcfg, torch_batch(b), 7)
    assert got.dtype == torch.int32 and got.shape == (3, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_oracle_identical_to_jax(model, rng):
    jcfg, tcfg, jp, tp = model
    b = np_batch(rng, jcfg, B=3, Lt=8)
    want = np.asarray(jax_beam.oracle_decode(jp, jcfg, b))
    got = beam.oracle_decode(tp, tcfg, torch_batch(b))
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gkw", [
    dict(maxlen=5, beam=3, penalty=1.0, nbest=4),
    dict(maxlen=6, beam=4, penalty=2.0, nbest=5, dec_eos=True, min_len=2),
])
def test_ensemble_beam_search_identical_to_jax(gkw, rng):
    """Two models of one configuration, their log-probs summed at every
    step, each with its own cache following the shared parents."""
    jcfg, tcfg = configs(dropout=0.0)
    jp0, tp0 = both_params(jcfg, seed=3)
    jp1, tp1 = both_params(jcfg, seed=4)
    b = np_batch(rng, jcfg, B=3)
    jr = jax_beam.beam_search([jp0, jp1], jcfg, b, JaxGenerateConfig(**gkw))
    tr = beam.beam_search([tp0, tp1], tcfg, torch_batch(b), GenerateConfig(**gkw))
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    single = beam.beam_search(tp0, tcfg, torch_batch(b), GenerateConfig(**gkw))
    assert not torch.equal(single.scores, tr.scores)     # the second model counts


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (1, 0.0), (5, 0.0), (0, 0.5),
                                         (0, 0.95), (7, 0.8), (50, 1e-9)])
def test_filter_logits_equals_jax(top_k, top_p, rng):
    """Random logits with ties (values on a coarse grid, whole rows of one
    value) and the NEG of banned tokens."""
    logits = np.round(rng.standard_normal((6, 50)) * 2, 1).astype(np.float32)
    logits[0] = 0.5                                  # a row of one value
    logits[1, :10] = logits[1].max()                 # a tie at the top
    logits[2, [UNK, PAD, SOS]] = sample.NEG
    want = np.asarray(jax_sample.filter_logits(jnp.asarray(logits), top_k, top_p))
    got = sample.filter_logits(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), want)


def sample_model_batch(rng, model, B=4):
    jcfg, tcfg, _, tp = model
    return tcfg, tp, torch_batch(np_batch(rng, jcfg, B=B))


def test_sampling_reproducible_from_its_seed(model, rng):
    tcfg, tp, b = sample_model_batch(rng, model)
    kw = dict(temperature=1.5, top_k=20, top_p=0.95)
    a = sample.sample_decode(tp, tcfg, b, 8, seed=11, **kw)
    assert a.dtype == torch.int32 and a.shape == (4, 8)
    assert torch.equal(a, sample.sample_decode(tp, tcfg, b, 8, seed=11, **kw))
    assert not torch.equal(a, sample.sample_decode(tp, tcfg, b, 8, seed=12, **kw))
    banned = torch.tensor([UNK, PAD, SOS], dtype=torch.int32)
    assert not torch.isin(a, banned).any()
    rows = sample.sample_decode(tp, tcfg, b, 8, seed=11, row_seeds=[5, 6, 7, 8], **kw)
    assert torch.equal(rows, sample.sample_decode(tp, tcfg, b, 8, seed=11,
                                                  row_seeds=[5, 6, 7, 8], **kw))


def test_row_seeds_make_rows_independent_of_the_batch(model, rng):
    """Row i's tokens depend on (seed, row_seeds[i]) only: the same row
    decoded alone, in another order or beside other rows draws the same."""
    tcfg, tp, b = sample_model_batch(rng, model)
    kw = dict(seed=2, temperature=2.0)
    full = sample.sample_decode(tp, tcfg, b, 8, row_seeds=[10, 11, 12, 13], **kw)
    order = [2, 0, 3, 1]
    perm = Batch(*[None if f is None else f[order] for f in b])
    shuffled = sample.sample_decode(tp, tcfg, perm, 8, row_seeds=[12, 10, 13, 11], **kw)
    assert torch.equal(shuffled, full[order])
    pair = Batch(*[None if f is None else f[[1, 3]] for f in b])
    assert torch.equal(sample.sample_decode(tp, tcfg, pair, 8, row_seeds=[11, 13], **kw),
                       full[[1, 3]])
    other = sample.sample_decode(tp, tcfg, b, 8, row_seeds=[10, 99, 12, 13], **kw)
    assert torch.equal(other[[0, 2, 3]], full[[0, 2, 3]])


def test_top_k1_sampling_is_greedy(model, rng):
    """top_k=1 keeps the argmax only: any seed gives greedy_decode's tokens
    (greedy bans nothing; on this model and batch it picks no banned
    special, which sampling bans)."""
    tcfg, tp, b = sample_model_batch(rng, model)
    greedy = beam.greedy_decode(tp, tcfg, b, 8)
    assert not torch.isin(greedy, torch.tensor([UNK, PAD, SOS], dtype=torch.int32)).any()
    for seed in (0, 9):
        assert torch.equal(sample.sample_decode(tp, tcfg, b, 8, seed=seed, top_k=1), greedy)


def test_ids2words_stops_at_eos():
    id2word = ["<unk>", "<blank>", "<sos>", "<eos>", "a", "b"]
    assert ids2words([4, 5, 3, 4], id2word) == ["a", "b"]
    assert ids2words(np.array([5, 4], np.int32), id2word) == ["b", "a"]
    assert ids2words([4, 3, 5], id2word, stop_at_eos=False) == ["a", "<eos>", "b"]
