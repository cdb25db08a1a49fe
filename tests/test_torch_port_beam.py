"""The port's beam search against the JAX package's, on the CPU at a tiny
size: with a float32 cache the tokens and lengths must be identical and the
scores agree to 1e-4 (float32 summation orders differ)."""

import numpy as np
import pytest
import torch

from bist_tpu.config import GenerateConfig as JaxGenerateConfig
from bist_tpu.decode.beam import beam_search as jax_beam_search
from bist_tpu_torch.config import GenerateConfig
from bist_tpu_torch.decode.beam import NEG, beam_search, extract_hyps, stable_topk
from torch_port_common import both_params, configs, np_batch, torch_batch
from torch_threads import two_threads  # noqa: F401 (autouse)


def test_stable_topk_prefers_lower_index_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, NEG, 3.0, NEG, NEG]])
    vals, idx = stable_topk(x, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]
    assert vals.tolist()[0][:4] == [3.0, 3.0, 3.0, 1.0]


@pytest.mark.parametrize("gkw", [
    dict(maxlen=5, beam=3, penalty=1.0, nbest=4),
    dict(maxlen=6, beam=4, penalty=2.0, nbest=5, dec_eos=True, min_len=2),
])
def test_beam_search_identical_to_jax(gkw, rng):
    jcfg, tcfg = configs(dropout=0.0)
    jp, tp = both_params(jcfg, seed=3)
    b = np_batch(rng, jcfg, B=3)
    jr = jax_beam_search(jp, jcfg, b, JaxGenerateConfig(**gkw))
    tr = beam_search(tp, tcfg, torch_batch(b), GenerateConfig(**gkw))
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               rtol=1e-4, atol=1e-4)
    assert (tr.scores > NEG / 2).all()


def test_early_exit_changes_nothing(rng):
    """early_exit stops the loop once no completion can beat the kept n-best
    and changes nothing."""
    jcfg, tcfg = configs(dropout=0.0)
    _, tp = both_params(jcfg, seed=3)
    b = torch_batch(np_batch(rng, jcfg, B=3))
    g = GenerateConfig(maxlen=12, beam=3, penalty=0.0, nbest=3)
    full = beam_search(tp, tcfg, b, g)
    early = beam_search(tp, tcfg, b, GenerateConfig(**{**g.__dict__,
                                                       "early_exit": True}))
    for a, e in zip(full, early):
        assert torch.equal(a, e)


def test_extract_hyps_and_bf16_cache(rng):
    jcfg, tcfg = configs(dropout=0.0)
    _, tp = both_params(jcfg, seed=3)
    b = torch_batch(np_batch(rng, jcfg, B=2))
    g = GenerateConfig(maxlen=5, beam=3, penalty=1.0, nbest=3)
    r = beam_search(tp, tcfg, b, g)
    id2word = [f"w{i}" for i in range(tcfg.vocab_size)]
    hyps = extract_hyps(r, id2word, 1, 3)
    assert len(hyps) == 3
    for (words, score), n in zip(hyps, range(3)):
        assert words == [id2word[t] for t in r.tokens[1, n, :r.lengths[1, n]]]
        assert score == pytest.approx(float(r.scores[1, n]))
    rb = beam_search(tp, tcfg, b, GenerateConfig(**{**g.__dict__,
                                                    "cache_dtype": "bfloat16"}))
    assert rb.tokens.shape == r.tokens.shape
    np.testing.assert_allclose(rb.scores.numpy(), r.scores.numpy(), atol=0.1)
