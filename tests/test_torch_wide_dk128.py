"""K1 "wide"'s widths at d_k 128 and D up to 1024 on the CPU, where K1 is
its plain version: `hop1_plain` (and its training residuals) against
`bist_tpu`'s hop-1 reference and its Pallas kernel in interpret mode at
d_model 1024 with 8 heads (40 and 130 kv rows), 512 with 4, 768 with 12
and a fully masked row (2e-4); the port's model at d_model 1024, 8 heads,
one block of each kind, against `bist_tpu`'s (forward to 5e-4, beam tokens
identical); and chip_smoke.py's phase-17 leg at d_model 1024 run at a tiny
width.  The CUDA kernels are held against these plain versions on the card
by test_torch_port_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bist_tpu.config import GenerateConfig as JaxGenerateConfig
from bist_tpu.decode.beam import beam_search as jax_beam_search
from bist_tpu.models import model as jax_model
from bist_tpu.models.layers import linear, mha_init
from bist_tpu.ops.bist_kernels import bist_hop1_fused, hop1_reference
from bist_tpu_torch.config import GenerateConfig
from bist_tpu_torch.decode.beam import beam_search
from bist_tpu_torch.models import model as torch_model
from bist_tpu_torch.ops import bist_kernels as K1
from bist_tpu_torch.weights import params_from_jax
from torch_port_common import CPU, assert_close, both_params, configs, np_batch, torch_batch
from torch_threads import two_threads  # noqa: F401 (autouse)

TOL = 2e-4
MODEL_TOL = 5e-4


def hop1_inputs(rng, B, G, Lq, Lk, D, h):
    p = mha_init(jax.random.PRNGKey(0), h, D)
    x = rng.standard_normal((B, Lq, D)).astype(np.float32)
    kv = rng.standard_normal((B, G, Lk, D)).astype(np.float32)
    mask = (rng.uniform(size=(B, 1, Lk)) > 0.25).astype(np.int32)
    mask[:, :, 0] = 1
    q_proj = np.array(linear(p["wq"], jnp.asarray(x)))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, p), CPU)
    return p, tp, x, q_proj, kv, mask


def t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("B,G,Lq,Lk,D,h", [
    (1, 2, 5, 40, 1024, 8),     # d_model 1024, 8 heads: d_k 128, one head a block
    (1, 2, 5, 130, 1024, 8),    # past 64 kv rows: K1 "wide"'s kv tiles at d_k 128
    (1, 2, 5, 40, 512, 4),      # d_k 128 at the reference's width
    (1, 2, 5, 40, 768, 12),     # D 768, d_k 64
])
def test_hop1_plain_matches_jax_at_dk128(B, G, Lq, Lk, D, h, rng):
    """`hop1_plain`'s output and residuals (concat, lse) against
    `hop1_reference` and the Pallas kernel in interpret mode (Lq padded to 8
    there)."""
    p, tp, x, q_proj, kv, mask = hop1_inputs(rng, B, G, Lq, Lk, D, h)
    assert D // h in (64, 128) and K1.hop1_supports(D, h)
    out, concat, lse = K1.hop1_plain(t(x), t(q_proj), t(kv), tp, h, t(mask),
                                     return_residuals=True)
    assert out.shape == concat.shape == (B, G, Lq, D) and lse.shape == (B, G, Lq, h)
    assert_close(out, hop1_reference(jnp.asarray(x), jnp.asarray(q_proj), jnp.asarray(kv),
                                     p, h, jnp.asarray(mask)), TOL, "vs hop1_reference")
    jout, jconcat, jlse = bist_hop1_fused(jnp.asarray(x), jnp.asarray(q_proj),
                                          jnp.asarray(kv), p, h, jnp.asarray(mask),
                                          return_residuals=True, interpret=True)
    assert_close(out, jout, TOL, "out vs the Pallas kernel (interpret)")
    assert_close(concat, np.asarray(jconcat)[:, :, :Lq], TOL, "concat vs Pallas")
    assert_close(lse, np.asarray(jlse)[:, :, :Lq], TOL, "lse vs Pallas")


def test_hop1_fully_masked_row_at_dk128(rng):
    """d_model 1024, 8 heads, past 64 kv rows: a batch row with no valid kv
    column attends uniformly over the true Lk (`hop1_reference`; concat the
    mean of V's rows, lse -1e9); the other row against the Pallas kernel,
    which also counts its padding columns in a fully masked row."""
    B, G, Lq, Lk, D, h = 2, 2, 3, 70, 1024, 8
    p, tp, x, q_proj, kv, mask = hop1_inputs(rng, B, G, Lq, Lk, D, h)
    mask[0] = 0
    out, concat, lse = K1.hop1_plain(t(x), t(q_proj), t(kv), tp, h, t(mask),
                                     return_residuals=True)
    assert_close(out, hop1_reference(jnp.asarray(x), jnp.asarray(q_proj), jnp.asarray(kv),
                                     p, h, jnp.asarray(mask)), TOL,
                 "fully masked row vs hop1_reference")
    v = t(kv)[0] @ tp["wv"]["w"] + tp["wv"]["b"]                      # (G, Lk, D)
    assert_close(concat[0], v.mean(1, keepdim=True).expand(G, Lq, D), TOL,
                 "masked row: concat vs the mean of V")
    assert torch.equal(lse[0], torch.full((G, Lq, h), -1e9))
    pallas = bist_hop1_fused(jnp.asarray(x), jnp.asarray(q_proj), jnp.asarray(kv), p, h,
                             jnp.asarray(mask), interpret=True)
    assert_close(out[1], np.asarray(pallas)[1], TOL, "valid row vs Pallas")


def model_1024(rng):
    """d_model 1024 with 8 heads (d_k 128), one block of each kind, no
    dropout: both packages' configurations and parameters, a numpy batch of
    2 and its port copy."""
    jcfg, tcfg = configs(d_model=1024, att_h=8, nb_blocks=1, nb_venc_blocks=1,
                         nb_cenc_blocks=1, dropout=0.0)
    jp, tp = both_params(jcfg, seed=2)
    b = np_batch(rng, jcfg, B=2)
    return jcfg, tcfg, jp, tp, b, torch_batch(b)


def test_model_at_d_model_1024_matches_jax(rng):
    """The port's model at d_model 1024, hop 1 through the K1 wrapper (its
    plain version here): forward_logprobs against `bist_tpu`'s to 5e-4
    (float32, other summation orders)."""
    jcfg, tcfg, jp, tp, b, tb = model_1024(rng)
    before = K1.hop1_fused.launches
    with torch.no_grad():
        tlogp, _ = torch_model.forward_logprobs(tp, tcfg, tb)
    jlogp, _ = jax.jit(lambda p, b: jax_model.forward_logprobs(p, jcfg, b, rngs=None))(jp, b)
    assert K1.hop1_fused.launches == before                 # CPU: the plain version
    assert tlogp.shape == (2, 6, 50)
    assert_close(tlogp, jlogp, MODEL_TOL, "forward_logprobs at d_model 1024")


def test_beam_search_at_d_model_1024_identical_to_jax(rng):
    """Beam search at d_model 1024 (the model above): tokens and lengths
    identical to `bist_tpu`'s."""
    jcfg, tcfg, jp, tp, b, tb = model_1024(rng)
    gkw = dict(maxlen=4, beam=2, penalty=1.0, nbest=2)
    jr = jax_beam_search(jp, jcfg, b, JaxGenerateConfig(**gkw))
    tr = beam_search(tp, tcfg, tb, GenerateConfig(**gkw))
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))


def test_chip_smoke_phase_width_1024_on_cpu():
    """Phase 17's d_model 1024 leg at a tiny width on the CPU: beam search
    eager and replayed against force_plain token for token, one train step's
    gradients against force_plain, its eager steps timed against
    force_plain; no kernel here, so no launch by kernel and no trace."""
    import chip_smoke

    assert chip_smoke.WIDTH_1024 == {"d_model": 1024, "att_h": 8}
    assert chip_smoke.WIDTH_1024_TRAIN == {"hop1_fwd": {"wide": 6},
                                           "hop1_bwd": {"wide": 6}}
    out = chip_smoke.phase_width_1024(torch.device("cpu"), B=2, train_B=2,
                                      model_kw=dict(d_model=32, att_h=4))
    gen, trn = out["generation"], out["training"]
    assert out["config"] == {"d_model": 32, "att_h": 4}
    assert gen["batches"] == 1 and gen["batch_size"] == 2
    assert gen["tokens_identical_to_plain"] == {"eager": 2, "replayed": 2}
    assert set(gen["responses_per_s"]) == {"kernels_eager", "kernels_replayed",
                                           "plain_eager", "plain_replayed"}
    assert gen["replayed_k1_by_name"] == chip_smoke.K1_NONE
    assert gen["eager_launches"] == {"hop1_fwd": 0, "hop1_variants": {}}
    check = trn["grad_check"]
    assert trn["batch_size"] == 2
    assert check["loss_rel_diff"] <= 5e-4 and check["launches"] == (0, 0)
    assert check["variants"] == {"hop1_fwd": {}, "hop1_bwd": {}}
    assert np.isfinite(check["loss_kernel"]) and out["seconds"] > 0
    speed = trn["speed"]
    assert speed["kernel_launches"] == {"hop1_fwd": {}, "hop1_bwd": {}}
    assert speed["breakdown"] == {}
    runs = {k: len(v) for k, v in speed["eager_ms"].items()}
    assert runs == {"kernels": 2 * speed["steps_a_run"], "plain": 2 * speed["steps_a_run"]}
    assert all(np.isfinite(v) and v > 0 for v in speed["eager_ms_per_step"].values())
