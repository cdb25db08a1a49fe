"""The port's training path on the CPU against the JAX package at the tiny
size of torch_port_common (d_model 32, 4 heads, 2 blocks): losses, the
Noam-Adam update, the training loader, the train step's loss trajectory,
and the port's own grad-accumulation, remat and checkpoint-resume
equivalences."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from bist_tpu.config import TrainConfig as JaxTrainConfig
from bist_tpu.data.avsd import load_avsd as jax_load_avsd
from bist_tpu.data.features import build_stores as jax_build_stores
from bist_tpu.data.loader import AVSDLoader as JaxLoader
from bist_tpu.models import model as jax_model
from bist_tpu.train import loop as jax_loop
from bist_tpu.train.losses import compute_losses as jax_compute_losses
from bist_tpu.train.losses import label_smoothing_kl as jax_label_smoothing_kl
from bist_tpu.train.schedule import make_optimizer as jax_make_optimizer
from bist_tpu.train.schedule import noam_schedule as jax_noam
from bist_tpu.vocab import get_vocabulary as jax_get_vocabulary
from bist_tpu_torch.config import TrainConfig
from bist_tpu_torch.data.avsd import load_avsd
from bist_tpu_torch.data.features import build_stores
from bist_tpu_torch.data.loader import AVSDLoader
from bist_tpu_torch.models import model as torch_model
from bist_tpu_torch.train import checkpoint as ckpt
from bist_tpu_torch.train import loop
from bist_tpu_torch.train.losses import compute_losses, label_smoothing_kl
from bist_tpu_torch.train.schedule import make_optimizer, noam_schedule
from bist_tpu_torch.vocab import get_vocabulary
from bist_tpu_torch.weights import tree_leaves
from torch_port_common import both_params, configs, np_batch, to_np, torch_batch

LOSS_KEYS = ("out", "temporal_ae", "spatial_ae")
STEPS = 5


def test_label_smoothing_kl_matches_jax(rng):
    V = 50
    logp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((12, V)).astype(np.float32)), -1)
    target = rng.integers(0, V, size=12).astype(np.int32)
    target[[2, 7]] = 1                                       # PAD rows
    target[3] = 0                                            # <unk>
    for smoothing in (0.1, 0.0):
        got = label_smoothing_kl(logp, torch.from_numpy(target), smoothing)
        want = jax_label_smoothing_kl(jnp.asarray(logp.numpy()), jnp.asarray(target),
                                      smoothing)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"auto_encoder": False},
                                {"enc_st_combine": "sum"},
                                {"nb_aenc_blocks": 2, "ft_sizes": (24, 12)}],
                         ids=["ae", "no-ae", "st_fused", "audio"])
def test_compute_losses_matches_jax(kw, rng):
    jcfg, tcfg = configs(**kw)
    b = np_batch(rng, jcfg)
    B, Lt = b.trg.shape
    Lq = b.query.shape[1]
    logp = np.array(jax.nn.log_softmax(rng.standard_normal((B, Lt, 50))), np.float32)
    lut = rng.standard_normal((50, 32)).astype(np.float32)
    ft = {k: rng.standard_normal((B, Lq, 32)).astype(np.float32)
          for k in ("cap_ft", "audio_ft", "temporal_ft", "spatial_ft", "st_fused")}
    for norm in (None, (np.int32(17), np.int32(9))):
        jloss, jm = jax_compute_losses(jnp.asarray(logp), ft, jnp.asarray(lut), jcfg,
                                       b, 0.1, norm_override=norm)
        tnorm = None if norm is None else tuple(torch.tensor(int(n)) for n in norm)
        tloss, tm = compute_losses(torch.from_numpy(logp),
                                   {k: torch.from_numpy(v) for k, v in ft.items()},
                                   torch.from_numpy(lut), tcfg, torch_batch(b), 0.1,
                                   norm_override=tnorm)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_noam_and_adam_match_optax(rng):
    d_model, warmup = 32, 10
    sched, jsched = noam_schedule(d_model, warmup), jax_noam(d_model, warmup)
    for c in range(0, 40, 3):
        np.testing.assert_allclose(sched(c), float(jsched(c)), rtol=1e-6)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx, jtx = make_optimizer(d_model, warmup), jax_make_optimizer(d_model, warmup)
    leaves = [torch.from_numpy(p.copy()) for p in params]
    state, jparams = tx.init(leaves), [jnp.asarray(p) for p in params]
    jstate = jtx.init(jparams)
    for _ in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        state = tx.update(leaves, [torch.from_numpy(g) for g in grads], state)
        upd, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for a, b in zip(leaves, jparams):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert state["count"] == 5


def test_training_loader_matches_jax(tmp_path):
    """Batch for batch over 2 epochs at one seed: the length-grouped shuffle,
    the answer cuts and the tail padding of both loaders."""
    root = str(tmp_path / "data")
    test_set = chip_smoke.write_tiny_dataset(root, 6, dict(d_model=32, att_h=4,
                                                           nb_blocks=1, nb_venc_blocks=1,
                                                           nb_cenc_blocks=1),
                                             dv=24, s=4, t_max=9)
    path = os.path.join(root, "<FeaType>", "<ImageID>.npy")
    kw = dict(include_caption="summary", separate_caption=True)
    vocab = get_vocabulary(test_set, cutoff=0, include_caption="summary")
    assert vocab == jax_get_vocabulary(test_set, cutoff=0, include_caption="summary")
    data, jdata = load_avsd(test_set, vocab, **kw), jax_load_avsd(test_set, vocab, **kw)
    stores, _ = build_stores(["resnext_st"], path, data.vid_set)
    jstores, _ = jax_build_stores(["resnext_st"], path, jdata.vid_set)
    lkw = dict(batch_size=4, shuffle=True, cut_a=True, seed=3, pad_batch_multiple=3,
               time_buckets=(4, 8, 16))
    loader = AVSDLoader(data, visual_stores=stores, **lkw)
    jloader = JaxLoader(jdata, visual_stores=jstores, **lkw)
    n = 0
    for _ in range(2):
        for (b, m), (jb, jm) in zip(loader, jloader):
            assert m == jm
            for f in b._fields:
                x, y = getattr(b, f), getattr(jb, f)
                assert (x is None) == (y is None), f
                if x is not None:
                    np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)
            n += 1
    assert n == 2 * len(loader) and len(loader) == len(jloader)


def batches(rng, jcfg, n=2, B=4):
    return [np_batch(rng, jcfg, B=B) for _ in range(n)]


def jax_run(jcfg, jp, bs, steps=STEPS):
    tcfg = JaxTrainConfig(warmup_steps=10)
    tx = jax_make_optimizer(jcfg.d_model, 10)
    state = jax_loop.TrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    step = jax_loop.make_train_step(jcfg, tcfg, tx, donate=False)
    traj = []
    for i in range(steps):
        state, m = step(state, bs[i % len(bs)], jax.random.PRNGKey(0))
        traj.append({k: float(m[k]) for k in LOSS_KEYS})
    return state.params, traj


def torch_state(tcfg, tp):
    tx = make_optimizer(tcfg.d_model, 10)
    params = loop.trainable(tp)
    return loop.TrainState(params, tx.init(tree_leaves(params)), 0), tx


def torch_run(tcfg, tp, bs, steps=STEPS, grad_accum=1):
    state, tx = torch_state(tcfg, tp)
    step = loop.make_train_step(tcfg, TrainConfig(warmup_steps=10), tx,
                                grad_accum=grad_accum)
    traj = []
    for i in range(steps):
        state, m = step(state, torch_batch(bs[i % len(bs)]), None)
        traj.append({k: float(m[k]) for k in LOSS_KEYS})
    return state, traj


@pytest.mark.parametrize("jax_hop1_kernel", [False, True], ids=["einsum", "pallas"])
def test_train_steps_match_jax(jax_hop1_kernel, rng, monkeypatch):
    """5 Noam-Adam steps (warmup 10, dropout 0, attention dropout 0) from
    the same init on the same batches: the loss trajectory agrees to 5e-4
    relative and a final eval forward's log-probs to 1e-3.  The port's hop 1
    runs hop1_trainable (K1/K2's plain versions here); JAX's runs its einsum
    path, or with the threshold at 0 its Pallas kernels (interpret mode).
    Parameters are compared through the forward, not leaf by leaf: the key
    biases have an analytically zero gradient, and Adam's first step turns
    the sign of its round-off residue into ±lr, differently in each package."""
    if jax_hop1_kernel:
        import bist_tpu.models.bist as jax_bist
        monkeypatch.setattr(jax_bist, "HOP1_FUSED_MIN_GRID_BYTES", 0)
    jcfg, tcfg = configs(dropout=0.0, attn_dropout=0.0)
    jp, tp = both_params(jcfg, seed=2)
    bs = batches(rng, jcfg)
    jparams, jtraj = jax_run(jcfg, jp, bs)
    state, ttraj = torch_run(tcfg, tp, bs)
    for i, (a, b) in enumerate(zip(ttraj, jtraj)):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=5e-4, err_msg=f"step {i} {k}")
    assert ttraj[-1]["out"] < ttraj[0]["out"]
    ev = np_batch(rng, jcfg, B=3)
    jlogp, _ = jax_model.forward_logprobs(jparams, jcfg, ev, rngs=None)
    with torch.no_grad():
        tlogp, _ = torch_model.forward_logprobs(state.params, tcfg, torch_batch(ev))
    np.testing.assert_allclose(to_np(tlogp), to_np(jlogp), rtol=1e-3, atol=1e-3)


class SGD:
    """A plain gradient step, so parameters after one update compare the
    gradients themselves."""

    def init(self, leaves):
        return {"count": 0}

    @torch.no_grad()
    def update(self, leaves, grads, state):
        torch._foreach_add_(leaves, grads, alpha=-0.1)
        return {"count": state["count"] + 1}


def test_grad_accum_equals_big_batch(rng):
    """grad_accum=2 over a batch of 4 whose token counts differ between the
    halves equals one step on the whole batch (global normalisers)."""
    jcfg, tcfg = configs(dropout=0.0, attn_dropout=0.0)
    _, tp = both_params(jcfg)
    b = np_batch(rng, jcfg, B=4)
    b.query[:2, 2:] = 1
    b.trg_y[:2, 3:] = 1
    results = []
    for accum in (1, 2):
        params = loop.trainable(tp)
        state = loop.TrainState(params, SGD().init(None), 0)
        step = loop.make_train_step(tcfg, TrainConfig(), SGD(), grad_accum=accum)
        results.append(step(state, torch_batch(b), None))
    (s1, m1), (s2, m2) = results
    assert int(m1["ntokens"]) == int(m2["ntokens"])
    assert int(m1["qntokens"]) == int(m2["qntokens"])
    for k in ("loss",) + LOSS_KEYS + ("cap_ae",):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5, err_msg=k)
    for a, c in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_remat_with_dropout_gives_the_same_loss_and_gradients(rng):
    """cfg.remat recomputes each decoder round in the backward pass; with
    dropout on, the recomputation must draw the same masks (from a clone of
    the generator's state at the round's start), and the generator must end
    where it ends without remat."""
    jcfg, tcfg = configs(dropout=0.2, attn_dropout=0.1)
    _, tp = both_params(jcfg)
    b = torch_batch(np_batch(rng, jcfg))
    out = []
    for remat in (False, True):
        params = loop.trainable(tp)
        gen = torch.Generator().manual_seed(5)
        cfg = tcfg.replace(remat=remat)
        logp, ft = torch_model.forward_logprobs(params, cfg, b, rngs=gen)
        loss, _ = compute_losses(logp, ft, params["embed"]["lut"], cfg, b, 0.1)
        grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
        out.append((loss.item(), grads, gen.get_state()))
    (l0, g0, st0), (l1, g1, st1) = out
    assert l1 == l0
    assert torch.equal(st0, st1)
    for a, c in zip(g0, g1):
        assert (a is None) == (c is None)
        if a is not None:
            np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-6, atol=1e-7)


def test_checkpoint_resume_equals_uninterrupted(rng, tmp_path):
    """2 steps, save, restore into a fresh state, 2 more steps equals 4
    uninterrupted steps (dropout on: each step re-seeds the generator from
    (seed, step)); the async saver writes the same file; find_latest_
    checkpoint skips a temporary of an unfinished write."""
    jcfg, tcfg = configs(dropout=0.1)
    _, tp = both_params(jcfg)
    bs = [torch_batch(b) for b in batches(rng, jcfg)]
    gen = loop.dropout_generator(tcfg, "cpu")

    def run(state, tx, n):
        step = loop.make_train_step(tcfg, TrainConfig(warmup_steps=10), tx)
        for _ in range(n):
            gen.manual_seed(loop.seed_for_step(7, state.step))
            state, _ = step(state, bs[state.step % 2], gen)
        return state

    full = run(*torch_state(tcfg, tp), 4)
    half = run(*torch_state(tcfg, tp), 2)
    prefix = str(tmp_path / "mtn")
    ckpt.save_checkpoint(prefix + "_best", half, epoch=1, best_valid_loss=3.5)
    saver = ckpt.AsyncSaver()
    saver.save(prefix + "_2", half, epoch=1)
    saver.wait()
    fresh, tx = torch_state(tcfg, tp)
    resumed, meta = ckpt.restore_train_state(prefix + "_best", fresh)
    assert meta["epoch"] == 1 and meta["best_valid_loss"] == 3.5 and resumed.step == 2
    again, _ = ckpt.restore_train_state(prefix + "_2.pt", torch_state(tcfg, tp)[0])
    for a, c in zip(tree_leaves(again.params), tree_leaves(resumed.params)):
        assert torch.equal(a, c)
    resumed = run(resumed, tx, 2)
    for a, c in zip(tree_leaves(full.params), tree_leaves(resumed.params)):
        assert torch.equal(a, c)
    assert all(p.requires_grad for p in tree_leaves(resumed.params))

    os.utime(prefix + "_best.pt", (1, 1))
    with open(prefix + "_3.pt" + ckpt.TMP_TAG + "99", "wb") as f:
        f.write(b"partial")
    assert ckpt.find_latest_checkpoint(prefix) == prefix + "_2.pt"
    assert ckpt.find_latest_checkpoint(str(tmp_path / "other")) is None
