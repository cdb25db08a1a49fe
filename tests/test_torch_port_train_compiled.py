"""The port's compiled train and eval steps (`train.compiled`) on the CPU,
where a program runs the eager step on its static buffers: at the tiny size
of torch_port_common (d_model 32, 4 heads, 2 blocks), every case must equal
the eager `make_train_step` / `make_eval_step` bit for bit (the same code on
the same values).  The card's captures are held against eager in
tests/test_torch_port_cuda.py and chip_smoke.py's phase 6."""

import numpy as np
import pytest
import torch

from bist_tpu_torch.config import TrainConfig
from bist_tpu_torch.train import checkpoint as ckpt
from bist_tpu_torch.train import loop
from bist_tpu_torch.train.compiled import EvalProgram, TrainProgram
from bist_tpu_torch.train.schedule import make_optimizer
from bist_tpu_torch.weights import tree_leaves
from torch_port_common import both_params, configs, np_batch, torch_batch
from torch_threads import two_threads  # noqa: F401 (autouse)

TCFG = TrainConfig(warmup_steps=10)


def fresh(tcfg, tp):
    tx = make_optimizer(tcfg.d_model, 10)
    params = loop.trainable(tp)
    return loop.TrainState(params, tx.init(tree_leaves(params)), 0), tx


def two_geometries(rng, jcfg, n=4, B=4):
    """n batches alternating between two geometries (history 7 and 11
    tokens, 3 and 5 clips)."""
    return [torch_batch(np_batch(rng, jcfg, B=B, Lh=7 if i % 2 == 0 else 11,
                                 T=3 if i % 2 == 0 else 5)) for i in range(n)]


def run(step, state, batches, gen=None, seed=7):
    metrics = []
    for b in batches:
        if gen is not None:
            gen.manual_seed(loop.seed_for_step(seed, state.step))
        state, m = step(state, b, gen)
        metrics.append(m)
    return state, metrics


def assert_same_run(a, b):
    (sa, ma), (sb, mb) = a, b
    assert sa.step == sb.step
    for x, y in zip(ma, mb):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for x, y in zip(tree_leaves(sa.params), tree_leaves(sb.params)):
        assert torch.equal(x, y)
    for x, y in zip(sa.opt_state["mu"] + sa.opt_state["nu"],
                    sb.opt_state["mu"] + sb.opt_state["nu"]):
        assert torch.equal(x, y)
    assert int(sa.opt_state["count"]) == int(sb.opt_state["count"])


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["single", "grad_accum2"])
def test_train_program_equals_eager_steps(grad_accum, rng):
    """4 steps over two geometries interleaved (grad_accum 1), or 2 steps of
    one (grad_accum 2): losses, metrics, parameters and Adam's state equal
    to the eager step's; the program saw each geometry once."""
    jcfg, tcfg = configs(dropout=0.0, attn_dropout=0.0)
    _, tp = both_params(jcfg)
    batches = two_geometries(rng, jcfg, n=4 if grad_accum == 1 else 2)
    state, tx = fresh(tcfg, tp)
    eager = run(loop.make_train_step(tcfg, TCFG, tx, grad_accum=grad_accum), state, batches)
    state, tx = fresh(tcfg, tp)
    prog = TrainProgram(state, tcfg, TCFG, tx, grad_accum=grad_accum)
    compiled = run(prog, state, batches)
    assert_same_run(compiled, eager)
    assert compiled[0].params is state.params
    assert prog.stats()["geometries"] == 2 and prog.stats()["captures"] == 0


def test_train_program_with_dropout_equals_eager(rng):
    """Dropout from the generator the program was built with, re-seeded from
    seed_for_step before each step: the eager step's masks and results."""
    jcfg, tcfg = configs(dropout=0.2, attn_dropout=0.1)
    _, tp = both_params(jcfg)
    batches = two_geometries(rng, jcfg, n=3)
    gen = loop.dropout_generator(tcfg, "cpu")
    state, tx = fresh(tcfg, tp)
    eager = run(loop.make_train_step(tcfg, TCFG, tx), state, batches, gen)
    state, tx = fresh(tcfg, tp)
    prog = TrainProgram(state, tcfg, TCFG, tx, gen=gen)
    assert_same_run(run(prog, state, batches, gen), eager)
    with pytest.raises(ValueError, match="generator the program was built with"):
        prog(state, batches[0], torch.Generator())


def test_eval_program_equals_eval_step(rng):
    jcfg, tcfg = configs(dropout=0.1)
    _, tp = both_params(jcfg)
    params = loop.trainable(tp)
    prog = EvalProgram(params, tcfg, TCFG)
    step = loop.make_eval_step(tcfg, TCFG)
    for b in two_geometries(rng, jcfg, n=3):
        got, want = prog(params, b), step(params, b)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="not the ones the program was built on"):
        prog(loop.trainable(tp), b)


def test_restore_into_a_live_program_continues_the_run(rng, tmp_path):
    """2 steps through a program, save, 1 step more, restore the checkpoint
    into the program's own state (in place: parameters, mu, nu, count), 2
    steps: equal to 4 uninterrupted steps (dropout on, so the step count
    restored also re-seeds the generator)."""
    jcfg, tcfg = configs(dropout=0.1)
    _, tp = both_params(jcfg)
    batches = two_geometries(rng, jcfg, n=4)
    gen = loop.dropout_generator(tcfg, "cpu")
    state, tx = fresh(tcfg, tp)
    full = run(TrainProgram(state, tcfg, TCFG, tx, gen=gen), state, batches, gen)
    state, tx = fresh(tcfg, tp)
    prog = TrainProgram(state, tcfg, TCFG, tx, gen=gen)
    state, first = run(prog, state, batches[:2], gen)
    ckpt.save_checkpoint(str(tmp_path / "mtn_2"), state, epoch=0)
    run(prog, state, batches[2:3], gen)
    state, _ = ckpt.restore_train_state(str(tmp_path / "mtn_2"), state)
    assert state.opt_state["count"] is prog.state.opt_state["count"]
    assert int(state.opt_state["count"]) == state.step == 2
    resumed = run(prog, state, batches[2:], gen)
    assert_same_run(resumed, (full[0], full[1][2:]))


def test_train_program_refuses_what_a_graph_cannot_replay(rng):
    """An optimizer whose state is not tensors on the parameters' device (the
    stand-in SGD of test_torch_port_train.py counts in a Python int), and
    remat with dropout (its rounds draw from generator clones), are refused
    when the program is built, naming why."""
    from test_torch_port_train import SGD

    jcfg, tcfg = configs(dropout=0.0, attn_dropout=0.0)
    _, tp = both_params(jcfg)
    params = loop.trainable(tp)
    state = loop.TrainState(params, SGD().init(None), 0)
    with pytest.raises(ValueError, match="'count' holds a int, not a tensor on cpu"):
        TrainProgram(state, tcfg, TCFG, SGD())
    state, tx = fresh(tcfg, tp)
    drop = tcfg.replace(dropout=0.1, remat=True)
    with pytest.raises(ValueError, match="remat with dropout"):
        TrainProgram(state, drop, TCFG, tx, gen=loop.dropout_generator(drop, "cpu"))
    prog = TrainProgram(state, tcfg.replace(remat=True), TCFG, tx)
    b = torch_batch(np_batch(np.random.default_rng(0), jcfg))
    state2, tx2 = fresh(tcfg, tp)
    eager = run(loop.make_train_step(tcfg.replace(remat=True), TCFG, tx2), state2, [b])
    assert_same_run(run(prog, state, [b]), eager)
