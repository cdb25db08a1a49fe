"""The port's TGIF-QA task (`bist_tpu_torch.tasks.tgifqa`) against
`bist_tpu.tasks.tgifqa` on the CPU, at the tiny size of tests/test_tgifqa.py
(d_model 16, 2 heads, 2 video blocks, Dv 12), inputs from a numpy seed:
TSV parsing, the answer vocabulary and candidate expansion give identical
arrays; the forward and the loss of all four tasks agree within 5e-4 on
`bist_tpu`'s parameters (acc and MAE equal) with zero-padded clips and
query tokens; three train steps agree with `optax.adam` (losses within
5e-4, parameters within 5e-4 + 5e-3·|p|); the compiled step
(`train.compiled.StepProgram`) equals the eager step; and the heads learn,
as `bist_tpu`'s tests require of its heads (the held-out proofs `slow`, as
theirs are)."""

import jax
import numpy as np
import optax
import pytest
import torch

from bist_tpu.config import ModelConfig as JaxModelConfig
from bist_tpu.tasks import tgifqa as J
from bist_tpu.vocab import SPECIALS
from bist_tpu_torch.config import ModelConfig as TorchModelConfig
from bist_tpu_torch.tasks import tgifqa as P
from bist_tpu_torch.train.compiled import StepProgram
from bist_tpu_torch.weights import params_from_jax, params_to_jax, tree_leaves
from chip_smoke import mc_heldout_batches

CPU = torch.device("cpu")
TINY = dict(vocab_size=40, nb_blocks=2, nb_venc_blocks=2, d_model=16, att_h=2,
            dropout=0.0, ft_sizes=(12,), include_caption="none", nb_cenc_blocks=0)
TASKS = ["frameqa", "count", "action", "transition"]
MC = ("action", "transition")
# parameters that shift a multiple-choice row's 5 scores by one constant
MC_SHIFTS = ("head.b", "out_norm_t.bias", "out_norm_s.bias")


@pytest.fixture(autouse=True)
def few_threads():
    """torch's default of a thread a core thrashes beside the suite's other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cfgs(**kw):
    return JaxModelConfig(**dict(TINY, **kw)), TorchModelConfig(**dict(TINY, **kw))


def np_batch(rng, task, B=4, Lq=6, T=5, S=3, dv=12, n_answers=10):
    """A TgifBatch of numpy arrays: the queries' last two tokens PAD, the
    last two clips zero (so both masks matter), MC rows B·5."""
    rows = B * 5 if task in MC else B
    query = rng.integers(4, 40, size=(rows, Lq)).astype(np.int32)
    query[:, -2:] = SPECIALS["<blank>"]
    fts = rng.standard_normal((rows, T, S, dv)).astype(np.float32)
    fts[:, -2:] = 0.0
    hi = {"frameqa": n_answers, "count": 10}.get(task, 5)
    label = rng.integers(1 if task == "count" else 0, hi, size=B).astype(np.int32)
    return J.TgifBatch(query=query, fts=fts, label=label)


def torch_batch(b):
    return P.TgifBatch(*[torch.tensor(x) for x in b])


def jax_params(task, jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, J.init_tgif_model(jax.random.PRNGKey(seed), jcfg, J.TGIFTask(task),
                                      n_answers=10))


def shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: s for k, v in tree.items() for n, s in shapes(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {n: s for i, v in enumerate(tree) for n, s in shapes(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tuple(np.shape(tree))}


@pytest.fixture
def tsv_files(tmp_path):
    """tests/test_tgifqa.py's splits, and a transition split."""
    files = {
        "frameqa": "gif_name\tquestion\tanswer\n"
                   "g1\twhat color is the cat\tred\n"
                   "g2\twhat color is the dog\tblue\n"
                   "g3\twhat color is the cat\tRed\n",
        "count": "gif_name\tquestion\tanswer\n"
                 "g1\thow many times does man jump\t3\n"
                 "g2\thow many times does man jump\t5.0\n",
        "action": "gif_name\tquestion\ta1\ta2\ta3\ta4\ta5\tanswer\n"
                  "g1\twhat does man do\tjump\tred\tblue\tcat\tdog\t0\n"
                  "g2\twhat does man do before\tdog\tjump\tcat\tred\tblue\t1\n",
        "transition": "gif_name\tquestion\ta1\ta2\ta3\ta4\ta5\tanswer\n"
                      "g3\twhat does the cat do after jump\tred\tjump\tblue two\t"
                      "three\tdog\t4\n",
    }
    out = {}
    for name, text in files.items():
        (tmp_path / f"{name}.tsv").write_text(text)
        out[name] = str(tmp_path / f"{name}.tsv")
    return out


@pytest.fixture
def vocab():
    v = dict(SPECIALS)
    for w in ("what color is the cat dog doing how many times does man "
              "jump red blue two three before after").split():
        v[w] = len(v)
    return v


def test_tsv_parsing_and_candidates_equal_bist_tpu(tsv_files, vocab, rng):
    av = P.build_answer_vocab(tsv_files["frameqa"])
    assert av == J.build_answer_vocab(tsv_files["frameqa"]) == {"red": 0, "blue": 1}
    assert P.build_answer_vocab(tsv_files["frameqa"], top_k=1) == {"red": 0}
    fts = {g: rng.standard_normal((4, 3, 12)).astype(np.float32) for g in ("g1", "g2", "g3")}
    for task in TASKS:
        got = P.load_tgif_tsv(tsv_files[task], P.TGIFTask(task), vocab, av)
        want = J.load_tgif_tsv(tsv_files[task], J.TGIFTask(task), vocab, av)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert (a.gif_name, a.label) == (b.gif_name, b.label)
            np.testing.assert_array_equal(a.question, b.question)
            assert (a.candidates is None) == (b.candidates is None)
            for x, y in zip(a.candidates or [], b.candidates or []):
                np.testing.assert_array_equal(x, y)
        if task in MC:
            for max_len in (16, 7):            # 7 cuts question + candidate
                pb = P.expand_candidates(got, fts.__getitem__, max_len=max_len)
                jb = J.expand_candidates(want, fts.__getitem__, max_len=max_len)
                for x, y in zip(pb, jb):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
                assert pb.query.shape == (5 * len(got), max_len)


@pytest.mark.parametrize("task", TASKS)
def test_forward_and_loss_match_bist_tpu(task, rng):
    """`bist_tpu`'s parameters through `params_from_jax`: the tree has its
    keys and shapes (also the port's own init's), the logits and the loss
    agree within 5e-4 and the metric is equal."""
    jcfg, tcfg = tiny_cfgs()
    npp = jax_params(task, jcfg)
    tp = params_from_jax(npp, CPU)
    own = P.init_tgif_model(torch.Generator().manual_seed(0), tcfg, P.TGIFTask(task),
                            n_answers=10, device=CPU)
    assert shapes(params_to_jax(own)) == shapes(params_to_jax(tp)) == shapes(npp)
    b = np_batch(rng, task)
    jt = J.TGIFTask(task)
    jloss = jax.jit(lambda p, x: (J.tgif_forward(p, jcfg, x.query, x.fts, jt),
                                  *J.tgif_loss(p, jcfg, x, jt)))
    j_logits, j_loss, j_m = jloss(npp, b)
    pb = torch_batch(b)
    with torch.no_grad():
        p_logits = P.tgif_forward(tp, tcfg, pb.query, pb.fts, P.TGIFTask(task))
        p_loss, p_m = P.tgif_loss(tp, tcfg, pb, P.TGIFTask(task))
    assert p_logits.shape == j_logits.shape
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(j_logits), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=5e-4, atol=5e-4)
    assert set(p_m) == set(j_m) == {"mae" if task == "count" else "acc"}
    for k in p_m:
        assert float(p_m[k]) == float(j_m[k]), k


@pytest.mark.parametrize("task", ["frameqa", "count", "action"])
def test_train_steps_match_optax(task, rng):
    """Three `make_tgif_train_step` steps (Adam at a constant 1e-2, dropout
    0) against `bist_tpu`'s jitted step on `optax.adam`: losses within
    5e-4, parameters within 5e-4 + 5e-3·|p|.  The key biases' gradient is
    analytically zero (a bias added to every key of a row shifts its scores
    by one constant), and so are, for multiple choice, the head's bias and
    the two output norms' biases (each adds one constant to the 5 scores a
    softmax compares): Adam turns the sign of their round-off residue into
    ±lr a step, differently in each package.  Those are held to 5e-4 +
    2·Σlr, as chip_smoke.py's `params_agree` holds the key biases."""
    jcfg, tcfg = tiny_cfgs()
    npp = jax_params(task, jcfg)
    b = np_batch(rng, task)
    jtx = optax.adam(1e-2)
    jstate = {"params": npp, "opt_state": jtx.init(npp), "step": 0}
    jstep = J.make_tgif_train_step(jcfg, J.TGIFTask(task), jtx)
    tx = P.tgif_optimizer(1e-2)
    state = P.create_tgif_train_state(params_from_jax(npp, CPU), tx)
    step = P.make_tgif_train_step(tcfg, P.TGIFTask(task), tx)
    pb = torch_batch(b)
    for i in range(3):
        jstate, jm = jstep(jstate, b, jax.random.PRNGKey(i))
        state, m = step(state, pb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=5e-4, atol=5e-4)
    assert state.step == 3 and int(state.opt_state["count"]) == 3
    want = jax.tree_util.tree_map(np.asarray, jstate["params"])
    got = params_to_jax(state.params)
    flat = lambda t: dict(zip(shapes(t), jax.tree_util.tree_leaves(t)))
    for name, w in flat(want).items():
        if name.endswith("wk.b") or (task in MC and name in MC_SHIFTS):
            assert np.abs(flat(got)[name] - w).max() <= 5e-4 + 2 * 3 * 1e-2, name
        else:
            np.testing.assert_allclose(flat(got)[name], w, rtol=5e-3, atol=5e-4,
                                       err_msg=name)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_step_program_equals_eager_step(dropout, rng):
    """The generalised compiled program (on the CPU: the eager step on its
    static buffers) over two geometries interleaved, with dropout from its
    generator re-seeded per step, equals the eager step bit for bit."""
    _, tcfg = tiny_cfgs(dropout=dropout)
    task = P.TGIFTask.ACTION
    params = P.init_tgif_model(torch.Generator().manual_seed(3), tcfg, task, device=CPU)
    tx = P.tgif_optimizer(1e-3)
    batches = [np_batch(rng, "action", B=2, T=3 if i % 2 else 5) for i in range(4)]

    def run(step, state, gen, convert):
        out = []
        for i, b in enumerate(batches):
            if gen is not None:
                gen.manual_seed(131 + i)
            state, m = step(state, convert(b), gen)
            out.append(m)
        return state, out

    gen_a = torch.Generator() if dropout else None
    eager = run(P.make_tgif_train_step(tcfg, task, tx), P.create_tgif_train_state(params, tx),
                gen_a, torch_batch)
    state = P.create_tgif_train_state(params, tx)
    gen_b = torch.Generator() if dropout else None
    prog = StepProgram(state, P.make_tgif_train_step(tcfg, task, tx), gen_b, label="tgif")
    got = run(prog, state, gen_b, lambda b: b)         # host batches, as the CLI's
    assert prog.stats()["geometries"] == 2
    assert got[0].step == eager[0].step == 4
    for x, y in zip(got[1], eager[1]):
        assert set(x) == set(y) == {"acc", "loss"}
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for x, y in zip(tree_leaves(got[0].params), tree_leaves(eager[0].params)):
        assert torch.equal(x, y)
    if dropout:       # the masks were drawn: a second seed gives another loss
        gen_b.manual_seed(7)
        _, m = prog(got[0], batches[0], gen_b)
        assert not torch.equal(m["loss"], got[1][0]["loss"])


def test_mc_batches_pad_videos_of_different_lengths(tmp_path, rng):
    """The CLI's batch builder: each multiple-choice video, of its own
    length, repeated 5 times and zero-padded (or cut) to the batch's time
    bucket; the open-ended tasks' questions padded to their bucket."""
    from bist_tpu_torch.data.features import FeatureStore

    lengths = {"a": 3, "b": 20, "c": 70}
    vids = {}
    for g, t in lengths.items():
        vids[g] = rng.standard_normal((t, 2, 5)).astype(np.float32)
        np.save(tmp_path / f"{g}.npy", vids[g])
    store = FeatureStore("tgif", str(tmp_path / "<ImageID>.npy"), workers=0)
    store.register(list(lengths))
    q = lambda n: np.arange(4, 4 + n, dtype=np.int32)
    exs = [P.TgifExample("a", q(3), 1, [q(2)] * 5), P.TgifExample("b", q(40), 4, [q(1)] * 5),
           P.TgifExample("c", q(5), 0, [q(3)] * 5)]
    (first, second) = P.tgif_batches(exs, P.TGIFTask.TRANSITION, store, 2, 8, drop_last=False)
    assert first.fts.shape == (10, 32, 2, 5) and second.fts.shape == (5, 128, 2, 5)
    for batch, names in ((first, "ab"), (second, "c")):
        for i, g in enumerate(np.repeat(list(names), 5)):
            t = min(lengths[g], batch.fts.shape[1])
            np.testing.assert_array_equal(batch.fts[i, :t], vids[g][:t])
            assert not batch.fts[i, t:].any()
    np.testing.assert_array_equal(first.query, P._candidate_rows(exs[:2], 8))
    np.testing.assert_array_equal(first.label, [1, 4])
    (only,) = P.tgif_batches(exs, P.TGIFTask.COUNT, store, 2, 32)     # drop_last
    assert only.query.shape == (2, 64) and only.fts.shape == (2, 32, 2, 5)
    assert (only.query[1, :32] == q(32)).all() and (only.query[1, 32:] == 1).all()


# ---------------------------------------------------------------------------
# The heads learn (after tests/test_tgifqa.py)


def _train_eval(cfg, task, params, train_batch, eval_batch, steps, lr=3e-3):
    tx = P.tgif_optimizer(lr)
    state = P.create_tgif_train_state(params, tx)
    step = P.make_tgif_train_step(cfg, task, tx)
    for _ in range(steps):
        state, _ = step(state, torch_batch(train_batch))
    with torch.no_grad():
        _, m = P.tgif_loss(state.params, cfg, torch_batch(eval_batch), task)
    return {k: float(v) for k, v in m.items()}


def _count_batch(rng, n, T=8, S=2, D=12):
    """label = number of 'event' frames (a fixed feature direction)."""
    event = np.linspace(1.0, -1.0, D).astype(np.float32) * 2.0
    fts = rng.standard_normal((n, T, S, D)).astype(np.float32) * 0.3
    labels = rng.integers(1, T, size=n).astype(np.int32)
    for i in range(n):
        pos = rng.choice(T, size=labels[i], replace=False)
        fts[i, pos] += event
    query = np.full((n, 3), 5, np.int32)          # constant question
    return P.TgifBatch(query=query, fts=fts, label=labels)


@pytest.mark.slow
def test_count_head_learns_heldout(rng):
    """Count regression generalises: held-out MAE far below the ~2.0 of the
    best constant predictor (labels uniform on [1,7])."""
    _, cfg = tiny_cfgs()
    params = P.init_tgif_model(torch.Generator().manual_seed(0), cfg, P.TGIFTask.COUNT,
                               device=CPU)
    train = _count_batch(rng, 96)
    heldout = _count_batch(rng, 48)
    m = _train_eval(cfg, P.TGIFTask.COUNT, params, train, heldout, steps=400)
    assert m["mae"] < 1.0, m          # constant predictor: ~1.7; chance: ~2.3


@pytest.mark.slow
@pytest.mark.parametrize("task", ["action", "transition"])
def test_mc_heads_learn_heldout(task, rng):
    """Action/Transition 5-way choice generalises well above the 0.2 chance
    level on held-out videos; transition requires matching the candidate to
    the temporally-cued half of the video."""
    _, cfg = tiny_cfgs()
    t = P.TGIFTask(task)
    params = P.init_tgif_model(torch.Generator().manual_seed(1), cfg, t, device=CPU)
    gen = mc_heldout_batches(rng, task == "transition")
    tx = P.tgif_optimizer(3e-3)
    state = P.create_tgif_train_state(params, tx)
    step = P.make_tgif_train_step(cfg, t, tx)
    for _ in range(400):
        state, _ = step(state, torch_batch(gen(16)))
    with torch.no_grad():
        _, m = P.tgif_loss(state.params, cfg, torch_batch(gen(48)), t)
    assert float(m["acc"]) > 0.6, m   # chance = 0.2


@pytest.mark.parametrize("task", ["frameqa", "count", "action"])
def test_heads_train(task, rng):
    _, cfg = tiny_cfgs()
    t = P.TGIFTask(task)
    params = P.init_tgif_model(torch.Generator().manual_seed(0), cfg, t, n_answers=10,
                               device=CPU)
    B = 4
    rows = B * 5 if task == "action" else B
    query = rng.integers(4, 40, size=(rows, 6)).astype(np.int32)
    fts = rng.standard_normal((rows, 3, 4, 12)).astype(np.float32)
    if task == "frameqa":
        label = rng.integers(0, 10, size=B).astype(np.int32)
    elif task == "count":
        label = rng.integers(1, 10, size=B).astype(np.int32)
    else:
        label = rng.integers(0, 5, size=B).astype(np.int32)
    batch = torch_batch(P.TgifBatch(query=query, fts=fts, label=label))

    tx = P.tgif_optimizer(1e-2)
    state = P.create_tgif_train_state(params, tx)
    step = P.make_tgif_train_step(cfg, t, tx)
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses[-1])
    with torch.no_grad():
        _, m = P.tgif_loss(state.params, cfg, batch, t)
    key = "mae" if task == "count" else "acc"
    assert key in m
