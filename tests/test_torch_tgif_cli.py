"""The port's TGIF-QA train CLI (`python -m bist_tpu_torch.cli.train_tgif`)
on the CPU: for each task on tiny TSVs and .npy grids it trains through its
compiled step program, scores the test split and writes <model>_best.pt;
and the batches it steps and scores equal those of
`bist_tpu.cli.train_tgif.main` on the same files and seed, recorded there
through stubs of `bist_tpu`'s step, loss, init and checkpoint (nothing of
`bist_tpu` is edited; the stubs keep its CLI from compiling).

`bist_tpu`'s multiple-choice batches stack each video as it is
(`expand_candidates`' np.stack) before padding them to the batch's time
bucket, so its CLI raises on a batch whose GIFs differ in length; the port
pads each video (tests/test_torch_tgifqa.py's
`test_mc_batches_pad_videos_of_different_lengths`).  The comparison of the
multiple-choice batches therefore gives every GIF one length; the CLI runs
of the port use GIFs of 3-20 clips."""

import logging
import os
from unittest import mock

import numpy as np
import pytest
import torch

from bist_tpu_torch.cli import train_tgif
from bist_tpu_torch.tasks import tgifqa as P
from bist_tpu_torch.train.checkpoint import load_checkpoint
from torch_threads import two_threads  # noqa: F401 (autouse)

WORDS = ("what color is the cat dog doing how many times does man jump red blue "
         "two three before after run").split()
TASKS = ["frameqa", "count", "action", "transition"]
TINY = ["--num-epochs", "2", "--batch-size", "4", "--d-model", "16", "--att-h", "2",
        "--n-answers", "10", "--max-len", "12", "--rand-seed", "3"]


def write_data(root, task, same_length=False, seed=0):
    """10 GIFs of (T, 4, 12) (T in 3-20, or 6 for all) and a train split of
    11 examples and a test split of 6 for `task`."""
    rng = np.random.default_rng(seed)
    os.makedirs(root / "feats", exist_ok=True)
    gifs = [f"g{i}" for i in range(10)]
    for g in gifs:
        t = 6 if same_length else int(rng.integers(3, 21))
        np.save(root / "feats" / f"{g}.npy", rng.standard_normal((t, 4, 12)).astype(np.float32))
    text = lambda: " ".join(rng.choice(WORDS, size=int(rng.integers(2, 9))))
    paths = {}
    for split, n in (("train", 11), ("test", 6)):
        if task in ("action", "transition"):
            lines = ["gif_name\tquestion\ta1\ta2\ta3\ta4\ta5\tanswer"]
            lines += [f"{rng.choice(gifs)}\t{text()}\t" + "\t".join(text() for _ in range(5))
                      + f"\t{rng.integers(0, 5)}" for _ in range(n)]
        else:
            answer = (lambda: rng.choice(WORDS[:6])) if task == "frameqa" \
                else (lambda: rng.integers(1, 8))
            lines = ["gif_name\tquestion\tanswer"]
            lines += [f"{rng.choice(gifs)}\t{text()}\t{answer()}" for _ in range(n)]
        paths[split] = root / f"{split}.tsv"
        paths[split].write_text("\n".join(lines) + "\n")
    return ["--task", task, "--train-tsv", str(paths["train"]), "--test-tsv",
            str(paths["test"]), "--feature-path", str(root / "feats")]


@pytest.mark.parametrize("task", TASKS)
def test_cli_trains_and_scores(task, tmp_path, caplog):
    """Two epochs of 2 steps through the program (2 geometries at most),
    the test split's 6 examples scored (a batch of 4 and the tail of 2),
    the state saved; multiple choice without dropout (hop 1 through K1/K2's
    plain versions), the open-ended tasks at the default 0.1."""
    caplog.set_level(logging.INFO)
    model = tmp_path / "exp" / task
    drop = ["--dropout", "0"] if task in ("action", "transition") else []
    state = train_tgif.main(write_data(tmp_path, task) + TINY + drop
                            + ["--model", str(model), "--device", "cpu"])
    key = "mae" if task == "count" else "acc"
    test = [r.getMessage() for r in caplog.records if r.getMessage().startswith("TEST")]
    assert len(test) == 1 and test[0].startswith(f"TEST {key}: ") \
        and test[0].endswith("over 6 examples"), test
    feeds = [r.getMessage() for r in caplog.records if "train feed" in r.getMessage()]
    assert len(feeds) == 2 and '"steps": 2' in feeds[0], feeds
    saved = load_checkpoint(str(model) + "_best")
    assert saved["step"] == state.step == 4 and saved["opt_state"]["count"] == 4
    assert np.isfinite([float(t.abs().sum()) for t in saved["opt_state"]["nu"]]).all()


def test_cli_device_defaults_to_cuda():
    assert train_tgif.build_parser().parse_args(
        ["--task", "count", "--train-tsv", "t", "--feature-path", "f", "--model", "m"]
    ).device == "cuda"


@pytest.mark.parametrize("task", TASKS)
def test_cli_batches_equal_bist_tpu(task, tmp_path):
    """The train batches (shuffled by the seed, the tail dropped, 2 epochs)
    and the test batches (in file order, the tail kept) that reach the
    step and the loss: query, features and labels equal to `bist_tpu`'s."""
    import bist_tpu.tasks.tgifqa as J
    import bist_tpu.train.checkpoint as jax_checkpoint
    from bist_tpu.cli import train_tgif as jax_train_tgif

    args = write_data(tmp_path, task, same_length=task in ("action", "transition")) + TINY
    want = []

    def jax_step(cfg, t, tx):
        def step(state, batch, key):
            want.append(("train", batch))
            return state, {"loss": 0.0, "acc": 0.0, "mae": 0.0}
        return step

    def jax_loss(params, cfg, batch, t, rngs=None):
        want.append(("test", batch))
        return 0.0, {"acc": 0.0, "mae": 0.0}

    with mock.patch.object(J, "make_tgif_train_step", jax_step), \
            mock.patch.object(J, "tgif_loss", jax_loss), \
            mock.patch.object(J, "init_tgif_model", lambda *a, **k: {"w": np.zeros(1)}), \
            mock.patch.object(jax_checkpoint, "save_checkpoint", lambda *a, **k: None):
        jax_train_tgif.main(args + ["--model", str(tmp_path / "jax"), "--device", "cpu"])

    got = []
    real_step, real_loss = P.make_tgif_train_step, P.tgif_loss

    def step_recorder(cfg, t, tx):
        step = real_step(cfg, t, tx)

        def recorded(state, batch, gen=None):
            got.append(("train", [x.clone() for x in batch]))   # the program's buffers
            return step(state, batch, gen)
        return recorded

    def loss_recorder(params, cfg, batch, t, rngs=None):
        if not torch.is_grad_enabled():         # the test split, not a train step's
            got.append(("test", list(batch)))
        return real_loss(params, cfg, batch, t, rngs)

    with mock.patch.object(P, "make_tgif_train_step", step_recorder), \
            mock.patch.object(P, "tgif_loss", loss_recorder):
        train_tgif.main(args + ["--model", str(tmp_path / "port"), "--device", "cpu"])

    assert [s for s, _ in got] == [s for s, _ in want] == ["train"] * 4 + ["test"] * 2
    for i, ((_, g), (_, w)) in enumerate(zip(got, want)):
        for name, x, y in zip(P.TgifBatch._fields, g, w):
            assert x.numpy().dtype == y.dtype, (i, name)
            np.testing.assert_array_equal(x.numpy(), y, err_msg=f"batch {i} {name}")
