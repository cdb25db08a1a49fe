#!/usr/bin/env python
"""TGIF-QA training with the PyTorch port (BASELINE.json config 5):

    python -m bist_tpu_torch.cli.train_tgif --task frameqa \\
        --train-tsv Train_frameqa_question.tsv --test-tsv Test_frameqa_question.tsv \\
        --feature-path '<dir>/<ImageID>.npy' --model exps/tgif_frameqa \\
        --num-epochs 10 [--device cpu]

Trains one of the four TGIF-QA tasks (frameqa / count / action /
transition) on the BiST video-reasoning backbone over (T, S, D) feature
grids, one .npy per GIF (as the extract CLI writes them).  The flags,
defaults, vocabulary, batches and log lines are those of
`bist_tpu.cli.train_tgif`; it runs on CUDA unless --device cpu is given.

Every train step goes through a `train.compiled.StepProgram`: one CUDA
graph per batch geometry, captured the first time the geometry comes (as
`bist_tpu` jits its step).  With --dropout 0, hop 1 of both video layers
trains through the hand-written kernels (K1 with residuals, K2); with
dropout it takes the plain path, as in `bist_tpu`, and the generator the
graphs read is re-seeded before each step from epoch · 131 + step, the
value of `bist_tpu`'s key.  The test split is scored eagerly under
no_grad (K1), weighted by examples, and the trained state is written to
<model>_best.pt (`train.checkpoint`).  Each epoch also logs its examples/s
end to end and the program's stats.  Multiple-choice batches repeat each
video 5 times on the host, as `bist_tpu` does.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import time
from collections import Counter

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="bist_tpu_torch TGIF-QA training")
    p.add_argument("--task", required=True,
                   choices=["frameqa", "count", "action", "transition"])
    p.add_argument("--train-tsv", required=True)
    p.add_argument("--test-tsv", default="")
    p.add_argument("--feature-path", required=True,
                   help="template <ImageID>.npy (or <FeaType>/<ImageID>.npy)")
    p.add_argument("--model", required=True)
    p.add_argument("--num-epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--att-h", type=int, default=8)
    p.add_argument("--nb-venc-blocks", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--n-answers", type=int, default=1000)
    p.add_argument("--max-len", type=int, default=32)
    p.add_argument("--rand-seed", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def build_vocab(train_tsv: str):
    """The vocabulary over question and candidate words with frequency > 1."""
    from bist_tpu_torch.vocab import SPECIALS

    freq: Counter = Counter()
    with open(train_tsv) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            freq.update(row["question"].lower().split())
            for i in range(1, 6):
                if f"a{i}" in row:
                    freq.update(row[f"a{i}"].lower().split())
    vocab = dict(SPECIALS)
    for w, c in freq.items():
        if c > 1:
            vocab[w] = len(vocab)
    return vocab


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s: %(message)s")
    import torch

    from bist_tpu_torch import resolve_device
    from bist_tpu_torch.config import ModelConfig
    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.data.features import FeatureStore
    from bist_tpu_torch.data.loader import device_prefetch
    from bist_tpu_torch.tasks.tgifqa import (
        TGIFTask, build_answer_vocab, create_tgif_train_state, init_tgif_model,
        load_tgif_tsv, make_tgif_train_step, tgif_batches, tgif_loss, tgif_optimizer)
    from bist_tpu_torch.train.checkpoint import save_checkpoint
    from bist_tpu_torch.train.compiled import StepProgram

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    task = TGIFTask(args.task)
    rng = np.random.default_rng(args.rand_seed)

    vocab = build_vocab(args.train_tsv)
    logging.info("#vocab = %d", len(vocab))
    answer_vocab = None
    if task == TGIFTask.FRAMEQA:
        answer_vocab = build_answer_vocab(args.train_tsv, args.n_answers)
        logging.info("#answers = %d", len(answer_vocab))

    train = load_tgif_tsv(args.train_tsv, task, vocab, answer_vocab)
    logging.info("#train = %d", len(train))

    template = args.feature_path if "<ImageID>" in args.feature_path \
        else os.path.join(args.feature_path, "<ImageID>.npy")
    store = FeatureStore("tgif", template.replace("<FeaType>", "tgif"))
    store.register(sorted({e.gif_name for e in train}))
    dv = store.dim()

    cfg = ModelConfig(vocab_size=len(vocab), nb_blocks=args.nb_venc_blocks,
                      nb_venc_blocks=args.nb_venc_blocks, nb_cenc_blocks=0,
                      d_model=args.d_model, att_h=args.att_h,
                      dropout=args.dropout, include_caption="none",
                      enc_vc_combine="none", ft_sizes=(dv,), ptr_ft="query")
    params = init_tgif_model(torch.Generator().manual_seed(args.rand_seed), cfg, task,
                             n_answers=args.n_answers, device=device)
    tx = tgif_optimizer(args.lr)
    state = create_tgif_train_state(params, tx)
    gen = torch.Generator(device=device) if cfg.dropout > 0 else None
    program = StepProgram(state, make_tgif_train_step(cfg, task, tx), gen,
                          label=f"tgif {task.value} train step")

    def batches(examples, shuffle=True, drop_last=True):
        """drop_last for training (few geometries); the test split keeps the
        tail batch so every example is scored.  Assembled on a background
        thread while the step before runs."""
        it = tgif_batches(examples, task, store, args.batch_size, args.max_len,
                          rng if shuffle else None, drop_last)
        return (b for b, _ in device_prefetch((b, None) for b in it))

    metric_key = "mae" if task == TGIFTask.COUNT else "acc"
    for epoch in range(args.num_epochs):
        t0 = time.time()
        tot = {metric_key: 0.0, "loss": 0.0}      # sums stay on the device
        n = examples = 0
        for batch in batches(train):
            if gen is not None:
                gen.manual_seed(epoch * 131 + n)
            state, m = program(state, batch, gen)
            tot = {k: tot[k] + m[k] for k in tot}
            n += 1
            examples += len(batch.label)
        tot = {k: float(v) for k, v in tot.items()}   # waits for the last step
        seconds = time.time() - t0
        logging.info("epoch %d: loss %.4f %s %.4f (%.1fs)", epoch + 1,
                     tot["loss"] / max(n, 1), metric_key,
                     tot[metric_key] / max(n, 1), seconds)
        logging.info("epoch %d train feed: %s", epoch + 1, json.dumps({
            "steps": n, "examples": examples, "seconds": seconds,
            "examples_per_s": examples / seconds if seconds > 0 else 0.0}))
        logging.info("epoch %d train program: %s", epoch + 1, json.dumps(program.stats()))

    if args.test_tsv:
        test = load_tgif_tsv(args.test_tsv, task, vocab, answer_vocab)
        tot, n = 0.0, 0
        with torch.no_grad():
            for batch in batches(test, shuffle=False, drop_last=False):
                _, m = tgif_loss(state.params, cfg, to_device(batch, device), task)
                k = len(batch.label)        # example-weighted aggregate
                tot += float(m[metric_key]) * k
                n += k
        logging.info("TEST %s: %.4f over %d examples", metric_key, tot / max(n, 1), n)

    os.makedirs(os.path.dirname(os.path.abspath(args.model)), exist_ok=True)
    save_checkpoint(args.model + "_best", state)
    logging.info("saved %s_best", args.model)
    return state


if __name__ == "__main__":
    main()
