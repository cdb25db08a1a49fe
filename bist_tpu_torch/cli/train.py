#!/usr/bin/env python
"""Training with the PyTorch port:

    python -m bist_tpu_torch.cli.train --fea-type resnext_st \\
        --train-path '<dir>/<FeaType>/<ImageID>.npy' --train-set <json> \\
        --valid-set <json> --model exps/mtn --dropout 0 --attn-dropout 0

The flags and artifacts are those of `bist_tpu.cli.train` (the reference
train.py's flags): <model>.conf (vocab + configs, JSON, read by either
package), <model>_params.txt, <model>_train.csv / <model>_trace.csv with the
reference columns, the best checkpoint <model>_best.pt (<model>_<N>.pt per
epoch with --save-all), and --resume (a checkpoint, or 'auto').  It runs on
CUDA unless --device cpu is given.

The train and eval steps run as programs of `train.compiled`: one CUDA
graph per batch geometry, captured the first time the geometry comes (as
`bist_tpu` jits both steps); the log reports the geometries captured and
the capture seconds at each epoch's end, and each epoch's examples/s end to
end and its wait on the loader.  --remat 1 with dropout cannot be captured:
the CLI then logs why and steps eagerly.  The feature batches are assembled
by the native loader (`native/`), and --num-workers sizes each feature
store's prefetch pool.  With --dropout 0 and --attn-dropout 0, hop 1 of
every video layer trains through the hand-written kernels (K1 forward with
residuals, K2 backward); with dropout it takes the plain path, as
`bist_tpu` does.  Not ported yet: data parallelism over several cards
(--num-devices > 1, ROADMAP queue 1 item 10) and --init-from-ref
(reference checkpoints, item 7).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="bist_tpu_torch training")
    # Data (reference flag names)
    p.add_argument("--gpu", "-g", default=0, type=int, help="unused; kept for CLI parity")
    p.add_argument("--fea-type", nargs="+", type=str, default=None,
                   help="feature types, e.g. resnext_st vggish; 'none' = text-only")
    p.add_argument("--train-path", default="", type=str,
                   help="feature path template <FeaType>/<ImageID>.npy")
    p.add_argument("--train-set", default="", type=str)
    p.add_argument("--valid-path", default="", type=str)
    p.add_argument("--valid-set", default="", type=str)
    p.add_argument("--test-set", default="", type=str)
    p.add_argument("--include-caption", default="none", type=str)
    p.add_argument("--separate-caption", default=1, type=int)
    p.add_argument("--cut-a", default=1, type=int)
    p.add_argument("--merge-source", default=0, type=int)
    p.add_argument("--model", default=None, type=str)
    p.add_argument("--cutoff", default=5, type=int)
    p.add_argument("--skip", default=1, type=int)
    p.add_argument("--num-workers", default=0, type=int,
                   help="threads of each feature store's prefetch pool (at least 1)")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    # Model
    p.add_argument("--nb-blocks", default=6, type=int)
    p.add_argument("--nb-venc-blocks", default=0, type=int)
    p.add_argument("--nb-cenc-blocks", default=0, type=int)
    p.add_argument("--nb-aenc-blocks", default=0, type=int)
    p.add_argument("--d-model", default=512, type=int)
    p.add_argument("--d-ff", default=2048, type=int,
                   help="parsed for parity; d_ff is always d_model*4 (mtn.py:70)")
    p.add_argument("--att-h", default=8, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--grad-accum", default=1, type=int,
                   help="accumulate gradients over N microbatches per "
                        "optimizer step (exact big-batch equivalence; peak "
                        "activation memory /N — combine with --remat)")
    p.add_argument("--feat-int8", default=0, type=int,
                   help="ship video features to the device as int8 + "
                        "per-position scale (4x less host-to-device traffic; "
                        "dequantised on the device; adds ~0.4%% input "
                        "quantisation noise)")
    p.add_argument("--attn-dropout", default=0.1, type=float,
                   help="attention-probability dropout; the reference "
                        "hardcodes 0.1 regardless of --dropout (mtn.py:77)")
    p.add_argument("--ptr-gen", default=1, type=int)
    p.add_argument("--ptr-ft", default="query,cap", type=str)
    p.add_argument("--mask-unk", default=1, type=int)
    p.add_argument("--vid-pos", default=0, type=int,
                   help="parsed for parity; never wired in the reference (mtn.py:108)")
    p.add_argument("--dec-st-combine", default="seq", type=str)
    p.add_argument("--enc-st-combine", default="none", type=str)
    p.add_argument("--enc-vc-combine", default="dyn", type=str)
    p.add_argument("--vid-enc-mode", default=22, type=int, help="parity no-op")
    p.add_argument("--auto-encoder", default=1, type=int)
    p.add_argument("--t2s", default=1, type=int)
    p.add_argument("--s2t", default=1, type=int)
    # Training
    p.add_argument("--num-epochs", "-e", default=15, type=int)
    p.add_argument("--rand-seed", "-s", default=1, type=int)
    p.add_argument("--prng", default="rbg", choices=["rbg", "threefry"],
                   help="accepted for CLI parity and ignored: the port's "
                        "dropout draws from a torch.Generator seeded from "
                        "--rand-seed + 777 and the step")
    p.add_argument("--batch-size", "-b", default=32, type=int)
    p.add_argument("--max-length", default=256, type=int)
    p.add_argument("--max-history-length", default=-1, type=int)
    p.add_argument("--report-interval", default=100, type=int)
    p.add_argument("--warmup-steps", default=4000, type=int)
    p.add_argument("--save-all", default=0, type=int)
    p.add_argument("--async-ckpt", default=1, type=int,
                   help="write checkpoints on a background thread (the state "
                        "is copied to host memory before training goes on); "
                        "0 writes them on the training thread")
    p.add_argument("--verbose", "-v", default=0, type=int)
    p.add_argument("--init-from-ref", default="", type=str,
                   help="reference-format checkpoints are not read by the "
                        "port yet (ROADMAP queue 1 item 7); must stay empty")
    p.add_argument("--reference-root", default="", type=str,
                   help="for --init-from-ref; must stay empty")
    p.add_argument("--resume", default="", type=str,
                   help="checkpoint to resume from (params + optimizer state "
                        "+ step), or 'auto' to pick up the newest complete "
                        "checkpoint for --model (fresh start if none)")
    p.add_argument("--num-devices", default=0, type=int,
                   help="0 or 1: the port trains on one card (data "
                        "parallelism is ROADMAP queue 1 item 10)")
    p.add_argument("--bf16", default=0, type=int, help="bfloat16 activations")
    p.add_argument("--remat", default=0, type=int,
                   help="gradient checkpointing per decoder round")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose >= 1 else logging.INFO,
        format="%(asctime)s %(levelname)s: %(message)s")
    for k in vars(args):
        print(f"{k}={getattr(args, k)}")
    if args.num_devices > 1:
        raise SystemExit("--num-devices > 1: data-parallel training is not "
                         "ported to bist_tpu_torch yet (ROADMAP queue 1 item 10)")
    if args.init_from_ref or args.reference_root:
        raise SystemExit("--init-from-ref: reference-format checkpoints are not "
                         "ported to bist_tpu_torch yet (ROADMAP queue 1 item 7)")

    import torch

    from bist_tpu_torch import resolve_device
    from bist_tpu_torch.config import ModelConfig, TrainConfig, save_conf
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.batching import pinned, quantize_features
    from bist_tpu_torch.data.features import build_stores, feature_shape
    from bist_tpu_torch.data.loader import AVSDLoader
    from bist_tpu_torch.train.checkpoint import (AsyncSaver, find_latest_checkpoint,
                                                 restore_train_state, save_checkpoint)
    from bist_tpu_torch.train.compiled import EvalProgram, TrainProgram
    from bist_tpu_torch.train.loop import (append_trace, create_train_state,
                                           dropout_generator, init_csv_logs,
                                           make_train_step, run_epoch)
    from bist_tpu_torch.vocab import get_vocabulary

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    np.random.seed(args.rand_seed)

    logging.info("Extracting words from %s", args.train_set)
    vocab = get_vocabulary(args.train_set, cutoff=args.cutoff,
                           include_caption=args.include_caption)
    logging.info("#vocab = %d", len(vocab))
    data_kw = dict(include_caption=args.include_caption,
                   separate_caption=bool(args.separate_caption),
                   max_history_length=args.max_history_length,
                   merge_source=bool(args.merge_source))
    logging.info("Loading training data from %s", args.train_set)
    train_data = load_avsd(args.train_set, vocab, **data_kw)
    logging.info("Loading validation data from %s", args.valid_set)
    valid_data = load_avsd(args.valid_set, vocab, **data_kw)

    vis_stores, aud_stores = build_stores(args.fea_type, args.train_path,
                                          train_data.vid_set, skip=args.skip,
                                          workers=args.num_workers)
    for s in vis_stores + aud_stores:
        s.register(valid_data.vid_set)
    ft_sizes = tuple(feature_shape(vis_stores) + feature_shape(aud_stores))
    logging.info("Detected feature dims: %s", list(ft_sizes))

    cfg = ModelConfig(
        vocab_size=len(vocab), nb_blocks=args.nb_blocks,
        nb_venc_blocks=args.nb_venc_blocks, nb_cenc_blocks=args.nb_cenc_blocks,
        nb_aenc_blocks=args.nb_aenc_blocks, d_model=args.d_model,
        att_h=args.att_h, dropout=args.dropout,
        attn_dropout=args.attn_dropout, ptr_gen=bool(args.ptr_gen),
        ptr_ft=args.ptr_ft, mask_unk=bool(args.mask_unk),
        dec_st_combine=args.dec_st_combine, enc_st_combine=args.enc_st_combine,
        enc_vc_combine=args.enc_vc_combine, auto_encoder=bool(args.auto_encoder),
        t2s=bool(args.t2s), s2t=bool(args.s2t),
        include_caption=args.include_caption,
        separate_caption=bool(args.separate_caption), ft_sizes=ft_sizes,
        dtype="bfloat16" if args.bf16 else "float32", remat=bool(args.remat))
    tcfg = TrainConfig(
        num_epochs=args.num_epochs, rand_seed=args.rand_seed,
        batch_size=args.batch_size, max_length=args.max_length,
        max_history_length=args.max_history_length,
        report_interval=args.report_interval, warmup_steps=args.warmup_steps,
        save_all=bool(args.save_all), cutoff=args.cutoff,
        cut_a=bool(args.cut_a), merge_source=bool(args.merge_source),
        skip=args.skip, num_devices=args.num_devices)

    if args.grad_accum > 1 and args.batch_size % args.grad_accum:
        raise SystemExit(f"--batch-size {args.batch_size} must divide by "
                         f"--grad-accum {args.grad_accum}")

    def prepare(batch):              # runs on the prefetch thread
        """int8 quantisation, then the arrays pinned (the feature grids are
        assembled in pinned memory), so that the programs copy them to the
        card without blocking."""
        if args.feat_int8 and batch.fts is not None and batch.fts_scale is None:
            q8, scale = quantize_features(batch.fts)
            batch = batch._replace(fts=q8, fts_scale=scale)
        return pinned(batch, device)

    # the tail batch is padded to a multiple of the microbatch count (padded
    # rows are all-PAD: zero tokens, zero loss; real_count excludes them)
    mk_loader = lambda data, shuffle, cut_a, pad_mult: AVSDLoader(
        data, visual_stores=vis_stores, audio_stores=aud_stores,
        batch_size=args.batch_size, shuffle=shuffle, cut_a=cut_a,
        seed=args.rand_seed, len_buckets=tcfg.len_buckets,
        time_buckets=tcfg.time_buckets, pad_batch_multiple=pad_mult,
        pin_memory=device.type == "cuda")
    train_loader = mk_loader(train_data, True, bool(args.cut_a), max(args.grad_accum, 1))
    valid_loader = mk_loader(valid_data, False, False, 1)
    logging.info("#train sample = %d  #train batch = %d",
                 len(train_data.examples), len(train_loader))
    logging.info("#validation sample = %d  #validation batch = %d",
                 len(valid_data.examples), len(valid_loader))

    state, tx = create_train_state(args.rand_seed, cfg, tcfg, device=device)
    start_epoch = 0
    min_valid_loss = 1.0e10
    resume_path = args.resume
    if resume_path == "auto":
        resume_path = find_latest_checkpoint(args.model) or ""
        if not resume_path:
            logging.info("--resume auto: no checkpoint for %s, fresh start", args.model)
    if resume_path:
        state, meta = restore_train_state(resume_path, state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        min_valid_loss = float(meta.get("best_valid_loss", 1.0e10))
        logging.info("resumed from %s at step %d epoch %d", resume_path,
                     state.step, start_epoch)

    os.makedirs(os.path.dirname(os.path.abspath(args.model)), exist_ok=True)
    save_conf(args.model + ".conf", vocab, cfg, tcfg, extra={"fea_type": args.fea_type})
    with open(args.model + "_params.txt", "w") as f:
        for k in vars(args):
            f.write(f"{k}={getattr(args, k)}\n")

    holder = [state]
    gen = dropout_generator(cfg, device)
    programs = {"eval": EvalProgram(state.params, cfg, tcfg)}
    try:
        programs["train"] = TrainProgram(state, cfg, tcfg, tx,
                                         grad_accum=args.grad_accum, gen=gen)
    except ValueError as e:
        # what a graph cannot hold (remat with dropout) steps eagerly, and says so
        logging.warning("the train step runs eagerly, not as a CUDA graph: %s", e)
    train_step = programs.get("train") or make_train_step(cfg, tcfg, tx,
                                                          grad_accum=args.grad_accum)
    eval_step = programs["eval"]
    train_log, trace_log = init_csv_logs(args.model, resume=bool(resume_path),
                                         start_epoch=start_epoch)
    logging.info("Saving training results to %s", train_log)
    logging.info("----------------")
    logging.info("Start training on %s", torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu")
    logging.info("----------------")
    bestmodel_num = 0
    saver = AsyncSaver() if args.async_ckpt else None
    save_fn = saver.save if saver is not None else save_checkpoint
    try:
        for epoch in range(start_epoch, args.num_epochs):
            t0 = time.time()
            train_losses = run_epoch(train_loader, None, train_step, epoch,
                                     train=True, gen=gen, seed=args.rand_seed + 777,
                                     report_interval=args.report_interval,
                                     train_log_path=train_log, prepare=prepare,
                                     state_holder=holder, device=device)
            logging.info("epoch: %d train loss: %s aeTemporalLoss %s aeSpatialLoss %s "
                         "(%.1fs)", epoch + 1, train_losses["out"],
                         train_losses["temporal_ae"], train_losses["spatial_ae"],
                         time.time() - t0)
            logging.info("-------validation--------")
            valid_losses = run_epoch(valid_loader, holder[0].params, eval_step,
                                     epoch, train=False, prepare=prepare, device=device)
            logging.info("epoch: %d valid loss: %s aeTemporalLoss %s aeSpatialLoss %s",
                         epoch + 1, valid_losses["out"],
                         valid_losses["temporal_ae"], valid_losses["spatial_ae"])
            for name, prog in programs.items():
                logging.info("epoch %d %s program: %s", epoch + 1, name,
                             json.dumps(prog.stats()))
            append_trace(trace_log, epoch, "train", train_losses)
            append_trace(trace_log, epoch, "val", valid_losses)

            valid_loss = (valid_losses["out"] + valid_losses["temporal_ae"]
                          + valid_losses["spatial_ae"])
            if args.save_all:
                save_fn(f"{args.model}_{epoch + 1}", holder[0], epoch=epoch,
                        best_valid_loss=min_valid_loss)
            if min_valid_loss > valid_loss:
                bestmodel_num = epoch + 1
                logging.info("validation loss reduced %.4f -> %.4f",
                             min_valid_loss, valid_loss)
                min_valid_loss = valid_loss
                save_fn(args.model + "_best", holder[0], epoch=epoch,
                        best_valid_loss=min_valid_loss)
                logging.info("writing model params to %s_best.pt", args.model)
            logging.info("----------------")
    finally:
        if saver is not None:
            saver.wait()          # join the last checkpoint write
    logging.info("the best model is epoch %d.", bestmodel_num)
    return holder[0]


if __name__ == "__main__":
    main()
