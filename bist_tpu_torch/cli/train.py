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
`bist_tpu` does.  --init-from-ref <prefix> starts from a reference-format
checkpoint (read through `bist_tpu_torch.convert`, --reference-root naming
a checkout of the reference): its vocabulary and model shape, a fresh
optimizer state.

Data parallelism: --num-devices N (0 = every local device of --device's
type; on the CPU that is 1) above 1 starts N ranks, one process per device
(`torch.multiprocessing`, spawn), rank r on cuda:r (on the CPU, N ranks on
the one CPU), joined by NCCL (gloo on the CPU); started by `torchrun`, the
CLI joins torchrun's group instead (cuda:LOCAL_RANK).  Every rank walks
the same global batches and trains on its rows, the gradients summed
across the ranks inside each captured step (`train.loop.make_grad_step`):
the losses are the one-device run's.  Only rank 0 writes the .conf, the
CSV logs and the checkpoints; --resume loads the same checkpoint on every
rank; at each epoch's end the ranks' parameters are checked bit for bit.
A rank that fails ends the run with a non-zero exit code (the others are
stopped, and every collective has a timeout).
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
                   help="start from a reference-format checkpoint "
                        "(<expdir>/mtn_best + its pickled .conf): its vocab and "
                        "model shape, a fresh optimizer state")
    p.add_argument("--reference-root", default="", type=str,
                   help="a checkout of the reference, for --init-from-ref")
    p.add_argument("--resume", default="", type=str,
                   help="checkpoint to resume from (params + optimizer state "
                        "+ step), or 'auto' to pick up the newest complete "
                        "checkpoint for --model (fresh start if none)")
    p.add_argument("--num-devices", default=0, type=int,
                   help="data-parallel ranks, one process per device: 0 = every "
                        "local device of --device's type (one on the CPU); on the "
                        "CPU, N > 1 runs N ranks on the one CPU")
    p.add_argument("--bf16", default=0, type=int, help="bfloat16 activations")
    p.add_argument("--remat", default=0, type=int,
                   help="gradient checkpointing per decoder round")
    return p


def _ranks(args) -> int:
    """The data-parallel rank count --num-devices asks for on --device's
    type (raises beyond the local CUDA devices)."""
    import torch

    from bist_tpu_torch import resolve_device
    from bist_tpu_torch.parallel.mesh import local_devices

    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is not None:
        if args.num_devices > 1:
            raise SystemExit(f"--num-devices {args.num_devices} with --device {device}: "
                             f"name the device type (cuda) to train on several")
        return 1                    # one named card
    try:
        return len(local_devices(device.type, args.num_devices))
    except ValueError as e:
        raise SystemExit(f"--num-devices {args.num_devices}: {e} "
                         f"({torch.cuda.device_count()} local)") from e


def _torchrun_rank():
    """(rank, world size, local rank) when torchrun started this process in
    a group of several, else None."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and "RANK" in os.environ:
        return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    return None


def _spawned_rank(rank, argv, world, address, threads):
    """One spawned rank: `_train` on its device in the group at `address`."""
    import torch

    torch.set_num_threads(threads)
    _train(build_parser().parse_args(argv), rank, world, address, local_rank=rank)


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    joined = _torchrun_rank()
    world = joined[1] if joined is not None else _ranks(args)
    if args.grad_accum > 1 and args.batch_size % (args.grad_accum * world):
        raise SystemExit(f"--batch-size {args.batch_size} must divide by "
                         f"--grad-accum x ranks ({args.grad_accum} x {world}): each "
                         f"microbatch must still split over the ranks")
    if joined is not None:
        rank, world, local = joined
        return _train(args, rank, world, None, local_rank=local)
    if world > 1:
        import socket

        import torch
        import torch.multiprocessing as mp

        # the group's rendezvous on a free local port; each rank re-parses argv
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            address = f"127.0.0.1:{sock.getsockname()[1]}"
        threads = max(1, torch.get_num_threads() // world)
        # join=True: a rank that raises stops the others and raises here
        mp.start_processes(_spawned_rank, args=(argv, world, address, threads),
                           nprocs=world, start_method="spawn")
        return None
    return _train(args, 0, 1, None)


def _train(args, rank: int, world: int, address, local_rank: int = 0):
    """The training run of one rank (world 1: the whole run)."""
    logging.basicConfig(
        level=(logging.DEBUG if args.verbose >= 1 else logging.INFO) if rank == 0
        else logging.WARNING,
        format=f"%(asctime)s %(levelname)s{f' [rank {rank}]' if world > 1 else ''}: "
               f"%(message)s")
    if rank == 0:
        for k in vars(args):
            print(f"{k}={getattr(args, k)}")
    if args.reference_root and not os.path.isdir(args.reference_root):
        raise SystemExit(f"--reference-root {args.reference_root}: no such directory "
                         f"(a checkout of the reference, for --init-from-ref)")
    ref_conf = ""
    if args.init_from_ref:
        from bist_tpu_torch.convert import default_conf_for, is_reference_conf

        ref_conf = default_conf_for(args.init_from_ref)
        if not os.path.exists(ref_conf) or not is_reference_conf(ref_conf):
            raise SystemExit(f"--init-from-ref {args.init_from_ref}: no reference-format "
                             f".conf (a pickled (vocab, args)) at {ref_conf}")

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
    dp = None
    if world > 1:
        from bist_tpu_torch.parallel import DataParallel, init_multihost

        if device.type == "cuda":
            device = torch.device("cuda", local_rank)
        init_multihost(address, world, rank, device=device)
        dp = DataParallel.in_group(device)
        logging.info("data-parallel: %d ranks (%s), rank %d on %s", dp.n, dp.backend,
                     rank, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    np.random.seed(args.rand_seed)

    ref_init = None
    if args.init_from_ref:
        from bist_tpu_torch.convert import load_reference_checkpoint_cli

        ref_params, ref_cfg, _, vocab, _ = load_reference_checkpoint_cli(
            args.init_from_ref, ref_conf, reference_root=args.reference_root or None,
            device=device)
        # the checkpoint dictates caption preprocessing: the loaders below
        # follow the flags, which must then match it
        if ref_cfg.include_caption != args.include_caption or \
                ref_cfg.separate_caption != bool(args.separate_caption):
            raise SystemExit(
                f"--init-from-ref checkpoint was trained with --include-caption "
                f"{ref_cfg.include_caption} --separate-caption "
                f"{int(ref_cfg.separate_caption)}; pass matching flags (got "
                f"--include-caption {args.include_caption} --separate-caption "
                f"{args.separate_caption})")
        ref_init = (ref_params, ref_cfg)
        logging.info("--init-from-ref %s: vocab (%d words) and model shape come from "
                     "the checkpoint", args.init_from_ref, len(vocab))
    else:
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
    if ref_init is not None:
        import dataclasses

        ref_cfg = ref_init[1]
        if ref_cfg.ft_sizes != ft_sizes:
            raise SystemExit(f"--init-from-ref feature dims {ref_cfg.ft_sizes} != "
                             f"detected {ft_sizes} (check --fea-type)")
        # the structure from the checkpoint, regularisation and precision
        # from the flags
        cfg = dataclasses.replace(ref_cfg, dropout=args.dropout,
                                  attn_dropout=args.attn_dropout, dtype=cfg.dtype,
                                  remat=cfg.remat)
    tcfg = TrainConfig(
        num_epochs=args.num_epochs, rand_seed=args.rand_seed,
        batch_size=args.batch_size, max_length=args.max_length,
        max_history_length=args.max_history_length,
        report_interval=args.report_interval, warmup_steps=args.warmup_steps,
        save_all=bool(args.save_all), cutoff=args.cutoff,
        cut_a=bool(args.cut_a), merge_source=bool(args.merge_source),
        skip=args.skip, num_devices=args.num_devices)

    n_ranks = dp.n if dp is not None else 1

    def prepare(batch):              # runs on the prefetch thread
        """int8 quantisation, then the arrays pinned (the feature grids are
        assembled in pinned memory), so that the programs copy them to the
        card without blocking."""
        if args.feat_int8 and batch.fts is not None and batch.fts_scale is None:
            q8, scale = quantize_features(batch.fts)
            batch = batch._replace(fts=q8, fts_scale=scale)
        return pinned(batch, device)

    # the tail batch is padded to a multiple of the ranks times the
    # microbatch count (padded rows are all-PAD: zero tokens, zero loss;
    # real_count excludes them); a rank takes its rows of each global batch
    mk_loader = lambda data, shuffle, cut_a, pad_mult: AVSDLoader(
        data, visual_stores=vis_stores, audio_stores=aud_stores,
        batch_size=args.batch_size, shuffle=shuffle, cut_a=cut_a,
        seed=args.rand_seed, len_buckets=tcfg.len_buckets,
        time_buckets=tcfg.time_buckets, pad_batch_multiple=pad_mult,
        pin_memory=device.type == "cuda",
        shard=None if dp is None else (dp.rank, dp.n))
    train_loader = mk_loader(train_data, True, bool(args.cut_a),
                             n_ranks * max(args.grad_accum, 1))
    valid_loader = mk_loader(valid_data, False, False, n_ranks)
    logging.info("#train sample = %d  #train batch = %d",
                 len(train_data.examples), len(train_loader))
    logging.info("#validation sample = %d  #validation batch = %d",
                 len(valid_data.examples), len(valid_loader))

    if ref_init is not None:
        # the checkpoint's parameters, a fresh optimizer state
        from bist_tpu_torch.train.loop import TrainState, trainable
        from bist_tpu_torch.train.schedule import make_optimizer
        from bist_tpu_torch.weights import tree_leaves

        tx = make_optimizer(cfg.d_model, tcfg.warmup_steps, tcfg.noam_factor,
                            tcfg.adam_b1, tcfg.adam_b2, tcfg.adam_eps)
        params = trainable(ref_init[0])
        state = TrainState(params, tx.init(tree_leaves(params)), 0)
        logging.info("params initialised from the reference checkpoint "
                     "(fresh optimizer state)")
    else:
        state, tx = create_train_state(args.rand_seed, cfg, tcfg, device=device)
    if dp is not None:
        dp.broadcast_params(state.params)       # every rank starts from rank 0's
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

    writer = rank == 0                          # the one rank that writes files
    if writer:
        os.makedirs(os.path.dirname(os.path.abspath(args.model)), exist_ok=True)
        save_conf(args.model + ".conf", vocab, cfg, tcfg, extra={"fea_type": args.fea_type})
        with open(args.model + "_params.txt", "w") as f:
            for k in vars(args):
                f.write(f"{k}={getattr(args, k)}\n")

    holder = [state]
    gen = dropout_generator(cfg, device)
    programs = {"eval": EvalProgram(state.params, cfg, tcfg, dp=dp)}
    try:
        programs["train"] = TrainProgram(state, cfg, tcfg, tx,
                                         grad_accum=args.grad_accum, gen=gen, dp=dp)
    except ValueError as e:
        # what a graph cannot hold (remat with dropout) steps eagerly, and says so
        logging.warning("the train step runs eagerly, not as a CUDA graph: %s", e)
    train_step = programs.get("train") or make_train_step(cfg, tcfg, tx,
                                                          grad_accum=args.grad_accum, dp=dp)
    eval_step = programs["eval"]
    train_log = trace_log = None
    if writer:
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
                                     rank=rank,
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
            if dp is not None:
                if not dp.replicas_identical(holder[0].params):
                    raise RuntimeError(f"epoch {epoch + 1}: the {dp.n} ranks' parameters "
                                       f"differ after the same updates")
                logging.info("epoch %d: parameters bit-identical on the %d ranks",
                             epoch + 1, dp.n)
            if not writer:
                continue
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
        if dp is not None:
            torch.distributed.destroy_process_group()
    logging.info("the best model is epoch %d.", bestmodel_num)
    return holder[0]


if __name__ == "__main__":
    main()
