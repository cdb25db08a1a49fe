#!/usr/bin/env python
"""Response generation with the PyTorch port:

    python -m bist_tpu_torch.cli.generate --test-set <json> \
        --test-path '<dir>/<FeaType>/<ImageID>.npy' --model <prefix> \
        --decode-style beam_search --beam 5 --output result.json

The flags and the result JSON are those of `bist_tpu.cli.generate`: it reads
<prefix>.conf (JSON, either package's) and the port checkpoint <prefix>.pt,
iterates the test JSON in dialog order, decodes each turn in batches of
--gen-batch-size and writes the input structure back with the answers
replaced.  It runs on CUDA unless --device cpu is given.

The decode styles are those of `bist_tpu`: greedy (the default), beam_search
(with --ensemble <prefix> ... for a sum of several models' log-probs),
oracle (teacher-forced argmax; needs labeled turns, so not with
--undisclosed-only) and sample (--temperature, --top-k, --top-p,
--sample-seed).  Each style runs as one CUDA graph per batch geometry
(`decode.compiled.DecodeProgram`), captured the first time the geometry
comes; on the CPU the same program runs eagerly.  As `bist_tpu` shards rows
over every local device, the rows of each batch split over --num-devices
devices (0, the default: every local device of --device's type; one on the
CPU, where N > 1 runs N replicas on the one CPU), one program per device
(`decode.compiled.ShardedDecode`): the tail batch pads to a multiple of the
device count and the answers are one device's.  A reference-format
checkpoint (<prefix>_best.pth.tar beside a pickled .conf, detected by the
.conf) is read through `bist_tpu_torch.convert`, with --reference-root
naming a checkout of the reference for its pickled classes.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import time

PORTED_STYLES = ("beam_search", "greedy", "oracle", "sample")


def build_parser():
    p = argparse.ArgumentParser(description="bist_tpu_torch generation")
    p.add_argument("--gpu", "-g", default=0, type=int, help="CLI parity no-op")
    p.add_argument("--test-path", default="", type=str)
    p.add_argument("--test-set", default="", type=str)
    p.add_argument("--model-conf", default="", type=str)
    p.add_argument("--reference-root", default="", type=str,
                   help="a checkout of the reference, for reference-format "
                        "checkpoints (--model <expdir>/mtn_best + pickled .conf)")
    p.add_argument("--model", "-m", default="", type=str,
                   help="checkpoint prefix: <prefix>.pt (+ <prefix>.conf), or a "
                        "reference-format checkpoint")
    p.add_argument("--maxlen", default=12, type=int)
    p.add_argument("--dec-eos", default=0, type=int)
    p.add_argument("--beam", default=3, type=int)
    p.add_argument("--penalty", default=2.0, type=float)
    p.add_argument("--nbest", default=5, type=int)
    p.add_argument("--output", "-o", default="", type=str)
    p.add_argument("--verbose", "-v", default=0, type=int)
    p.add_argument("--decode-style", default="greedy", type=str,
                   help="beam_search | greedy | oracle | sample")
    p.add_argument("--temperature", default=1.0, type=float)
    p.add_argument("--top-k", default=0, type=int)
    p.add_argument("--top-p", default=0.0, type=float)
    p.add_argument("--sample-seed", default=1, type=int)
    p.add_argument("--cache-dtype", default="float32",
                   choices=["float32", "bfloat16", "float8_e4m3fn", "float8_e5m2"],
                   help="storage of the decode memory (KV cache, "
                        "cross-attention K/V, pointer sources); float8 is "
                        "stored at 1 byte and read as bfloat16 (answers may "
                        "differ from float32)")
    p.add_argument("--encode-dtype", default="", choices=["", "float32", "bfloat16"],
                   help="context-precompute activation dtype ('' = the "
                        "model's own); bfloat16 gives hop 1 a bfloat16 grid "
                        "(answers may differ from float32)")
    p.add_argument("--scan-unroll", default=1, type=int,
                   help="accepted for CLI parity; the port's beam loop is a "
                        "Python loop, so there is nothing to unroll")
    p.add_argument("--undisclosed-only", default=0, type=int)
    p.add_argument("--labeled-test", default=None, type=str)
    p.add_argument("--num-workers", default=0, type=int,
                   help="threads of each feature store's prefetch pool (at least 1)")
    p.add_argument("--gen-batch-size", default=32, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    p.add_argument("--num-devices", default=0, type=int,
                   help="devices each batch's rows split over: 0 = every local device "
                        "of --device's type (one on the CPU)")
    p.add_argument("--ensemble", nargs="*", default=None,
                   help="additional checkpoint prefixes to ensemble with "
                        "--model (summed log-probs; all share --model-conf)")
    p.add_argument("--feat-int8", default=0, type=int,
                   help="ship video features as int8 + per-position scale, "
                        "dequantised on the device")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose >= 1 else logging.INFO,
        format="%(asctime)s %(levelname)s: %(message)s")
    for k in vars(args):
        print(f"{k}={getattr(args, k)}")
    if args.decode_style not in PORTED_STYLES:
        raise SystemExit(f"--decode-style {args.decode_style}: not one of "
                         f"{', '.join(PORTED_STYLES)}")
    if args.reference_root and not os.path.isdir(args.reference_root):
        raise SystemExit(f"--reference-root {args.reference_root}: no such directory; "
                         f"reference-format checkpoints are not read without a "
                         f"checkout of the reference")
    if args.decode_style == "oracle" and args.undisclosed_only:
        raise SystemExit("--decode-style oracle requires labeled targets; "
                         "run without --undisclosed-only")
    if args.ensemble and args.decode_style != "beam_search":
        raise SystemExit("--ensemble is only supported with "
                         "--decode-style beam_search")

    import torch

    from bist_tpu_torch import resolve_device
    from bist_tpu_torch.config import GenerateConfig, load_conf
    from bist_tpu_torch.convert import (default_conf_for, is_reference_conf,
                                        load_reference_checkpoint_cli)
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.batching import pinned, quantize_features
    from bist_tpu_torch.data.features import build_stores
    from bist_tpu_torch.data.loader import AVSDLoader, device_prefetch
    from bist_tpu_torch.decode.beam import extract_hyps
    from bist_tpu_torch.decode.compiled import ShardedDecode
    from bist_tpu_torch.parallel.mesh import local_devices
    from bist_tpu_torch.decode.sample import mix_seed
    from bist_tpu_torch.vocab import ids2words, make_id2word
    from bist_tpu_torch.weights import load_params

    device = resolve_device(args.device)
    try:
        devices = [device] if device.index is not None and args.num_devices <= 1 \
            else local_devices(device.type, args.num_devices)
    except ValueError as e:
        raise SystemExit(f"--num-devices {args.num_devices}: {e}") from e
    device = devices[0]
    if len(devices) > 1:
        logging.info("decoding data-parallel over %d devices", len(devices))
    torch.backends.cuda.matmul.allow_tf32 = False
    conf_path = args.model_conf or default_conf_for(args.model)

    def load(prefix):
        path = prefix if prefix.endswith(".pt") else prefix + ".pt"
        logging.info("Loading model params from %s", path)
        return load_params(path, device)

    if is_reference_conf(conf_path):
        if args.ensemble:
            raise SystemExit("--ensemble is not supported with reference-format "
                             "checkpoints; convert them first (bist_tpu_torch.convert)")
        logging.info("reference-format checkpoint detected; importing")
        params, cfg, tcfg, vocab, extra = load_reference_checkpoint_cli(
            args.model, conf_path, reference_root=args.reference_root or None,
            device=device)
    else:
        vocab, cfg, tcfg, extra = load_conf(conf_path)
        params = load(args.model)
    if args.ensemble:
        params = [params] + [load(p) for p in args.ensemble]
        logging.info("ensembling %d models", len(params))
    id2word = make_id2word(vocab)
    logging.info("#vocab = %d", len(vocab))

    # feature-type override at test time (reference generate.py:101-104)
    had_vggish = any("vggish" in str(s)
                     for s in (extra.get("fea_type") or [])) or cfg.has_audio
    fea_type = ["resnext_st"] + (["vggish_testset"] if had_vggish else [])
    if not cfg.has_video:
        fea_type = None

    logging.info("Loading test data from %s", args.test_set)
    test_data = load_avsd(args.test_set, vocab,
                          include_caption=cfg.include_caption,
                          separate_caption=cfg.separate_caption,
                          max_history_length=tcfg.max_history_length,
                          merge_source=tcfg.merge_source,
                          undisclosed_only=bool(args.undisclosed_only))
    vis_stores, aud_stores = build_stores(fea_type, args.test_path,
                                          test_data.vid_set, skip=tcfg.skip,
                                          workers=args.num_workers)
    loader = AVSDLoader(test_data, visual_stores=vis_stores,
                        audio_stores=aud_stores, batch_size=args.gen_batch_size,
                        shuffle=False, cut_a=False, len_buckets=tcfg.len_buckets,
                        time_buckets=tcfg.time_buckets, pin_memory=device.type == "cuda",
                        pad_batch_multiple=len(devices))
    logging.info("#test sample = %d  #test batch = %d",
                 len(test_data.examples), len(loader))

    labeled_test = None
    if args.undisclosed_only and args.labeled_test:
        with open(args.labeled_test) as f:
            labeled_test = json.load(f)

    gcfg = GenerateConfig(maxlen=args.maxlen, beam=args.beam,
                          penalty=args.penalty, nbest=args.nbest,
                          dec_eos=bool(args.dec_eos),
                          undisclosed_only=bool(args.undisclosed_only),
                          decode_style=args.decode_style,
                          gen_batch_size=args.gen_batch_size,
                          cache_dtype=args.cache_dtype,
                          encode_dtype=args.encode_dtype,
                          temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, sample_seed=args.sample_seed)
    # the decode style as one CUDA graph per batch geometry on each device,
    # captured the first time the geometry comes (as bist_tpu jits each style)
    program = ShardedDecode(params, cfg, gcfg, devices)

    logging.info("----------------------- generate --------------------------")
    start_time = time.time()
    answers = {}     # qa_id -> (answer string, nbest hypotheses or None)
    n_done = 0

    def prepare(batch):
        """Loader-thread work for the upcoming batches: int8 quantisation and
        the arrays pinned, so that the program copies them in without
        blocking."""
        if args.feat_int8 and batch.fts is not None:
            q8, scale = quantize_features(batch.fts)
            batch = batch._replace(fts=q8, fts_scale=scale)
        return pinned(batch, device)

    def drain(out, meta):
        """The answers of a decoded batch (reading them waits for its decode;
        the next batch is queued on the card by then)."""
        nonlocal n_done
        out = program.gather(out)       # every device's rows, in order, on the host
        if gcfg.decode_style == "beam_search":
            for row in range(meta.real_count):
                hyps = extract_hyps(out, id2word, row, gcfg.nbest)
                answers[meta.qa_ids[row]] = (" ".join(hyps[0][0]) if hyps else "", hyps)
        else:
            out = out.numpy()
            for row in range(meta.real_count):
                answers[meta.qa_ids[row]] = (" ".join(ids2words(out[row], id2word)), None)
        n_done += meta.real_count
        logging.info("decoded %d/%d turns (%.1f turns/s; %d geometries captured "
                     "in %.2f s)", n_done, len(test_data.examples),
                     n_done / max(time.time() - start_time, 1e-9),
                     sum(p.captures for p in program.programs),
                     sum(p.capture_seconds for p in program.programs))

    pending = None
    for n_batch, (batch, meta) in enumerate(device_prefetch(iter(loader), prepare)):
        if gcfg.decode_style == "beam_search":
            out = program(batch)
        else:
            # sampling: the batch counter folded into the seed, so rows of
            # different batches draw independent noise
            out = program(batch, seed=mix_seed(args.sample_seed, n_batch))
        if pending is not None:
            drain(*pending)
        pending = (out, meta)
    if pending is not None:
        drain(*pending)

    # reassemble the result JSON in original order (generate.py:30-71)
    result_dialogs = []
    qa_id = 0
    for idx, dialog in enumerate(test_data.original["dialogs"]):
        vid = dialog["image_id"]
        if args.undisclosed_only:
            out_dialog = dialog["dialog"][-1:]
            ref_dialog = None
            if labeled_test is not None:
                ref = labeled_test["dialogs"][idx]
                if ref["image_id"] != vid:
                    raise ValueError(f"--labeled-test dialog {idx} is "
                                     f"{ref['image_id']}, expected {vid}")
                ref_dialog = ref["dialog"][-1:]
        else:
            out_dialog = dialog["dialog"]
            ref_dialog = None
        pred_dialog = {"image_id": vid, "dialog": copy.deepcopy(out_dialog)}
        result_dialogs.append(pred_dialog)
        for t, qa in enumerate(out_dialog):
            if qa_id not in answers:
                qa_id += 1
                continue
            best, hyps = answers[qa_id]
            logging.info("%d %s_%d", qa_id, vid, t)
            logging.info("QS: %s", qa["question"])
            logging.info("REF: %s", ref_dialog[t]["answer"] if ref_dialog
                         else qa["answer"])
            if hyps:
                for n, (words, score) in enumerate(hyps):
                    logging.info("HYP[%d]: %s  ( %f )", n + 1, " ".join(words), score)
            else:
                logging.info("HYP: %s", best)
            pred_dialog["dialog"][t]["answer"] = best
            qa_id += 1
            logging.info("-----------------------")

    wall = time.time() - start_time
    logging.info("----------------")
    logging.info("wall time = %f  (%.2f responses/sec, %s)", wall,
                 len(test_data.examples) / max(wall, 1e-9),
                 torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu")
    result = {"dialogs": result_dialogs}
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        logging.info("writing results to %s", args.output)
        with open(args.output, "w") as f:
            json.dump(result, f, indent=4)
    logging.info("done")
    return result


if __name__ == "__main__":
    main()
