#!/usr/bin/env python
"""Video feature extraction with the PyTorch port, run offline before
training (the role of the reference video-classification-3d-cnn-pytorch
main.py):

    python -m bist_tpu_torch.cli.extract_features --video_root <dir> \\
        --output <dir> --model resnext-101-kinetics.pth --mode feature \\
        --spatio_temporal 1 --sample_duration 16 --stride 4

The flags and output files are those of `bist_tpu.cli.extract_features`.
Per video: frames (an .npy (T, H, W, 3) stack, a directory of jpg/png
frames, or a video file through ffmpeg when it is on PATH), clips of
--sample_duration frames every --stride, the backbone (`models.resnext3d`
or the zoo of `models.backbones3d`), and one `<output>/<vid>.npy` of
(clips, 16, 2048) channels-last grids — or, with --mode score,
`<output>/<vid>.json` with each clip's top-5 classes, their scores and its
1-based frame `segment`.  A video whose output exists is skipped.
--start_idx/--end_idx shard the sorted file list across invocations.

--pack 1 (default) packs clips across videos into full device batches while
a producer thread decodes the next videos; --pack 0 batches each video on
its own.  Every batch is --batch_size clips (the last zero-padded), so both
give the same features.  --bf16 1 runs the net in bfloat16 (float32 out);
--int8 1 quantizes the bottleneck convs (resnext only; --int8-calib,
--int8-stages).  It runs on CUDA unless --device cpu is given.  --dp N
splits every batch's clips over N devices, each through its own replica of
the backbone (rows are independent: the features are one device's); --dp
0 (default) takes the largest number of local devices of --device's type
that divides --batch_size (one on the CPU, where --dp N runs N replicas on
the one CPU).  --int8 stays on one device, as in `bist_tpu`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np


def _read_images(files) -> np.ndarray:
    from PIL import Image

    return np.stack([np.asarray(Image.open(f).convert("RGB")) for f in files])


def decode_video_ffmpeg(path: str, tmpdir: str) -> np.ndarray:
    """Video file → (T, H, W, 3) uint8 through an ffmpeg jpg dump
    (reference main.py:70)."""
    subprocess.check_call(
        ["ffmpeg", "-nostdin", "-loglevel", "error", "-i", path,
         os.path.join(tmpdir, "image_%05d.jpg")])
    files = sorted(glob.glob(os.path.join(tmpdir, "image_*.jpg")))
    if not files:
        raise RuntimeError(f"no frames decoded from {path}")
    return _read_images(files)


def load_frames(path: str) -> np.ndarray:
    """A video file (needs ffmpeg), a frame directory of jpg/png (needs PIL)
    or a .npy (T, H, W, 3) stack → (T, H, W, 3) uint8 frames."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.jpg"))
                       + glob.glob(os.path.join(path, "*.png")))
        if not files:
            raise RuntimeError(f"no frames in {path}")
        return _read_images(files)
    if path.endswith(".npy"):
        return np.load(path)
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not available; provide frame directories or .npy stacks")
    with tempfile.TemporaryDirectory() as tmp:
        return decode_video_ffmpeg(path, tmp)


def _output_path(args, mode: str, vid: str) -> str:
    return os.path.join(args.output, vid + (".json" if mode == "score" else ".npy"))


def _save_video_output(args, mode, vid, feats, windows, i, total):
    """One video's features (.npy) or scores (.json)."""
    if mode == "score":
        top = np.argsort(-feats, axis=-1)[:, :5]
        with open(_output_path(args, mode, vid), "w") as f:
            json.dump({"video": vid, "clips": [
                {"top5": [int(c) for c in row],
                 "scores": [float(feats[k, c]) for c in row],
                 # the clip's 1-based [first, last] frames (the
                 # generate_result_video contract)
                 "segment": [windows[k][0] + 1, max(windows[k]) + 1]}
                for k, row in enumerate(top)]}, f, indent=1)
        print(f"[{i + 1}/{total}] {vid}: scored {feats.shape[0]} clips")
    else:
        np.save(_output_path(args, mode, vid), feats)
        print(f"[{i + 1}/{total}] {vid}: {feats.shape}")


def run_packed(entries, args, apply_fn, mode):
    """Clips packed across videos: every device batch is `--batch_size`
    clips drawn across video boundaries (the last zero-padded), while a
    producer thread decodes and preprocesses the next videos (the
    reference's DataLoader workers, classify.py:21-22).  The same features
    as the per-video path: the same clips through the same batch shape."""
    from bist_tpu_torch.models.resnext3d import clips_of

    total = len(entries)
    q: "queue.Queue" = queue.Queue(maxsize=2)

    def producer():
        for i, path in enumerate(entries):
            vid = os.path.splitext(os.path.basename(path))[0]
            if os.path.exists(_output_path(args, mode, vid)):
                print(f"[{i + 1}/{total}] {vid}: exists, skip")
                continue
            try:
                clips, windows = clips_of(load_frames(path), args.sample_duration,
                                          args.stride)
            except Exception as e:   # per-video resilience (reference main.py)
                print(f"[{i + 1}/{total}] {vid}: FAILED ({e})")
                continue
            q.put((i, vid, clips, windows))
        q.put(None)

    threading.Thread(target=producer, daemon=True).start()

    B = args.batch_size
    buf_rows = []          # clip arrays, in arrival order
    buf_owner = []         # parallel: index into `open_videos`
    open_videos = []       # [i, vid, windows, n_clips, outputs]

    def flush(final=False):
        nonlocal buf_rows, buf_owner
        while len(buf_rows) >= B or (final and buf_rows):
            take = min(B, len(buf_rows))
            chunk = np.stack(buf_rows[:take])
            if take < B:
                chunk = np.concatenate(
                    [chunk, np.zeros((B - take,) + chunk.shape[1:], chunk.dtype)])
            out = apply_fn(chunk)[:take]
            for owner, row in zip(buf_owner[:take], out):
                open_videos[owner][4].append(row)
            buf_rows, buf_owner = buf_rows[take:], buf_owner[take:]
            # save the videos whose clips are all back (arrival order)
            for idx, v in enumerate(open_videos):
                if v is not None and len(v[4]) == v[3]:
                    i, vid, windows, _, outs = v
                    _save_video_output(args, mode, vid, np.stack(outs), windows, i, total)
                    open_videos[idx] = None

    while True:
        item = q.get()
        if item is None:
            break
        i, vid, clips, windows = item
        open_videos.append([i, vid, windows, len(clips), []])
        buf_rows.extend(clips)
        buf_owner.extend([len(open_videos) - 1] * len(clips))
        flush()
    flush(final=True)


def run_per_video(entries, args, apply_fn, mode):
    """Each video in batches of its own clips (the last zero-padded)."""
    from bist_tpu_torch.models.resnext3d import extract_video_features, make_clip_windows

    total = len(entries)
    for i, path in enumerate(entries):
        vid = os.path.splitext(os.path.basename(path))[0]
        if os.path.exists(_output_path(args, mode, vid)):
            print(f"[{i + 1}/{total}] {vid}: exists, skip")
            continue
        try:
            frames = load_frames(path)
            feats = extract_video_features(
                None, frames, stride=args.stride, batch_size=args.batch_size,
                mode=mode, apply_fn=apply_fn, sample_duration=args.sample_duration)
            windows = make_clip_windows(len(frames), args.sample_duration, args.stride)
            _save_video_output(args, mode, vid, feats, windows, i, total)
        except Exception as e:  # the reference's per-video resilience
            print(f"[{i + 1}/{total}] {vid}: FAILED ({e})")


def build_parser():
    p = argparse.ArgumentParser(description="bist_tpu_torch feature extraction")
    p.add_argument("--video_root", required=True,
                   help="directory of videos / frame dirs / .npy stacks")
    p.add_argument("--output", required=True, help="output feature directory")
    p.add_argument("--model", default="",
                   help="pretrained Kinetics checkpoint (.pth, kenshohara format); "
                        "empty = random init (testing only)")
    p.add_argument("--mode", default="feature", choices=["feature", "score"])
    p.add_argument("--spatio_temporal", type=int, default=1)
    p.add_argument("--temporal_only", type=int, default=0)
    p.add_argument("--sample_duration", type=int, default=16)
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=128, help="clips per device batch")
    p.add_argument("--dp", type=int, default=0,
                   help="devices a batch's clips split over; 0 = the largest count of "
                        "local devices dividing --batch_size")
    p.add_argument("--pack", type=int, default=1,
                   help="pack clips across videos into full device batches, with "
                        "decoding on a producer thread; 0 batches each video on "
                        "its own.  The same features either way.")
    p.add_argument("--start_idx", type=int, default=0)
    p.add_argument("--end_idx", type=int, default=-1)
    p.add_argument("--model_name", default="resnext",
                   choices=["resnext", "resnet", "preresnet", "wideresnet", "densenet"],
                   help="backbone family (reference model.py:7-120 zoo)")
    p.add_argument("--model_depth", type=int, default=101)
    p.add_argument("--resnet_shortcut", default="B", choices=["A", "B"])
    p.add_argument("--wide_resnet_k", type=int, default=2)
    p.add_argument("--bf16", type=int, default=0,
                   help="run the net in bfloat16 (float32 accumulation and output)")
    p.add_argument("--int8", type=int, default=0,
                   help="quantize the bottleneck convs to int8 (per-channel weights, "
                        "per-tensor activations; the stem and the other stages in "
                        "bfloat16); resnext family only")
    p.add_argument("--int8-calib", default="first", choices=["first", "dynamic"],
                   help="int8 activation scales: 'first' calibrates static per-tensor "
                        "scales on the first batch; 'dynamic' takes each conv input's "
                        "abs-max every batch")
    p.add_argument("--int8-stages", default="3,4",
                   help="comma list of 1-based stages to quantize, or 'all'")
    p.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    return p


def _int8_stages(spec: str):
    if spec.strip().lower() == "all":
        return None
    try:
        stages = tuple(sorted(int(s) - 1 for s in spec.split(",")))
    except ValueError:
        sys.exit(f"--int8-stages wants a comma list of 1-based stage numbers or "
                 f"'all', got {spec!r}")
    if any(s < 0 or s > 3 for s in stages):
        sys.exit("--int8-stages values must be in 1..4")
    return stages


def build_apply(args, device, mode, devices=None):
    """The backbone as a function numpy clip batch → numpy float32 outputs,
    at the precision the flags ask for; with `devices` (several, float32 or
    bfloat16), data-parallel: each device's row block through its replica
    (`dp_apply`)."""
    import torch

    from bist_tpu_torch.models import resnext3d as rx
    from bist_tpu_torch.weights import tree_map

    if args.int8 and args.model_name != "resnext":
        sys.exit("--int8 supports the resnext family only")
    stages = _int8_stages(args.int8_stages) if args.int8 else None
    if args.model_name == "resnext":
        if args.model_depth not in rx.DEPTH_BLOCKS:
            sys.exit(f"resnext depth must be one of {sorted(rx.DEPTH_BLOCKS)} "
                     "(reference model.py:54-64)")
        if args.model:
            params = rx.load_torch_resnext(args.model)   # depth from the state dict
            print(f"loaded checkpoint {args.model}")
        else:
            params = rx.init_resnext101(torch.Generator().manual_seed(0),
                                        depth=args.model_depth)
            print("WARNING: random init (no --model checkpoint)")
        backbone = rx.resnext101_apply
    else:
        from bist_tpu_torch.models import backbones3d as zoo

        name = {"preresnet": "preact_resnet"}.get(args.model_name, args.model_name)
        if args.model:
            arch, params = zoo.load_torch_backbone(
                rx.load_checkpoint_state_dict(args.model), name, args.model_depth,
                shortcut=args.resnet_shortcut, wide_k=args.wide_resnet_k)
            print(f"loaded checkpoint {args.model}")
        else:
            arch, params = zoo.init_backbone(
                torch.Generator().manual_seed(0), name, args.model_depth,
                shortcut=args.resnet_shortcut, wide_k=args.wide_resnet_k)
            print("WARNING: random init (no --model checkpoint)")
        backbone = lambda net, x, m: zoo.backbone_apply(arch, net, x, m)  # noqa: E731

    if args.int8:
        params = tree_map(lambda t: t.to(device), params)
        if args.int8_calib == "dynamic":
            net = rx.prepare(rx.quantize_resnext_int8(params, stages=stages), device)
            return rx.batch_apply(net, mode, torch.bfloat16, backbone)
        # static scales calibrated on the first batch: one float forward
        # records each conv input's abs-max, then every batch runs the
        # reduce-free static path
        state = {"params": params}

        def apply_fn(chunk):
            if "run" not in state:
                fp = state.pop("params")
                x = torch.from_numpy(chunk).to(device).to(torch.bfloat16)
                scales = rx.collect_act_scales(rx.prepare(fp, device), x)
                qnet = rx.prepare(rx.quantize_resnext_int8(fp, act_scales=scales,
                                                           stages=stages), device)
                state["run"] = rx.batch_apply(qnet, mode, torch.bfloat16, backbone)
                print("int8: calibrated static scales on first batch")
            return state["run"](chunk)

        return apply_fn
    dtype = torch.float32
    if args.bf16:
        params = tree_map(lambda t: t.to(torch.bfloat16), params)
        dtype = torch.bfloat16
    if devices is not None and len(devices) > 1:
        return dp_apply(params, devices, mode, dtype, backbone)
    return rx.batch_apply(rx.prepare(params, device), mode, dtype, backbone)


def dp_apply(params, devices, mode, dtype, backbone):
    """Data-parallel `batch_apply`: a batch's clips split into contiguous row
    blocks, block i through the backbone's replica on devices[i] (one net a
    device; devices that repeat share theirs), every block launched before
    any is read back, the outputs in row order."""
    import torch

    from bist_tpu_torch.models import resnext3d as rx
    from bist_tpu_torch.parallel.mesh import DataParallel, row_slice

    dp = DataParallel(devices=devices)
    nets = {}
    for d in dp.devices:
        if d not in nets:
            nets[d] = rx.prepare(params, d)

    def run(chunk: np.ndarray) -> np.ndarray:
        outs = [backbone(nets[d],
                         torch.from_numpy(chunk[row_slice(i, dp.n, len(chunk))]).to(d).to(dtype),
                         mode) for i, d in enumerate(dp.devices)]
        return np.concatenate([o.float().cpu().numpy() for o in outs])

    return run


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from bist_tpu_torch import resolve_device
    from bist_tpu_torch.parallel.mesh import local_devices

    device = resolve_device(args.device)
    # the data-parallel conv stage: --dp 0 is the largest local device count
    # dividing --batch_size; the int8 path stays on one device (as bist_tpu's)
    n_avail = torch.cuda.device_count() if device.type == "cuda" else 1
    dp_n = args.dp if args.dp > 0 else max(
        n for n in range(1, n_avail + 1) if args.batch_size % n == 0)
    if args.int8:
        dp_n = 1
    devices = None
    if dp_n > 1:
        if args.batch_size % dp_n:
            sys.exit(f"--batch_size {args.batch_size} not divisible by --dp {dp_n}")
        try:
            devices = local_devices(device.type, dp_n)
        except ValueError as e:
            sys.exit(f"--dp {dp_n}: {e}")
        print(f"extraction mesh: {dp_n} of {n_avail} device(s)")
    if args.mode == "score":
        mode = "score"
    else:
        mode = "spatio_temporal" if args.spatio_temporal else "temporal_only"
        if args.temporal_only:
            mode = "temporal_only"

    entries = sorted(
        glob.glob(os.path.join(args.video_root, "*.mp4"))
        + glob.glob(os.path.join(args.video_root, "*.gif"))
        + glob.glob(os.path.join(args.video_root, "*.webm"))
        + glob.glob(os.path.join(args.video_root, "*.npy"))
        + [d for d in glob.glob(os.path.join(args.video_root, "*")) if os.path.isdir(d)])
    end = args.end_idx if args.end_idx >= 0 else len(entries)
    entries = entries[args.start_idx:end]
    os.makedirs(args.output, exist_ok=True)

    with torch.inference_mode():
        apply_fn = build_apply(args, device, mode, devices)
        (run_packed if args.pack else run_per_video)(entries, args, apply_fn, mode)


if __name__ == "__main__":
    main()
