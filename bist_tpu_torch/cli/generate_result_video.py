#!/usr/bin/env python
"""Classification-result visualizer of the PyTorch port — a copy of
`bist_tpu.cli.generate_result_video` (framework-free), role-equivalent to
the reference `video-classification-3d-cnn-pytorch/generate_result_video/`
demo.

Takes the `--mode score` output of `bist_tpu_torch.cli.extract_features`
(per-clip class scores + 1-based frame `segment` ranges), averages scores
over `--temporal_unit` clip groups, overlays the winning class name on every
frame of each group's segment, and re-encodes the annotated video.

Differences from the reference demo (generate_result_video.py:28-99), by
environment design rather than omission:
  * frame decode reuses the extractor's load_frames (ffmpeg when present,
    else frame directories / .npy stacks) instead of requiring ffmpeg;
  * output is an .mp4 via ffmpeg when available, otherwise an animated .gif
    (PIL, no external binaries) — `--output_format {auto,mp4,gif,frames}`;
  * the label font is the system DejaVu Sans (the reference ships a TTF).

Usage:
  python -m bist_tpu_torch.cli.generate_result_video <score_json_dir_or_file> \
      <video_root> <dst_dir> <class_names_file> <temporal_unit> [--fps 25]
"""

import argparse
import glob
import json
import os
import shutil
import subprocess
import tempfile

import numpy as np

FONT_CANDIDATES = (
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
)


def _font(size: int):
    from PIL import ImageFont

    for path in FONT_CANDIDATES:
        if os.path.exists(path):
            return ImageFont.truetype(path, size)
    return ImageFont.load_default(size)


def annotate_frames(frames: np.ndarray, labels_per_frame) -> list:
    """frames (T, H, W, 3) uint8 + per-frame label string (or None) →
    list of PIL images with the reference's label box (dark box, light
    text, 5% min-side font — generate_result_video.py:74-92)."""
    from PIL import Image, ImageDraw

    out = []
    for i, arr in enumerate(frames):
        image = Image.fromarray(arr).convert("RGB")
        label = labels_per_frame[i]
        if label:
            min_length = min(image.size)
            font_size = max(int(min_length * 0.05), 8)
            font = _font(font_size)
            d = ImageDraw.Draw(image)
            l, t, r, b = d.textbbox((0, 0), label, font=font)
            tw, th = r - l, b - t
            x = int(font_size * 0.5)
            y = int(font_size * 0.25)
            d.rectangle((x, y, x + tw + x * 2, y + th + y * 2),
                        fill=(30, 30, 30))
            d.text((x + x, y + y), label, font=font, fill=(235, 235, 235))
        out.append(image)
    return out


def unit_labels(clips, class_names, temporal_unit: int):
    """Average scores over groups of `temporal_unit` clips (0 = the whole
    video as one unit) and return [(label, (seg_first, seg_last))], 1-based
    inclusive frame ranges (reference generate_result_video.py:49-63)."""
    unit = len(clips) if temporal_unit == 0 else temporal_unit
    units = []
    for i in range(0, len(clips), unit):
        group = clips[i:i + unit]
        # accumulate scores BY CLASS ID across the group's clips (each
        # clip's `scores` are aligned with its own `top5` ids, and the
        # extractor emits them sorted descending — a positionwise slot
        # average would therefore always elect clip[0]'s top-1 and mix
        # scores of unrelated classes).  This is
        # the cross-clip vote the reference intends (its own group loop
        # has a bug re-adding clips[i]'s scores instead of clips[j]'s,
        # generate_result_video.py:58-59).
        acc: dict = {}
        for c in group:
            scores = np.asarray(c["scores"], np.float64)
            ids = c.get("top5", list(range(len(scores))))
            for cls_id, s in zip(ids, scores):
                acc[cls_id] = acc.get(cls_id, 0.0) + float(s)
        cls = max(acc, key=acc.get)
        label = class_names[cls] if cls < len(class_names) else str(cls)
        units.append((label, (group[0]["segment"][0],
                              group[-1]["segment"][1])))
    return units


def write_video(images, dst_path: str, fps: float, fmt: str) -> str:
    """Encode annotated frames.  Returns the actual output path."""
    if fmt == "auto":
        fmt = "mp4" if shutil.which("ffmpeg") else "gif"
    base = os.path.splitext(dst_path)[0]
    if fmt == "mp4":
        with tempfile.TemporaryDirectory() as tmp:
            for i, im in enumerate(images):
                im.save(os.path.join(tmp, f"image_{i + 1:05d}.jpg"))
            out = base + ".mp4"
            subprocess.check_call(
                ["ffmpeg", "-nostdin", "-y", "-loglevel", "error",
                 "-r", str(fps), "-i", os.path.join(tmp, "image_%05d.jpg"),
                 "-b:v", "1000k", out])
            return out
    if fmt == "gif":
        out = base + ".gif"
        images[0].save(out, save_all=True, append_images=images[1:],
                       duration=int(1000 / fps), loop=0)
        return out
    # frames: a directory of annotated jpgs
    out = base + "_frames"
    os.makedirs(out, exist_ok=True)
    for i, im in enumerate(images):
        im.save(os.path.join(out, f"image_{i + 1:05d}.jpg"))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("result", help="score .json file or directory of them "
                                  "(the extractor's --mode score output)")
    p.add_argument("video_root", help="directory of videos / frame dirs / "
                                      ".npy stacks (the extractor's loaders)")
    p.add_argument("dst_dir")
    p.add_argument("class_names", help="one class name per line "
                                       "(e.g. Kinetics-400 labels)")
    p.add_argument("temporal_unit", type=int,
                   help="clips per label unit; 0 = whole video")
    p.add_argument("--fps", type=float, default=25.0,
                   help="output frame rate (the reference probes ffprobe; "
                        "frame-dir/.npy inputs carry no fps)")
    p.add_argument("--output_format", default="auto",
                   choices=["auto", "mp4", "gif", "frames"])
    args = p.parse_args(argv)

    from bist_tpu_torch.cli.extract_features import load_frames

    with open(args.class_names) as f:
        class_names = [ln.rstrip("\n") for ln in f]

    if os.path.isdir(args.result):
        result_files = sorted(glob.glob(os.path.join(args.result, "*.json")))
    else:
        result_files = [args.result]
    os.makedirs(args.dst_dir, exist_ok=True)

    for rf in result_files:
        with open(rf) as f:
            result = json.load(f)
        results = result if isinstance(result, list) else [result]
        for entry in results:
            vid = entry["video"]
            candidates = ([os.path.join(args.video_root, vid)]
                          + glob.glob(os.path.join(args.video_root,
                                                   vid + ".*")))
            path = next((c for c in candidates if os.path.exists(c)), None)
            if path is None:
                print(f"{vid}: video not found, skip")
                continue
            frames = load_frames(path)
            labels = [None] * len(frames)
            for label, (first, last) in unit_labels(
                    entry["clips"], class_names, args.temporal_unit):
                for j in range(first - 1, min(last, len(frames))):
                    labels[j] = label
            images = annotate_frames(frames, labels)
            out = write_video(images,
                              os.path.join(args.dst_dir, vid + ".mp4"),
                              args.fps, args.output_format)
            print(f"{vid}: {out} ({len(images)} frames)")


if __name__ == "__main__":
    main()
