"""The extractor's layout and cuDNN search on one card: which activation
memory format and which `torch.backends.cudnn.benchmark` setting
`models.resnext3d` keeps (`MEMORY_FORMAT`, `CUDNN_BENCHMARK`).

    python -m bist_tpu_torch.tools.extract_probe [--depth 101] [--batch 128] [--out f.json]

ResNeXt at --depth with random weights from seed 0 on a batch of random
16 × 112 × 112 clips, in float32 (TF32 off), bfloat16 and int8 (stages 3
and 4, static scales calibrated on the batch), each with (N, C, T, H, W)
activations contiguous and in `torch.channels_last_3d`, each with cuDNN's
algorithm search off and on.  Each case runs in a process of its own:
PyTorch keeps one cuDNN plan per convolution shape for the process
whatever the search setting, so a case run after another of the same
shapes would reuse its plan; the case's process sets the two module
constants before it prepares a net.  For every case it prints one JSON
line: the first call's seconds (where the search runs), then chip_smoke's
`extractor_speed` readings (median ms of 5 batches after 2, clips/s,
TFLOP/s, device ms by part, busy share, top kernels).  Last, the fastest
case of each precision.  The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


PRECISIONS = ("float32", "bfloat16", "int8")
FORMATS = ("contiguous", "channels_last_3d")


def run_case(precision: str, fmt_name: str, bench: bool, depth: int, batch: int,
             reps: int) -> dict:
    import torch

    from chip_smoke import extractor_speed, kinetics_clips, resnext_conv_macs
    from bist_tpu_torch.models import resnext3d as rx
    from bist_tpu_torch.weights import tree_map

    device = torch.device("cuda")
    rx.MEMORY_FORMAT = {"contiguous": torch.contiguous_format,
                        "channels_last_3d": torch.channels_last_3d}[fmt_name]
    rx.CUDNN_BENCHMARK = bench
    params = rx.init_resnext101(torch.Generator().manual_seed(0), depth=depth)
    macs = sum(resnext_conv_macs(params).values())
    with torch.inference_mode():
        clips = kinetics_clips(batch, 2, device)
        if precision == "bfloat16":
            params = tree_map(lambda t: t.to(torch.bfloat16), params)
        elif precision == "int8":
            scales = rx.collect_act_scales(rx.prepare(params, device),
                                           clips.to(torch.bfloat16))
            params = rx.quantize_resnext_int8(params, act_scales=scales, stages=(2, 3))
        net = rx.prepare(params, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rx.resnext101_apply(net, clips)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        return {"precision": precision, "memory_format": fmt_name, "cudnn_benchmark": bench,
                "first_call_s": first, **extractor_speed(device, net, clips, macs, reps=reps)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--depth", type=int, default=101)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default="")
    p.add_argument("--case", default="", help=argparse.SUPPRESS)   # precision,format,0|1
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("extract_probe measures the card: no CUDA device")
    if args.case:
        precision, fmt_name, bench = args.case.split(",")
        print(json.dumps(run_case(precision, fmt_name, bench == "1", args.depth, args.batch,
                                  args.reps)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = []
    for precision in PRECISIONS:
        for fmt_name in FORMATS:
            for bench in (0, 1):
                r = subprocess.run(
                    [sys.executable, "-m", "bist_tpu_torch.tools.extract_probe",
                     "--depth", str(args.depth), "--batch", str(args.batch),
                     "--reps", str(args.reps), "--case", f"{precision},{fmt_name},{bench}"],
                    capture_output=True, text=True, timeout=600, check=True)
                row = json.loads(r.stdout.strip().splitlines()[-1])
                rows.append(row)
                print(json.dumps(row), flush=True)
    best = {}
    for r in rows:
        if r["precision"] not in best or r["ms_per_batch"] < best[r["precision"]]["ms_per_batch"]:
            best[r["precision"]] = r
    summary = {k: {"memory_format": v["memory_format"], "cudnn_benchmark": v["cudnn_benchmark"],
                   "ms_per_batch": v["ms_per_batch"], "clips_per_s": v["clips_per_s"]}
               for k, v in best.items()}
    print(json.dumps({"card": card, "fastest": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows, "fastest": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
