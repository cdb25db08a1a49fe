"""The train CLI at the flagship width on an on-disk dataset of real size:
does the feed (native batch assembly, prefetch, pinning) keep up with the
replayed train step?

    python -m bist_tpu_torch.tools.train_feed [--dialogs 400] [--epochs 3]

Writes the first `--dialogs` dialogs of the vendored DSTC7 test set (every
turn a training example: 1,607 in the first 400) and random float32 features of 8-40 clips x 16
regions x 2048 per video (numpy seed 0) under build/train_feed/, the first
16 of them as the validation set, then runs `python -m
bist_tpu_torch.cli.train` for `--epochs` epochs at the flagship widths
(d_model 128, 8 heads, 3/3/3 blocks, summary caption; dropout 0 so that
hop 1 runs K1 and K2), batches of 32, warmup 4000, on the card.  An epoch
captures each geometry it meets first (the answer cuts are drawn anew each
epoch, so a later epoch can still meet new ones) and replays the rest.  Prints
the card and one JSON line: for each epoch the CLI's "epoch feed"
readings of training and validation (examples/s end to end, seconds waited
on the loader), its train step rate (the steps alone) and its train and
eval programs' stats (geometries captured, capture seconds, graph pool
bytes), read from its log.  Fails when the log holds the native loader's
fallback line or an eager train step.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
TEST_JSON = ROOT / "dstc7avsd_eval" / "data" / "test_set4DSTC7-AVSD.json"
S, DV, T_MIN, T_MAX = 16, 2048, 8, 40


def write_dataset(out: Path, n_dialogs: int, n_valid: int = 16, seed: int = 0):
    """(train set, valid set, feature template) under `out`."""
    (out / "resnext_st").mkdir(parents=True, exist_ok=True)
    full = json.loads(TEST_JSON.read_text())
    rng = np.random.default_rng(seed)
    sets = []
    for name, n in (("train", n_dialogs), ("valid", min(n_valid, n_dialogs))):
        path = out / f"{name}.json"
        path.write_text(json.dumps(dict(full, dialogs=full["dialogs"][:n])))
        sets.append(str(path))
    for d in full["dialogs"][:n_dialogs]:
        t = int(rng.integers(T_MIN, T_MAX + 1))
        np.save(out / "resnext_st" / f"{d['image_id']}.npy",
                rng.standard_normal((t, S, DV), dtype=np.float32))
    return sets[0], sets[1], str(out / "<FeaType>" / "<ImageID>.npy")


def main(argv=None) -> int:
    from bist_tpu_torch.native.loader import FALLBACK_LOG

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dialogs", type=int, default=400)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=str(ROOT / "build" / "train_feed"))
    args = p.parse_args(argv)
    root = Path(args.root)
    train_set, valid_set, path = write_dataset(root, args.dialogs)
    cmd = [sys.executable, "-m", "bist_tpu_torch.cli.train", "--fea-type", "resnext_st",
           "--train-path", path, "--train-set", train_set, "--valid-set", valid_set,
           "--model", str(root / "exp" / "mtn"), "--num-epochs", str(args.epochs),
           "--batch-size", str(args.batch_size), "--nb-blocks", "3", "--nb-venc-blocks", "3",
           "--nb-cenc-blocks", "3", "--d-model", "128", "--att-h", "8",
           "--include-caption", "summary", "--dropout", "0", "--attn-dropout", "0",
           "--report-interval", "1000", "--num-workers", str(args.num_workers),
           "--device", args.device]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1800)
    (root / "train_cli.log").write_text(r.stderr)
    if r.returncode != 0:
        print(r.stderr[-4000:], file=sys.stderr)
        return 1
    if FALLBACK_LOG in r.stderr or "runs eagerly" in r.stderr:
        print("the native assembler or a program was not used", file=sys.stderr)
        return 1
    lines = r.stderr.splitlines()
    logged = lambda marker: [json.loads(ln.split(marker, 1)[1]) for ln in lines if marker in ln]
    rates = [{"examples_per_s": float(m.group(1)), "mean_ms_per_step": float(m.group(2))}
             for m in re.finditer(r"train step rate: (\d+) examples/s \(([\d.]+) ms/step",
                                  r.stderr)]
    epochs = [{"train_feed": t, "eval_feed": e, "train_step_rate": rate, "train_program": tp,
               "eval_program": ep}
              for t, e, rate, tp, ep in zip(
                  logged("train epoch feed: "), logged("eval epoch feed: "), rates,
                  logged(" train program: "), logged(" eval program: "))]
    out = {"dialogs": args.dialogs, "num_workers": args.num_workers,
           "batch_size": args.batch_size, "epochs": epochs}
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
