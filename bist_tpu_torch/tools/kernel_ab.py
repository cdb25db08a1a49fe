"""The flagship kernel cases of `chip_smoke.py`'s phase 2, and phase 6's
train step, from two source trees in turns (A, B, B, A), one process each,
on one card:

    python -m bist_tpu_torch.tools.kernel_ab <tree A> <tree B> [--out file.json]

Each tree is a checkout of this repository (for instance the parent commit
unpacked with `git archive` into a git-ignored directory); each process
builds that tree's kernels from its own sources into its own build/
directory and runs its own `chip_smoke.check_hop1` / `check_hop1_bwd` /
`check_flash` on the main path's shapes, each held against its plain
version (a tree whose check also times "tiled" beside "whole" reports
that too), then `phase_train` for 16 flagship steps (ms/step, and the
device ms/step of all kernels and of the hop-1 kernels).  Prints one JSON line per process and, last, the per-case
readings of both trees side by side ("ms" by single call, "device_ms" back
to back; chip_smoke.py's methods).  Compare two versions only inside one
such run: between runs the host moves the single-call times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (kernel, case, chip_smoke function, its arguments after the device, its
# keyword arguments: a tree whose function does not take one runs without it)
CASES = [
    ("hop1_fwd", "t2s", "check_hop1", ("t2s", "whole", 64, 16, 32, 40, 128, 8, True, True, 1),
     {}),
    ("hop1_fwd", "s2t", "check_hop1",
     ("s2t", "whole", 64, 40, 32, 16, 128, 8, False, False, 2), {}),
    ("hop1_fwd", "train t2s", "check_hop1",
     ("train t2s", "whole", 32, 16, 32, 40, 128, 8, True, True, 9, True), {}),
    ("hop1_fwd", "train s2t", "check_hop1",
     ("train s2t", "whole", 32, 40, 32, 16, 128, 8, False, False, 10, True), {}),
    ("hop1_bwd", "t2s", "check_hop1_bwd", ("t2s", 32, 16, 32, 40, 128, 8, True, True, 11),
     {"variant": "whole", "vs_tiled": True}),
    ("hop1_bwd", "s2t", "check_hop1_bwd", ("s2t", 32, 40, 32, 16, 128, 8, False, False, 12),
     {"variant": "whole", "vs_tiled": True}),
    ("flash_fwd", "mha kv=32768", "check_flash", ("mha kv=32768", 128, 32, 32768, 64, True, 4),
     {}),
    ("train", "step", "phase_train", ((), 16), {}),
]

# run inside a tree (the working directory): its chip_smoke, its kernels;
# the cases come as JSON in argv[1]
CHILD = r"""
import inspect, json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke
from bist_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
_build.build()
dev = torch.device("cuda")
keys = ("ms", "device_ms", "plain_ms", "max_abs_err", "variant", "tiled_ms",
        "tiled_device_ms", "ms_per_step")
out = {}
for kernel, case, fn, args, kw in json.loads(sys.argv[1]):
    f = getattr(chip_smoke, fn)
    takes = inspect.signature(f).parameters
    r = f(dev, *args, **{k: v for k, v in kw.items() if k in takes})
    out[f"{kernel} {case}"] = {k: r[k] for k in keys if k in r}
    for k in ("device_ms_per_step", "hop1_kernels_ms_per_step"):
        if r.get("profile"):
            out[f"{kernel} {case}"][k] = r["profile"][k]
print(json.dumps(out))
"""


def run_tree(tree: str) -> dict:
    r = subprocess.run([sys.executable, "-c", CHILD, json.dumps(CASES)], cwd=tree,
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{tree}: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tree_a")
    p.add_argument("tree_b")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    runs = []
    for label, tree in (("A", args.tree_a), ("B", args.tree_b), ("B", args.tree_b),
                        ("A", args.tree_a)):
        res = run_tree(tree)
        runs.append((label, res))
        print(json.dumps({"tree": label, "path": tree, "cases": res}), flush=True)
    side = {case: {f"{label}{i}": r[case] for i, (label, r) in enumerate(runs)}
            for case in runs[0][1]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(side, f, indent=1)
    print(json.dumps(side))
    return 0


if __name__ == "__main__":
    sys.exit(main())
