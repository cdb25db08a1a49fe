"""The flagship kernel cases of `chip_smoke.py`'s phase 2 (and K2 at the
reference width's train step, D 512 B 32), and phase 6's
train step, from two source trees in turns (A, B, B, A), one process each,
on one card:

    python -m bist_tpu_torch.tools.kernel_ab <tree A> <tree B> [--out file.json]
        [--sass hop1_fwd hop1_bwd]

Each tree is a checkout of this repository (for instance the parent commit
unpacked with `git archive` into a git-ignored directory); each process
builds that tree's kernels from its own sources into its own build/
directory and runs its own `chip_smoke.check_hop1` / `check_hop1_bwd` /
`check_flash` on the main path's shapes, each held against its plain
version (a tree whose check also times "tiled" beside "whole" reports
that too; K3 at head dims 64, 320 and 16, each beside one SDPA call),
then `phase_train` for 16 flagship steps (ms/step, and the device
ms/step of all kernels and of the hop-1 kernels), then phase 18's train
step and phase 17's d_model 1024 one (`step_speed` in CHILD, from the
tree's own chip_smoke helpers: d_model 512, B 32, 65-180 clips, runs of
LONG_STEPS steps; d_model 1024 with 8 heads, B 32, 8-40 clips, runs of
WIDTH_STEPS steps; eager steps through the kernels and under force_plain
in turns, ms/step from the host; K2's launches by kernel; the device ms
by kernel of 2 steps under torch.profiler).  Prints one JSON line per
process and, last, the per-case readings of both trees side by side
("ms" by single call, "device_ms" back to back; chip_smoke.py's methods;
for K3 also "kernel_only_ms", its kernels' own device time a call from
torch.profiler, which the host's work cannot move).  Compare two versions only inside one such run: between runs
the host moves the single-call times.  With
`--sass`, the named kernel libraries of both trees' builds are also
disassembled (cuobjdump -sass) and their instructions compared kernel by
kernel: the kernels whose instructions are identical, those that differ,
and those only one tree has.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

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
    # "wide" at the reference's width and at D 256 (phase 2's cases)
    ("hop1_fwd", "t2s D=512", "check_hop1",
     ("t2s D=512", "wide", 64, 16, 32, 40, 512, 8, True, True, 8), {}),
    ("hop1_fwd", "s2t D=512", "check_hop1",
     ("s2t D=512", "wide", 64, 40, 32, 16, 512, 8, False, False, 34), {}),
    ("hop1_fwd", "t2s D=256", "check_hop1",
     ("t2s D=256", "wide", 64, 16, 32, 40, 256, 8, True, True, 7), {}),
    ("hop1_bwd", "t2s", "check_hop1_bwd", ("t2s", 32, 16, 32, 40, 128, 8, True, True, 11),
     {"variant": "whole", "vs_tiled": True}),
    ("hop1_bwd", "s2t", "check_hop1_bwd", ("s2t", 32, 40, 32, 16, 128, 8, False, False, 12),
     {"variant": "whole", "vs_tiled": True}),
    # the reference width's train step (d_model 512, 8 heads): K2 "wide"
    ("hop1_bwd", "train t2s D=512", "check_hop1_bwd",
     ("train t2s D=512", 32, 16, 32, 40, 512, 8, True, True, 49),
     {"variant": "wide", "vs_tiled": True}),
    ("hop1_bwd", "train s2t D=512", "check_hop1_bwd",
     ("train s2t D=512", 32, 40, 32, 16, 512, 8, False, False, 50),
     {"variant": "wide", "vs_tiled": True}),
    ("hop1_bwd", "train t2s D=256", "check_hop1_bwd",
     ("train t2s D=256", 32, 16, 32, 40, 256, 8, True, True, 51),
     {"variant": "wide", "vs_tiled": True}),
    # d_model 1024's train step shape: each tree's own K2 kernel there
    ("hop1_bwd", "train t2s D=1024", "check_hop1_bwd",
     ("train t2s D=1024", 32, 16, 32, 40, 1024, 8, True, True, 81), {}),
    ("flash_fwd", "mha kv=32768", "check_flash", ("mha kv=32768", 128, 32, 32768, 64, True, 4),
     {}),
    ("flash_fwd", "kv=32768, d=320", "check_flash",
     ("kv=32768, d=320", 32, 32, 32768, 320, True, 26), {}),
    ("flash_fwd", "short kv, d=16", "check_flash", ("short kv, d=16", 4096, 1, 40, 16, True, 5),
     {}),
    ("train", "step", "phase_train", ((), 16), {}),
]
# steps a run of `step_speed` (CHILD), after the cases: phase 18's train
# step, phase 17's d_model 1024 one
LONG_STEPS = 10
WIDTH_STEPS = 3

# run inside a tree (the working directory): its chip_smoke, its kernels;
# the cases come as JSON in argv[1], LONG_STEPS and WIDTH_STEPS in argv[2:4]
CHILD = r"""
import contextlib, inspect, json, re, statistics, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke
from bist_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
_build.build()
dev = torch.device("cuda")


def step_speed(dev, steps, model_kw, clips, seed):
    # a train step of chip_smoke's at model_kw's width, B 32, over clips
    from bist_tpu_torch.config import TrainConfig
    from bist_tpu_torch.data.avsd import load_avsd
    from bist_tpu_torch.data.batching import to_device
    from bist_tpu_torch.ops import dispatch
    from bist_tpu_torch.ops.bist_kernels import hop1_bwd
    from bist_tpu_torch.train.loop import create_train_state, make_train_step
    from bist_tpu_torch.vocab import get_vocabulary

    cs = chip_smoke
    vocab = get_vocabulary(cs.TEST_JSON, cutoff=3, include_caption="summary")
    data = load_avsd(cs.TEST_JSON, vocab, include_caption="summary", separate_caption=True)
    batch = to_device(cs.make_batches(data, 1, 32, seed=seed, answers=True,
                                      clips=clips)[0], dev)
    cfg = cs.flagship_cfg(len(vocab), **model_kw, dropout=0.0, attn_dropout=0.0)
    tcfg = TrainConfig(warmup_steps=10)
    state, tx = create_train_state(0, cfg, tcfg, device=dev)
    step = make_train_step(cfg, tcfg, tx)

    def run(n, plain):
        st, times = cs.copy_state(state), []
        with dispatch.force_plain() if plain else contextlib.nullcontext():
            for _ in range(n):
                t0 = time.perf_counter()
                st, _ = step(st, batch, None)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        return times

    run(1, False)
    run(1, True)
    hop1_bwd.launches, hop1_bwd.variants = 0, {}
    ms = {False: [], True: []}
    for plain in (False, True, True, False):
        ms[plain] += run(steps, plain)
    variants = dict(hop1_bwd.variants)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(2, False)
    return {"ms_per_step": statistics.median(ms[False]),
            "plain_ms_per_step": statistics.median(ms[True]),
            "eager_ms": ms[False], "plain_eager_ms": ms[True], "k2_variants": variants,
            "breakdown": cs.step_breakdown(prof, 2)}


keys = ("ms", "device_ms", "plain_ms", "max_abs_err", "variant", "tiled_ms",
        "tiled_device_ms", "library_ms", "library_device_ms", "bound_ms", "ms_per_step")
out = {}
for kernel, case, fn, args, kw in json.loads(sys.argv[1]):
    f = getattr(chip_smoke, fn)
    takes = inspect.signature(f).parameters
    r = f(dev, *args, **{k: v for k, v in kw.items() if k in takes})
    out[f"{kernel} {case}"] = {k: r[k] for k in keys if k in r}
    if kernel == "flash_fwd":
        # the K3 kernels' own device time a call (CUPTI), without the host
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            f(dev, *args, **{k: v for k, v in kw.items() if k in takes})
        ev = [e for e in prof.key_averages() if "pytorch" not in e.key
              and re.search(r"\bflash_(fwd|fwd_wide|fwd_mma|merge)_kernel<", e.key)]
        calls = sum(e.count for e in ev if "merge" not in e.key)
        total = sum(getattr(e, "self_device_time_total", 0.0) or 0.0 for e in ev)
        if calls:
            out[f"{kernel} {case}"]["kernel_only_ms"] = total / calls / 1e3
    for k in ("device_ms_per_step", "hop1_kernels_ms_per_step"):
        if r.get("profile"):
            out[f"{kernel} {case}"][k] = r["profile"][k]
out["train long video step"] = step_speed(dev, int(sys.argv[2]), chip_smoke.REFERENCE_WIDTH,
                                         chip_smoke.LONG_CLIPS, 3)
out["train d_model 1024 step"] = step_speed(dev, int(sys.argv[3]), chip_smoke.WIDTH_1024,
                                            (8, chip_smoke.T_MAX), 1)
print(json.dumps(out))
"""


def run_tree(tree: str) -> dict:
    r = subprocess.run([sys.executable, "-c", CHILD, json.dumps(CASES), str(LONG_STEPS),
                        str(WIDTH_STEPS)],
                       cwd=tree,
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{tree}: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def sass(tree: str, name: str) -> dict:
    """The instructions of the tree's built kernel library `name`, by kernel
    (its mangled name, the anonymous namespace's hash taken out)."""
    from bist_tpu_torch.ops import _build

    so, = (Path(tree) / "build" / "bist_tpu_torch").glob(f"{name}-*.so")
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            # a kernel in an anonymous namespace carries a hash of its tree's
            # source file in its name: the same name in both trees without it
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w*?_cu_[0-9a-f]{8}", "_GLOBAL__N_",
                          m.group(1))
            cur = out.setdefault(name, [])
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+([^;]*;)", line)
        if m and cur is not None:
            cur.append(m.group(1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tree_a")
    p.add_argument("tree_b")
    p.add_argument("--out", default="")
    p.add_argument("--sass", nargs="*", default=[], metavar="LIBRARY")
    args = p.parse_args(argv)
    runs = []
    for label, tree in (("A", args.tree_a), ("B", args.tree_b), ("B", args.tree_b),
                        ("A", args.tree_a)):
        res = run_tree(tree)
        runs.append((label, res))
        print(json.dumps({"tree": label, "path": tree, "cases": res}), flush=True)
    side = {case: {f"{label}{i}": r[case] for i, (label, r) in enumerate(runs)}
            for case in runs[0][1]}
    for name in args.sass:
        a, b = sass(args.tree_a, name), sass(args.tree_b, name)
        print(json.dumps({"sass": name,
                          "identical": sum(a[k] == b[k] for k in a if k in b),
                          "differing": [k for k in a if k in b and a[k] != b[k]],
                          "only_A": [k for k in a if k not in b],
                          "only_B": [k for k in b if k not in a]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(side, f, indent=1)
    print(json.dumps(side))
    return 0


if __name__ == "__main__":
    sys.exit(main())
