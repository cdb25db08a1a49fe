"""K1 "wide"'s attention over kv tiles (csrc/hop1_fwd.cu,
`hop1_fwd_wide_attn_tiles_kernel`, past 64 kv rows) at kv tiles of 64, 32
and 16 rows, on one card:

    python -m bist_tpu_torch.tools.wide_tile_sweep [--out file.json]

Builds a copy of csrc/hop1_fwd.cu for each tile size (kWideTile set, one
nvcc each, all started together, into build/bist_tpu_torch/tile_sweep/),
then, at each case (t2s launches of videos of 65-600 clips at D 128, 256
and 512, random inputs from a numpy seed), holds every build against the
plain version (2e-4 + 2e-4·|plain|) and times it in turns (64, 32, 16, 16,
32, 64): device ms a call over 20 calls back to back (the median of 5 such
runs) and the attention kernel's own device ms from torch.profiler.  Also
prints each build's registers and spills (ptxas) and the card's name and
power limit.  About 2 minutes of a chip call.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

from bist_tpu_torch.ops import _build

TILES = (64, 32, 16)
# name, B, G, Lq, Lk, D, h, strided (t2s's view of the grid), masked
CASES = [("t2s Lk200 D128", 64, 16, 32, 200, 128, 8, True, True),
         ("t2s Lk80 D128", 64, 16, 32, 80, 128, 8, True, True),
         ("t2s Lk200 D512", 64, 16, 32, 200, 512, 8, True, True),
         ("t2s Lk65 D256 h4", 64, 16, 32, 65, 256, 4, True, True),
         ("multi-tile", 4, 8, 32, 600, 512, 8, False, True),
         ("one video", 1, 16, 32, 176, 128, 8, True, False)]
TOL = 2e-4


def build(out_dir: Path) -> dict:
    """One library a tile size; {tile: (path, ptxas rows of the kernel)}."""
    src = (_build.SRC_DIR / "hop1_fwd.cu").read_text()
    decl = re.search(r"constexpr int kWideTile = (\d+);", src)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tile in TILES:
        cu, so = out_dir / f"hop1_fwd_t{tile}.cu", out_dir / f"hop1_fwd_t{tile}.so"
        cu.write_text(src.replace(decl.group(0), f"constexpr int kWideTile = {tile};"))
        procs[tile] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", f"-I{_build.SRC_DIR}",
             "-o", str(so), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    built = {}
    for tile, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for kWideTile {tile}:\n{log}")
        regs, cur = [], None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                args = [int(a) for a in re.findall(r"Li(\d+)E", m.group(1))]
                cur = ({"dk": 8 * args[0], "query_tiles": args[1]}
                       if "attn_tiles" in m.group(1) and len(args) == 2 else None)
                regs += [cur] if cur else []
            elif cur is not None:
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("spill_stores", r"(\d+) bytes spill stores")):
                    m = re.search(pat, line)
                    if m:
                        cur[key] = int(m.group(1))
        built[tile] = (so, regs)
    return built


def inputs(torch, dev, B, G, Lq, Lk, D, h, strided, masked, seed=7):
    from bist_tpu_torch.models.layers import mha_init

    rng = np.random.default_rng(seed)
    p = {n: {k: t.to(dev) for k, t in w.items()}
         for n, w in mha_init(torch.Generator().manual_seed(seed), h, D).items()}
    t = lambda *s: torch.tensor(rng.standard_normal(s, dtype=np.float32), device=dev)
    x, q = t(B, Lq, D), t(B, Lq, D)
    kv = t(B, Lk, G, D).transpose(1, 2) if strided else t(B, G, Lk, D)
    mask = None
    if masked:
        m = (np.arange(Lk)[None, :] < rng.integers(1, Lk + 1, size=B)[:, None])
        m[0] = False                                # a fully masked row
        mask = torch.tensor(m.astype(np.int32)[:, None, :], device=dev)
    return p, x, q, kv, mask


def device_ms(torch, fn, launches=20, reps=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def attn_ms(torch, fn, calls=10):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum((getattr(e, "self_device_time_total", 0.0) or 0.0) for e in prof.key_averages()
               if "hop1_fwd_wide_attn" in e.key) / 1e3 / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the readings to this JSON file too")
    args = ap.parse_args(argv)
    import torch

    from bist_tpu_torch.ops import bist_kernels as K1

    if not torch.cuda.is_available():
        print("wide_tile_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    built = build(_build.BUILD_DIR / "tile_sweep")
    libs = {tile: K1.bind_fwd(ctypes.CDLL(str(so))) for tile, (so, _) in built.items()}
    for tile, (_, regs) in built.items():
        print(f"ptxas kWideTile {tile}: {json.dumps(regs)}", flush=True)
    dev = torch.device("cuda")
    rows = []
    for name, B, G, Lq, Lk, D, h, strided, masked in CASES:
        p, x, q, kv, mask = inputs(torch, dev, B, G, Lq, Lk, D, h, strided, masked)
        want = K1.hop1_plain(x, q, kv, p, h, mask)
        row = {"case": name, "shape": dict(B=B, G=G, Lq=Lq, Lk=Lk, D=D, h=h),
               **{str(t): {"device_ms": [], "attn_ms": []} for t in TILES}}
        for tile in TILES + TILES[::-1]:
            run = lambda: K1._hop1_fused_as("wide", x, q, kv, p, h, mask, lib=libs[tile])
            got = run()
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=TOL, atol=TOL):
                raise AssertionError(f"{name} at kWideTile {tile}: differs from plain by "
                                     f"{(got - want).abs().max().item():.3e}")
            row[str(tile)]["device_ms"].append(device_ms(torch, run))
            row[str(tile)]["attn_ms"].append(attn_ms(torch, run))
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"card": card, "cases": rows}
    if args.out:
        Path(args.out).write_text(json.dumps(out))
    print("attention ms (mean of the two turns) by kv tile: " + "; ".join(
        f"{r['case']} " + ", ".join(f"{t}: {statistics.mean(r[str(t)]['attn_ms']):.4f}"
                                   for t in TILES) for r in rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
