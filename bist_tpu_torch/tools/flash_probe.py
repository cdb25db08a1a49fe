"""Where the time of K3's kernel goes on one NVIDIA GPU: builds of
csrc/flash_fwd.cu with one part left out, each timed against the kernel as
it is.

    python -m bist_tpu_torch.tools.flash_probe [--out file.json]

Each variant compiles the source with `FLASH_PROBE` set to the bits of
`VARIANTS` (the source's hooks; the port's build leaves it 0): no q kᵀ
products (and their fragment loads), no p v products, no products at all,
no K/V loads (the ring keeps its zeros), and `exp2f` in place of the
kernel's `ex2.approx`.  The parts left out still run their loops'
bookkeeping and barriers, so a variant's time is the kernel's less that
part's own cost, where nothing else waits on it.  Every variant is built by
nvcc into build/flash_probe/ and timed back to back (chip_smoke's
`device_time_ms`) at mha's shape in float32 and bfloat16 and at head dims
128 and 320, with the launcher's plan; the kernel as it is and the `exp2f`
build are held against `attention_plain`.  Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

from bist_tpu_torch.ops import _build

OUT = _build.BUILD_DIR.parent / "flash_probe"
# FLASH_PROBE's bits (csrc/flash_fwd.cu): 1 no q kᵀ products, 2 no p v
# products, 4 no K/V loads, 8 exp2f for ex2.approx
VARIANTS = {"kernel": 0, "no q k products": 1, "no p v products": 2, "no products": 3,
            "no loads": 4, "exp2f": 8}
CHECKED = ("kernel", "exp2f")
# (G, Lq, Lk, d, bfloat16)
CASES = [(128, 32, 32768, 64, False), (128, 32, 32768, 64, True),
         (128, 32, 32768, 128, False), (32, 32, 32768, 320, False)]


def build() -> dict:
    """One library per variant, all nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, bits in VARIANTS.items():
        so = OUT / f"flash_fwd_probe{bits}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DFLASH_PROBE={bits}", "-o", str(so),
               str(_build.SRC_DIR / "flash_fwd.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"flash_probe: {name} failed to build\n{log}")
        lib = ctypes.CDLL(str(so))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bist_flash_fwd.argtypes = [P] * 8 + [I] * 7 + [ctypes.c_float, P]
        lib.bist_flash_plan.argtypes = [I] * 5 + [ctypes.POINTER(I)] * 2
        libs[name] = lib
    return libs


def launcher(lib, q, k, v, mask):
    """A call of the library's kernel with the launcher's own plan."""
    import torch

    G, Lq, d = q.shape
    Lk = k.shape[1]
    bf16 = int(q.dtype == torch.bfloat16)
    chunk, nsplit = ctypes.c_int(), ctypes.c_int()
    if lib.bist_flash_plan(G, Lq, Lk, d, bf16, ctypes.byref(chunk), ctypes.byref(nsplit)):
        raise RuntimeError("flash_probe: planning failed")
    chunk, nsplit = chunk.value, nsplit.value
    out = torch.empty_like(q)
    parts = [torch.empty(s, device=q.device) for s in
             ((G, nsplit, Lq), (G, nsplit, Lq), (G, nsplit, Lq, d))]

    def call():
        rc = lib.bist_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                                out.data_ptr(), *[t.data_ptr() for t in parts], bf16, G, Lq,
                                Lk, d, chunk, nsplit, d ** -0.5,
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash_probe: launch failed with CUDA error {rc}")
        return out
    return call


def main(argv=None) -> int:
    import numpy as np
    import torch

    from chip_smoke import device_time_ms
    from bist_tpu_torch.ops.flash_attention import attention_plain

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build()
    dev = torch.device("cuda")
    rows = []
    for G, Lq, Lk, d, bf16 in CASES:
        rng = np.random.default_rng(0)
        dtype = torch.bfloat16 if bf16 else torch.float32
        q, k, v = (torch.tensor(rng.standard_normal(s, dtype=np.float32), device=dev).to(dtype)
                   for s in ((G, Lq, d), (G, Lk, d), (G, Lk, d)))
        mask = torch.tensor((np.arange(Lk)[None, :] < rng.integers(1, Lk + 1, size=G)[:, None])
                            .astype(np.int32), device=dev)
        want = attention_plain(q, k, v, mask).float()
        for name, lib in libs.items():
            call = launcher(lib, q, k, v, mask)
            row = {"G": G, "Lq": Lq, "Lk": Lk, "d": d, "dtype": str(dtype)[6:],
                   "variant": name, "device_ms": device_time_ms(call), "card": card}
            if name in CHECKED:
                row["max_abs_err"] = (call().float() - want).abs().max().item()
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
