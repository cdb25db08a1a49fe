"""K3's dispatch sweep on one card: where the flash path starts to beat
`models.layers.mha`'s plain path.

    python -m bist_tpu_torch.tools.flash_sweep [--out file.json]

At mha's shape in chip_smoke.py's phase 4 (a batch of 16, 8 heads, 32
queries, a key-padding mask; float32, TF32 off) and kv lengths 256 ...
32768 at head dims 16 and 64, it times back to back (chip_smoke's
`device_time_ms`), on the same random inputs:

  * "k3_ms": the K3 kernel, on contiguous inputs;
  * "k3_path_ms": mha's flash branch as it runs (`layers._flash_path`, which
    also copies the heads of q, k and v into contiguous rows);
  * "plain_ms": mha's plain branch (`attention_weights`, then p v);
  * "sdpa_ms": one `F.scaled_dot_product_attention` call on the same views.

Prints one JSON line per shape and, last, the crossover at each head dim:
the shortest kv length from which the flash branch beats the plain one at
that and every longer length measured (null if it never does).  The
dispatch threshold (`ops.dispatch.FLASH_MIN_KV`) is not changed by this
tool.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

LK = (256, 1024, 4096, 16384, 32768)
HEAD_DIMS = (16, 64)
B, H, LQ = 16, 8, 32


def measure(device, Lk, dk, seed=0) -> dict:
    import torch
    import torch.nn.functional as F

    from chip_smoke import device_time_ms
    from bist_tpu_torch.models.layers import _flash_path, attention_weights
    from bist_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    rng = np.random.default_rng(seed)
    # (B, H, L, dk) views of (B, L, H, dk) rows, as split_heads gives them
    q, k, v = (torch.tensor(rng.standard_normal((B, L, H, dk), dtype=np.float32),
                            device=device).transpose(1, 2) for L in (LQ, Lk, Lk))
    lengths = rng.integers(Lk // 2, Lk + 1, size=B)
    mask = torch.tensor((np.arange(Lk)[None, :] < lengths[:, None]).astype(np.int32),
                        device=device)[:, None, None, :]          # (B, 1, 1, Lk)
    flat = [t.reshape(B * H, -1, dk).contiguous() for t in (q, k, v)]
    flat_mask = mask[:, :, 0].expand(B, H, Lk).reshape(B * H, Lk).contiguous()
    kernel = lambda: flash_attention(*flat, flat_mask)
    path = lambda: _flash_path(q, k, v, mask)
    plain = lambda: torch.matmul(attention_weights(q, k, mask, 0.0, None), v)
    bool_mask = mask != 0
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bool_mask)
    want = attention_plain(*flat, flat_mask).reshape(B, H, LQ, dk)
    err = max((f().reshape(B, H, LQ, dk) - want).abs().max().item()
              for f in (kernel, path, plain))
    return {"Lk": Lk, "d": dk, "G": B * H, "Lq": LQ, "max_abs_err": err, "k3_ms": device_time_ms(kernel),
            "k3_path_ms": device_time_ms(path), "plain_ms": device_time_ms(plain),
            "sdpa_ms": device_time_ms(sdpa)}


def crossover(rows, dk):
    """The shortest kv length from which the flash branch beats the plain
    one at every longer length measured too (None if it never does)."""
    at = sorted((r for r in rows if r["d"] == dk), key=lambda r: r["Lk"])
    best = None
    for r in reversed(at):
        if r["k3_path_ms"] >= r["plain_ms"]:
            break
        best = r["Lk"]
    return best


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    rows = []
    for dk in HEAD_DIMS:
        for Lk in LK:
            rows.append(dict(measure(device, Lk, dk), card=card))
            print(json.dumps(rows[-1]), flush=True)
    summary = {"card": card, "crossover_kv": {str(dk): crossover(rows, dk)
                                              for dk in HEAD_DIMS}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, **summary}, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
