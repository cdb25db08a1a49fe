"""Single source of the port's kernel dispatch rules.

  * Hop 1: always, when there is no dropout, with or without a gradient.
    Without one, `models.bist._hop1` calls `ops.bist_kernels.hop1_fused`
    (K1); with one, `hop1_trainable`, whose forward is K1 writing its
    residuals and whose backward is K2 (`hop1_bwd`).  Dropout (`--dropout`
    or `--attn-dropout` above 0) keeps hop 1 on the plain path, as in
    `bist_tpu`, whose kernels have no dropout either.  `bist_tpu` engages its
    Pallas hop-1 kernels only above 5 GiB of grid, a capacity frontier of the
    TPU v5e's 16 GB HBM that says nothing about this card.
  * Flash attention (K3, `ops.flash_attention.flash_attention`) inside
    `models.layers.mha`: the JAX predicate minus its d_k ≥ 64 guard (that
    guard exists for the TPU's 128-lane padding): no dropout, no returned
    attention, no gradient, kv-validity masks only, and kv length ≥
    FLASH_MIN_KV.  The threshold keeps the JAX value until a sweep on the
    H100 sets it.

Neither rule looks at widths, dtypes or alignment: on the card a call that
meets it goes to the kernel, which takes float32 and bfloat16 grids, every
D with D % h == 0 (hop 1) and every head dim (flash).  K1 chooses among
three kernels by shape (`ops.bist_kernels.hop1_variant`): "whole" at the
flagship's D 64/128 up to 64 kv rows, "wide" at every D that is a
multiple of 128 from 256 to 1024 (`bist_tpu`'s default d_model 512 with 8
heads, d_model 1024 with 8) with d_k 8, 16, 32, 64 or 128 and, past 64 kv
rows (t2s over a video of more than 64 clips), at D 128 too, "tiled"
elsewhere: D above 1024, heads that do not tile 128 columns (d_k 24, 48,
96, 15, 65, ...), D 64 past 64 kv rows and misaligned grids.  K2 has the
same three (`hop1_bwd_variant`) over the same domains: its "wide" and K1's
come from one rule (`csrc/hop1_gemm.cuh`'s `wide_widths`), so a train step
that runs K1 "wide" runs K2 "wide".  All three write one residual layout
(concat (B, G, Lq, D), lse (B, G, Lq, h)), so K2 reads whichever forward
ran.  "tiled" is known to be slower than the plain path at the widths it
still holds (PERF.md, section 6; ROADMAP's K4).

`force_plain()` turns both kernels off, so one batch can run through the
kernels and through the plain PyTorch paths for comparison (tests,
`chip_smoke.py`).
"""

from __future__ import annotations

import contextlib

import torch

FLASH_MIN_KV = 32768

_force_plain = False


@contextlib.contextmanager
def force_plain():
    """Run the plain PyTorch paths instead of the kernels inside the block."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def hop1_uses_kernel(dropout_active: bool) -> bool:
    return not (_force_plain or dropout_active)


def mha_uses_flash(kv_len: int, dropout_active: bool, grad: bool,
                   return_attn: bool, mask_is_kv_validity: bool) -> bool:
    return (not (_force_plain or dropout_active or grad or return_attn)
            and mask_is_kv_validity and kv_len >= FLASH_MIN_KV)
