"""Single source of the port's kernel dispatch rules.

  * Hop 1 (K1, `ops.bist_kernels.hop1_fused`): always, when there is no
    dropout and no gradient is asked for (the backward kernel, K2, belongs to
    the training slice).  `bist_tpu` engages its Pallas hop-1 kernel only
    above 5 GiB of grid, a capacity frontier of the TPU v5e's 16 GB HBM that
    says nothing about this card.
  * Flash attention (K3, `ops.flash_attention.flash_attention`) inside
    `models.layers.mha`: the JAX predicate minus its d_k ≥ 64 guard (that
    guard exists for the TPU's 128-lane padding): no dropout, no returned
    attention, no gradient, kv-validity masks only, and kv length ≥
    FLASH_MIN_KV.  The threshold keeps the JAX value until a sweep on the
    H100 sets it.

Neither rule looks at widths or dtypes: on the card a call that meets it
goes to the kernel, which takes float32 and bfloat16 and raises on a width
it cannot take (hop 1: D > 512, D not a multiple of 8, or D / h not a
multiple of 4; flash: a head dim above 256).  K1 is known to be slower than
the plain path at widths above the flagship's when few (batch, group)
blocks fill the card (PERF.md, section 7).

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


def hop1_uses_kernel(dropout_active: bool, grad: bool) -> bool:
    return not (_force_plain or dropout_active or grad)


def mha_uses_flash(kv_len: int, dropout_active: bool, grad: bool,
                   return_attn: bool, mask_is_kv_validity: bool) -> bool:
    return (not (_force_plain or dropout_active or grad or return_attn)
            and mask_is_kv_validity and kv_len >= FLASH_MIN_KV)
