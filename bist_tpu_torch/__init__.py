"""bist_tpu_torch — the PyTorch/CUDA port of bist_tpu for NVIDIA Hopper.

The JAX package `bist_tpu` is the reference; this package computes the same
functions with PyTorch, and every Pallas kernel of `bist_tpu` on the ported
paths is a CUDA C++ kernel written for `sm_90a` (`bist_tpu_torch/csrc`,
built with `nvcc` at first use by `bist_tpu_torch.ops._build`).

Parameters are nested dicts of tensors with the names and layouts of the JAX
parameter tree (a linear weight is (in, out)), so `weights.params_from_jax`
carries a JAX model across without a transpose.

Entry points run on CUDA unless the caller asks for the CPU; on the CPU every
kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bist_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (--device cpu) to run on the CPU")
    return dev
