"""Parameter bridge between the JAX package's parameter tree and the port's.

The port keeps the JAX tree as it is: the same nested dicts and lists, the
same names, and the same layouts — a linear weight is (in, out) in both, and
`models.layers.linear` computes x @ w + b — so no leaf is transposed either
way.  `params_from_jax` takes the JAX tree with numpy leaves (for example
`jax.tree_util.tree_map(np.asarray, params)`); `params_to_jax` gives numpy
leaves back.  A port checkpoint (`<model>.pt`) is that tree saved with
`torch.save`.
"""

from __future__ import annotations

import numpy as np
import torch

from bist_tpu_torch import resolve_device


def tree_map(fn, tree):
    """`fn` applied to every leaf of a parameter tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(tree, device=None):
    """JAX parameter tree (numpy leaves) → port parameters on `device`
    (default cuda; raises without it).  Leaves become float32 tensors of the
    same shape; lists stay lists."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a, dtype=np.float32),
                                           device=device), tree)


def params_to_jax(params):
    """Port parameters → the JAX tree with numpy float32 leaves."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(), params)


def save_params(path: str, params) -> None:
    torch.save(tree_map(lambda t: t.detach().cpu(), params), path)


def load_params(path: str, device=None):
    """A port checkpoint onto `device` (default cuda; raises without it)."""
    device = resolve_device(device)
    return tree_map(lambda t: t.to(device),
                    torch.load(path, map_location="cpu", weights_only=True))
