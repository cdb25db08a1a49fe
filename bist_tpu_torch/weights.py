"""Parameter bridge between the JAX package's parameter tree and the port's.

The port keeps the JAX tree as it is: the same nested dicts and lists, the
same names, and the same layouts — a linear weight is (in, out) in both, and
`models.layers.linear` computes x @ w + b — so no leaf is transposed either
way.  `params_from_jax` takes the JAX tree with numpy leaves (for example
`jax.tree_util.tree_map(np.asarray, params)`); `params_to_jax` gives numpy
leaves back.  Leaves are float32 on both sides, except the extractor's
int8 kernels (`resnext3d.quantize_resnext_int8`), which stay int8 both
ways, and its bfloat16 leaves, which come across as bfloat16 and go back as
float32 (numpy has no bfloat16 of its own).  A port checkpoint (`<model>.pt`) is that tree saved with
`torch.save`, or a training checkpoint (`train.checkpoint`) that holds it
under "params".
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


def tree_leaves(tree) -> list:
    """The leaves of a parameter tree in `tree_map`'s order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _leaf_from_jax(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.int8:
        return torch.tensor(a, device=device)
    t = torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    return t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t


def params_from_jax(tree, device=None):
    """JAX parameter tree (numpy leaves) → port parameters on `device`
    (default cuda; raises without it).  Leaves become float32 tensors of the
    same shape (int8 and bfloat16 ones keep their type); lists stay
    lists."""
    device = resolve_device(device)
    return tree_map(lambda a: _leaf_from_jax(a, device), tree)


def params_to_jax(params):
    """Port parameters → the JAX tree with numpy float32 leaves (int8 ones
    stay int8)."""
    return tree_map(lambda t: t.detach().cpu().numpy() if t.dtype == torch.int8
                    else t.detach().to("cpu", torch.float32).numpy(), params)


def save_params(path: str, params) -> None:
    torch.save(tree_map(lambda t: t.detach().cpu(), params), path)


def load_params(path: str, device=None):
    """The parameters of a port checkpoint or training checkpoint onto
    `device` (default cuda; raises without it)."""
    device = resolve_device(device)
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(tree, dict) and "params" in tree and "opt_state" in tree:
        tree = tree["params"]
    return tree_map(lambda t: t.to(device), tree)
