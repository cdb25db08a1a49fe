"""Tensor parallelism: Megatron-style parameter sharding over the 'model'
axis of a 2-D ('data', 'model') mesh (the port's counterpart of
`bist_tpu.parallel.tp`).

`bist_tpu` annotates the parameters and lets GSPMD place every collective.
The port places them by hand, with the same rules:

  * attention wq/wk/wv and FFN w1: column-parallel, `Shard(1)` on w and
    `Shard(0)` on b (the output features, i.e. whole heads), so each rank
    computes its own head group, or its slice of the FFN's hidden layer;
  * attention wo and FFN w2: row-parallel, `Shard(0)` on w (the input
    features) and b replicated: each rank's partial product is summed over
    the model axis (one all-reduce), then the bias is added once;
  * everything else (LayerNorms, embeddings, fusion gates, the pointer
    switch) replicated.

The rule matches any wq/wk/wv/wo/w1/w2 on a leaf's path, so the pointer
generator's one-head attention (`gen.pointer_attn[i]`) is sharded too: its
width, not its heads, and its score is the sum of the ranks' partial
products (`models.generator`).

The model learns the model-axis group in one place: `tensor_parallel(tp)`,
a context manager in the idiom of `ops.dispatch.force_plain`.  Inside it,
`models.layers.mha`/`ffn`, `models.generator` and the decode path of
`models.model` take local shards and place the collectives (`copy_to`:
identity forward, all-reduce backward, before a column-parallel product;
`reduce_from`: all-reduce forward, identity backward, after a row-parallel
one).  Outside it every path is the one-device path, op for op.  Inside
it the hop-1 and flash kernels stay off (it enters
`ops.dispatch.force_plain`), as `bist_tpu` keeps its Pallas kernels off
under TP: K1 fuses the full `Wo` and the residual and cannot take a head
shard.

Dropout under TP: a mask on a sharded activation (attention probabilities,
the FFN's hidden layer) is drawn at full width from the same generator and
the rank keeps its slice; a mask on a replicated activation is drawn whole.
Every model rank then applies the masks a one-process run applies, and the
generators stay in step.

Constraints: att_h and d_ff must divide by the model-axis size.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional

import torch

from bist_tpu_torch.ops import dispatch

# param-name → rule, keyed by the linear's name on the leaf's path
_COL = "column"   # column-parallel: shard the output dim
_ROW = "row"      # row-parallel: shard the input dim
_RULES = {"wq": _COL, "wk": _COL, "wv": _COL, "w1": _COL,
          "wo": _ROW, "w2": _ROW}


def _map_with_path(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, prefix + (i,)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def shard_dim(path) -> Optional[int]:
    """The dim a leaf at `path` is split on over the model axis, None when
    it is replicated (`bist_tpu.parallel.tp._spec_for`'s rules)."""
    for k in path:
        rule = _RULES.get(k)
        if rule is None:
            continue
        if rule == _COL:
            return 1 if path[-1] == "w" else 0
        return 0 if path[-1] == "w" else None
    return None


def param_specs(params: Any, axis: str = "model"):
    """A tree mirroring `params`: each leaf's DTensor placement along the
    model axis (`Shard(1)` for `bist_tpu`'s `P(None, 'model')`, `Shard(0)`
    for `P('model')` and `P('model', None)`, `Replicate()` for `P()`).  On a
    ('data', 'model') mesh a leaf's placements are (Replicate(), that).
    `axis` keeps `bist_tpu`'s signature: the rules do not depend on it."""
    from torch.distributed.tensor import Replicate, Shard

    def spec(path, leaf):
        d = shard_dim(path)
        return Replicate() if d is None else Shard(d)

    return _map_with_path(spec, params)


@dataclass(frozen=True)
class TensorParallel:
    """This process's place on the model axis: the axis's process group
    (`from_mesh`; None serves `shard_params` alone, which issues no
    collective), its rank in it and its size."""
    group: Any
    rank: int
    size: int

    @classmethod
    def from_mesh(cls, mesh) -> "TensorParallel":
        """The 'model' axis of a `DeviceMesh` (`parallel.make_mesh(model_axis=)`)."""
        import torch.distributed as dist

        group = mesh.get_group("model")
        return cls(group, dist.get_rank(group), dist.get_world_size(group))


def shard_params(params: Any, tp: TensorParallel):
    """This rank's local shards of a full parameter tree (every rank holds
    the full tree, e.g. `weights.params_from_jax`'s or a checkpoint's):
    each sharded leaf split into `tp.size` equal blocks along its dim,
    block `tp.rank` kept (a copy); replicated leaves as they are.
    (`bist_tpu`'s takes the mesh and the axis name and lets GSPMD place the
    blocks; here the model axis is `TensorParallel.from_mesh(mesh)`.)"""

    def local(path, t):
        d = shard_dim(path)
        return t if d is None else t.chunk(tp.size, d)[tp.rank].clone()

    return _map_with_path(local, params)


def gather_params(params: Any, tp: TensorParallel):
    """The full tree back from every rank's local shards (one all-gather a
    sharded leaf over the model axis; replicated leaves as they are).
    Gradients gather the same way: they follow the parameters' layout."""
    import torch.distributed as dist

    def full(path, t):
        d = shard_dim(path)
        if d is None or tp.size == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(tp.size)]
        dist.all_gather(parts, t.detach().contiguous(), group=tp.group)
        return torch.cat(parts, d)

    return _map_with_path(full, params)


def validate_tp_config(cfg, model_parallel: int) -> None:
    if cfg.att_h % model_parallel:
        raise ValueError(
            f"att_h={cfg.att_h} not divisible by model axis {model_parallel}")
    if cfg.d_ff % model_parallel:
        raise ValueError(
            f"d_ff={cfg.d_ff} not divisible by model axis {model_parallel}")


# ---------------------------------------------------------------------------
# the model-axis context and its collectives

_active: Optional[TensorParallel] = None
# the model axis's all-reduces issued in this process (forward and
# backward) and the bytes they carried; read by chip_smoke.py's phase 15
counts = {"all_reduces": 0, "bytes": 0}


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    counts["all_reduces"] += 1
    counts["bytes"] += y.numel() * y.element_size()
    return y


@contextlib.contextmanager
def tensor_parallel(tp: Optional[TensorParallel]):
    """Run the model on this rank's shards over `tp`'s model axis inside the
    block, with the kernels off (`ops.dispatch.force_plain`); None: the
    one-device path, kernels as dispatched."""
    global _active
    prev, _active = _active, tp
    try:
        with contextlib.nullcontext() if tp is None else dispatch.force_plain():
            yield
    finally:
        _active = prev


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model axis (the
    input of a column-parallel product feeds every rank's shard)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """The ranks' partial results summed over the model axis forward; the
    gradient passed through (every rank's partial gets the whole of it)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor) -> torch.Tensor:
    """`x` entering a column-parallel product (identity outside TP)."""
    tp = _active
    return x if tp is None or tp.size == 1 else _CopyTo.apply(x, tp.group)


def reduce_from(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial summed over the model axis
    (identity outside TP)."""
    tp = _active
    return x if tp is None or tp.size == 1 else _ReduceFrom.apply(x, tp.group)


def local_heads(h: int) -> int:
    """The heads this rank computes of an h-head attention."""
    return h if _active is None else h // _active.size


def local_slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of a full-width tensor along `dim` (a dropout mask
    drawn whole); `x` itself outside TP."""
    tp = _active
    if tp is None or tp.size == 1:
        return x
    return x.chunk(tp.size, dim)[tp.rank]


def full_shape(shape, dim: int):
    """The full-width shape of a local tensor split along `dim`."""
    tp = _active
    shape = list(shape)
    if tp is not None:
        shape[dim] *= tp.size
    return tuple(shape)
