"""Sequence parallelism: the long axes of a batch sharded over the 'seq'
axis of a ('data', 'seq') or ('data', 'model', 'seq') mesh (the port's
counterpart of `bist_tpu.parallel.sp`).

`bist_tpu` annotates the batch (his, fts, audio_fts and fts_scale as
`P(data, seq)`; query, cap, trg and trg_y as `P(data)`) and lets GSPMD
place every collective.  The port places them by hand, at the few ops that
need a whole long axis:

  * the masks: `spatial_mask` reduces over T, so each rank's partial sum
    (int8 grids: partial |max|) is all-reduced over 'seq' before its `!= 0`
    test (`seq_all_reduce`); the per-position masks (his, temporal, audio)
    are gathered (`models.model.build_masks`);
  * the history's embedding, the video and audio input projections and
    their norms run on this rank's block (the history's positional
    encoding at the block's global offset, `offset`); then the encoded
    history and audio, the memories of cross-attentions and of the
    pointer, are gathered once, and so are the history's ids
    (`models.model.encode`, `generator_tokens`);
  * the BiST hops (`models.bist`): s2t hop 1 attends over S within each
    temporal step, so it runs on the local T groups, 1/n of the one-device
    work, and its output is gathered for hop 2, which attends over T; t2s
    hop 1 attends over T within each region, so it runs on the grid
    gathered once in `encode`, and every seq rank computes the same t2s
    output.  Both are plain (B, G, Lk, D) calls of K1/K2, which stay on
    under SP alone (under TP × SP the tensor-parallel context turns them
    off, as under TP).

Everything after those gathers is replicated over 'seq': each seq rank
computes the same loss.  The gradients (`train.loop.make_grad_step(sp=)`):

  * the backward starts from loss / n on every seq rank;
  * `gather_seq`'s backward sums the ranks' gradients of the gathered
    tensor and keeps this rank's block (an all-reduce and a slice, which
    every backend and device has; a reduce-scatter would carry 1/n of its
    bytes);
  * every parameter gradient is then all-reduced over the data × seq ranks
    of this rank's model index, in one call.

Why this scheme: the n ranks together compute (1/n)·Σ_r loss_r, which is
the loss, and the backward above is that sum's exact backward, each
gather's backward being the transpose of the gather.  A leaf such as
`embed.lut` is used by replicated rows (query, trg: each rank's share is
1/n of the gradient) and by sharded ones (his: each rank's share is its
block's whole gradient), and the sum over the seq ranks adds both right.
Taking the own block in the gather's backward and summing only the
"sharded" leaves' gradients would count one of the two uses n times or
none.  The loss normalisers (ntokens, qntokens) are summed over 'data'
only: the seq ranks hold the same trg and query rows; the loss and metrics
reported are the unscaled ones, summed over 'data' only.

Dropout under SP: a mask on a seq-sharded activation (the history's
embedding, s2t hop 1's attention and output) is drawn at full length from
the generator that the seq ranks of one data row share (seeded by the data
rank, `train.loop.seed_for_step`), and the rank keeps its block; a mask on
a replicated activation is drawn whole.  Every seq rank then applies the
masks that a one-process run applies, and the generators stay in step.

The model learns the seq axis in one place: `sequence_parallel(sp)`, in
the idiom of `parallel.tp.tensor_parallel`.  Outside it every path is the
one-device path, op for op.

Constraints: the sharded lengths must divide by the seq-axis size
(`validate_sp_batch`); the bucketed batching pads to powers of two, so
pick a power-of-two seq axis.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional

import torch

from bist_tpu_torch.data.batching import Batch

# the batch fields whose axis 1 grows with the input's length
LONG_FIELDS = ("his", "fts", "audio_fts", "fts_scale")


def batch_specs(dp_axis: Optional[str] = "data", sp_axis: str = "seq") -> Batch:
    """The placement of each batch field as DTensor placements over the
    mesh axes (dp_axis, sp_axis), or (sp_axis,) without a data axis: rows
    `Shard(0)` on the data axis; the long axes (his, fts, audio_fts and
    fts_scale, whose T shards with fts) `Shard(1)` on the seq axis, the
    rest `Replicate()` there (`bist_tpu`'s `P(data, seq)` and `P(data)`).
    A mesh axis not named (a 'model' axis) replicates."""
    from torch.distributed.tensor import Replicate, Shard

    row = (Shard(0),) if dp_axis else ()
    return Batch(**{f: row + ((Shard(1),) if f in LONG_FIELDS else (Replicate(),))
                    for f in Batch._fields})


@dataclass(frozen=True)
class SequenceParallel:
    """This process's place on the seq axis: the axis's process group
    (`from_mesh`; None serves `shard_batch` alone, which issues no
    collective), its rank in it, its size, and the group of the data × seq
    ranks that share this rank's model index, over which the gradients are
    summed."""
    group: Any
    rank: int
    size: int
    grad_group: Any = None

    @classmethod
    def from_mesh(cls, mesh) -> "SequenceParallel":
        """The 'seq' axis of a `DeviceMesh` (`parallel.make_mesh(seq_axis=)`).
        Every rank of the mesh calls it: it makes one process group for
        each model index."""
        import torch.distributed as dist

        group = mesh.get_group("seq")
        names = mesh.mesh_dim_names
        ranks = mesh.mesh
        blocks = ([ranks.select(names.index("model"), m) for m in range(ranks.shape[
            names.index("model")])] if "model" in names else [ranks])
        me, grad_group = dist.get_rank(), None
        for block in blocks:
            members = sorted(block.flatten().tolist())
            g = dist.new_group(members)
            if me in members:
                grad_group = g
        return cls(group, dist.get_rank(group), dist.get_world_size(group), grad_group)


def _block(x, rank: int, size: int):
    k = x.shape[1] // size
    part = x[:, rank * k:(rank + 1) * k]
    return part.contiguous() if isinstance(part, torch.Tensor) else part.copy()


def shard_batch(batch: Batch, sp: SequenceParallel) -> Batch:
    """This rank's block of the long axes of `batch` (arrays or tensors,
    a copy): block r of n is [r·L/n, (r+1)·L/n) of axis 1; the other fields
    as they are.  Rows are the data axis's (`DataParallel.shard`).
    (`bist_tpu`'s places the blocks through GSPMD on a mesh.)"""
    validate_sp_batch(batch, sp.size)
    return type(batch)(*[x if x is None or f not in LONG_FIELDS else _block(x, sp.rank, sp.size)
                         for f, x in zip(batch._fields, batch)])


def validate_sp_batch(batch: Batch, seq_parallel: int) -> None:
    """The sharded axes must divide by the seq-axis size (bucketed padding
    guarantees this for power-of-two buckets and axes)."""
    checks = {"his L": batch.his.shape[1]}
    if batch.fts is not None:
        checks["fts T"] = batch.fts.shape[1]
    if batch.audio_fts is not None:
        checks["audio T"] = batch.audio_fts.shape[1]
    for name, dim in checks.items():
        if dim % seq_parallel:
            raise ValueError(
                f"{name}={dim} not divisible by seq axis {seq_parallel}; "
                "pad to a multiple (len_buckets/time_buckets)")


# ---------------------------------------------------------------------------
# the seq-axis context and its collectives

_active: Optional[SequenceParallel] = None
# the seq axis's collectives issued in this process (forward and backward)
# and the bytes they carried; read by chip_smoke.py's phase 16
counts = {"all_gathers": 0, "all_reduces": 0, "bytes": 0}


@contextlib.contextmanager
def sequence_parallel(sp: Optional[SequenceParallel]):
    """Run the model on this rank's block of the long axes over `sp`'s seq
    axis inside the block; None: the one-device path.  The kernels keep
    their dispatch."""
    global _active
    prev, _active = _active, sp
    try:
        yield
    finally:
        _active = prev


def active() -> Optional[SequenceParallel]:
    """The seq axis the model runs over, or None (also for an axis of 1)."""
    sp = _active
    return sp if sp is not None and sp.size > 1 else None


def _all_gather(x: torch.Tensor, dim: int, sp: SequenceParallel) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(sp.size)]
    dist.all_gather(parts, x, group=sp.group)
    counts["all_gathers"] += 1
    counts["bytes"] += x.numel() * x.element_size() * sp.size
    return torch.cat(parts, dim)


def _all_reduce(x: torch.Tensor, sp: SequenceParallel, op: str = "sum") -> torch.Tensor:
    import torch.distributed as dist

    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=sp.group)
    counts["all_reduces"] += 1
    counts["bytes"] += y.numel() * y.element_size()
    return y


class _GatherSeq(torch.autograd.Function):
    """The ranks' blocks concatenated along `dim` forward; backward, the
    ranks' gradients of the whole summed and this rank's block kept (a
    reduce-scatter, as an all-reduce and a slice)."""

    @staticmethod
    def forward(ctx, x, dim, sp):
        ctx.dim, ctx.sp = dim, sp
        return _all_gather(x, dim, sp)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        return _all_reduce(g, sp).chunk(sp.size, ctx.dim)[sp.rank].contiguous(), None, None


class _AllReduceSeq(torch.autograd.Function):
    """The ranks' partial sums summed forward; backward, the ranks'
    gradients of the sum summed (each rank's partial feeds every rank's
    copy of the sum)."""

    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return _all_reduce(x, sp)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.sp), None


def gather_seq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of a seq-sharded tensor → the whole, along `dim`
    (identity outside SP)."""
    sp = active()
    return x if sp is None else _GatherSeq.apply(x, dim, sp)


def seq_all_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The ranks' partial reductions over a seq-sharded axis combined:
    "sum" (differentiable) or "max" (integers, no gradient); identity
    outside SP."""
    sp = active()
    if sp is None:
        return x
    return _AllReduceSeq.apply(x, sp) if op == "sum" else _all_reduce(x, sp, op)


def offset(length: int) -> int:
    """The global position of this rank's first element of a seq-sharded
    axis whose block is `length` long (0 outside SP)."""
    sp = active()
    return 0 if sp is None else sp.rank * length


def local_slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of a full-length tensor along `dim` (a dropout
    mask drawn whole); `x` itself outside SP."""
    sp = active()
    return x if sp is None else x.chunk(sp.size, dim)[sp.rank]


def full_shape(shape, dim: int):
    """The full-length shape of a local block split along `dim`."""
    sp = active()
    shape = list(shape)
    if sp is not None:
        shape[dim] *= sp.size
    return tuple(shape)
