"""Data parallelism: batch rows split over devices, parameters replicated
(the port's counterpart of `bist_tpu.parallel.mesh`).

`bist_tpu` puts the rows on a `('data',)` mesh (`NamedSharding(mesh,
P('data'))`) and lets XLA insert the gradient all-reduce.  The port does
the same by hand, in two forms:

  * one process driving several devices (`DataParallel(num_devices)` or
    `DataParallel(devices=[...])`): inference, whose rows are independent.
    `shard(batch)` gives one contiguous row block per device, device i rows
    [i·B/n, (i+1)·B/n) (the layout of `P('data')`), and
    `put_replicated(tree)` one copy of the parameters per device.  A list
    may repeat a device: replicas that share one card (or the CPU);
  * one process per device, joined by `torch.distributed`
    (`DataParallel.in_group(device)`, after `parallel.multihost.
    init_multihost`): training.  `shard(batch)` gives this rank's block,
    `all_reduce_grads` sums the gradients across the ranks in one
    collective on a flat buffer that the gradients are views of (allocated
    once, beside the parameters, so that a CUDA graph can capture it), and
    `broadcast_params` copies rank 0's parameters to every rank.

The train step normalises its loss on the GLOBAL batch's token counts and
SUMS the ranks' gradients (`train.loop.make_grad_step`), which makes n
ranks compute the one-device step.  DDP is not used: it averages gradients
of an `nn.Module`, and the port's step differentiates a parameter tree.

On a 2-D ('data', 'model') mesh (`make_mesh(model_axis=)`, tensor
parallelism: `parallel.tp`) the data side is the mesh's data axis:
`DataParallel.in_group(device, mesh)` splits rows and sums gradients over
the data subgroup only, and the ranks of one model group take the same
rows.  On a ('data', 'seq') or ('data', 'model', 'seq') mesh
(`make_mesh(seq_axis=)`, sequence parallelism: `parallel.sp`) the same
holds: the ranks of one data index take the same rows and split their long
axes, and the gradients are summed over the data × seq ranks
(`DataParallel.over_group`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bist_tpu_torch.weights import tree_leaves, tree_map


def local_devices(device_type: str = "cuda", num_devices: int = 0) -> List[torch.device]:
    """The first `num_devices` local devices of a type (0 = all of them):
    cuda:0 … cuda:n-1, raising when more cards are asked for than exist
    (`bist_tpu`'s `devs[:n]` would give fewer in silence); on the CPU, n
    replicas of the one CPU (1 for 0)."""
    if device_type != "cuda":
        return [torch.device(device_type)] * max(num_devices, 1)
    avail = torch.cuda.device_count()
    if avail == 0:
        raise RuntimeError("no CUDA device is available")
    if num_devices > avail:
        raise ValueError(f"{num_devices} devices asked for, {avail} CUDA device(s) present")
    return [torch.device("cuda", i) for i in range(num_devices or avail)]


def canonical_device(device) -> torch.device:
    """`device` with its index: "cuda" is the current card, as a tensor put
    there reports it."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _in_group() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def make_mesh(num_devices: int = 0, axis_name: str = "data", model_axis: int = 1,
              seq_axis: int = 1, devices: Optional[Sequence] = None,
              device_type: str = "cuda"):
    """Inside a process group: a 1-D `DeviceMesh` over its ranks, named
    `axis_name`; with model_axis > 1 a 2-D (world / model_axis, model_axis)
    one named ('data', 'model'): rank r at data index r // model_axis,
    model index r % model_axis (tensor parallelism, `parallel.tp`); with
    seq_axis > 1 a 3-D (world / (model_axis·seq_axis), model_axis,
    seq_axis) one named ('data', 'model', 'seq'), its 'model' axis dropped
    when it has one rank: rank r at data index r // (model_axis·seq_axis),
    model index (r // seq_axis) % model_axis, seq index r % seq_axis
    (sequence parallelism, `parallel.sp`; `np.reshape(devices, (dp, tp,
    sp))`'s order, as `bist_tpu` lays its mesh out).  Outside one: the list
    of devices (`local_devices`, or `devices` cut to `num_devices`); a mesh
    of more than one axis then raises, as tensor and sequence parallelism
    run one process per device."""
    if (model_axis > 1 or seq_axis > 1) and (devices is not None or not _in_group()):
        axes = "('data', 'model')" if seq_axis == 1 else "('data', 'model', 'seq')"
        raise RuntimeError(f"a {axes} mesh needs one process per device: "
                           "call parallel.multihost.init_multihost first")
    if devices is None and _in_group():
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        if model_axis == 1 and seq_axis == 1:
            return init_device_mesh(device_type, (world,), mesh_dim_names=(axis_name,))
        for name, n in (("model", model_axis), ("seq", seq_axis)):
            if world % n:
                raise ValueError(f"a {name} axis of {n} does not divide the "
                                 f"{world} processes of the group")
        if world % (model_axis * seq_axis):
            raise ValueError(f"a model axis of {model_axis} and a seq axis of {seq_axis} "
                             f"do not divide the {world} processes of the group")
        shape, names = (world // (model_axis * seq_axis), model_axis, seq_axis), \
            (axis_name, "model", "seq")
        keep = [i for i, n in enumerate(shape) if i == 0 or n > 1]
        return init_device_mesh(device_type, tuple(shape[i] for i in keep),
                                mesh_dim_names=tuple(names[i] for i in keep))
    devs = [torch.device(d) for d in devices] if devices is not None \
        else local_devices(device_type, num_devices)
    return devs[:num_devices] if num_devices > 0 else devs


def batch_sharding(mesh=None, axis_name: str = "data"):
    """The placement of a batch: rows split over the data axis
    (`P('data')`), as DTensor placements.  The arguments are read by no
    one: they keep `bist_tpu`'s signature, whose mesh has one data axis."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def replicate(mesh=None):
    """The placement of the parameters: a copy on every device (`P()`).
    `mesh` keeps `bist_tpu`'s signature and is not read."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def row_slice(i: int, n: int, n_rows: int) -> slice:
    """Device i's rows of a batch of `n_rows` rows split over n devices:
    [i·B/n, (i+1)·B/n), the layout of `P('data')`.  Every data-parallel
    path of the port splits its rows here."""
    if n_rows % n:
        raise ValueError(f"a batch of {n_rows} rows does not split over {n} devices "
                         f"(pad it: DataParallel.pad_batch_to)")
    k = n_rows // n
    return slice(i * k, (i + 1) * k)


def row_block(batch, i: int, n: int):
    """`row_slice`'s rows of every field of a batch (a NamedTuple of arrays
    or tensors; None stays None)."""
    return type(batch)(*[None if x is None else x[row_slice(i, n, x.shape[0])]
                         for x in batch])


def _to(x, device):
    if x is None:
        return None
    t = torch.as_tensor(x)
    return t if t.device == device else t.to(device, non_blocking=True)


def shard_batch(mesh, batch) -> list:
    """The row blocks of `batch`, block i on the mesh's device i (a list of
    devices, `make_mesh` outside a group)."""
    n = len(mesh)
    return [type(batch)(*[_to(x, torch.device(d)) for x in row_block(batch, i, n)])
            for i, d in enumerate(mesh)]


class DataParallel:
    """The devices of a data-parallel run and the moves onto them.

    `DataParallel(num_devices=0, device_type="cuda")` or
    `DataParallel(devices=[...])`: one process, `n` devices.
    `DataParallel.in_group(device, mesh=None)`: one process per device in
    the process group (`n` its world size, `rank` this process's place), or
    on a ('data', 'model') mesh the data axis (`n` its size, `rank` this
    process's data index, the collectives over the data subgroup)."""

    def __init__(self, num_devices: int = 0, *, devices: Optional[Sequence] = None,
                 device_type: str = "cuda"):
        devs = devices if devices is not None else local_devices(device_type, num_devices)
        self.devices: List[torch.device] = [canonical_device(d) for d in devs]
        self.n = len(self.devices)
        self.rank = 0
        self.grouped = False     # one process of a process group (in_group)
        self.backend: Optional[str] = None      # the group's backend (nccl, gloo)
        self.group = None        # the collectives' process group (None: the world)
        self.collectives = 0     # collectives issued from Python (a replay issues none)
        self._flat: Dict[torch.dtype, Tuple[torch.Tensor, List[torch.Tensor], tuple]] = {}

    @classmethod
    def in_group(cls, device, mesh=None) -> "DataParallel":
        """This process's part of a data-parallel run over the whole process
        group (its world), on `device`; with a 2-D `mesh` (`make_mesh(
        model_axis=)`), over the mesh's data axis: the ranks that share this
        process's model index."""
        if not _in_group():
            raise RuntimeError("DataParallel.in_group: no process group (call "
                               "parallel.multihost.init_multihost first)")
        group = mesh.get_group(mesh.mesh_dim_names[0]) \
            if mesh is not None and mesh.ndim > 1 else None
        return cls.over_group(device, group)

    @classmethod
    def over_group(cls, device, group) -> "DataParallel":
        """This process's part of the sums over `group`, a process group it
        belongs to (None: the world); `in_group`'s data axis, or the data ×
        seq ranks over which sequence parallelism sums its gradients."""
        import torch.distributed as dist

        dp = cls(devices=[device])
        dp.grouped = True
        dp.group = group
        dp.n = dist.get_world_size(group)
        dp.rank = dist.get_rank(group)
        dp.backend = dist.get_backend(group)
        return dp

    def pad_batch_to(self, n_examples: int) -> int:
        """Round a batch size up to a multiple of the device count."""
        return ((n_examples + self.n - 1) // self.n) * self.n

    # -- one process, several devices --------------------------------------

    def blocks(self, batch) -> list:
        """The n row blocks of a batch where they are (host slices of a host
        batch): block i is device i's rows."""
        return [row_block(batch, i, self.n) for i in range(self.n)]

    def shard(self, batch) -> list:
        """The row blocks this process holds, each on its device: all n in
        one process, this rank's block alone in a group (as
        `addressable_shards` of a `P('data')` array)."""
        if self.grouped:
            return [type(batch)(*[_to(x, self.devices[0])
                                  for x in row_block(batch, self.rank, self.n)])]
        return shard_batch(self.devices, batch)

    def put_replicated(self, tree) -> list:
        """One copy of a parameter tree per device; devices that repeat share
        their copy, and a device the tree is on takes the tree itself."""
        copies: Dict[torch.device, object] = {}
        out = []
        src = tree_leaves(tree)[0].device
        for d in self.devices:
            if d not in copies:
                copies[d] = tree if d == src else tree_map(lambda t: t.to(d), tree)
            out.append(copies[d])
        return out

    # -- a process group: the gradient side --------------------------------

    def _check_group(self, what: str) -> None:
        if not self.grouped:
            raise RuntimeError(f"DataParallel.{what}: no process group "
                               f"(DataParallel.in_group)")

    def grad_buffer(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The flat buffers that `all_reduce_grads` reduces, one per dtype of
        `leaves` (the parameters), allocated on the first call and kept:
        views of them shaped like the leaves, in the leaves' order."""
        key = tuple((tuple(t.shape), t.dtype) for t in leaves)
        views: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for dtype in dict.fromkeys(t.dtype for t in leaves):
            idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
            have = self._flat.get(dtype)
            if have is None or have[2] != key:
                flat = torch.empty(sum(leaves[i].numel() for i in idx), dtype=dtype,
                                   device=leaves[idx[0]].device)
                parts, o = [], 0
                for i in idx:
                    parts.append(flat[o:o + leaves[i].numel()].view(leaves[i].shape))
                    o += leaves[i].numel()
                have = self._flat[dtype] = (flat, parts, key)
            for i, v in zip(idx, have[1]):
                views[i] = v
        return views

    def all_reduce_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The ranks' gradients SUMMED: copied into the flat buffer (one per
        dtype), one all-reduce each, returned as the buffer's views."""
        import torch.distributed as dist

        self._check_group("all_reduce_grads")
        views = self.grad_buffer(grads)
        torch._foreach_copy_(views, list(grads))
        for flat, _, _ in self._flat.values():
            dist.all_reduce(flat, group=self.group)
            self.collectives += 1
        return views

    def all_reduce_sum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """0-d tensors of one dtype summed across the ranks in one
        all-reduce (a stacked vector)."""
        import torch.distributed as dist

        self._check_group("all_reduce_sum")
        v = torch.stack(list(tensors))
        dist.all_reduce(v, group=self.group)
        self.collectives += 1
        return list(v.unbind(0))

    def broadcast_params(self, tree) -> None:
        """Every leaf of `tree` set to rank 0's values, in place."""
        import torch.distributed as dist

        self._check_group("broadcast_params")
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        with torch.no_grad():
            for t in tree_leaves(tree):
                dist.broadcast(t, src=src, group=self.group)
                self.collectives += 1

    def replicas_identical(self, tree) -> bool:
        """Whether every rank holds the same bits in `tree`: a checksum of the
        leaves' bits (int64 sums of their int32 words, with their position)
        compared by a min and a max all-reduce."""
        import torch.distributed as dist

        self._check_group("replicas_identical")
        with torch.no_grad():
            sums = []
            for t in tree_leaves(tree):
                words = t.detach().contiguous().view(-1).view(torch.uint8)
                words = words[: words.numel() // 4 * 4].view(torch.int32).long()
                pos = torch.arange(1, words.numel() + 1, device=words.device)
                sums.append(torch.stack([words.sum(), (words * pos).sum()]))
            check = torch.stack(sums).view(-1)
            lo, hi = check.clone(), check.clone()
            dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=self.group)
            dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=self.group)
            self.collectives += 2
            return bool(torch.equal(lo, hi))
