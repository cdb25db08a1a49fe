"""Process-group initialisation (the port's counterpart of
`bist_tpu.parallel.multihost`).

`bist_tpu` joins hosts with `jax.distributed`; the port joins processes,
one per card, with `torch.distributed`: NCCL between CUDA processes, gloo
between CPU ones.  Call `init_multihost()` once per process before the
data-parallel path (`parallel.mesh.DataParallel.in_group`): with
`coordinator_address` it rendezvouses at tcp://<address>, otherwise it
reads `torchrun`'s environment (MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE), the counterpart of `jax.distributed`'s auto-detection.  Each
process then feeds its own rows (`local_example_slice`, or the loader's
`shard`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

# a collective that waits longer than this fails the run (a rank that died
# must not leave the others waiting for ever)
GROUP_TIMEOUT_S = 600


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *, device=None) -> int:
    """`torch.distributed.init_process_group` wrapper; returns this
    process's rank.  No-op (returns 0) for num_processes <= 1.

    `device` is this process's device (default cuda; raises without it):
    NCCL on CUDA, gloo elsewhere.
    A second call in an initialised process returns the rank; any other
    failure (an unreachable coordinator, mismatched process counts)
    raises: swallowing it would train on one process in silence."""
    import torch.distributed as dist

    from bist_tpu_torch import resolve_device

    if num_processes is not None and num_processes <= 1:
        return 0
    if dist.is_initialized():            # the one tolerated failure
        return dist.get_rank()
    device = resolve_device(device)
    kw = {}
    if coordinator_address:
        kw["init_method"] = f"tcp://{coordinator_address}"
        if num_processes is None or process_id is None:
            raise ValueError("init_multihost: a coordinator address needs num_processes "
                             "and process_id")
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        missing += [k for k, v in (("RANK", process_id), ("WORLD_SIZE", num_processes))
                    if v is None and k not in os.environ]
        if missing:
            raise RuntimeError(f"init_multihost: no coordinator address and no "
                               f"{', '.join(missing)} in the environment (start the "
                               f"processes with torchrun, or pass coordinator_address)")
        kw["init_method"] = "env://"
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if device.type == "cuda":
        from bist_tpu_torch.parallel.mesh import canonical_device

        torch.cuda.set_device(canonical_device(device))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **kw)
    return dist.get_rank()


def local_example_slice(n_examples: int) -> slice:
    """The contiguous slice of a dataset this process should load (a
    per-process input pipeline); the whole dataset outside a process
    group."""
    import torch.distributed as dist

    rank, count = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                   else (0, 1))
    per = (n_examples + count - 1) // count
    start = rank * per
    return slice(start, min(start + per, n_examples))
