"""Worker process of tests/test_torch_parallel.py: one rank of a gloo group
on the CPU running the port's data-parallel train step.

Usage: python torch_parallel_worker.py <address> <world size> <rank> <dir>

<dir>/inputs.pt holds the model's configuration fields, its parameters and
the global batches (written by the test); the rank writes what it computed
on its rows of them to <dir>/rank<r>.pt:

  * `make_grad_step` with the group: loss, metrics and the summed
    gradients, at grad_accum 1 and 2;
  * one Adam step of `make_train_step` and of a `TrainProgram` built on the
    group: the parameters after it, and whether the ranks hold the same
    bits (`DataParallel.replicas_identical`);
  * the loss of a batch with all-PAD rows (padding to the rank count);
  * at dropout 0.1, each rank's own gradient of identical rows, its
    generator seeded as the train loop seeds it (`seed_for_step` with the
    rank);
  * `init_multihost`'s, `local_example_slice`'s and `make_mesh`'s answers
    in the group.
"""

import os
import sys

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

from bist_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from bist_tpu_torch.data.batching import Batch  # noqa: E402
from bist_tpu_torch.parallel import (DataParallel, init_multihost,  # noqa: E402
                                     local_example_slice, make_mesh)
from bist_tpu_torch.train.compiled import TrainProgram  # noqa: E402
from bist_tpu_torch.train.loop import (TrainState, dropout_generator, make_grad_step,  # noqa: E402
                                       make_train_step, seed_for_step, trainable)
from bist_tpu_torch.train.schedule import make_optimizer  # noqa: E402
from bist_tpu_torch.weights import tree_leaves, tree_map  # noqa: E402


def detached(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def main():
    address, world, rank, root = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    got = init_multihost(address, world, rank, device="cpu")
    assert got == rank, (got, rank)
    assert init_multihost(address, world, rank, device="cpu") == rank   # tolerated twice
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    cfg = ModelConfig(**inp["cfg"])
    tcfg = TrainConfig(warmup_steps=10)
    dp = DataParallel.in_group("cpu")
    assert (dp.n, dp.rank, dp.backend) == (world, rank, "gloo")
    mesh = make_mesh(device_type="cpu")
    out = {"slice10": local_example_slice(10), "slice7": local_example_slice(7),
           "mesh": (mesh.mesh.tolist(), mesh.mesh_dim_names)}

    def mine(batch):
        (local,) = dp.shard(Batch(*batch))
        return local

    def new_state():
        params = trainable(inp["params"])
        tx = make_optimizer(cfg.d_model, tcfg.warmup_steps)
        return TrainState(params, tx.init(tree_leaves(params)), 0), tx

    batch = mine(inp["batch"])
    for accum in (1, 2):
        state, tx = new_state()
        loss, metrics, grads = make_grad_step(cfg, tcfg, grad_accum=accum, dp=dp)(
            state.params, batch)
        out[f"accum{accum}"] = {"loss": loss, "metrics": metrics,
                                "grads": [g.clone() for g in grads]}
        state, _ = make_train_step(cfg, tcfg, tx, grad_accum=accum, dp=dp)(state, batch)
        out[f"accum{accum}"]["params"] = detached(state.params)
        out[f"accum{accum}"]["identical"] = dp.replicas_identical(state.params)

    # the compiled program on the group (the CPU runs its step eagerly on
    # its static buffers) against the eager step's update
    state, tx = new_state()
    prog = TrainProgram(state, cfg, tcfg, tx, dp=dp)
    state, metrics = prog(state, batch)
    out["program"] = {"params": detached(state.params), "metrics": metrics,
                      "identical": dp.replicas_identical(state.params)}

    state, _ = new_state()
    out["padded_loss"] = make_grad_step(cfg, tcfg, dp=dp)(
        state.params, mine(inp["padded"]))[0]

    dcfg = cfg.replace(dropout=0.1)
    gen = dropout_generator(dcfg, "cpu")
    gen.manual_seed(seed_for_step(778, 0, rank))
    state, _ = new_state()
    out["dropout_grads"] = make_grad_step(dcfg, tcfg)(state.params, mine(inp["same_rows"]),
                                                      gen)[2]
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
