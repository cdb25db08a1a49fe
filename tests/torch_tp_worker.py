"""Worker process of tests/test_torch_tp.py: one rank of a 4-rank gloo
group on the CPU running the port's tensor-parallel train step and beam
search.

Usage: python torch_tp_worker.py <address> <world size> <rank> <dir>

<dir>/inputs.pt holds the model's configuration fields, its full
parameters and the global batch (written by the test).  In one group the
rank builds a (2 data × 2 model) mesh and a (1 × 4) one (one head a rank)
and writes, for each, to <dir>/rank<r>.pt (with `make_mesh`'s answer to a
model axis of 3):

  * the mesh and this rank's place on it;
  * `gather_params(shard_params(p, tp), tp)` equal to p bit for bit;
  * `make_grad_step` with the data and model axes at grad_accum 1 and 2:
    the loss and the gradients gathered to full leaves;
  * one Adam step of `make_train_step`: its loss and step, and whether the
    data replicas hold the same shards after it, and after one drifts and
    `broadcast_params` restores it;
  * beam search (beam 2, maxlen 4, nbest 2) on this rank's rows, inside
    `tensor_parallel`;
  * on the 1 × 4 mesh, at dropout 0.1 (both rates), the loss and gathered
    gradients of one step, the generator seeded as the train loop seeds it.
"""

import os
import sys

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

from bist_tpu_torch.config import GenerateConfig, ModelConfig, TrainConfig  # noqa: E402
from bist_tpu_torch.data.batching import Batch  # noqa: E402
from bist_tpu_torch.decode.beam import beam_search  # noqa: E402
from bist_tpu_torch.parallel import (DataParallel, TensorParallel,  # noqa: E402
                                     gather_params, init_multihost, make_mesh,
                                     shard_params, tensor_parallel)
from bist_tpu_torch.train.loop import (TrainState, dropout_generator, make_grad_step,  # noqa: E402
                                       make_train_step, seed_for_step, trainable)
from bist_tpu_torch.train.schedule import make_optimizer  # noqa: E402
from bist_tpu_torch.weights import tree_leaves, tree_map  # noqa: E402

GCFG = GenerateConfig(maxlen=4, beam=2, penalty=1.0, nbest=2)   # test_torch_tp.GEN


def as_tree(leaves, like):
    """Copies of `leaves` (in `tree_leaves(like)`'s order; the data axis's
    gradients are views of its reused buffer) in `like`'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it).clone(), like)


def on_mesh(cfg, tcfg, full, batch, model_axis, dropout_seed=None):
    mesh = make_mesh(model_axis=model_axis, device_type="cpu")
    tp = TensorParallel.from_mesh(mesh)
    dp = DataParallel.in_group("cpu", mesh)
    (local,) = dp.shard(batch)
    out = {"mesh": (mesh.mesh.tolist(), mesh.mesh_dim_names),
           "data": (dp.rank, dp.n), "model": (tp.rank, tp.size),
           "rows": int(local.query.shape[0])}
    shards = shard_params(full, tp)
    out["round_trip"] = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(gather_params(shards, tp)), tree_leaves(full)))

    def new_state():
        params = trainable(shards)
        tx = make_optimizer(cfg.d_model, tcfg.warmup_steps)
        return TrainState(params, tx.init(tree_leaves(params)), 0), tx

    for accum in (1, 2):
        state, tx = new_state()
        loss, _, grads = make_grad_step(cfg, tcfg, grad_accum=accum, dp=dp, tp=tp)(
            state.params, local)
        out[f"accum{accum}"] = {"loss": loss,
                                "grads": gather_params(as_tree(grads, state.params), tp)}
    state, tx = new_state()
    state, metrics = make_train_step(cfg, tcfg, tx, dp=dp, tp=tp)(state, local)
    out["adam"] = {"loss": metrics["loss"], "step": state.step,
                   "finite": all(bool(torch.isfinite(t).all())
                                 for t in tree_leaves(state.params)),
                   "data_replicas_identical": dp.replicas_identical(state.params)}
    # a data replica that drifted, then rank 0's shards broadcast over the
    # data axis
    with torch.no_grad():
        tree_leaves(state.params)[0].add_(float(dp.rank))
    drifted = dp.replicas_identical(state.params)
    dp.broadcast_params(state.params)
    out["broadcast"] = (drifted, dp.replicas_identical(state.params))
    with tensor_parallel(tp):
        out["beam"] = beam_search(shards, cfg, local, GCFG).tokens
    if dropout_seed is not None:
        dcfg = cfg.replace(dropout=0.1, attn_dropout=0.1)
        gen = dropout_generator(dcfg, "cpu")
        gen.manual_seed(seed_for_step(dropout_seed, 0, dp.rank))
        state, _ = new_state()
        loss, _, grads = make_grad_step(dcfg, tcfg, dp=dp, tp=tp)(state.params, local, gen)
        out["dropout"] = {"loss": loss,
                          "grads": gather_params(as_tree(grads, state.params), tp)}
    return out


def main():
    address, world, rank, root = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    init_multihost(address, world, rank, device="cpu")
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    cfg = ModelConfig(**inp["cfg"])
    tcfg = TrainConfig(warmup_steps=50)
    batch = Batch(*inp["batch"])
    try:
        make_mesh(model_axis=3, device_type="cpu")
        bad_axis = None
    except ValueError as e:
        bad_axis = str(e)
    out = {"bad_axis": bad_axis,
           "2x2": on_mesh(cfg, tcfg, inp["params"], batch, 2),
           "1x4": on_mesh(cfg, tcfg, inp["params"], batch, 4,
                          dropout_seed=inp["dropout_seed"])}
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
