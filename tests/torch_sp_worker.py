"""Worker process of tests/test_torch_sp.py: one rank of a 4-rank gloo
group on the CPU running the port's sequence-parallel train step and beam
search.

Usage: python torch_sp_worker.py <address> <world size> <rank> <dir>

<dir>/inputs.pt holds the models' configuration fields and full
parameters and the global batches (written by the test).  In one group
the rank builds a (2 data × 2 seq) mesh, a (1 × 4 seq) one and a (1 × 2
model × 2 seq) one and writes, for each, to <dir>/rank<r>.pt (with
`make_mesh`'s answer to a seq axis of 3):

  * the mesh and this rank's place on it;
  * `make_grad_step` with the data, model and seq axes: the loss and the
    gradients (gathered to full leaves over the model axis) — at
    grad_accum 1 and 2 and on the int8 batch on the 2 × 2 mesh, on the
    audio model's batch on the 1 × 4 mesh;
  * one Adam step of `make_train_step` on the 2 × 2 mesh: its loss and
    whether all four ranks hold the same parameters after it;
  * beam search (beam 2, maxlen 4, nbest 2) on this rank's rows and block,
    inside `sequence_parallel` (and `tensor_parallel`);
  * on the 1 × 4 mesh, at dropout 0.1 (both rates), the loss and gradients
    of one step, the generator seeded as the train loop seeds it, and every
    dropout mask this rank kept, in the order drawn.
"""

import os
import sys

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

from bist_tpu_torch.config import GenerateConfig, ModelConfig, TrainConfig  # noqa: E402
from bist_tpu_torch.data.batching import Batch  # noqa: E402
from bist_tpu_torch.decode.beam import beam_search  # noqa: E402
from bist_tpu_torch.models import layers  # noqa: E402
from bist_tpu_torch.parallel import (DataParallel, SequenceParallel,  # noqa: E402
                                     TensorParallel, gather_params, init_multihost,
                                     make_mesh, sequence_parallel, shard_params,
                                     tensor_parallel)
from bist_tpu_torch.parallel import sp as sp_mod  # noqa: E402
from bist_tpu_torch.train.loop import (TrainState, dropout_generator, make_grad_step,  # noqa: E402
                                       make_train_step, seed_for_step, trainable)
from bist_tpu_torch.train.schedule import make_optimizer  # noqa: E402
from bist_tpu_torch.weights import tree_leaves, tree_map  # noqa: E402

GCFG = GenerateConfig(maxlen=4, beam=2, penalty=1.0, nbest=2)   # test_torch_tp.GEN


def as_tree(leaves, like):
    """Copies of `leaves` (in `tree_leaves(like)`'s order; the reducer's
    gradients are views of its reused buffer) in `like`'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it).clone(), like)


class Mesh:
    """One mesh's axes and this rank's data rows and seq block of a batch."""

    def __init__(self, model_axis, seq_axis):
        self.mesh = make_mesh(model_axis=model_axis, seq_axis=seq_axis, device_type="cpu")
        self.tp = TensorParallel.from_mesh(self.mesh) if model_axis > 1 else None
        self.sp = SequenceParallel.from_mesh(self.mesh)
        self.dp = DataParallel.in_group("cpu", self.mesh)

    def local(self, batch):
        (rows,) = self.dp.shard(batch)
        return sp_mod.shard_batch(rows, self.sp)

    def params(self, full):
        return full if self.tp is None else shard_params(full, self.tp)

    def full(self, tree):
        return tree if self.tp is None else gather_params(tree, self.tp)

    def grads(self, cfg, tcfg, full, batch, accum=1, gen=None):
        params = trainable(self.params(full))
        loss, metrics, grads = make_grad_step(cfg, tcfg, grad_accum=accum, dp=self.dp,
                                              tp=self.tp, sp=self.sp)(
            params, self.local(batch), gen)
        return {"loss": loss, "ntokens": metrics["ntokens"],
                "grads": self.full(as_tree(grads, params))}

    def beam(self, cfg, full, batch):
        with tensor_parallel(self.tp), sequence_parallel(self.sp):
            return beam_search(self.params(full), cfg, self.local(batch), GCFG).tokens

    def place(self):
        names = self.mesh.mesh_dim_names
        return {"mesh": (self.mesh.mesh.tolist(), names),
                "coords": tuple(self.mesh.get_local_rank(n) for n in names),
                "data": (self.dp.rank, self.dp.n), "seq": (self.sp.rank, self.sp.size)}


def main():
    address, world, rank, root = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    init_multihost(address, world, rank, device="cpu")
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    cfg, acfg = ModelConfig(**inp["cfg"]), ModelConfig(**inp["audio_cfg"])
    tcfg = TrainConfig(warmup_steps=50)
    batch, qbatch, abatch = (Batch(*inp[k]) for k in ("batch", "int8_batch", "audio_batch"))
    params = inp["params"]
    try:
        make_mesh(seq_axis=3, device_type="cpu")
        bad_axis = None
    except ValueError as e:
        bad_axis = str(e)
    out = {"bad_axis": bad_axis}

    m = Mesh(1, 2)                                        # 2 data × 2 seq
    out["2x2"] = dict(m.place(), accum1=m.grads(cfg, tcfg, params, batch),
                      accum2=m.grads(cfg, tcfg, params, batch, accum=2),
                      int8=m.grads(cfg, tcfg, params, qbatch),
                      beam=m.beam(cfg, params, batch))
    state = TrainState(trainable(params), None, 0)
    tx = make_optimizer(cfg.d_model, tcfg.warmup_steps)
    state = state._replace(opt_state=tx.init(tree_leaves(state.params)))
    sp_mod.counts.update(all_gathers=0, all_reduces=0, bytes=0)
    state, metrics = make_train_step(cfg, tcfg, tx, dp=m.dp, sp=m.sp)(
        state, m.local(batch))
    world_dp = DataParallel.over_group("cpu", None)
    out["2x2"]["adam"] = {"loss": metrics["loss"], "step": state.step,
                          "counts": dict(sp_mod.counts),
                          "all_ranks_identical": world_dp.replicas_identical(state.params)}

    m = Mesh(1, 4)                                        # 1 data × 4 seq
    out["1x4"] = dict(m.place(), accum1=m.grads(cfg, tcfg, params, batch),
                      audio=m.grads(acfg, tcfg, inp["audio_params"], abatch),
                      beam=m.beam(cfg, params, batch))
    dcfg = cfg.replace(dropout=0.1, attn_dropout=0.1)
    gen = dropout_generator(dcfg, "cpu")
    gen.manual_seed(seed_for_step(inp["dropout_seed"], 0, m.dp.rank))
    kept, draw = [], layers.dropout_mask

    def recording(shape, rate, rngs, shard_dim=None, seq_dim=None):
        mask = draw(shape, rate, rngs, shard_dim, seq_dim)
        kept.append((mask.clone(), seq_dim))
        return mask

    layers.dropout_mask = recording
    try:
        out["1x4"]["dropout"] = dict(m.grads(dcfg, tcfg, params, batch, gen=gen), masks=kept)
    finally:
        layers.dropout_mask = draw

    m = Mesh(2, 2)                                        # 1 data × 2 model × 2 seq
    out["1x2x2"] = dict(m.place(), model=(m.tp.rank, m.tp.size),
                        accum1=m.grads(cfg, tcfg, params, batch),
                        beam=m.beam(cfg, params, batch))
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
