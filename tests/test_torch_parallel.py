"""The port's data-parallel layer (`bist_tpu_torch.parallel`) on the CPU:
the row blocks of `DataParallel.shard` against `bist_tpu`'s
`addressable_shards` on the 8-device CPU mesh (tests/conftest.py), and the
train step of two gloo processes (tests/torch_parallel_worker.py) against
the one-process step at the same global batch, whose two row blocks hold
different numbers of tokens, and against `bist_tpu`'s 8-way sharded step."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bist_tpu.config import ModelConfig as JaxModelConfig
from bist_tpu.config import TrainConfig as JaxTrainConfig
from bist_tpu.data.batching import Batch as JaxBatch
from bist_tpu.models.model import forward_logprobs as jax_forward
from bist_tpu.models.model import init_model as jax_init_model
from bist_tpu.parallel import mesh as jax_mesh
from bist_tpu.parallel import multihost as jax_multihost
from bist_tpu.train.losses import compute_losses as jax_losses
from bist_tpu_torch.config import ModelConfig, TrainConfig
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.parallel import (DataParallel, batch_sharding, init_multihost,
                                     local_example_slice, make_mesh, replicate)
from bist_tpu_torch.train.loop import make_grad_step, trainable
from bist_tpu_torch.weights import params_from_jax, tree_leaves
from torch_threads import two_threads  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
# tests/test_parallel.py's tiny model, without dropout
MODEL = dict(vocab_size=40, nb_blocks=1, nb_venc_blocks=1, nb_cenc_blocks=1, d_model=16,
             att_h=2, dropout=0.0, attn_dropout=0.0, include_caption="summary",
             separate_caption=True, ft_sizes=(8,))
B = 8


def tiny_batch(rng, B=B, lengths=None):
    """tests/test_parallel.py's batch; `lengths` cuts row i's answer to
    lengths[i] tokens (the rest PAD), so row blocks can hold different
    numbers of tokens."""
    def toks(L):
        x = rng.integers(4, 40, size=(B, L)).astype(np.int32)
        x[:, -1] = 1
        return x

    trg_y = toks(5)
    if lengths is not None:
        for i, n in enumerate(lengths):
            trg_y[i, n:] = 1
    return JaxBatch(query=toks(6), his=toks(8), trg=toks(5), trg_y=trg_y, cap=toks(4),
                    fts=rng.standard_normal((B, 3, 4, 8)).astype(np.float32),
                    audio_fts=None)


def as_torch(batch):
    return Batch(*[None if x is None else torch.from_numpy(np.asarray(x)) for x in batch])


# ---------------------------------------------------------------------------
# the row blocks against bist_tpu's mesh


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_matches_bist_tpu_addressable_shards(rng, n):
    batch = tiny_batch(rng)
    sharded = jax_mesh.DataParallel(num_devices=n).shard(batch)
    blocks = DataParallel(devices=[CPU] * n).shard(as_torch(batch))
    assert len(blocks) == n
    for name in JaxBatch._fields:
        arr = getattr(sharded, name)
        if arr is None:
            assert all(getattr(b, name) is None for b in blocks)
            continue
        shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
        assert len(shards) == n
        for shard, block in zip(shards, blocks):
            got = getattr(block, name)
            assert got.device == CPU
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data), err_msg=name)


def test_pad_batch_to_mesh_and_placements():
    for n in (1, 3, 4, 8):
        port, ref = DataParallel(devices=[CPU] * n), jax_mesh.DataParallel(num_devices=n)
        assert port.n == ref.n == n
        assert [port.pad_batch_to(k) for k in range(0, 20)] == \
            [ref.pad_batch_to(k) for k in range(0, 20)]
    assert make_mesh(device_type="cpu") == [CPU] and make_mesh(3, device_type="cpu") == [CPU] * 3
    assert DataParallel(num_devices=2, device_type="cpu").devices == [CPU, CPU]
    assert [type(p).__name__ for p in batch_sharding()] == ["Shard"]
    assert batch_sharding()[0].dim == 0
    assert [type(p).__name__ for p in replicate()] == ["Replicate"]
    with pytest.raises(RuntimeError, match="needs one process per device"):
        make_mesh(model_axis=2, device_type="cpu")
    with pytest.raises(ValueError, match="does not split over 3"):
        DataParallel(devices=[CPU] * 3).shard(as_torch(tiny_batch(np.random.default_rng(0))))
    params = {"w": torch.ones(2), "b": [torch.zeros(3)]}
    copies = DataParallel(devices=[CPU] * 3).put_replicated(params)
    assert len(copies) == 3 and all(c is params for c in copies)   # one device: shared
    with pytest.raises(RuntimeError, match="no process group"):
        DataParallel(devices=[CPU]).all_reduce_grads([torch.ones(2)])


def test_init_multihost_single_process_and_example_slice():
    assert init_multihost(num_processes=1) == jax_multihost.init_multihost(num_processes=1) == 0
    for n in (0, 1, 7, 10):
        assert local_example_slice(n) == jax_multihost.local_example_slice(n)


def test_padded_rows_contribute_nothing(rng):
    """All-PAD rows (padding to the rank count) change neither the loss nor
    the gradients: their token counts are zero and the KL masks them."""
    cfg, tcfg = ModelConfig(**MODEL), TrainConfig(warmup_steps=10)
    b4 = tiny_batch(rng, B=4)
    pad = JaxBatch(query=np.full((4, 6), 1, np.int32), his=np.full((4, 8), 1, np.int32),
                   trg=np.full((4, 5), 1, np.int32), trg_y=np.full((4, 5), 1, np.int32),
                   cap=np.full((4, 4), 1, np.int32), fts=np.zeros((4, 3, 4, 8), np.float32),
                   audio_fts=None)
    b8 = JaxBatch(*[None if a is None else np.concatenate([a, b], 0) for a, b in zip(b4, pad)])
    params = trainable(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_init_model(jax.random.PRNGKey(5), JaxModelConfig(**MODEL))), CPU))
    grad = make_grad_step(cfg, tcfg)
    l4, _, g4 = grad(params, as_torch(b4))
    l8, _, g8 = grad(params, as_torch(b8))
    np.testing.assert_allclose(float(l4), float(l8), rtol=1e-5)
    for a, b in zip(g4, g8):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# two gloo processes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# row i's answer keeps LENGTHS[i] tokens: rank 0's rows (0-3) hold 8, rank
# 1's 15, so a mean of the ranks' own losses would differ from the global one
LENGTHS = [1, 1, 2, 4, 4, 4, 3, 4]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The inputs, the JAX parameters, and what each of 2 gloo ranks computed
    (tests/torch_parallel_worker.py)."""
    root = str(tmp_path_factory.mktemp("dp2"))
    rng = np.random.default_rng(11)
    batch = tiny_batch(rng, lengths=LENGTHS)
    padded = tiny_batch(rng, B=4)
    padded = JaxBatch(*[None if x is None else np.concatenate(
        [x, np.full_like(x, 1) if x.dtype == np.int32 else np.zeros_like(x)]) for x in padded])
    same = tiny_batch(rng, B=1)
    same = JaxBatch(*[None if x is None else np.repeat(x, 4, 0) for x in same])
    jparams = jax_init_model(jax.random.PRNGKey(5), JaxModelConfig(**MODEL))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), CPU)
    torch.save({"cfg": MODEL, "params": params, "batch": tuple(as_torch(batch)),
                "padded": tuple(as_torch(padded)), "same_rows": tuple(as_torch(same))},
               os.path.join(root, "inputs.pt"))
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
                               address, "2", str(r), root], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a data-parallel worker timed out")
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return {"batch": batch, "padded": padded, "params": params, "jparams": jparams,
            "ranks": ranks}


def grads_close(got, want, atol_scale=1e-4):
    """tests/test_parallel.py's gradient tolerance: 1e-4·max(|g|, 1)."""
    for a, b in zip(got, want):
        scale = float(b.abs().max()) + 1e-6
        diff = float((a - b).abs().max())
        assert diff < atol_scale * max(scale, 1.0) + 1e-6, (diff, scale)


def test_shards_hold_different_token_counts(two_ranks):
    """The two ranks' rows of the global batch hold 8 and 15 answer tokens,
    which the global counts sum."""
    blocks = DataParallel(devices=[CPU] * 2).shard(as_torch(two_ranks["batch"]))
    assert [int((b.trg_y != 1).sum()) for b in blocks] == [8, 15]
    for r in two_ranks["ranks"]:
        assert int(r["accum1"]["metrics"]["ntokens"]) == 8 + 15


@pytest.mark.parametrize("accum", [1, 2])
def test_two_processes_match_one_process(two_ranks, accum):
    """Loss within 1e-5, gradients within 1e-4·max(|g|, 1) of the one-process
    step at the global batch (on every rank), the metrics the global
    batch's, and the ranks' parameters after Adam bit-identical."""
    cfg, tcfg = ModelConfig(**MODEL), TrainConfig(warmup_steps=10)
    loss, metrics, grads = make_grad_step(cfg, tcfg, grad_accum=accum)(
        trainable(two_ranks["params"]), as_torch(two_ranks["batch"]))
    for r in two_ranks["ranks"]:
        got = r[f"accum{accum}"]
        np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
        assert int(got["metrics"]["ntokens"]) == int(metrics["ntokens"]) == sum(LENGTHS)
        assert int(got["metrics"]["qntokens"]) == int(metrics["qntokens"])
        for k in ("out", "temporal_ae", "spatial_ae"):
            np.testing.assert_allclose(float(got["metrics"][k]), float(metrics[k]), rtol=1e-5)
        grads_close(got["grads"], grads)
        assert got["identical"]
    a, b = (r[f"accum{accum}"]["params"] for r in two_ranks["ranks"])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_a_mean_of_rank_losses_would_be_wrong(two_ranks):
    """DDP's recipe (each rank normalising by its own tokens, the losses
    averaged) is not the global batch's loss here: the shards hold 8 and 15
    answer tokens."""
    cfg, tcfg = ModelConfig(**MODEL), TrainConfig(warmup_steps=10)
    params = trainable(two_ranks["params"])
    grad = make_grad_step(cfg, tcfg)
    whole = float(grad(params, as_torch(two_ranks["batch"]))[0])
    halves = [float(grad(params, blk)[0]) for blk in
              DataParallel(devices=[CPU] * 2).shard(as_torch(two_ranks["batch"]))]
    assert abs(np.mean(halves) - whole) > 1e-3 * abs(whole)
    np.testing.assert_allclose(float(two_ranks["ranks"][0]["accum1"]["loss"]), whole, rtol=1e-5)


def test_program_on_the_group_matches_the_eager_step(two_ranks):
    """A TrainProgram built on the group updates as the eager step does, and
    the ranks stay bit-identical."""
    for r in two_ranks["ranks"]:
        assert r["program"]["identical"]
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(r["program"]["params"]),
                                                     tree_leaves(r["accum1"]["params"])))
        np.testing.assert_allclose(float(r["program"]["metrics"]["loss"]),
                                   float(r["accum1"]["loss"]), rtol=0)


def test_two_processes_match_bist_tpu_sharded_step(two_ranks):
    """The port's 2-rank gradients against `jax.value_and_grad` on
    `bist_tpu`'s 8-way sharded batch, at 5e-4."""
    jcfg, tcfg = JaxModelConfig(**MODEL), JaxTrainConfig(warmup_steps=10)

    def loss_fn(params, batch):
        logp, ft = jax_forward(params, jcfg, batch, rngs=None)
        return jax_losses(logp, ft, params["embed"]["lut"], jcfg, batch, tcfg.smoothing)[0]

    dp = jax_mesh.DataParallel()
    assert dp.n == 8
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        dp.put_replicated(two_ranks["jparams"]), dp.shard(two_ranks["batch"]))
    for r in two_ranks["ranks"]:
        got = r["accum1"]
        np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=5e-4)
        want = [torch.from_numpy(np.array(g)) for g in jax.tree_util.tree_leaves(grads)]
        # the trees' leaf orders: jax sorts dict keys, the port keeps insertion order
        port = dict(zip(_paths(r["accum1"]["params"]), got["grads"]))
        jax_paths = [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(grads)[0]]
        for path, w in zip(jax_paths, want):
            g = port[path]
            scale = float(jnp.max(jnp.abs(w.numpy()))) + 1e-6
            assert float((g - w).abs().max()) < 5e-4 * max(scale, 1.0) + 1e-6, path


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}[{i}]")]
    return [prefix]


def test_padded_rows_on_a_rank_contribute_nothing(two_ranks):
    """A global batch of 4 rows padded with 4 all-PAD rows to 8 (rank 1 gets
    padding only): the 2-rank loss is the 4 real rows' loss."""
    cfg, tcfg = ModelConfig(**MODEL), TrainConfig(warmup_steps=10)
    real = JaxBatch(*[None if x is None else x[:4] for x in two_ranks["padded"]])
    want = float(make_grad_step(cfg, tcfg)(trainable(two_ranks["params"]), as_torch(real))[0])
    for r in two_ranks["ranks"]:
        np.testing.assert_allclose(float(r["padded_loss"]), want, rtol=1e-5)


def test_dropout_masks_differ_by_rank(two_ranks):
    """Two ranks given identical rows at dropout 0.1, each generator seeded
    as the train loop seeds it (`seed_for_step` with the rank), compute
    different gradients: their masks differ."""
    a, b = (r["dropout_grads"] for r in two_ranks["ranks"])
    assert any(not torch.allclose(x, y) for x, y in zip(a, b))


def test_local_example_slice_and_mesh_in_the_group(two_ranks):
    """`bist_tpu`'s per-process slice arithmetic on the group's ranks, and
    `make_mesh` in the group: a 1-D DeviceMesh over the ranks named 'data'."""
    for rank, r in enumerate(two_ranks["ranks"]):
        assert r["mesh"] == ([0, 1], ("data",))
        for n, key in ((10, "slice10"), (7, "slice7")):
            per = (n + 1) // 2
            assert r[key] == slice(rank * per, min(rank * per + per, n))
