"""The port's tensor parallelism (`bist_tpu_torch.parallel.tp`) on the CPU:
the placement rules leaf for leaf against `bist_tpu.parallel.tp`'s, the
divisibility checks, shard → gather, and the train step and beam search of
four gloo processes (tests/torch_tp_worker.py) on a (2 data × 2 model) and
a (1 × 4) mesh, on `tests/test_tp.py`'s set-up: the loss and every
gathered gradient against `bist_tpu`'s jitted `value_and_grad` on the same
weights, at `test_tp.py`'s tolerances (loss abs 2e-5, gradients rtol 1e-3
and atol 1e-5)."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bist_tpu.config import GenerateConfig as JaxGenerateConfig
from bist_tpu.config import ModelConfig as JaxModelConfig
from bist_tpu.config import TrainConfig as JaxTrainConfig
from bist_tpu.data.batching import Batch as JaxBatch
from bist_tpu.decode.beam import beam_search as jax_beam_search
from bist_tpu.models.model import forward_logprobs as jax_forward
from bist_tpu.models.model import init_model as jax_init_model
from bist_tpu.parallel import tp as jax_tp
from bist_tpu.train.losses import compute_losses as jax_losses
from bist_tpu_torch.config import GenerateConfig, ModelConfig, TrainConfig
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.decode.beam import beam_search
from bist_tpu_torch.ops import dispatch
from bist_tpu_torch.parallel import (TensorParallel, param_specs, shard_params,
                                     tensor_parallel, validate_tp_config)
from bist_tpu_torch.parallel.tp import shard_dim
from bist_tpu_torch.train.loop import dropout_generator, make_grad_step, seed_for_step, trainable
from bist_tpu_torch.weights import params_from_jax, tree_leaves
from torch_threads import two_threads  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
# tests/test_tp.py's model
MODEL = dict(vocab_size=80, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2, d_model=32,
             att_h=4, dropout=0.0, attn_dropout=0.0, include_caption="summary",
             separate_caption=True, ft_sizes=(16,), enc_st_combine="none",
             enc_vc_combine="dyn", dec_st_combine="seq")
B = 4
# __graft_entry__.dryrun_multichip's decode
GEN = dict(maxlen=4, beam=2, penalty=1.0, nbest=2)
MESHES = ["2x2", "1x4"]
DROPOUT_SEED = 7


def jax_batch():
    """tests/test_tp.py's batch."""
    rng = np.random.default_rng(5)

    def toks(L):
        x = rng.integers(4, MODEL["vocab_size"], size=(B, L)).astype(np.int32)
        x[:, -1] = 1
        return x

    return JaxBatch(query=toks(6), his=toks(10), trg=toks(5), trg_y=toks(5), cap=toks(4),
                    fts=rng.standard_normal((B, 3, 4, 16)).astype(np.float32),
                    audio_fts=None)


def as_torch(batch):
    return Batch(*[None if x is None else torch.from_numpy(np.asarray(x)) for x in batch])


def walk(tree, prefix=""):
    """(path, leaf) in jax.tree_util.keystr's notation; a PartitionSpec is a
    leaf."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in walk(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [pl for i, v in enumerate(tree) for pl in walk(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxModelConfig(**MODEL)
    jparams = jax_init_model(jax.random.PRNGKey(3), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), CPU)
    return jcfg, jparams, params, jax_batch()


@pytest.fixture(scope="module")
def four_ranks(setup, tmp_path_factory):
    """What each of 4 gloo ranks computed (tests/torch_tp_worker.py), and
    `bist_tpu`'s one-device loss and gradients (test_tp.py's oracle) and
    beam tokens."""
    jcfg, jparams, params, batch = setup
    root = str(tmp_path_factory.mktemp("tp4"))
    torch.save({"cfg": MODEL, "params": params, "batch": tuple(as_torch(batch)),
                "dropout_seed": DROPOUT_SEED}, os.path.join(root, "inputs.pt"))
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_tp_worker.py"),
                               address, "4", str(r), root], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]

    # bist_tpu's oracle while the workers run
    tcfg = JaxTrainConfig(warmup_steps=50)

    def loss_fn(p, b):
        logp, ft = jax_forward(p, jcfg, b, rngs=None)
        return jax_losses(logp, ft, p["embed"]["lut"], jcfg, b, tcfg.smoothing)[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams, batch)
    ref = {path: np.asarray(g) for path, g in walk(
        jax.tree_util.tree_map(np.asarray, ref_grads))}
    ref_beam = np.asarray(jax_beam_search(jparams, jcfg, batch, JaxGenerateConfig(**GEN)).tokens)
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a tensor-parallel worker timed out")
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    return {"ranks": ranks, "ref_loss": float(ref_loss), "ref_grads": ref,
            "ref_beam": ref_beam}


# ---------------------------------------------------------------------------
# in process


def test_param_specs_match_bist_tpu(setup):
    """Leaf for leaf on the same carried tree: P(None, 'model') ↔ Shard(1),
    P('model') and P('model', None) ↔ Shard(0), P() ↔ Replicate()."""
    from torch.distributed.tensor import Replicate, Shard

    _, jparams, params, _ = setup
    want = dict(walk(jax_tp.param_specs(jparams)))
    got = walk(param_specs(params))
    assert len(got) == len(want) == len(tree_leaves(params))
    kinds = set()
    for path, placement in got:
        spec = want[path]
        if "model" in tuple(spec):
            assert placement == Shard(tuple(spec).index("model")), path
        else:
            assert placement == Replicate(), path
        kinds.add((tuple(spec), type(placement).__name__))
    assert kinds == {((None, "model"), "Shard"), (("model",), "Shard"),
                     (("model", None), "Shard"), ((), "Replicate")}
    specs = param_specs(params)
    assert specs["gen"]["pointer_attn"][0]["wq"]["w"] == Shard(1)
    assert specs["decoder"]["v_layers"][1]["t2s_hop1"]["attn"]["wo"]["w"] == Shard(0)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_validate_tp_config_raises_where_bist_tpu_does(n):
    for kw in ({}, {"att_h": 2}, {"d_model": 24, "att_h": 4}):
        jcfg, cfg = JaxModelConfig(**dict(MODEL, **kw)), ModelConfig(**dict(MODEL, **kw))
        try:
            jax_tp.validate_tp_config(jcfg, n)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            validate_tp_config(cfg, n)
        else:
            with pytest.raises(ValueError) as got:
                validate_tp_config(cfg, n)
            assert str(got.value) == want
    if n == 3:
        with pytest.raises(ValueError, match="att_h=4 not divisible by model axis 3"):
            validate_tp_config(ModelConfig(**MODEL), 3)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shards_concatenate_to_the_full_tree(setup, n):
    """The n ranks' `shard_params` blocks, laid side by side along each
    leaf's shard dim, are the full leaves bit for bit; replicated leaves are
    the full ones on every rank."""
    params = setup[2]
    shards = [tree_leaves(shard_params(params, TensorParallel(None, r, n))) for r in range(n)]
    for i, (path, full) in enumerate(walk(params)):
        keys = [k.strip("'") if not k.isdigit() else int(k)
                for k in path.strip("[]").split("][")]
        d = shard_dim(keys)
        if d is None:
            assert all(s[i] is full for s in shards), path
        else:
            assert all(s[i].shape[d] == full.shape[d] // n for s in shards), path
            assert torch.equal(torch.cat([s[i] for s in shards], d), full), path


def test_kernels_off_under_tensor_parallelism():
    flash = dict(kv_len=dispatch.FLASH_MIN_KV, dropout_active=False, grad=False,
                 return_attn=False, mask_is_kv_validity=True)
    assert dispatch.hop1_uses_kernel(False) and dispatch.mha_uses_flash(**flash)
    with tensor_parallel(TensorParallel(None, 0, 2)):
        assert not dispatch.hop1_uses_kernel(False)
        assert not dispatch.mha_uses_flash(**flash)
    assert dispatch.hop1_uses_kernel(False) and dispatch.mha_uses_flash(**flash)


# ---------------------------------------------------------------------------
# four gloo processes


@pytest.mark.parametrize("mesh", MESHES)
def test_meshes_and_places(four_ranks, mesh):
    want = {"2x2": [[0, 1], [2, 3]], "1x4": [[0, 1, 2, 3]]}[mesh]
    for r, got in enumerate(four_ranks["ranks"]):
        g = got[mesh]
        assert g["mesh"] == (want, ("data", "model"))
        m = len(want[0])
        assert g["data"] == (r // m, len(want)) and g["model"] == (r % m, m)
        assert g["rows"] == B // len(want)
        assert g["round_trip"]


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_step_matches_bist_tpu(four_ranks, mesh):
    """Loss at abs 2e-5 and every gathered gradient leaf at rtol 1e-3, atol
    1e-5 of `bist_tpu`'s one-device step, on every rank."""
    ref = four_ranks["ref_grads"]
    for got in four_ranks["ranks"]:
        g = got[mesh]["accum1"]
        assert float(g["loss"]) == pytest.approx(four_ranks["ref_loss"], abs=2e-5)
        paths = walk(g["grads"])
        assert len(paths) == len(ref)
        for path, grad in paths:
            np.testing.assert_allclose(grad.numpy(), ref[path], rtol=1e-3, atol=1e-5,
                                       err_msg=path)


@pytest.mark.parametrize("mesh", MESHES)
def test_grad_accum_two_equals_one(four_ranks, mesh):
    for got in four_ranks["ranks"]:
        one, two = got[mesh]["accum1"], got[mesh]["accum2"]
        np.testing.assert_allclose(float(two["loss"]), float(one["loss"]), rtol=1e-5)
        for (path, a), (_, b) in zip(walk(one["grads"]), walk(two["grads"])):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=path)


@pytest.mark.parametrize("mesh", MESHES)
def test_adam_step_on_local_shards(four_ranks, mesh):
    """One Adam step: finite loss and parameters, step 1, and the data
    replicas of each shard bit-identical after it; a replica that drifts
    is restored by `broadcast_params` over the data axis (on the 1 × 4 mesh
    the data axis has one rank: nothing drifts)."""
    for got in four_ranks["ranks"]:
        a = got[mesh]["adam"]
        assert np.isfinite(float(a["loss"])) and a["finite"]
        assert a["step"] == 1 and a["data_replicas_identical"]
        assert got[mesh]["broadcast"] == (mesh == "1x4", True)


def test_make_mesh_refuses_an_axis_that_does_not_divide(four_ranks):
    for got in four_ranks["ranks"]:
        assert got["bad_axis"] == "a model axis of 3 does not divide the 4 processes of the group"


@pytest.mark.parametrize("mesh", MESHES)
def test_beam_tokens_match_one_device(setup, four_ranks, mesh):
    """Beam 2, maxlen 4, nbest 2 (`__graft_entry__.dryrun_multichip`'s decode)
    on each rank's rows: the tokens of `bist_tpu`'s beam search on the same
    weights and batch, and of the port's one-device beam search."""
    params, batch = setup[2], as_torch(setup[3])
    want = beam_search(params, ModelConfig(**MODEL), batch, GenerateConfig(**GEN)).tokens
    np.testing.assert_array_equal(want.numpy(), four_ranks["ref_beam"])
    for got in four_ranks["ranks"]:
        d, n = got[mesh]["data"]
        k = B // n
        np.testing.assert_array_equal(got[mesh]["beam"].numpy(),
                                      four_ranks["ref_beam"][d * k:(d + 1) * k])
        assert torch.equal(got[mesh]["beam"], want[d * k:(d + 1) * k])


def test_dropout_step_equals_one_process(setup, four_ranks):
    """At dropout 0.1 (both rates) on the 1 × 4 mesh, each rank drawing the
    full-width masks and keeping its block: the loss and gradients of the
    one-process port at the same seed."""
    cfg = ModelConfig(**dict(MODEL, dropout=0.1, attn_dropout=0.1))
    gen = dropout_generator(cfg, "cpu")
    gen.manual_seed(seed_for_step(DROPOUT_SEED, 0))
    loss, _, grads = make_grad_step(cfg, TrainConfig(warmup_steps=50))(
        trainable(setup[2]), as_torch(setup[3]), gen)
    clean = float(four_ranks["ranks"][0]["1x4"]["accum1"]["loss"])
    assert abs(float(loss) - clean) > 1e-3          # the masks changed the loss
    for got in four_ranks["ranks"]:
        g = got["1x4"]["dropout"]
        np.testing.assert_allclose(float(g["loss"]), float(loss), rtol=1e-5)
        for a, b in zip(tree_leaves(g["grads"]), grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


def test_chip_smoke_phase_tensor_parallel_on_cpu(tmp_path):
    """chip_smoke.py's phase 15 on the CPU at tiny widths: two gloo ranks at
    a (1 × 2) mesh against one process, train step and beam search."""
    import chip_smoke

    tiny = dict(d_model=32, att_h=4, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2)
    out = chip_smoke.phase_tensor_parallel(CPU, str(tmp_path / "tp"), B=4, rows=4, steps=2,
                                           model_kw=tiny)
    assert out["heads_a_rank"] == 2 and out["beam_tokens_identical_rows"] == 4
    assert out["loss_rel_err"] <= 5e-4 and out["grad_max_err_over_bound"] <= 1.0
    assert len(out["tp_losses"]) == 2 and all(np.isfinite(out["tp_losses"]))
    assert out["model_all_reduces_a_step"]["all_reduces"] > 0
    assert out["beam_model_all_reduces"]["bytes"] > 0
    assert all(0.0 < x < 1.0 for x in out["model_all_reduce_share"])
    assert all(len(x) == 2 for x in out["timed_tp_step_ms"] + out["model_all_reduce_ms"])
    assert set(out["one_device_eager_ms_per_step"]) == {"kernels", "plain"}
