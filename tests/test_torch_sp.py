"""The port's sequence parallelism (`bist_tpu_torch.parallel.sp`) on the
CPU: the batch placements field for field against
`bist_tpu.parallel.sp.batch_specs()`, the divisibility check, the long
axes' blocks, the history's positional offset, `make_mesh`'s rank order,
and the train step and beam search of four gloo processes
(tests/torch_sp_worker.py) on a (2 data × 2 seq), a (1 × 4 seq) and a
(1 × 2 model × 2 seq) mesh, on `tests/test_sp.py`'s set-up (d_model 32, 2
blocks, his L 8, T 4, B 4): the loss and every gradient gathered to full
leaves against `bist_tpu`'s jitted `value_and_grad` on the same weights,
at `test_sp.py`'s tolerances (loss abs 2e-5, gradients rtol 1e-3 and atol
1e-5), on a float, an int8 (`fts_scale`) and an audio batch, with
grad_accum 2; beam tokens identical to one device's; and at dropout 0.1
each seq rank's masks equal to a one-process run's, sliced to its
block."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from bist_tpu.config import GenerateConfig as JaxGenerateConfig
from bist_tpu.config import ModelConfig as JaxModelConfig
from bist_tpu.config import TrainConfig as JaxTrainConfig
from bist_tpu.data.batching import Batch as JaxBatch
from bist_tpu.data.batching import quantize_features
from bist_tpu.decode.beam import beam_search as jax_beam_search
from bist_tpu.models.model import forward_logprobs as jax_forward
from bist_tpu.models.model import init_model as jax_init_model
from bist_tpu.parallel import sp as jax_sp
from bist_tpu.train.losses import compute_losses as jax_losses
from bist_tpu_torch.config import GenerateConfig, ModelConfig, TrainConfig
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.decode.beam import beam_search
from bist_tpu_torch.models import layers
from bist_tpu_torch.models.model import _embed_seq, _pe
from bist_tpu_torch.ops import dispatch
from bist_tpu_torch.parallel import (SequenceParallel, TensorParallel, batch_specs,
                                     sequence_parallel, tensor_parallel, validate_sp_batch)
from bist_tpu_torch.parallel import sp
from bist_tpu_torch.train.loop import dropout_generator, make_grad_step, seed_for_step, trainable
from bist_tpu_torch.vocab import PAD
from bist_tpu_torch.weights import params_from_jax, tree_leaves
from torch_threads import two_threads  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
# tests/test_sp.py's model
MODEL = dict(vocab_size=80, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2, d_model=32,
             att_h=4, dropout=0.0, attn_dropout=0.0, include_caption="summary",
             separate_caption=True, ft_sizes=(16,), enc_st_combine="none",
             enc_vc_combine="dyn", dec_st_combine="seq")
# with audio (two context blocks over an 8-frame, 8-feature track) and the
# history as a pointer source, the two sharded memories besides the grid
AUDIO_MODEL = dict(MODEL, ft_sizes=(16, 8), nb_aenc_blocks=2, ptr_ft="query,his")
B = 4
GEN = dict(maxlen=4, beam=2, penalty=1.0, nbest=2)      # test_torch_tp.GEN
MESHES = ["2x2", "1x4", "1x2x2"]
DROPOUT_SEED = 7


def jax_batch():
    """tests/test_sp.py's batch: his L 8 and fts T 4 divide the seq axes."""
    rng = np.random.default_rng(5)

    def toks(L):
        x = rng.integers(4, MODEL["vocab_size"], size=(B, L)).astype(np.int32)
        x[:, -1] = 1
        return x

    return JaxBatch(query=toks(6), his=toks(8), trg=toks(5), trg_y=toks(5), cap=toks(4),
                    fts=rng.standard_normal((B, 4, 4, 16)).astype(np.float32),
                    audio_fts=None)


def int8_batch(batch):
    q, scale = quantize_features(batch.fts)
    return batch._replace(fts=q, fts_scale=scale)


def audio_batch(batch):
    rng = np.random.default_rng(9)
    a = rng.standard_normal((B, 8, 8)).astype(np.float32)
    a[:, 6:] = 0.0                                      # padded frames: masked
    his = batch.his.copy()
    his[:, :2] = PAD                                    # padded history: masked
    return batch._replace(his=his, audio_fts=a)


def as_torch(batch):
    return Batch(*[None if x is None else torch.from_numpy(np.asarray(x)) for x in batch])


def walk(tree, prefix=""):
    """(path, leaf) in jax.tree_util.keystr's notation."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in walk(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in walk(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_value_and_grad(jcfg, jparams, batch):
    tcfg = JaxTrainConfig(warmup_steps=50)

    def loss_fn(p, b):
        logp, ft = jax_forward(p, jcfg, b, rngs=None)
        return jax_losses(logp, ft, p["embed"]["lut"], jcfg, b, tcfg.smoothing)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams, batch)
    return float(loss), dict(walk(jax.tree_util.tree_map(np.asarray, grads)))


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxModelConfig(**MODEL)
    jparams = jax_init_model(jax.random.PRNGKey(3), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), CPU)
    return jcfg, jparams, params, jax_batch()


@pytest.fixture(scope="module")
def four_ranks(setup, tmp_path_factory):
    """What each of 4 gloo ranks computed (tests/torch_sp_worker.py), and
    `bist_tpu`'s one-device losses and gradients (test_sp.py's oracle) on
    the float, int8 and audio batches, and its beam tokens."""
    jcfg, jparams, params, batch = setup
    ajcfg = JaxModelConfig(**AUDIO_MODEL)
    ajparams = jax_init_model(jax.random.PRNGKey(4), ajcfg)
    aparams = params_from_jax(jax.tree_util.tree_map(np.asarray, ajparams), CPU)
    root = str(tmp_path_factory.mktemp("sp4"))
    torch.save({"cfg": MODEL, "params": params, "batch": tuple(as_torch(batch)),
                "int8_batch": tuple(as_torch(int8_batch(batch))),
                "audio_cfg": AUDIO_MODEL, "audio_params": aparams,
                "audio_batch": tuple(as_torch(audio_batch(batch))),
                "dropout_seed": DROPOUT_SEED}, os.path.join(root, "inputs.pt"))
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_sp_worker.py"),
                               address, "4", str(r), root], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]

    # bist_tpu's oracles while the workers run
    refs = {"float": _jax_value_and_grad(jcfg, jparams, batch),
            "int8": _jax_value_and_grad(jcfg, jparams, int8_batch(batch)),
            "audio": _jax_value_and_grad(ajcfg, ajparams, audio_batch(batch))}
    ref_beam = np.asarray(jax_beam_search(jparams, jcfg, batch, JaxGenerateConfig(**GEN)).tokens)
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a sequence-parallel worker timed out")
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    return {"ranks": ranks, "refs": refs, "ref_beam": ref_beam}


def _assert_matches(got, ref):
    """test_sp.py's tolerances: loss abs 2e-5, each gradient leaf rtol 1e-3,
    atol 1e-5."""
    ref_loss, ref_grads = ref
    assert float(got["loss"]) == pytest.approx(ref_loss, abs=2e-5)
    paths = walk(got["grads"])
    assert len(paths) == len(ref_grads)
    for path, grad in paths:
        np.testing.assert_allclose(grad.numpy(), ref_grads[path], rtol=1e-3, atol=1e-5,
                                   err_msg=path)


# ---------------------------------------------------------------------------
# in process


def test_batch_specs_match_bist_tpu():
    """Field for field: P(data, seq) ↔ (Shard(0), Shard(1)), P(data) ↔
    (Shard(0), Replicate()); without a data axis the seq placement alone."""
    from torch.distributed.tensor import Replicate, Shard

    want, got = jax_sp.batch_specs(), batch_specs()
    assert got._fields == want._fields
    for name, spec, placement in zip(want._fields, want, got):
        assert tuple(spec) in (("data", "seq"), ("data",)), name
        assert placement == ((Shard(0), Shard(1)) if tuple(spec) == ("data", "seq")
                             else (Shard(0), Replicate())), name
    assert batch_specs(dp_axis=None).his == (Shard(1),)
    assert batch_specs(dp_axis=None).query == (Replicate(),)
    assert got.fts_scale == got.fts


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_validate_sp_batch_raises_where_bist_tpu_does(n):
    """4 (and its divisors) accepted, 3 and 5 refused with bist_tpu's
    message, on the float and the audio batch."""
    for jb in (jax_batch(), audio_batch(jax_batch())):
        try:
            jax_sp.validate_sp_batch(jb, n)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            validate_sp_batch(as_torch(jb), n)
        else:
            with pytest.raises(ValueError) as got:
                validate_sp_batch(as_torch(jb), n)
            assert str(got.value) == want
    assert (n in (3, 5)) == (want is not None)


@pytest.mark.parametrize("n", [2, 4])
def test_blocks_concatenate_to_the_batch(n):
    """The n ranks' `shard_batch` blocks laid side by side are the long
    fields, fts_scale sharded with fts; the short fields are the batch's."""
    batch = as_torch(audio_batch(int8_batch(jax_batch())))
    blocks = [sp.shard_batch(batch, SequenceParallel(None, r, n)) for r in range(n)]
    for name, full in zip(batch._fields, batch):
        parts = [getattr(b, name) for b in blocks]
        if name in sp.LONG_FIELDS:
            assert all(p.shape[1] == full.shape[1] // n for p in parts), name
            assert torch.equal(torch.cat(parts, 1), full), name
        else:
            assert all(p is full for p in parts), name
    assert blocks[1].fts_scale.shape == (B, 4 // n, 4, 1)
    np_blocks = sp.shard_batch(int8_batch(jax_batch()), SequenceParallel(None, 1, n))
    np.testing.assert_array_equal(np_blocks.fts_scale,
                                  int8_batch(jax_batch()).fts_scale[:, 4 // n:2 * (4 // n)])


def test_history_block_takes_its_global_positions(setup):
    """Each rank's block of the history embeds at its global offset: the n
    blocks' embeddings are the one-device embedding's blocks."""
    params = setup[2]
    cfg = ModelConfig(**MODEL)
    his = torch.from_numpy(jax_batch().his)
    whole = _embed_seq(params, cfg, _pe(params, cfg), his, None)
    for r in range(4):
        with sequence_parallel(SequenceParallel(None, r, 4)):
            assert sp.offset(2) == 2 * r
            got = _embed_seq(params, cfg, _pe(params, cfg), his[:, 2 * r:2 * r + 2], None,
                             seq_sharded=True)
        assert torch.equal(got, whole[:, 2 * r:2 * r + 2])
    assert sp.offset(2) == 0


def test_kernels_stay_on_under_sequence_parallelism():
    """SP alone keeps K1/K2/K3's dispatch; under TP × SP they are off, as
    under TP."""
    flash = dict(kv_len=dispatch.FLASH_MIN_KV, dropout_active=False, grad=False,
                 return_attn=False, mask_is_kv_validity=True)
    with sequence_parallel(SequenceParallel(None, 0, 2)):
        assert dispatch.hop1_uses_kernel(False) and dispatch.mha_uses_flash(**flash)
        with tensor_parallel(TensorParallel(None, 0, 2)):
            assert not dispatch.hop1_uses_kernel(False)
            assert not dispatch.mha_uses_flash(**flash)


# ---------------------------------------------------------------------------
# four gloo processes


@pytest.mark.parametrize("mesh", MESHES)
def test_meshes_and_places(four_ranks, mesh):
    """bist_tpu's `np.reshape(devices, (dp, tp, sp))` order: rank r at data
    r // (tp·sp), model (r // sp) % tp, seq r % sp; a 'model' axis of 1
    dropped."""
    dp_, tp_, sp_ = {"2x2": (2, 1, 2), "1x4": (1, 1, 4), "1x2x2": (1, 2, 2)}[mesh]
    ranks = np.arange(4).reshape(dp_, tp_, sp_)
    want_names = ("data", "model", "seq") if tp_ > 1 else ("data", "seq")
    want_mesh = (ranks if tp_ > 1 else ranks[:, 0]).tolist()
    for r, got in enumerate(four_ranks["ranks"]):
        g = got[mesh]
        assert g["mesh"] == (want_mesh, want_names)
        coords = (r // (tp_ * sp_), (r // sp_) % tp_, r % sp_)
        assert g["coords"] == (coords if tp_ > 1 else (coords[0], coords[2]))
        assert g["data"] == (coords[0], dp_) and g["seq"] == (coords[2], sp_)
        if tp_ > 1:
            assert g["model"] == (coords[1], tp_)


def test_make_mesh_refuses_a_seq_axis_that_does_not_divide(four_ranks):
    for got in four_ranks["ranks"]:
        assert got["bad_axis"] == "a seq axis of 3 does not divide the 4 processes of the group"


@pytest.mark.parametrize("mesh", MESHES)
def test_sp_step_matches_bist_tpu(four_ranks, mesh):
    """Loss at abs 2e-5 and every (gathered) gradient leaf at rtol 1e-3,
    atol 1e-5 of `bist_tpu`'s one-device step, on every rank; the token
    count is the global batch's."""
    for got in four_ranks["ranks"]:
        _assert_matches(got[mesh]["accum1"], four_ranks["refs"]["float"])
        assert int(got[mesh]["accum1"]["ntokens"]) == int(np.sum(jax_batch().trg_y != PAD))


@pytest.mark.parametrize("case", ["accum2", "int8"])
def test_sp_step_cases_match_bist_tpu(four_ranks, case):
    """On the 2 × 2 mesh: grad_accum 2 against the float batch's oracle,
    and the int8 batch (dequantised on each rank's T block, the spatial
    mask's |max| combined over the seq axis) against bist_tpu on it."""
    ref = four_ranks["refs"]["float" if case == "accum2" else "int8"]
    for got in four_ranks["ranks"]:
        _assert_matches(got["2x2"][case], ref)


def test_sp_step_with_audio_matches_bist_tpu(four_ranks):
    """On the 1 × 4 mesh, a model with audio context layers and the history
    as a pointer source, on a batch with padded audio frames and history:
    the gathered audio memory, audio mask, history ids and encodings."""
    for got in four_ranks["ranks"]:
        _assert_matches(got["1x4"]["audio"], four_ranks["refs"]["audio"])


def test_adam_step_keeps_every_rank_identical(four_ranks):
    """One Adam step on the 2 × 2 mesh: the parameters of all four ranks
    bit-identical after it (the gradients summed over data × seq), the
    collectives counted."""
    for got in four_ranks["ranks"]:
        a = got["2x2"]["adam"]
        assert np.isfinite(float(a["loss"])) and a["step"] == 1
        assert a["all_ranks_identical"]
        assert a["counts"]["all_gathers"] > 0 and a["counts"]["all_reduces"] > 0
        assert a["counts"]["bytes"] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_beam_tokens_match_one_device(setup, four_ranks, mesh):
    """Beam 2, maxlen 4, nbest 2 on each rank's rows and block: the tokens
    of `bist_tpu`'s beam search and of the port's one-device one."""
    params, batch = setup[2], as_torch(setup[3])
    want = beam_search(params, ModelConfig(**MODEL), batch, GenerateConfig(**GEN)).tokens
    np.testing.assert_array_equal(want.numpy(), four_ranks["ref_beam"])
    for got in four_ranks["ranks"]:
        d, n = got[mesh]["data"]
        k = B // n
        assert torch.equal(got[mesh]["beam"], want[d * k:(d + 1) * k])


def test_dropout_masks_are_one_process_masks_sliced(setup, four_ranks, monkeypatch):
    """At dropout 0.1 (both rates) on the 1 × 4 mesh: each rank drew its
    masks in a one-process run's order, each the one-process mask (sliced
    to the rank's block where the activation is seq-sharded: the history's
    embedding, s2t hop 1), and the loss and gradients are the one-process
    step's at the same seed."""
    cfg = ModelConfig(**dict(MODEL, dropout=0.1, attn_dropout=0.1))
    one, draw = [], layers.dropout_mask

    def recording(shape, rate, rngs, shard_dim=None, seq_dim=None):
        mask = draw(shape, rate, rngs, shard_dim, seq_dim)
        one.append(mask.clone())
        return mask

    monkeypatch.setattr(layers, "dropout_mask", recording)
    gen = dropout_generator(cfg, "cpu")
    gen.manual_seed(seed_for_step(DROPOUT_SEED, 0))
    loss, _, grads = make_grad_step(cfg, TrainConfig(warmup_steps=50))(
        trainable(setup[2]), as_torch(setup[3]), gen)
    clean = float(four_ranks["ranks"][0]["1x4"]["accum1"]["loss"])
    assert abs(float(loss) - clean) > 1e-3          # the masks changed the loss
    for got in four_ranks["ranks"]:
        g = got["1x4"]["dropout"]
        r = got["1x4"]["seq"][0]
        assert len(g["masks"]) == len(one)
        sharded = 0
        for (mask, seq_dim), full in zip(g["masks"], one):
            if seq_dim is not None:
                full = full.chunk(4, seq_dim)[r]
                sharded += 1
            assert torch.equal(mask, full)
        assert sharded > 0
        np.testing.assert_allclose(float(g["loss"]), float(loss), rtol=1e-5)
        for a, b in zip(tree_leaves(g["grads"]), grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)
