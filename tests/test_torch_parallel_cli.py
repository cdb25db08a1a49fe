"""The port's data-parallel entry points on the CPU, where N devices are N
replicas on the one CPU: the train CLI at --num-devices 2 (two gloo ranks)
against --num-devices 1; the Responder over [cpu] * 4 against one device
(at the flagship geometry) and against `bist_tpu`'s dp-4 Responder (tiny
width); a dp 2 bundle written by `serve --export-dp 2` against
`bist_tpu`'s dp 2 bundle and served against a dp 1 bundle; the generate CLI
at --num-devices 2 against one device and `bist_tpu`'s CLI over the CPU
mesh; and the extract CLI at --dp 2 against --dp 1 and `bist_tpu`'s --dp 2."""

import json
import os
import threading
import types

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from bist_tpu import export as jax_export
from bist_tpu import serving as jax_serving
from bist_tpu.cli import extract_features as jax_extract
from bist_tpu.cli import generate as jax_generate
from bist_tpu.config import GenerateConfig as JaxGenerateConfig
from bist_tpu.config import ModelConfig as JaxModelConfig
from bist_tpu.models.model import init_model as jax_init_model
from bist_tpu.train import checkpoint as jax_checkpoint
from bist_tpu_torch import export
from bist_tpu_torch.cli import extract_features, generate, serve, train
from bist_tpu_torch.config import GenerateConfig, ModelConfig, TrainConfig, load_conf, save_conf
from bist_tpu_torch.models import backbones3d as zoo
from bist_tpu_torch.models.model import init_model
from bist_tpu_torch.serving import DynamicBatcher, Responder
from bist_tpu_torch.train.checkpoint import restore_train_state
from bist_tpu_torch.train.loop import create_train_state
from bist_tpu_torch.vocab import SPECIALS
from bist_tpu_torch.weights import load_params, params_from_jax, params_to_jax, save_params
from torch_port_common import zoo_state_dict

CPU = torch.device("cpu")
TINY = dict(d_model=32, att_h=4, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2)
WORDS = "a the man is walking sitting what doing he yes no couch dog cat room"
SERVE_MODEL = dict(nb_blocks=1, nb_venc_blocks=1, nb_cenc_blocks=1, d_model=16, att_h=2,
                   dropout=0.0, include_caption="summary", separate_caption=True,
                   ft_sizes=(8,))


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_vocab():
    vocab = dict(SPECIALS)
    for w in WORDS.split():
        vocab[w] = len(vocab)
    return vocab


def request_fields(n, seed=0, T=8, S=4, D=8):
    rng = np.random.default_rng(seed)
    words = WORDS.split()
    return [dict(question=" ".join(rng.choice(words, 3 + i % 3)),
                 history=" ".join(rng.choice(words, 5 + 2 * i)),
                 caption=" ".join(rng.choice(words, 2 + i % 2)),
                 features=rng.standard_normal((T - i % 3, S, D)).astype(np.float32))
            for i in range(n)]


def answers(rsp, fields):
    reqs = [rsp.make_request(**f) for f in fields]
    rsp.respond(reqs)
    return [(r._answer, r._nbest) for r in reqs]


def same_answers(got, want):
    """The same answers and n-best words; the scores to 1e-5 (the CPU's
    matrix products of one row and of four may round apart)."""
    assert [a for a, _ in got] == [a for a, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert [x for x, _ in g] == [x for x, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# training


def read_trace(model):
    with open(model + "_trace.csv") as f:
        return [ln.split(",") for ln in f.read().splitlines()[1:]]


def test_train_cli_two_ranks_match_one(tmp_path):
    """--num-devices 2 on the CPU (two gloo ranks) against --num-devices 1:
    the same epoch losses within 1e-5; rank 0 alone writes one checkpoint
    and one set of CSV logs, and the checkpoint loads; --resume on both
    ranks continues from it."""
    root = str(tmp_path / "tiny")
    test_set = chip_smoke.write_tiny_dataset(root, 4, TINY, dv=24, s=4, t_max=9)
    base = ["--fea-type", "resnext_st", "--train-path",
            os.path.join(root, "<FeaType>", "<ImageID>.npy"), "--train-set", test_set,
            "--valid-set", test_set, "--batch-size", "4", "--nb-blocks", "2",
            "--nb-venc-blocks", "2", "--nb-cenc-blocks", "2", "--d-model", "32",
            "--att-h", "4", "--include-caption", "summary", "--dropout", "0",
            "--attn-dropout", "0", "--cutoff", "0", "--warmup-steps", "10",
            "--report-interval", "1", "--device", "cpu"]
    one, two = (os.path.join(root, f"exp{n}", "mtn") for n in (1, 2))
    assert train.main(base + ["--model", one, "--num-epochs", "1"]) is not None
    assert train.main(base + ["--model", two, "--num-epochs", "1", "--num-devices", "2"]) \
        is None
    a, b = read_trace(one), read_trace(two)
    assert [r[:2] for r in a] == [r[:2] for r in b] == [["1", "train"], ["1", "val"]]
    np.testing.assert_allclose(np.array([r[2:] for r in b], float),
                               np.array([r[2:] for r in a], float), rtol=1e-5)
    with open(one + "_train.csv") as f1, open(two + "_train.csv") as f2:
        steps1, steps2 = f1.read().splitlines(), f2.read().splitlines()
    assert len(steps1) == len(steps2) > 1       # one writer: no row twice
    assert sorted(os.listdir(os.path.dirname(two))) == [
        "mtn.conf", "mtn_best.pt", "mtn_params.txt", "mtn_trace.csv", "mtn_train.csv"]
    _, cfg, _, _ = load_conf(two + ".conf")
    template, _ = create_train_state(0, cfg, TrainConfig(), device=CPU)
    state, meta = restore_train_state(two + "_best.pt", template)
    assert state.step > 0 and meta["epoch"] == 0
    # every rank resumes from the one checkpoint and trains epoch 2
    train.main(base + ["--model", two, "--num-epochs", "2", "--num-devices", "2",
                       "--resume", "auto"])
    assert [r[:2] for r in read_trace(two)] == [["1", "train"], ["1", "val"],
                                               ["2", "train"], ["2", "val"]]


# ---------------------------------------------------------------------------
# serving


def test_responder_over_four_cpu_replicas_flagship_geometry():
    """The Responder over [cpu] * 4 at the flagship geometry (d_model 128, 8
    heads, 3/3/3 blocks, (16, 2048) grids; tests/test_serving.py's
    multi-device case), fed through the DynamicBatcher: the answers and
    n-best lists of the one-device Responder."""
    vocab = make_vocab()
    cfg = chip_smoke.flagship_cfg(len(vocab), dv=2048)
    params = init_model(0, cfg, device=CPU)
    gcfg = GenerateConfig(maxlen=4, beam=5, penalty=1.0, nbest=2)
    kw = dict(max_batch=4, len_buckets={"q": (16,), "h": (64,), "c": (16,)},
              time_buckets=(16,))
    one = Responder(params, cfg, vocab, gcfg, **kw)
    four = Responder(params, cfg, vocab, gcfg, devices=[CPU] * 4, **kw)
    assert one.decoder.n == 1 and four.decoder.n == 4 and len(four.decoder.programs) == 4
    fields = request_fields(4, seed=1, T=16, S=16, D=2048)
    for f in fields:
        f["history"] = "a man is walking"
    want = answers(one, fields)
    server = DynamicBatcher(four, max_batch=4, max_wait_ms=50)
    server.start()
    try:
        got = {}

        def ask(i):
            got[i] = server.submit(**fields[i], timeout=600.0)

        ts = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        server.stop()
    assert [got[i] for i in range(4)] == [w[0] for w in want]
    same_answers(answers(four, fields), want)
    stats = four.stats()
    assert stats["devices"] == 4 and stats["geometries"] >= 4


@pytest.mark.parametrize("style", ["beam_search", "greedy"])
def test_responder_dp4_matches_bist_tpu_dp4(style):
    """At a tiny width, the port's Responder over [cpu] * 4 answers as
    `bist_tpu`'s Responder sharded over 4 devices of the CPU mesh does (the
    same words; scores to 1e-4)."""
    vocab = make_vocab()
    jcfg = JaxModelConfig(vocab_size=len(vocab), **SERVE_MODEL)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), CPU)
    kw = dict(maxlen=5, beam=3, penalty=1.0, nbest=3, decode_style=style)
    bkw = dict(max_batch=4, len_buckets=(8, 16), time_buckets=(8,))
    jr = jax_serving.Responder(jp, jcfg, vocab, JaxGenerateConfig(**kw), **bkw)
    assert jr._dp.n == 4
    tr = Responder(tp, ModelConfig(vocab_size=len(vocab), **SERVE_MODEL), vocab,
                   GenerateConfig(**kw), devices=[CPU] * 4, **bkw)
    fields = request_fields(4)
    jreqs = [jax_serving.Request(question=jr.tokenize(f["question"]),
                                 history=jr.tokenize(f["history"]),
                                 caption=jr.tokenize(f["caption"]),
                                 features=f["features"]) for f in fields]
    jr.respond(jreqs)
    got = answers(tr, fields)
    for a, (answer, nbest) in zip(jreqs, got):
        assert answer == a._answer
        assert [w for w, _ in nbest] == [w for w, _ in a._nbest]
        np.testing.assert_allclose([s for _, s in nbest], [s for _, s in a._nbest], atol=1e-4)


def test_dp2_bundle_against_bist_tpu_and_dp1(tmp_path):
    """`serve --export-dp 2` writes a dp 2 bundle with `bist_tpu`'s geometry
    keys, "dp" and params.npz keys; served over two CPU replicas it answers
    as a dp 1 bundle of the same model does."""
    vocab = make_vocab()
    cfg = ModelConfig(vocab_size=len(vocab), **SERVE_MODEL)
    jcfg = JaxModelConfig(vocab_size=len(vocab), **SERVE_MODEL)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), CPU)
    prefix = str(tmp_path / "mtn")
    save_conf(prefix + ".conf", vocab, cfg, TrainConfig())
    save_params(prefix + ".pt", params)
    dp2 = str(tmp_path / "dp2")
    serve.main(["--model", prefix, "--export-bundle", dp2, "--export-dp", "2",
                "--max-batch", "4", "--export-lq", "8", "--export-lh", "16", "--export-lc",
                "8", "--export-t", "8", "--feat-s", "4", "--decode-style", "greedy",
                "--maxlen", "4", "--cache-dtype", "float32", "--device", "cpu"])
    with open(os.path.join(dp2, "bundle.json")) as f:
        meta = json.load(f)
    assert meta["dp"] == 2
    geoms = list(meta["geometries"].values())
    assert [g["B"] for g in geoms] == [4]

    jdir = str(tmp_path / "jax_dp2")
    jax_export.save_bundle(jdir, jp, jcfg, JaxGenerateConfig(
        maxlen=4, decode_style="greedy"), vocab, geoms, dp=2)
    with open(os.path.join(jdir, "bundle.json")) as f:
        jmeta = json.load(f)
    assert jmeta["dp"] == meta["dp"] and set(jmeta["geometries"]) == set(meta["geometries"])
    assert jmeta["geometries"] == meta["geometries"]
    with np.load(os.path.join(jdir, "params.npz")) as a, \
            np.load(os.path.join(dp2, "params.npz")) as b:
        assert sorted(a.files) == sorted(b.files)

    bundle2 = export.load_bundle(dp2, "cpu")
    dp1 = str(tmp_path / "dp1")
    export.save_bundle(dp1, params, cfg, bundle2.gcfg, vocab, geoms, dp=1)
    bundle1 = export.load_bundle(dp1, "cpu")
    r2, r1 = bundle2.make_responder(), bundle1.make_responder()
    assert r2.decoder.n == 2 and r1.decoder.n == 1
    r2.warmup_geometries(bundle2.geometries.values())
    fields = request_fields(4, seed=3)
    same_answers(answers(r2, fields), answers(r1, fields))
    with pytest.raises(ValueError, match="exported data-parallel over 2"):
        bundle2.make_responder(devices=["cpu"] * 3)


# ---------------------------------------------------------------------------
# generation and extraction


@pytest.mark.parametrize("style", ["beam_search", "sample"])
def test_generate_cli_two_devices_match_one(tmp_path, style):
    """The generate CLI with each batch's rows split over two CPU replicas
    (the tail batch padded to 2 rows) writes the one-device result; at beam
    search, the answers of `bist_tpu`'s CLI over the 8-device CPU mesh (its
    tail batches padded to 8 rows) on the same checkpoint.  Sampling draws
    from another generator than `bist_tpu`'s, so it is held to one device."""
    root = str(tmp_path / "gen")
    test_set = chip_smoke.write_tiny_dataset(root, 3, TINY, dv=24, s=4, t_max=9)
    args = ["--test-set", test_set, "--test-path",
            os.path.join(root, "<FeaType>", "<ImageID>.npy"), "--model",
            os.path.join(root, "mtn"), "--decode-style", style, "--beam", "3",
            "--maxlen", "6", "--undisclosed-only", "1", "--gen-batch-size", "2",
            "--device", "cpu"]
    results = []
    for n in (1, 2):
        out = os.path.join(root, f"result{n}.json")
        generate.main(args + ["--num-devices", str(n), "--output", out])
        with open(out) as f:
            results.append(json.load(f))
    assert results[0] == results[1]
    turns = [t for d in results[1]["dialogs"] for t in d["dialog"]]
    assert len(turns) == 3 and all(isinstance(t["answer"], str) for t in turns)
    if style != "beam_search":
        return
    params = load_params(os.path.join(root, "mtn.pt"), CPU)
    jax_checkpoint.save_checkpoint(os.path.join(root, "mtn"), types.SimpleNamespace(
        params=params_to_jax(params), opt_state={}, step=0))
    assert jax.device_count() == 8
    out = os.path.join(root, "result_bist_tpu.json")
    jax_generate.main(args + ["--output", out])
    with open(out) as f:
        want = [t["answer"] for d in json.load(f)["dialogs"] for t in d["dialog"]]
    assert [t["answer"] for t in turns] == want


def test_extract_cli_dp2_matches_dp1(tmp_path):
    """The conv stage over two CPU replicas (--dp 2: each takes 2 of a
    batch's 4 clips) writes the features of --dp 1, bit for bit, and those
    of `bist_tpu`'s CLI at --dp 2 on the CPU mesh to 1e-5 of max |f|
    (float32, two summation orders)."""
    rng = np.random.default_rng(0)
    (tmp_path / "videos").mkdir()
    for vid, n in (("a", 24), ("b", 16)):
        np.save(tmp_path / "videos" / f"{vid}.npy",
                rng.integers(0, 256, (n, 112, 112, 3), dtype=np.uint8))
    arch, shapes = zoo.init_backbone(torch.Generator().manual_seed(0), "resnet", 10)
    torch.save({"arch": "resnet-10",
                "state_dict": zoo_state_dict("resnet", arch, shapes, seed=1)},
               tmp_path / "resnet-10.pth")
    outs = {}
    for name, dp, main, extra in (("1", "1", extract_features.main, ["--device", "cpu"]),
                                  ("2", "2", extract_features.main, ["--device", "cpu"]),
                                  ("bist_tpu", "2", jax_extract.main, [])):
        out = tmp_path / f"dp{name}"
        main(["--video_root", str(tmp_path / "videos"), "--output", str(out),
              "--stride", "8", "--batch_size", "4", "--model_name", "resnet",
              "--model_depth", "10", "--model", str(tmp_path / "resnet-10.pth"), "--dp", dp]
             + extra)
        outs[name] = {v: np.load(out / f"{v}.npy") for v in ("a", "b")}
    for v in ("a", "b"):
        assert outs["1"][v].shape[0] == {"a": 3, "b": 2}[v]     # 5 clips: 2 batches
        np.testing.assert_array_equal(outs["2"][v], outs["1"][v])
        want = outs["bist_tpu"][v]
        assert outs["2"][v].shape == want.shape
        assert np.abs(outs["2"][v] - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.slow
def test_chip_smoke_phase_data_parallel_on_cpu(tmp_path):
    """chip_smoke.py's phase 14 on the CPU: the flagship's train program on
    a one-rank gloo group (nothing captured) at batches of 4, two gloo
    ranks, and the Responder and the serve CLI's dp 2 bundle on two CPU
    replicas of a tiny model (~3 min)."""
    cli_root = str(tmp_path / "cli")
    chip_smoke.write_tiny_dataset(cli_root, 4, TINY, dv=24, s=4, t_max=9)
    model = chip_smoke.serving_model(CPU, model_kw=TINY, dv=24)
    fields = chip_smoke.serving_requests(16, dv=24, s=4, t_max=9)
    out = chip_smoke.phase_data_parallel(CPU, str(tmp_path / "dp"), model, fields, cli_root,
                                         B=4, group=4, dv=24, s=4, t_max=9)
    assert out["world_one"]["calls_bit_identical"] == 5
    assert out["two_ranks"]["params_bit_identical"] and out["two_ranks"]["rows_each"] == [2, 2]
    assert out["serving"]["responder"]["identical"] == 16
    assert out["serving"]["bundle"]["identical"] == 16 and out["serving"]["bundle"]["dp"] == 2
