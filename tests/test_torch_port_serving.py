"""The port's serving runtime (`bist_tpu_torch.serving`, `cli.serve`) on the
CPU: held against `bist_tpu.serving` with the same parameters, vocabulary,
requests and buckets (the tiny model of tests/test_serving.py), and the
contracts of tests/test_serving.py within the port."""

import base64
import io
import json
import sys
import threading
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from bist_tpu import serving as jax_serving
from bist_tpu.config import GenerateConfig as JaxGenerateConfig
from bist_tpu.config import ModelConfig as JaxModelConfig
from bist_tpu.models.model import init_model as jax_init_model
from bist_tpu_torch import serving
from bist_tpu_torch.cli import serve
from bist_tpu_torch.config import GenerateConfig, ModelConfig
from bist_tpu_torch.data.batching import quantize_features
from bist_tpu_torch.decode.beam import greedy_decode
from bist_tpu_torch.models.model import init_model
from bist_tpu_torch.serving import DynamicBatcher, Request, Responder
from bist_tpu_torch.vocab import EOS, SOS, SPECIALS, ids2words, make_id2word
from bist_tpu_torch.weights import params_from_jax
from torch_threads import two_threads  # noqa: F401 (autouse)

WORDS = "a the man is walking sitting what doing he yes no couch dog cat room"
MODEL = dict(nb_blocks=1, nb_venc_blocks=1, nb_cenc_blocks=1, d_model=16, att_h=2,
             dropout=0.0, include_caption="summary", separate_caption=True,
             ft_sizes=(8,))
CPU = torch.device("cpu")


def make_vocab(words=WORDS):
    vocab = dict(SPECIALS)
    for w in words.split():
        vocab[w] = len(vocab)
    return vocab


def model(**kw):
    """The port's parameters (seed 0) and configuration of the tiny model."""
    cfg = ModelConfig(vocab_size=len(make_vocab()), **dict(MODEL, **kw))
    return init_model(0, cfg, device=CPU), cfg


def features(rng, T=5, S=4, D=8):
    return rng.standard_normal((T, S, D)).astype(np.float32)


@pytest.fixture(scope="module")
def served():
    params, cfg = model()
    responder = Responder(params, cfg, make_vocab(), GenerateConfig(
        maxlen=4, beam=2, penalty=1.0, nbest=2), max_batch=4,
        len_buckets=(8, 16), time_buckets=(8,))
    responder.warmup(feature_shape=(4, 8), t_clips=8)
    server = DynamicBatcher(responder, max_batch=4, max_wait_ms=20)
    server.start()
    yield server
    server.stop()


# ---------------------------------------------------------------------------
# against bist_tpu.serving


@pytest.fixture(scope="module")
def both():
    """The tiny model's JAX parameters and the same values in the port."""
    vocab = make_vocab()
    jcfg = JaxModelConfig(vocab_size=len(vocab), **MODEL)
    tcfg = ModelConfig(vocab_size=len(vocab), **MODEL)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), CPU)
    return vocab, jcfg, jp, tcfg, tp


def request_fields(seed=0, n=3):
    """Client fields of n requests of different lengths and clip counts."""
    rng = np.random.default_rng(seed)
    words = WORDS.split()
    out = []
    for i in range(n):
        out.append(dict(question=" ".join(rng.choice(words, 3 + i)),
                        history=" ".join(rng.choice(words, 5 + 4 * i)),
                        caption=" ".join(rng.choice(words, 2 + i)),
                        features=features(rng, T=3 + 2 * i)))
    return out


def jax_request(rsp, f):
    return jax_serving.Request(
        question=rsp.tokenize(f["question"]), history=rsp.tokenize(f["history"]),
        caption=rsp.tokenize(f["caption"]), features=f["features"])


@pytest.mark.parametrize("style", ["beam_search", "greedy"])
def test_answers_and_nbest_match_bist_tpu(both, style):
    """The same requests through both Responders at a float32 cache: the
    same answers and n-best words (scores to 1e-4: two frameworks' float32
    sums), and the port's request fields equal to bist_tpu's."""
    vocab, jcfg, jp, tcfg, tp = both
    kw = dict(maxlen=5, beam=3, penalty=1.0, nbest=3, decode_style=style)
    jr = jax_serving.Responder(jp, jcfg, vocab, JaxGenerateConfig(**kw), max_batch=4,
                               len_buckets=(8, 16), time_buckets=(8,))
    tr = Responder(tp, tcfg, vocab, GenerateConfig(**kw), max_batch=4,
                   len_buckets=(8, 16), time_buckets=(8,))
    fields = request_fields()
    jreqs = [jax_request(jr, f) for f in fields]
    treqs = [tr.make_request(**f) for f in fields]
    for a, b in zip(jreqs, treqs):
        for name in ("question", "history", "caption", "features"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    jr.respond(jreqs)
    tr.respond(treqs)
    for a, b in zip(jreqs, treqs):
        assert b._answer == a._answer
        assert [w for w, _ in b._nbest] == [w for w, _ in a._nbest]
        np.testing.assert_allclose([s for _, s in b._nbest], [s for _, s in a._nbest],
                                   atol=1e-4)


@pytest.mark.parametrize("feat_int8", [False, True])
def test_make_batch_matches_bist_tpu(both, feat_int8):
    vocab, jcfg, jp, tcfg, tp = both
    kw = dict(max_batch=8, batch_buckets=(2, 8), len_buckets={"q": (4, 8), "h": (16,),
                                                              "c": (8,)},
              time_buckets=(4, 8), feat_int8=feat_int8)
    jr = jax_serving.Responder(jp, jcfg, vocab, JaxGenerateConfig(), **kw)
    tr = Responder(tp, tcfg, vocab, GenerateConfig(), **kw)
    fields = request_fields(seed=1)
    jb = jr.make_batch([jax_request(jr, f) for f in fields])
    tb = tr.make_batch([tr.make_request(**f) for f in fields])
    assert tb.query.shape == (8, 8) and tb.fts.shape[:2] == (8, 8)
    for name in jb._fields:
        a, b = getattr(jb, name), getattr(tb, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.dtype == np.asarray(a).dtype, name
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)


def test_metrics_keys_match_bist_tpu(both):
    vocab, jcfg, jp, tcfg, tp = both
    jm = jax_serving.DynamicBatcher(jax_serving.Responder(
        jp, jcfg, vocab, JaxGenerateConfig(), max_batch=4)).metrics()
    tm = DynamicBatcher(Responder(tp, tcfg, vocab, GenerateConfig(),
                                  max_batch=4)).metrics()
    assert set(tm) == set(jm)
    for key in ("latency_ms", "component_seconds"):
        assert set(tm[key]) == set(jm[key]), key
    assert serving.default_batch_buckets(64) == jax_serving.default_batch_buckets(64)
    assert serving.DEFAULT_LEN_BUCKETS == jax_serving.DEFAULT_LEN_BUCKETS
    assert serving.DEFAULT_TIME_BUCKETS == jax_serving.DEFAULT_TIME_BUCKETS


MALFORMED = [
    ("no features", "beam_search", None, dict()),
    ("features of rank 2", "beam_search", None, dict(features=np.zeros((4, 8), np.float32))),
    ("another grid than the pinned one", "beam_search", (4, 8),
     dict(features=np.zeros((4, 5, 8), np.float32))),
    ("another feature dim", "beam_search", None, dict(features=np.zeros((4, 4, 9), np.float32))),
    ("a seed on a beam search server", "beam_search", None,
     dict(features=np.zeros((4, 4, 8), np.float32), seed=42)),
] + [(f"seed {bad!r}", "sample", None, dict(features=np.zeros((4, 4, 8), np.float32), seed=bad))
     for bad in ("abc", 2 ** 40, -3, 1.5, True)]


@pytest.mark.parametrize("what,style,tail,kw", MALFORMED, ids=[m[0] for m in MALFORMED])
def test_submit_rejects_what_bist_tpu_rejects(both, what, style, tail, kw):
    """Malformed requests raise ValueError in submit() in both packages,
    before anything is queued (neither batcher is started)."""
    vocab, jcfg, jp, tcfg, tp = both
    for pkg, params, cfg, gcfg in ((jax_serving, jp, jcfg, JaxGenerateConfig),
                                   (serving, tp, tcfg, GenerateConfig)):
        rsp = pkg.Responder(params, cfg, vocab, gcfg(decode_style=style), max_batch=4,
                            feat_tail=tail)
        with pytest.raises(ValueError):
            pkg.DynamicBatcher(rsp, max_batch=4).submit("what", **kw)


def test_audio_submit_checks_match_bist_tpu():
    """An audio-visual model: a malformed audio grid is rejected at submit()
    in both packages."""
    vocab = make_vocab("what")
    kw = dict(vocab_size=len(vocab), nb_blocks=1, nb_venc_blocks=1, nb_cenc_blocks=0,
              nb_aenc_blocks=1, d_model=16, att_h=2, dropout=0.0,
              include_caption="none", separate_caption=False, ft_sizes=(8, 4))
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), CPU)
    fts = np.zeros((4, 4, 8), np.float32)
    for pkg, params, cfg, gcfg in ((jax_serving, jp, jcfg, JaxGenerateConfig),
                                   (serving, tp, tcfg, GenerateConfig)):
        server = pkg.DynamicBatcher(pkg.Responder(params, cfg, vocab, gcfg(maxlen=2),
                                                  max_batch=2, time_buckets=(4,)),
                                    max_batch=2)
        for audio, match in ((None, "requires audio"),
                             (np.zeros((4,), np.float32), "audio must be"),
                             (np.zeros((4, 99), np.float32), "audio dim")):
            with pytest.raises(ValueError, match=match):
                server.submit("what", features=fts, audio=audio)


# ---------------------------------------------------------------------------
# the contracts of tests/test_serving.py within the port


def test_concurrent_requests_are_coalesced(served, rng):
    answers, errs = {}, []
    batches0 = served.stats["batches"]
    fts = [features(rng, T=4 + i % 3) for i in range(8)]
    go = threading.Barrier(8)

    def worker(i):
        try:
            go.wait(timeout=30)
            answers[i] = served.submit("what is he doing", history="a man is walking",
                                       caption="the dog", features=fts[i])
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs and len(answers) == 8
    assert served.stats["batches"] - batches0 < 8


def post(base, path, obj):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.load(r)


def npy_b64(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return base64.b64encode(buf.getvalue()).decode()


class Http:
    """make_http_server over a batcher, serving on a free port in a thread."""

    def __init__(self, batcher, requires_features=True):
        self.httpd = serve.make_http_server("127.0.0.1", 0, batcher,
                                            requires_features=requires_features)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self.base

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


def test_http_round_trip(served, rng):
    """healthz; /respond with nested lists, base64 .npy and an int8 upload
    with its scale; 400 without features, without 'question' and for an
    int8 upload without its scale; 404 on another path; /metrics."""
    fts = features(rng)
    with Http(served) as base:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.load(r)
        assert health["ok"] is True and "batches" in health["stats"]
        code, resp = post(base, "/respond", {
            "question": "what is he doing", "history": "a man is walking",
            "caption": "the man", "features": fts.tolist()})
        assert code == 200 and isinstance(resp["answer"], str) and resp["latency_ms"] > 0
        listed = resp["answer"]
        code, resp = post(base, "/respond", {
            "question": "what is he doing", "history": "a man is walking",
            "caption": "the man", "features_b64": npy_b64(fts)})
        assert code == 200 and resp["answer"] == listed
        q8, scale = quantize_features(fts[None])
        code, resp = post(base, "/respond", {
            "question": "what is he doing", "features_b64": npy_b64(q8[0]),
            "features_scale_b64": npy_b64(scale[0])})
        assert code == 200 and isinstance(resp["answer"], str)
        for body in ({"question": "no features"},
                     {"features": fts.tolist()},
                     {"question": "what", "features_b64": npy_b64(q8[0])}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(base, "/respond", body)
            assert ei.value.code == 400, body
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(base, "/nope", {})
        assert ei.value.code == 404
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            remote = json.load(r)
        assert remote["latency_ms"]["count"] == served.metrics()["latency_ms"]["count"]
        assert remote["requests"] >= 3


def test_pipelined_batcher_under_backlog(served):
    """pipeline_depth 2 with batches of 2: every request completes with the
    answer a direct respond() of the same row gives."""
    responder = served.responder
    pipelined = DynamicBatcher(responder, max_batch=2, max_wait_ms=5, pipeline_depth=2)
    pipelined.start()
    try:
        answers, errs = {}, []

        def worker(i):
            try:
                answers[i] = pipelined.submit(
                    "what is he doing", history="a man is walking", caption="the dog",
                    features=np.zeros((4, 4, 8), np.float32) + i % 3)
            except Exception as e:  # pragma: no cover - reported below
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs and len(answers) == 10
        assert pipelined.stats["batches"] >= 5 and pipelined.stats["errors"] == 0
        for k in range(3):
            req = responder.make_request("what is he doing", "a man is walking", "the dog",
                                         np.zeros((4, 4, 8), np.float32) + k)
            responder.respond([req])
            assert all(answers[i] == req._answer for i in range(k, 10, 3))
    finally:
        pipelined.stop()


def test_batch_error_propagates_and_thread_survives(served, rng):
    with pytest.raises(ValueError, match="requires video features"):
        served.submit("what is he doing", features=None)
    with pytest.raises(ValueError, match=r"\(T, S, Dv\)"):
        served.submit("what is he doing", features=np.zeros((4, 8), np.float32))
    # a Request that breaks make_batch in the batcher thread (put directly,
    # past submit's checks)
    errors0 = served.stats["errors"]
    bad = Request(question=served.responder.tokenize("what"),
                  history=np.array([0], np.int32), caption=None,
                  features=np.zeros((4, 4), np.float32))
    served._q.put(bad)
    assert bad._event.wait(60)
    assert bad._error is not None and served.stats["errors"] > errors0
    ans = served.submit("what is he doing", history="a man is walking",
                        caption="the dog", features=features(rng))
    assert isinstance(ans, str)


def test_error_rate_counts_requests_not_batches():
    stub = types.SimpleNamespace(max_batch=4, timings={})
    b = DynamicBatcher(stub, max_batch=4)
    b.stats.update(requests=8, batches=2)
    reqs = [Request(question=np.zeros(1, np.int32), history=np.zeros(1, np.int32),
                    caption=None, features=None) for _ in range(4)]
    b._fail(reqs, RuntimeError("boom"))
    assert b.stats["errors"] == 4 and b.metrics()["error_rate"] == 0.5
    assert all(r._event.is_set() and r._error is not None for r in reqs)


def test_latency_reservoir_under_contention():
    """16 threads record latencies while the interpreter switches threads
    every microsecond: the reservoir holds exactly what one thread recording
    all of them in turn would (no lost or doubled trim)."""
    stub = types.SimpleNamespace(max_batch=4, timings={})
    b = DynamicBatcher(stub, max_batch=4)
    b._lat_cap = 64
    n_threads, per_thread = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [b._record_latency(0.001)
                                                    for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    want = 0
    for _ in range(n_threads * per_thread):
        if want >= 64:
            want -= 32
        want += 1
    assert len(b._lat) == want
    assert b.metrics()["latency_ms"]["count"] == want


def test_clamp_preserves_boundary_tokens():
    ids = np.array([SOS, 5, 6, 7, 8, 9, EOS], np.int32)
    h = serving._clamp_head(ids, 4)
    assert len(h) == 4 and list(h[:3]) == [SOS, 5, 6] and h[-1] == EOS
    t = serving._clamp_tail(ids, 4)
    assert t[0] == SOS and list(t[1:]) == [8, 9, EOS]
    assert serving._clamp_head(ids, 7) is ids and serving._clamp_tail(ids, 8) is ids
    for f in ("_clamp_head", "_clamp_tail"):
        np.testing.assert_array_equal(getattr(serving, f)(ids, 4),
                                      getattr(jax_serving, f)(ids, 4))


def test_seed_rejected_on_deterministic_server(served, rng):
    with pytest.raises(ValueError, match="only meaningful"):
        served.submit("what is he doing", features=features(rng), seed=42)


def test_sampling_reproducible_per_seed_and_batch_invariant():
    """The same (sample_seed, seed) gives the same answer alone and
    coalesced with other requests; unseeded requests draw the server's own
    streams; malformed seeds fail at submit() and leave the server well."""
    params, cfg = model()
    gcfg = GenerateConfig(maxlen=6, decode_style="sample", temperature=2.0, sample_seed=7)
    responder = Responder(params, cfg, make_vocab(), gcfg, max_batch=4,
                          len_buckets=(8, 16), time_buckets=(8,))
    server = DynamicBatcher(responder, max_batch=4, max_wait_ms=50)
    server.start()
    try:
        fts = features(np.random.default_rng(0), T=8)
        ask = lambda seed: server.submit("what is he doing", history="a man is walking",
                                         caption="the man", features=fts, seed=seed,
                                         timeout=120)
        alone = ask(42)
        answers = {}
        go = threading.Barrier(4)

        def work(i, seed):
            go.wait(timeout=30)
            answers[i] = ask(seed)

        batches0 = server.stats["batches"]
        ts = [threading.Thread(target=work, args=(i, s))
              for i, s in enumerate([42, None, 99, None])]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert len(answers) == 4 and server.stats["batches"] - batches0 < 4
        assert answers[0] == alone
        assert ask(99) == answers[2]
        other = GenerateConfig(**dict(vars(gcfg), sample_seed=8))
        responder2 = Responder(params, cfg, make_vocab(), other, max_batch=4,
                               len_buckets=(8, 16), time_buckets=(8,))
        rows = [responder2.make_request("what is he doing", "a man is walking",
                                        "the man", fts, seed=s) for s in range(6)]
        responder2.respond(rows[:4])
        responder2.respond(rows[4:])
        assert len({r._answer for r in rows}) > 1        # streams differ by seed
        for bad in ("abc", 2 ** 40, -3, 1.5, True):
            with pytest.raises(ValueError):
                ask(bad)
        assert ask(42) == alone
    finally:
        server.stop()


def test_component_seconds_accumulate(served, rng):
    m0 = served.metrics()["component_seconds"]
    for _ in range(3):
        served.submit("what is he doing", history="a man is walking",
                      caption="the man", features=features(rng))
    m1 = served.metrics()["component_seconds"]
    for key in ("coalesce_s", "assemble_s", "ship_s", "device_wait_s", "extract_s"):
        assert m1[key] >= m0[key], key
    assert m1["assemble_s"] > m0["assemble_s"] and m1["ship_s"] > m0["ship_s"]
    assert m1["device_wait_s"] > m0["device_wait_s"]


def test_warmup_lens_warms_length_buckets():
    params, cfg = model()
    responder = Responder(params, cfg, make_vocab(), GenerateConfig(maxlen=3, beam=2),
                          max_batch=2, len_buckets=(8, 16, 32), time_buckets=(8,))
    widths = []
    orig = responder.make_batch

    def spy(reqs):
        b = orig(reqs)
        widths.append((len(reqs), b.query.shape[1]))
        return b

    responder.make_batch = spy
    responder.warmup(feature_shape=(4, 8), t_clips=8, lens=(8, 32), all_batch_buckets=False)
    assert sorted(set(widths)) == [(2, 8), (2, 32)]
    widths.clear()
    responder.warmup(feature_shape=(4, 8), t_clips=8)
    assert widths == [(2, 16)]                # every batch bucket: here only 2
    assert responder.feat_tail == (4, 8)


def test_greedy_style_equals_offline_greedy(rng):
    params, cfg = model()
    vocab = make_vocab()
    r = Responder(params, cfg, vocab, GenerateConfig(maxlen=4, decode_style="greedy"),
                  max_batch=2, len_buckets=(8,), time_buckets=(8,))
    reqs = [r.make_request("what is he doing", "a man is walking", "the man",
                           features(rng)) for _ in range(2)]
    r.respond(reqs)
    ids = greedy_decode(params, cfg, r.make_batch(reqs), 4).numpy()
    id2word = make_id2word(vocab)
    for i, req in enumerate(reqs):
        assert req._answer == " ".join(ids2words(ids[i], id2word))
        assert req._nbest == [(ids2words(ids[i], id2word), 0.0)]


def test_unsupported_decode_style_raises_at_construction():
    params, cfg = model()
    for style in ("oracle", "bogus"):
        with pytest.raises(ValueError, match="decode_style"):
            Responder(params, cfg, make_vocab(), GenerateConfig(decode_style=style),
                      max_batch=2)


def test_feat_int8_responder(rng):
    params, cfg = model()
    r = Responder(params, cfg, make_vocab(), GenerateConfig(maxlen=3, beam=2, nbest=1),
                  max_batch=4, len_buckets=(8,), time_buckets=(8,), feat_int8=True)
    req = r.make_request("what is he doing", "a man is walking", "a man", features(rng))
    batch = r.make_batch([req])
    assert batch.fts.dtype == np.int8 and batch.fts_scale is not None
    r.respond([req])
    assert isinstance(req._answer, str)


def test_unpinned_server_takes_two_grids(rng):
    """Without a pinned grid one batcher serves two spatial grids at once
    (one batch per grid)."""
    vocab = make_vocab()
    params, cfg = model(nb_cenc_blocks=0, include_caption="none", separate_caption=False)
    responder = Responder(params, cfg, vocab, GenerateConfig(maxlen=2, beam=2, nbest=1),
                          max_batch=2, len_buckets=(8,), time_buckets=(4,))
    responder.warmup(t_clips=4, all_batch_buckets=False)
    assert responder.feat_tail is None
    server = DynamicBatcher(responder, max_batch=2, max_wait_ms=100)
    server.start()
    try:
        results = {}

        def ask(name, S):
            results[name] = server.submit("what is he doing",
                                          features=features(rng, T=4, S=S), timeout=120)

        ts = [threading.Thread(target=ask, args=("s4", 4)),
              threading.Thread(target=ask, args=("s8", 8))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert set(results) == {"s4", "s8"} and server.stats["errors"] == 0
    finally:
        server.stop()


def test_http_audio_model_round_trip(rng):
    vocab = make_vocab()
    params, cfg = model(nb_cenc_blocks=0, nb_aenc_blocks=1, include_caption="none",
                        ft_sizes=(8, 6))
    assert cfg.has_audio
    responder = Responder(params, cfg, vocab, GenerateConfig(maxlen=3, beam=2, nbest=1),
                          max_batch=2, len_buckets=(8, 16), time_buckets=(8,))
    responder.warmup(feature_shape=(4, 8), t_clips=8, all_batch_buckets=False)
    server = DynamicBatcher(responder, max_batch=2, max_wait_ms=5)
    server.start()
    fts, aud = features(rng), rng.standard_normal((4, 6)).astype(np.float32)
    try:
        with Http(server) as base:
            code, resp = post(base, "/respond", {"question": "what is he doing",
                                                 "features": fts.tolist(),
                                                 "audio": aud.tolist()})
            assert code == 200 and isinstance(resp["answer"], str)
            code, resp = post(base, "/respond", {"question": "what is he doing",
                                                 "features": fts.tolist(),
                                                 "audio_b64": npy_b64(aud)})
            assert code == 200 and isinstance(resp["answer"], str)
            for body in ({"question": "what", "features": fts.tolist()},
                         {"features": fts.tolist(), "audio": aud.tolist()}):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    post(base, "/respond", body)
                assert ei.value.code == 400
    finally:
        server.stop()


def test_batch_rows_and_buckets():
    params, cfg = model()
    r = Responder(params, cfg, make_vocab(), GenerateConfig(), max_batch=64)
    assert r.batch_buckets == (8, 16, 32, 64)
    assert [r.batch_rows(n) for n in (1, 8, 9, 33, 64)] == [8, 8, 16, 64, 64]
    with pytest.raises(ValueError, match="exceed"):
        r.batch_rows(65)
    with pytest.raises(ValueError, match="max_batch"):
        Responder(params, cfg, make_vocab(), GenerateConfig(), max_batch=8,
                  batch_buckets=(4,))
