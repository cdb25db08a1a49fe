"""The port's evaluation kit (`bist_tpu_torch.evalkit`, `cli.evaluate`), a
copy of `bist_tpu.evalkit`: both vendored DSTC7 goldens scored by both
packages give the same numbers, within the golden bands of
tests/test_metrics_golden.py, in the golden's .eval layout."""

import ast
import gzip
import json
import os
import re

import pytest

from bist_tpu.evalkit import harness as jax_harness
from bist_tpu.evalkit import meteor as jax_meteor
from bist_tpu_torch.cli import evaluate, repo_root
from bist_tpu_torch.evalkit import harness, meteor

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "dstc7avsd_eval")
MULTIREF = f"{REF}/data/test_set4DSTC7-AVSD_multiref.json"
FIXTURES = ["baseline_i3d_rgb-i3d_flow", "baseline_i3d_rgb-i3d_flow-vggish"]
NUM = re.compile(r"\d+(?:\.\d+)?(?:e[+-]?\d+)?")


def load_golden(name):
    corpus, per_image = {}, {}
    with open(f"{REF}/sample/{name}.eval") as f:
        for ln in f:
            m = re.match(r"^(Bleu_[1-4]|METEOR|ROUGE_L|CIDEr): ([\d.]+)", ln)
            if m and m.group(1) not in corpus:
                corpus[m.group(1)] = float(m.group(2))
            m = re.match(r"^(\d+) (\{.*\})$", ln)
            if m:
                per_image[int(m.group(1))] = ast.literal_eval(m.group(2))
    return corpus, per_image


@pytest.fixture(scope="module", params=FIXTURES)
def scored(request, tmp_path_factory):
    """One golden scored by both packages' result-file pipeline: its name,
    then (corpus, .eval text) of the port and of bist_tpu."""
    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    out = {}
    for tag, h in (("port", harness), ("jax", jax_harness)):
        path = str(tmp / f"{tag}.eval")
        corpus = h.evaluate_result_file(f"{REF}/sample/{name}.json", MULTIREF,
                                        stopwords_path=f"{REF}/data/stopwords.txt",
                                        out_path=path)
        with open(path) as f:
            out[tag] = (corpus, f.read())
    return name, out["port"], out["jax"]


def per_image_of(text):
    return {int(m.group(1)): ast.literal_eval(m.group(2))
            for m in re.finditer(r"^(\d+) (\{.*\})$", text, re.M)}


def test_numbers_equal_bist_tpu_exactly(scored):
    _, (corpus, text), (jcorpus, jtext) = scored
    assert corpus == jcorpus
    assert per_image_of(text) == per_image_of(jtext)


def test_golden_bands(scored):
    name, (corpus, text), _ = scored
    gold_corpus, gold_img = load_golden(name)
    for metric in ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr"]:
        assert abs(corpus[metric] - gold_corpus[metric]) < 1.5e-3, metric
    # METEOR without the synonym and paraphrase tables: a lower bound
    assert -0.006 < corpus["METEOR"] - gold_corpus["METEOR"] <= 1e-6
    per_image = per_image_of(text)
    assert set(per_image) == set(gold_img)
    for i, img in per_image.items():
        g = gold_img[i]
        assert abs(img["Bleu_4"] - g["Bleu_4"]) < 1e-6
        assert abs(img["ROUGE_L"] - g["ROUGE_L"]) < 1e-6
        assert abs(img["CIDEr"] - g["CIDEr"]) < 0.03


def test_eval_file_byte_layout(scored):
    """Numbers aside, the port's .eval is the golden's line for line; with
    them, it is byte for byte the JAX package's."""
    name, (_, text), (_, jtext) = scored
    assert text == jtext
    with open(f"{REF}/sample/{name}.eval") as f:
        golden = f.read()
    assert [NUM.sub("#", ln) for ln in text.splitlines()] == \
        [NUM.sub("#", ln) for ln in golden.splitlines()]


def write_tables(tmp_path):
    syn = tmp_path / "syn.txt"
    syn.write_text("dog canine puppy\nsofa couch\nwalk stroll\nstreet road avenue\n")
    para = tmp_path / "para.tsv.gz"
    with gzip.open(para, "wt") as f:
        f.write("# comment\npassed away\tdied\ndown the street ||| along the road\n")
    return str(syn), str(para)


CASES = [
    ("the dog sits on the couch", ["the canine sits on the sofa"]),
    ("the man passed away quietly", ["the man died quietly"]),
    ("a man is walking down the street", ["a person strolls along the road",
                                          "the guy walks"]),
    ("nothing in common here", ["completely different words"]),
]


@pytest.mark.parametrize("stages", ["exact+stem", "synonym", "paraphrase", "both"])
def test_meteor_table_stages_equal_bist_tpu(tmp_path, stages):
    syn, para = write_tables(tmp_path)
    kw = {"exact+stem": {}, "synonym": dict(synonyms=syn),
          "paraphrase": dict(paraphrase=para), "both": dict(synonyms=syn, paraphrase=para)}
    tables = meteor.MeteorTables.load(**kw[stages])
    jtables = jax_meteor.MeteorTables.load(**kw[stages])
    base = []
    for h, rs in CASES:
        hyp, refs = h.split(), [r.split() for r in rs]
        got = meteor.meteor_single(hyp, refs, tables)
        assert got == jax_meteor.meteor_single(hyp, refs, jtables)
        base.append(meteor.meteor_single(hyp, refs))
        assert got >= base[-1]                        # stages only add matches
    if stages != "exact+stem":
        scores = [meteor.meteor_single(h.split(), [r.split() for r in rs], tables)
                  for h, rs in CASES]
        assert scores != base


def test_evaluate_cli_prints_the_seven_metrics_and_writes_eval(tmp_path, capsys):
    """The CLI on the first 100 dialogs of a golden's result JSON, against
    the vendored ground truth by default: its summary is the seven metrics
    of bist_tpu's harness on the same file, and the .eval lands beside it."""
    with open(f"{REF}/sample/{FIXTURES[0]}.json") as f:
        full = json.load(f)
    result = tmp_path / "result.json"
    result.write_text(json.dumps(dict(full, dialogs=full["dialogs"][:100])))
    assert evaluate.DEFAULT_MULTIREF == os.path.join(repo_root(), "dstc7avsd_eval",
                                                     "data", os.path.basename(MULTIREF))
    evaluate.main([str(result)])
    out = capsys.readouterr().out
    want = jax_harness.evaluate_result_file(str(result), MULTIREF,
                                            out_path=str(tmp_path / "jax.eval"))
    summary = out.split("--- summary ---")[1].splitlines()[1:8]
    assert summary == ["%s: %.3f" % (m, want[m]) for m in harness.METRIC_ORDER]
    assert (tmp_path / "result.eval").read_text() == (tmp_path / "jax.eval").read_text()
