"""DSTC7-AVSD evaluation harness, pure python3.

Replaces the reference's bash + python2 + Java pipeline
(dstc7avsd_eval/dstc7avsd_eval.sh → get_hypotheses.py → evaluate.py →
coco-caption) with in-process scoring.  Same inputs (result JSON + the
COCO-format multi-reference ground truth), same outputs (a `.eval` text file
whose summary lines awk-match the reference's, dstc7avsd_eval.sh:31-32).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

from bist_tpu_torch.evalkit.bleu import BleuScorer
from bist_tpu_torch.evalkit.cider import CiderScorer
from bist_tpu_torch.evalkit.meteor import meteor_corpus
from bist_tpu_torch.evalkit.ptb_tokenizer import ptb_tokenize
from bist_tpu_torch.evalkit.rouge import rouge_l_corpus


class StopwordFilter:
    """Regex word filter (dstc7avsd_eval/utils/stopword_filter.py:4-35).

    Each line of the file is `pattern [replacement]`; a word matching
    ^pattern$ is replaced (dropped when the replacement is empty).  The
    shipped stopwords.txt contains `,` and `.` — i.e. strips punctuation
    tokens."""

    def __init__(self, filename: Optional[str] = None,
                 patterns: Optional[List[Tuple[str, str]]] = None):
        self.pats: List[Tuple[re.Pattern, str]] = []
        if filename and os.path.exists(filename):
            for ln in open(filename):
                ww = ln.split()
                if len(ww) == 1:
                    self.pats.append((re.compile(r"^" + ww[0] + r"$"), ""))
                elif len(ww) == 2:
                    self.pats.append((re.compile(r"^" + ww[0] + r"$"), ww[1]))
        for pat, repl in patterns or []:
            self.pats.append((re.compile(r"^" + pat + r"$"), repl))

    def __call__(self, sentence: str) -> str:
        out = []
        for w in sentence.split():
            target = w
            for pat, repl in self.pats:
                v = pat.sub(repl, w)
                if v != w:
                    target = v
                    break
            if target != "":
                out.append(target)
        return " ".join(out)


# The reference's stopwords.txt contains raw "," and "." — and "." compiled
# as ^.$ matches ANY single character, so EVERY one-char token is dropped
# (e.g. "a").  The golden .eval scores embed this behaviour; the default must
# reproduce it, not an escaped literal dot.
DEFAULT_STOPWORDS = [(",", ""), (".", "")]


def get_hypotheses(result: dict, last_only: bool = True,
                   swfilter: Optional[StopwordFilter] = None) -> List[dict]:
    """Result JSON → COCO hypothesis list [{image_id:int, caption:str}]
    (dstc7avsd_eval/utils/get_hypotheses.py:26-41): sequential integer ids in
    dialog order, last turn only with -l."""
    annos = []
    image_id = 1
    for dialog in result["dialogs"]:
        turns = dialog["dialog"]
        for n, qa in enumerate(turns):
            if not last_only or n == len(turns) - 1:
                sent = qa["answer"]
                if swfilter:
                    sent = swfilter(sent)
                annos.append({"image_id": image_id, "caption": sent})
                image_id += 1
    return annos


def load_coco_refs(multiref_path: str) -> Dict[int, List[str]]:
    """COCO-format ground truth → {image_id: [ref captions]}."""
    with open(multiref_path) as f:
        gt = json.load(f)
    refs: Dict[int, List[str]] = {}
    for ann in gt["annotations"]:
        refs.setdefault(int(ann["image_id"]), []).append(ann["caption"])
    return refs


def evaluate_coco(hypotheses: List[dict], multiref_path: str,
                  meteor_tables=None
                  ) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """Score hypotheses against the multi-reference ground truth.

    Returns (corpus metrics, per-image metrics) with the coco-caption metric
    names: Bleu_1..4, METEOR, ROUGE_L, CIDEr.  meteor_tables (an
    evalkit.meteor.MeteorTables) activates the synonym/paraphrase stages
    when their data files are available."""
    refs_raw = load_coco_refs(multiref_path)
    hyp_raw = {int(h["image_id"]): [h["caption"]] for h in hypotheses}
    ids = sorted(hyp_raw.keys())

    hyp_tok, hyp_tokens = ptb_tokenize(hyp_raw, with_count=True)
    ref_tok, ref_tokens = ptb_tokenize({i: refs_raw[i] for i in ids},
                                       with_count=True)

    hyps = [hyp_tok[i][0].split() for i in ids]
    refs_list = [[r.split() for r in ref_tok[i]] for i in ids]

    bleu = BleuScorer()
    cider = CiderScorer()
    for h, rs in zip(hyps, refs_list):
        bleu.append(h, rs)
        cider.append(h, rs)
    bleu_corpus, bleu_imgs = bleu.compute()
    cider_corpus, cider_imgs = cider.compute()
    rouge_corpus, rouge_imgs = rouge_l_corpus(hyps, refs_list)
    meteor_mean, meteor_imgs = meteor_corpus(hyps, refs_list,
                                             tables=meteor_tables)

    corpus = {f"Bleu_{k+1}": bleu_corpus[k] for k in range(4)}
    corpus["METEOR"] = meteor_mean
    corpus["ROUGE_L"] = rouge_corpus
    corpus["CIDEr"] = cider_corpus
    # Aux stats used by write_eval_file to reproduce the coco-caption stdout
    # layout byte-for-byte (underscore keys; not metrics).
    corpus["_bleu_totals"] = dict(bleu.totals)
    corpus["_ref_tokens"] = ref_tokens
    corpus["_hyp_tokens"] = hyp_tokens

    per_image = []
    for n, i in enumerate(ids):
        per_image.append({
            "image_id": i,
            **{f"Bleu_{k+1}": bleu_imgs[n][k] for k in range(4)},
            "METEOR": meteor_imgs[n],
            "ROUGE_L": rouge_imgs[n],
            "CIDEr": cider_imgs[n],
        })
    return corpus, per_image


METRIC_ORDER = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
                "CIDEr"]


# eval.items() iteration order of the python2 dict in the reference's
# evaluate.py stdout (sample/baseline_*.eval lines 26-32).
_PY2_EVAL_ORDER = ["CIDEr", "Bleu_4", "Bleu_3", "Bleu_2", "Bleu_1",
                   "ROUGE_L", "METEOR"]
# imgToEval[id] dict key order in the per-image py2 repr lines.
_PY2_IMG_ORDER = ["CIDEr", "Bleu_4", "Bleu_3", "Bleu_2", "Bleu_1",
                  "ROUGE_L", "image_id", "METEOR"]


def write_eval_file(path: str, corpus: Dict[str, float],
                    per_image: List[Dict[str, float]]) -> None:
    """Write the `.eval` artifact in coco-caption's exact stdout layout
    (sample/baseline_i3d_rgb-i3d_flow.eval is the oracle): tokenizer/loader
    progress lines, the Bleu totals dict + ratio, per-scorer `Metric: value`
    summary lines (what the awk summary greps, dstc7avsd_eval.sh:31-32), the
    py2 eval.items() block, then one py2-dict-repr line per image.  Only
    timing figures differ from the reference byte-wise."""
    bt = corpus.get("_bleu_totals")
    with open(path, "w") as f:
        if "_ref_tokens" in corpus:
            f.write("PTBTokenizer tokenized %d tokens at 500000.00 tokens per"
                    " second.\n" % corpus["_ref_tokens"])
            f.write("PTBTokenizer tokenized %d tokens at 500000.00 tokens per"
                    " second.\n" % corpus["_hyp_tokens"])
        f.write("loading annotations into memory...\n")
        f.write("0:00:00.000000\n")
        f.write("creating index...\nindex created!\n")
        f.write("Loading and preparing results...     \n")
        f.write("DONE (t=0.00s)\n")
        f.write("creating index...\nindex created!\n")
        f.write("tokenization...\nsetting up scorers...\n")
        f.write("computing Bleu score...\n")
        if bt is not None:
            f.write("{'reflen': %d, 'guess': %r, 'testlen': %d, "
                    "'correct': %r}\n" % (bt["reflen"], bt["guess"],
                                          bt["testlen"], bt["correct"]))
            f.write("ratio: %.12g\n" % (bt["testlen"] / max(bt["reflen"], 1)))
        for k in range(1, 5):
            f.write("Bleu_%d: %.3f\n" % (k, corpus[f"Bleu_{k}"]))
        f.write("computing METEOR score...\nMETEOR: %.3f\n" % corpus["METEOR"])
        f.write("computing Rouge score...\nROUGE_L: %.3f\n" % corpus["ROUGE_L"])
        f.write("computing CIDEr score...\nCIDEr: %.3f\n" % corpus["CIDEr"])
        for m in _PY2_EVAL_ORDER:
            f.write("%s: %.3f\n" % (m, corpus[m]))
        for img in per_image:
            body = ", ".join("'%s': %r" % (k, img[k]) for k in _PY2_IMG_ORDER)
            f.write("%d {%s}\n" % (img["image_id"], body))


def evaluate_result_file(result_path: str, multiref_path: str,
                         stopwords_path: Optional[str] = None,
                         last_only: bool = True,
                         out_path: Optional[str] = None,
                         meteor_tables=None) -> Dict[str, float]:
    """Full stage-3 pipeline for one result JSON (dstc7avsd_eval.sh:24-34)."""
    with open(result_path) as f:
        result = json.load(f)
    sw = StopwordFilter(stopwords_path) if stopwords_path else \
        StopwordFilter(patterns=DEFAULT_STOPWORDS)
    hyps = get_hypotheses(result, last_only=last_only, swfilter=sw)
    corpus, per_image = evaluate_coco(hyps, multiref_path,
                                      meteor_tables=meteor_tables)
    if out_path is None:
        out_path = os.path.splitext(result_path)[0] + ".eval"
    write_eval_file(out_path, corpus, per_image)
    summary = " ".join("%s: %.3f" % (m, corpus[m]) for m in METRIC_ORDER)
    print(summary)
    return corpus
