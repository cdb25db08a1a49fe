#!/usr/bin/env python
"""Evaluation, stage 3 of the reference pipeline (a copy of
`bist_tpu.cli.evaluate`): the objective DSTC7-AVSD metrics of result JSON
files, in-process (`bist_tpu_torch.evalkit`; no Java, no python2).

    python -m bist_tpu_torch.cli.evaluate result1.json [result2.json ...]

Writes resultN.eval next to each input and prints the summary the
reference's dstc7avsd_eval.sh prints (its lines 31-32).  The ground truth
defaults to the vendored dstc7avsd_eval/data/test_set4DSTC7-AVSD_multiref.json.
"""

import argparse
import os

from bist_tpu_torch.cli import repo_root

DEFAULT_MULTIREF = os.path.join(
    repo_root(), "dstc7avsd_eval", "data", "test_set4DSTC7-AVSD_multiref.json")


def main(argv=None):
    p = argparse.ArgumentParser(description="DSTC7-AVSD objective evaluation")
    p.add_argument("results", nargs="+", help="result JSON file(s)")
    p.add_argument("--reference", default=None,
                   help="COCO-format multi-reference ground truth JSON")
    p.add_argument("--stopwords", "-s", default=None,
                   help="stopword filter file (default: strip , and .)")
    p.add_argument("--last", "-l", action="store_true", default=True,
                   help="score only last answers per dialog (default true)")
    p.add_argument("--all-turns", dest="last", action="store_false")
    p.add_argument("--meteor-synonyms", default=None, metavar="FILE",
                   help="synonym groups file (one space-separated group per "
                        "line, .gz ok): turns on METEOR's synonym stage; see "
                        "bist_tpu_torch/evalkit/meteor.py for the format")
    p.add_argument("--meteor-paraphrase", default=None, metavar="FILE",
                   help="paraphrase table ('a ||| b' or TSV per line, .gz "
                        "ok): turns on METEOR's paraphrase stage")
    args = p.parse_args(argv)

    multiref = args.reference
    if multiref is None and os.path.exists(DEFAULT_MULTIREF):
        multiref = DEFAULT_MULTIREF
    if multiref is None:
        p.error("no multi-reference ground truth found; pass --reference")

    from bist_tpu_torch.evalkit.harness import METRIC_ORDER, evaluate_result_file

    tables = None
    if args.meteor_synonyms or args.meteor_paraphrase:
        from bist_tpu_torch.evalkit.meteor import MeteorTables

        tables = MeteorTables.load(synonyms=args.meteor_synonyms,
                                   paraphrase=args.meteor_paraphrase)

    for result in args.results:
        print(f"Result: {result}")
        corpus = evaluate_result_file(result, multiref,
                                      stopwords_path=args.stopwords,
                                      last_only=args.last,
                                      meteor_tables=tables)
        print("--- summary ---")
        for m in METRIC_ORDER:
            print("%s: %.3f" % (m, corpus[m]))
        print("---------------")


if __name__ == "__main__":
    main()
