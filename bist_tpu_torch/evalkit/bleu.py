"""Corpus BLEU with the coco-caption accumulation scheme.

Replaces the runtime-cloned tylin/coco-caption Bleu scorer consumed by the
reference evaluation harness (dstc7avsd_eval/utils/evaluate.py).  Behavioural
contract (validated against dstc7avsd_eval/sample/*.eval goldens):
  * modified n-gram precision with per-reference max counts, n = 1..4;
  * 'closest' reference length per image (ties → shorter ref);
  * corpus score from summed correct/guess/testlen/reflen with
    (correct + tiny) / (guess + small) smoothing, tiny=1e-15, small=1e-9;
  * brevity penalty exp(1 − 1/ratio) applied when ratio < 1 where
    ratio = (testlen + tiny) / (reflen + small);
  * per-image scores use the same formula on single-image counts.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import math

SMALL = 1e-9
TINY = 1e-15


def ngram_counts(tokens: Sequence[str], n_max: int = 4) -> List[Counter]:
    out = []
    for n in range(1, n_max + 1):
        out.append(Counter(tuple(tokens[i:i + n])
                           for i in range(len(tokens) - n + 1)))
    return out


def _closest_ref_len(reflens: List[int], testlen: int) -> int:
    return min(reflens, key=lambda l: (abs(l - testlen), l))


class BleuScorer:
    def __init__(self, n: int = 4):
        self.n = n
        self.totals = {"testlen": 0, "reflen": 0,
                       "guess": [0] * n, "correct": [0] * n}
        self.image_scores: List[List[float]] = []

    def append(self, hyp: Sequence[str], refs: Sequence[Sequence[str]]) -> None:
        hyp_counts = ngram_counts(hyp, self.n)
        max_ref: List[Counter] = [Counter() for _ in range(self.n)]
        for ref in refs:
            rc = ngram_counts(ref, self.n)
            for k in range(self.n):
                for g, c in rc[k].items():
                    if c > max_ref[k][g]:
                        max_ref[k][g] = c
        testlen = len(hyp)
        reflen = _closest_ref_len([len(r) for r in refs], testlen)
        guess = [max(0, testlen - k) for k in range(self.n)]
        correct = [sum(min(c, max_ref[k][g]) for g, c in hyp_counts[k].items())
                   for k in range(self.n)]
        self.totals["testlen"] += testlen
        self.totals["reflen"] += reflen
        for k in range(self.n):
            self.totals["guess"][k] += guess[k]
            self.totals["correct"][k] += correct[k]
        self.image_scores.append(self._score_counts(testlen, reflen, guess, correct))

    def _score_counts(self, testlen, reflen, guess, correct) -> List[float]:
        bleus = []
        bleu = 1.0
        for k in range(self.n):
            bleu *= (correct[k] + TINY) / (guess[k] + SMALL)
            bleus.append(bleu ** (1.0 / (k + 1)))
        ratio = (testlen + TINY) / (reflen + SMALL)
        if ratio < 1:
            bp = math.exp(1 - 1 / ratio)
            bleus = [b * bp for b in bleus]
        return bleus

    def compute(self) -> Tuple[List[float], List[List[float]]]:
        """(corpus bleu_1..n, per-image bleu lists)."""
        t = self.totals
        corpus = self._score_counts(t["testlen"], t["reflen"], t["guess"],
                                    t["correct"])
        return corpus, self.image_scores
