"""CIDEr (coco-caption / tylin variant).

Replaces the coco-caption Cider scorer.  Contract (validated against the
dstc7avsd_eval/sample/*.eval per-image goldens):
  * n-grams n = 1..4 with TF·IDF vectors per sentence;
  * document frequency over the reference corpus: an n-gram's df = number of
    images in which ANY reference contains it;
  * idf = log(N_images) − log(max(1, df));
  * clipped similarity per n: Σ_g min(h_g, r_g) · r_g / (‖h‖·‖r‖)
    (the tylin repo's sim — hypothesis counts clipped to the reference's);
  * gaussian length penalty exp(−(len_h − len_r)² / (2·σ²)), σ = 6;
  * score = 10 · mean_n( mean_refs( sim ) ).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

SIGMA = 6.0
N = 4


def _counts(tokens: Sequence[str]) -> Counter:
    c = Counter()
    for n in range(1, N + 1):
        for i in range(len(tokens) - n + 1):
            c[tuple(tokens[i:i + n])] += 1
    return c


class CiderScorer:
    def __init__(self):
        self.hyps: List[Counter] = []
        self.refs: List[List[Counter]] = []
        self.hyp_lens: List[int] = []
        self.ref_lens: List[List[int]] = []

    def append(self, hyp: Sequence[str], refs: Sequence[Sequence[str]]) -> None:
        self.hyps.append(_counts(hyp))
        self.refs.append([_counts(r) for r in refs])
        self.hyp_lens.append(len(hyp))
        self.ref_lens.append([len(r) for r in refs])

    def _doc_freq(self) -> Dict[tuple, int]:
        df: Dict[tuple, int] = defaultdict(int)
        for refs in self.refs:
            seen = set()
            for rc in refs:
                seen.update(rc.keys())
            for g in seen:
                df[g] += 1
        return df

    @staticmethod
    def _vec(counts: Counter, df, log_n: float):
        vec = [defaultdict(float) for _ in range(N)]
        norm = [0.0] * N
        for g, c in counts.items():
            idf = log_n - math.log(max(1.0, df.get(g, 0.0)))
            k = len(g) - 1
            vec[k][g] = c * idf
            norm[k] += (c * idf) ** 2
        return vec, [math.sqrt(x) for x in norm]

    def compute(self) -> Tuple[float, List[float]]:
        df = self._doc_freq()
        log_n = math.log(max(len(self.refs), 1))
        scores = []
        for hc, rcs, hl, rls in zip(self.hyps, self.refs, self.hyp_lens,
                                    self.ref_lens):
            hvec, hnorm = self._vec(hc, df, log_n)
            acc = [0.0] * N
            for rc, rl in zip(rcs, rls):
                rvec, rnorm = self._vec(rc, df, log_n)
                delta = float(hl - rl)
                penalty = math.exp(-(delta ** 2) / (2 * SIGMA ** 2))
                for k in range(N):
                    val = sum(min(hvec[k][g], rvec[k][g]) * rvec[k][g]
                              for g in hvec[k])
                    if hnorm[k] != 0 and rnorm[k] != 0:
                        val /= hnorm[k] * rnorm[k]
                    acc[k] += val * penalty
            n_refs = max(len(rcs), 1)
            score = 10.0 * sum(a / n_refs for a in acc) / N
            scores.append(score)
        mean = sum(scores) / len(scores) if scores else 0.0
        return mean, scores
