"""ROUGE-L (coco-caption variant).

Replaces the coco-caption Rouge scorer (dstc7avsd_eval stage 3 dependency).
Contract: per image, LCS-based F-measure with beta = 1.2 — precision and
recall each maximised over references independently:
    P_max = max_r LCS(hyp, r) / |hyp|,  R_max = max_r LCS(hyp, r) / |r|
    F = (1 + β²)·P_max·R_max / (R_max + β²·P_max)   (0 when denom = 0)
Corpus score = mean over images.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

BETA = 1.2


def lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Classic O(len(a)·len(b)) dynamic program, rolling row."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_single(hyp: Sequence[str], refs: Sequence[Sequence[str]]) -> float:
    if not hyp:
        return 0.0
    prec, rec = [], []
    for ref in refs:
        l = lcs_len(hyp, ref)
        prec.append(l / len(hyp))
        rec.append(l / len(ref) if ref else 0.0)
    p, r = max(prec), max(rec)
    denom = r + BETA * BETA * p
    return ((1 + BETA * BETA) * p * r / denom) if denom > 0 else 0.0


def rouge_l_corpus(hyps: List[Sequence[str]],
                   refs_list: List[List[Sequence[str]]]
                   ) -> Tuple[float, List[float]]:
    scores = [rouge_l_single(h, rs) for h, rs in zip(hyps, refs_list)]
    return (sum(scores) / len(scores) if scores else 0.0), scores
