"""Pure-python3 approximation of the Stanford PTBTokenizer as invoked by the
coco-caption harness (java -cp stanford-corenlp ... PTBTokenizer
-preserveLines -lowerCase, followed by punctuation-token removal).

Replaces the Java subprocess boundary of the reference evaluation stack
(dstc7avsd_eval/dstc7avsd_eval.sh:29 → pycocoevalcap tokenizer).  Implements
the PTB rules that matter for AVSD-style text: lowercasing, punctuation
splitting, contraction splitting (don't → do n't), bracket normalisation,
and the coco harness's post-hoc punctuation filtering.  Validated end-to-end
against the committed golden scores (dstc7avsd_eval/sample/*.eval) in
tests/test_metrics_golden.py.
"""

from __future__ import annotations

import re
from typing import Dict, List

# Tokens the coco harness removes AFTER tokenization.
PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

_CONTRACTIONS = re.compile(
    r"\b(can)(not)\b"
    r"|\b(d)('ye)\b"
    r"|\b(gim)(me)\b"
    r"|\b(gon)(na)\b"
    r"|\b(got)(ta)\b"
    r"|\b(lem)(me)\b"
    r"|\b(more)('n)\b"
    r"|\b(wan)(na)\b",
    re.IGNORECASE)

# n't / 'll / 're / 've / 's / 'm / 'd clitics split off the host word.
_CLITIC = re.compile(r"(?i)([a-z])(n't|'ll|'re|'ve|'s|'m|'d)\b")

_BRACKET_MAP = {
    "(": "-LRB-", ")": "-RRB-", "{": "-LCB-", "}": "-RCB-",
    "[": "-LSB-", "]": "-RSB-",
}


def _ptb_split(text: str) -> List[str]:
    t = " " + text + " "
    # PTB normalises any run of 2+ dots to the ellipsis token "..."
    t = re.sub(r"\.{2,}", " ... ", t)
    t = re.sub(r"([,;:@#$%&?!])", r" \1 ", t)
    # final period: a period before optional closing quotes/brackets at end or
    # before whitespace-end
    t = re.sub(r"([^\.])(\.)(\s|$)", r"\1 \2 ", t)
    for b, repl in _BRACKET_MAP.items():
        t = t.replace(b, f" {repl} ")
    t = re.sub(r"--", " -- ", t)
    # quotes
    t = re.sub(r'^"', " `` ", t)
    t = re.sub(r'(\s)"', r"\1 `` ", t)
    t = t.replace('"', " '' ")
    t = re.sub(r"(\S)('')", r"\1 \2 ", t)
    # possessive and clitics
    t = _CLITIC.sub(r"\1 \2", t)
    t = _CONTRACTIONS.sub(lambda m: " ".join(g for g in m.groups() if g), t)
    # leading apostrophe kept with token ('tis) — leave as is
    return t.split()


def ptb_tokenize_sentence(text: str, lowercase: bool = True,
                          remove_punct: bool = True) -> List[str]:
    if lowercase:
        text = text.lower()
    toks = _ptb_split(text)
    if remove_punct:
        toks = [w for w in toks if w not in PUNCTUATIONS]
    return toks


def ptb_tokenize(captions: Dict[str, List[str]], with_count: bool = False):
    """Tokenize {image_id: [caption, ...]} → {image_id: ['tok tok ...', ...]}
    — the same shape the coco PTBTokenizer wrapper produces.

    with_count=True also returns the total PRE-punct-removal token count
    from the same pass (the figure PTBTokenizer prints, reproduced in the
    .eval stdout layout) — callers previously re-tokenized the whole corpus
    just for that integer."""
    out: Dict[str, List[str]] = {}
    count = 0
    for k, v in captions.items():
        lst = []
        for c in v:
            toks = ptb_tokenize_sentence(c, remove_punct=False)
            count += len(toks)
            lst.append(" ".join(w for w in toks if w not in PUNCTUATIONS))
        out[k] = lst
    if with_count:
        return out, count
    return out
