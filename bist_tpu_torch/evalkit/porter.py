"""Self-contained Porter stemmer (M.F. Porter, 1980, "An algorithm for
suffix stripping", Program 14(3):130-137 — the algorithm is public domain).

Vendored so the METEOR stem stage has no optional dependency: the round-1
implementation fell back to an identity stemmer if nltk was missing, which
would silently depress METEOR scores.  This module implements the ORIGINAL
published algorithm (the de-facto standard; METEOR 1.5 uses the closely
related Snowball English stemmer — measured equivalent on the DSTC7 goldens
to <3e-4 corpus METEOR, see tests/test_metrics_golden.py band).
"""

from __future__ import annotations

_VOWELS = "aeiou"


def _cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """m in the paper: number of VC sequences in [C](VC)^m[V]."""
    seq = []
    for i in range(len(stem)):
        c = _cons(stem, i)
        if not seq or seq[-1] != c:
            seq.append(c)
    if seq and seq[0]:
        seq = seq[1:]
    if seq and not seq[-1]:
        seq = seq[:-1]
    return len(seq) // 2


def _has_vowel(stem: str) -> bool:
    return any(not _cons(stem, i) for i in range(len(stem)))


def _double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _cons(word, len(word) - 1))


def _cvc(word: str) -> bool:
    """*o: stem ends cvc where the final c is not w, x or y."""
    return (len(word) >= 3
            and _cons(word, len(word) - 3)
            and not _cons(word, len(word) - 2)
            and _cons(word, len(word) - 1)
            and word[-1] not in "wxy")


_STEP2 = [
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
    ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
    ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
    ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
    ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
]

_STEP3 = [
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""),
]

_STEP4 = [
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
    "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
]


def porter_stem(word: str) -> str:
    if len(word) <= 2 or not word.isascii() or not word.isalpha():
        return word
    word = word.lower()

    # Step 1a
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith("ies"):
        word = word[:-2]
    elif word.endswith("ss"):
        pass
    elif word.endswith("s"):
        word = word[:-1]

    # Step 1b
    flag_1b = False
    if word.endswith("eed"):
        if _measure(word[:-3]) > 0:
            word = word[:-1]
    elif word.endswith("ed"):
        if _has_vowel(word[:-2]):
            word = word[:-2]
            flag_1b = True
    elif word.endswith("ing"):
        if _has_vowel(word[:-3]):
            word = word[:-3]
            flag_1b = True
    if flag_1b:
        if word.endswith(("at", "bl", "iz")):
            word += "e"
        elif _double_cons(word) and word[-1] not in "lsz":
            word = word[:-1]
        elif _measure(word) == 1 and _cvc(word):
            word += "e"

    # Step 1c
    if word.endswith("y") and _has_vowel(word[:-1]):
        word = word[:-1] + "i"

    # Step 2 (longest-match within the step; suffixes are mutually exclusive
    # by ending letter in the paper's table, so first-match suffices when
    # ordered longest-first per ending)
    for suf, repl in _STEP2:
        if word.endswith(suf):
            stem = word[: len(word) - len(suf)]
            if _measure(stem) > 0:
                word = stem + repl
            break

    # Step 3
    for suf, repl in _STEP3:
        if word.endswith(suf):
            stem = word[: len(word) - len(suf)]
            if _measure(stem) > 0:
                word = stem + repl
            break

    # Step 4
    for suf in _STEP4:
        if word.endswith(suf):
            stem = word[: len(word) - len(suf)]
            if suf == "ion" and (not stem or stem[-1] not in "st"):
                break
            if _measure(stem) > 1:
                word = stem
            break

    # Step 5a
    if word.endswith("e"):
        stem = word[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            word = stem

    # Step 5b
    if _measure(word) > 1 and _double_cons(word) and word.endswith("l"):
        word = word[:-1]

    return word
