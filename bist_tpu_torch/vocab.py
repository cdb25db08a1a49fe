"""Vocabulary construction and tokenisation (a copy of `bist_tpu.vocab`).

Byte-for-byte semantic parity with the reference
(data/data_handler.py:22-57 `get_vocabulary`, data/data_utils.py:30-40
`words2ids`): whitespace tokenisation, specials <unk>=0 <blank>=1(pad)
<sos>=2 <eos>=3, frequency cutoff `freq > cutoff`, and — crucially for
checkpoint compatibility — identical id assignment order (first-occurrence
scan order: per dialog, optional caption first, then all question words
across turns, then all answer words across turns).
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

UNK, PAD, SOS, EOS = 0, 1, 2, 3
SPECIALS = {"<unk>": UNK, "<blank>": PAD, "<sos>": SOS, "<eos>": EOS}


def _caption_text(dialog: dict, include_caption: str) -> str:
    if include_caption in ("caption", "summary"):
        return dialog[include_caption]
    if include_caption == "caption,summary":
        return dialog["caption"] + dialog["summary"]
    return ""


def get_vocabulary(dataset_file: str, cutoff: int = 0,
                   include_caption: str = "none", ptr_gen: bool = False,
                   ) -> Dict[str, int]:
    """Build word→id vocab from an AVSD-format JSON.

    Matches reference data_handler.py:22-57 exactly, including:
      * scan order (captions, then questions over all turns, then answers),
      * `freq > cutoff` (strict) selection,
      * ptr_gen=True keeps every word regardless of cutoff.
    Note the reference train entry calls this WITHOUT ptr_gen even for
    pointer-generator models (train.py:56), so cutoff applies by default.
    """
    with open(dataset_file, "r") as f:
        dialog_data = json.load(f)
    word_freq: Dict[str, int] = {}
    for dialog in dialog_data["dialogs"]:
        if include_caption in ("caption", "summary", "caption,summary"):
            for word in _caption_text(dialog, include_caption).split():
                word_freq[word] = word_freq.get(word, 0) + 1
        for key in ("question", "answer"):
            for turn in dialog["dialog"]:
                for word in turn[key].split():
                    word_freq[word] = word_freq.get(word, 0) + 1

    vocab = dict(SPECIALS)
    if ptr_gen:
        for word in word_freq:
            vocab[word] = len(vocab)
    else:
        for word, freq in word_freq.items():
            if freq > cutoff:
                vocab[word] = len(vocab)
    return vocab


def words2ids(text: str, vocab: Dict[str, int]) -> np.ndarray:
    """<sos> w1 .. wn <eos> as int32 (reference data_utils.py:30-40)."""
    words = text.split()
    out = np.empty(len(words) + 2, dtype=np.int32)
    out[0] = SOS
    for i, w in enumerate(words):
        out[i + 1] = vocab.get(w, UNK)
    out[-1] = EOS
    return out


def make_id2word(vocab: Dict[str, int]) -> List[str]:
    """vocablist sorted by id (generate.py:24)."""
    return sorted(vocab.keys(), key=lambda s: vocab[s])
