"""AVSD JSON → flattened per-turn examples, and the training-time random
answer cut (a copy of `bist_tpu.data.avsd`).

Semantic parity with reference data/data_handler.py:60-133 `load`: caption
handling per include_caption / separate_caption, history = caption (or
<blank> when the caption is separate) + prior QA pairs windowed by
max_history_length, merge_source, undisclosed_only (last turn only), the
100-pair cap for *_test files, answer_in = answer[:-1], answer_out =
answer[1:].
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from bist_tpu_torch.vocab import PAD, words2ids


@dataclass
class Example:
    vid: str
    qa_id: int
    history: np.ndarray     # int32 tokens
    question: np.ndarray
    answer_in: np.ndarray
    answer_out: np.ndarray
    caption: Optional[np.ndarray] = None  # present iff include_caption & separate_caption


@dataclass
class AVSDData:
    examples: List[Example]
    vocab: Dict[str, int]
    original: dict                       # the raw parsed JSON (for result output)
    vid_set: List[str]


def _with_caption(include_caption: str) -> bool:
    return include_caption in ("caption", "summary", "caption,summary")


def load_avsd(dataset_file: str, vocab: Dict[str, int],
              include_caption: str = "none", separate_caption: bool = False,
              max_history_length: int = -1, merge_source: bool = False,
              undisclosed_only: bool = False) -> AVSDData:
    with open(dataset_file, "r") as f:
        dialog_data = json.load(f)

    examples: List[Example] = []
    vid_set: List[str] = []
    seen = set()
    qa_id = 0
    test_mode_file = any(t in dataset_file for t in ("train_test", "valid_test", "test_test"))

    for dialog in dialog_data["dialogs"]:
        if include_caption in ("caption", "summary"):
            caption = words2ids(dialog[include_caption], vocab)
        elif include_caption == "caption,summary":
            caption = words2ids(dialog["caption"] + dialog["summary"], vocab)
        else:
            caption = np.array([PAD], dtype=np.int32)

        questions = [words2ids(d["question"], vocab) for d in dialog["dialog"]]
        answers = [words2ids(d["answer"], vocab) for d in dialog["dialog"]]
        qa_pair = [np.concatenate((q, a)).astype(np.int32)
                   for q, a in zip(questions, answers)]
        vid = dialog["image_id"]
        if vid not in seen:
            seen.add(vid)
            vid_set.append(vid)

        turns = range(len(questions) - 1, len(questions)) if undisclosed_only \
            else range(len(questions))
        for n in turns:
            if undisclosed_only and dialog["dialog"][n]["answer"] != "__UNDISCLOSED__":
                raise ValueError(
                    f"undisclosed_only expects __UNDISCLOSED__ answers, got "
                    f"{dialog['dialog'][n]['answer']!r} for {vid}")
            if _with_caption(include_caption) and separate_caption:
                history_parts = [np.array([PAD], dtype=np.int32)]
            else:
                history_parts = [caption]
            start = max(0, n - max_history_length) if max_history_length > 0 else 0
            for m in range(start, n):
                history_parts.append(qa_pair[m])
            history = np.concatenate(history_parts).astype(np.int32) \
                if len(history_parts) > 1 else history_parts[0]
            question = questions[n]
            if merge_source:
                question = np.concatenate((caption, history, question)).astype(np.int32)
            examples.append(Example(
                vid=vid, qa_id=qa_id,
                history=history, question=question,
                answer_in=answers[n][:-1], answer_out=answers[n][1:],
                caption=caption if (_with_caption(include_caption) and separate_caption)
                else None,
            ))
            qa_id += 1
        if test_mode_file and qa_id > 100:
            break

    return AVSDData(examples=examples, vocab=vocab, original=dialog_data,
                    vid_set=vid_set)


def cut_answer(answer_in: np.ndarray, answer_out: np.ndarray,
               rng: np.random.Generator):
    """Random answer truncation to simulate partial decoding.

    Reference Dataset.__getitem__ (data/dataset.py:33-38): with p=0.5 pick
    end_idx ∈ [1, len(answer_in)), answer_out = answer_in[1:end_idx] +
    [answer_in[end_idx]], answer_in = answer_in[:end_idx]."""
    if rng.uniform() >= 0.5 and len(answer_in) > 1:
        end_idx = int(rng.integers(1, len(answer_in)))
        new_out = np.concatenate((answer_in[1:end_idx], [answer_in[end_idx]]))
        return answer_in[:end_idx].astype(np.int32), new_out.astype(np.int32)
    return answer_in, answer_out
