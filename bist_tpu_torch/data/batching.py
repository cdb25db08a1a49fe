"""Static-shape batch assembly (a copy of `bist_tpu.data.batching`) and the
move of a host batch onto a torch device.

Sequence axes pad up to bucket sizes so a run sees a handful of shapes.
Masks are not stored in the batch: `models.model.build_masks` derives them
from the padded tokens and features.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from bist_tpu_torch.vocab import PAD


class Batch(NamedTuple):
    """One batch, padded with PAD (tokens) or zeros (features); absent
    modalities are None.  Host batches hold numpy arrays, device batches
    torch tensors (`to_device`)."""

    query: np.ndarray            # (B, Lq) int32
    his: np.ndarray              # (B, Lh) int32
    trg: np.ndarray              # (B, Lt) int32   — answer_in
    trg_y: np.ndarray            # (B, Lt) int32   — answer_out
    cap: Optional[np.ndarray] = None        # (B, Lc) int32
    fts: Optional[np.ndarray] = None        # (B, T, S, Dv) float (or int8
                                            #  with fts_scale set)
    audio_fts: Optional[np.ndarray] = None  # (B, Ta, Da) float
    fts_scale: Optional[np.ndarray] = None  # (B, T, S, 1) f32 — per-position
                                            #  dequant scale for int8 fts


def to_device(batch: Batch, device) -> Batch:
    """Every array of `batch` as a tensor on `device` (None stays None)."""
    return Batch(*[None if x is None else torch.as_tensor(x).to(device)
                   for x in batch])


def pinned(batch: Batch, device) -> Batch:
    """Every array of `batch` as a CPU tensor, for a CUDA `device` in pinned
    memory (an array pinned already is kept), so that a copy to the card
    does not make the host wait for the work queued on the stream."""
    def pin(x):
        t = torch.as_tensor(x)
        return t if torch.device(device).type != "cuda" or t.is_pinned() else t.pin_memory()

    return Batch(*[None if x is None else pin(x) for x in batch])


def quantize_features(fts: np.ndarray):
    """Symmetric per-position int8 quantisation of a (B, T, S, D) grid:
    (int8 grid, (B, T, S, 1) f32 scale); zero rows stay exactly zero, so the
    validity masks still see them."""
    amax = np.max(np.abs(fts), axis=-1, keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.round(fts / safe), -127, 127).astype(np.int8)
    return q, scale


class BatchMeta(NamedTuple):
    """Host-side metadata travelling alongside a Batch."""
    vids: List[str]
    qa_ids: List[int]
    real_count: int              # rows < real_count are genuine examples


def bucket_len(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n; past the largest, the next multiple of it."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def pad_to(seqs: Sequence[np.ndarray], length: int, pad_value: int = PAD,
           dtype=np.int32) -> np.ndarray:
    """Stack 1-D int sequences into (B, length), right-padded (longer ones
    are truncated)."""
    out = np.full((len(seqs), length), pad_value, dtype=dtype)
    for i, s in enumerate(seqs):
        k = min(len(s), length)
        out[i, :k] = s[:k]
    return out


def pad_features(fts: Sequence[np.ndarray], t_len: int, tail=None,
                 pad_rows: int = 0, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Stack (Ti, ...) feature arrays into (B + pad_rows, t_len, ...) float32,
    zero-padded on T (longer ones truncated); the pad_rows extra rows (batch
    padding to a bucket) are all-zero.  `tail` pins the per-step shape (a
    server's pinned grid); by default the first array's.  `out`, a float32
    array of that shape, receives the grid (each element written once)."""
    tail = tuple(tail) if tail is not None else fts[0].shape[1:]
    shape = (len(fts) + pad_rows, t_len) + tail
    if out is None:
        out = np.empty(shape, dtype=np.float32)
    for i, f in enumerate(fts):
        k = min(f.shape[0], t_len)
        out[i, :k] = f[:k]
        out[i, k:] = 0.0
    out[len(fts):] = 0.0
    return out


def pad_tokens(seqs: Sequence[np.ndarray], buckets: Sequence[int],
               n_rows: int = 0) -> np.ndarray:
    """Bucket + pad 1-D token sequences into (max(len(seqs), n_rows), L), L
    the smallest bucket covering the longest sequence; rows beyond len(seqs)
    are all-PAD (batch padding, masked everywhere downstream)."""
    arr = pad_to(seqs, bucket_len(max(len(s) for s in seqs), buckets))
    if n_rows > len(seqs):
        arr = np.concatenate(
            [arr, np.full((n_rows - len(seqs), arr.shape[1]), PAD, np.int32)])
    return arr


def make_batch(histories: Sequence[np.ndarray],
               questions: Sequence[np.ndarray],
               answers_in: Sequence[np.ndarray],
               answers_out: Sequence[np.ndarray],
               captions: Optional[Sequence[np.ndarray]] = None,
               len_buckets: Sequence[int] = (16, 32, 64, 128, 256),
               pad_batch_to: int = 0) -> Batch:
    """Assemble the token fields of a static-shape Batch from ragged
    per-example arrays (features are assembled by data.features).
    pad_batch_to > len(histories) adds all-PAD rows: their token counts are
    0, so they add nothing to the loss (a tail batch padded to a multiple of
    the gradient-accumulation microbatches)."""
    n_rows = max(len(histories), pad_batch_to)
    trg = pad_tokens(answers_in, len_buckets, n_rows)
    return Batch(query=pad_tokens(questions, len_buckets, n_rows),
                 his=pad_tokens(histories, len_buckets, n_rows), trg=trg,
                 trg_y=pad_to(list(answers_out) + [()] * (n_rows - len(answers_out)),
                              trg.shape[1]),
                 cap=pad_tokens(captions, len_buckets, n_rows)
                 if captions is not None else None)
