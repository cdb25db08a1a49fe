"""Evaluation iterator: AVSD examples + feature stores → static-shape
Batches in dataset order (the eval side of `bist_tpu.data.loader`; the
shuffled, answer-cutting training iteration arrives with the training
slice)."""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

from bist_tpu_torch.data.avsd import AVSDData, Example
from bist_tpu_torch.data.batching import Batch, BatchMeta, bucket_len, make_batch
from bist_tpu_torch.data.features import FeatureStore


class AVSDLoader:
    def __init__(self, data: AVSDData,
                 visual_stores: Sequence[FeatureStore] = (),
                 audio_stores: Sequence[FeatureStore] = (),
                 batch_size: int = 32,
                 len_buckets: Sequence[int] = (16, 32, 64, 128, 256),
                 time_buckets: Sequence[int] = (16, 32, 48, 64)):
        self.data = data
        self.visual_stores = list(visual_stores)
        self.audio_stores = list(audio_stores)
        self.batch_size = batch_size
        self.len_buckets = tuple(len_buckets)
        self.time_buckets = tuple(time_buckets)

    def __len__(self) -> int:
        n = len(self.data.examples)
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[Batch, BatchMeta]]:
        exs = self.data.examples
        for s in range(0, len(exs), self.batch_size):
            yield self._assemble(exs[s:s + self.batch_size])

    def _assemble(self, exs: List[Example]) -> Tuple[Batch, BatchMeta]:
        vids = [e.vid for e in exs]

        def _features(store):
            t_pad = bucket_len(store.max_t(vids), self.time_buckets)
            return store.get_batch(vids, t_pad)

        batch = make_batch(
            [e.history for e in exs], [e.question for e in exs],
            [e.answer_in for e in exs], [e.answer_out for e in exs],
            captions=[e.caption for e in exs] if exs[0].caption is not None
            else None,
            len_buckets=self.len_buckets)
        batch = batch._replace(
            fts=_features(self.visual_stores[0]) if self.visual_stores else None,
            audio_fts=_features(self.audio_stores[0]) if self.audio_stores
            else None)
        meta = BatchMeta(vids=vids, qa_ids=[e.qa_id for e in exs],
                         real_count=len(exs))
        return batch, meta
