"""Epoch iterator: AVSD examples + feature stores → static-shape Batches (a
copy of `bist_tpu.data.loader`).

  * length-grouped batching for training: examples are ordered by history
    length within shuffled chunks, so batches are shape-homogeneous while
    the batch order stays random; without `shuffle`, dataset order;
  * every array is padded to bucket sizes (see batching.bucket_len);
  * `cut_a` random answer truncation is re-drawn per epoch per example
    (reference Dataset.__getitem__, dataset.py:33-38);
  * one numpy `default_rng(seed)` drives the shuffle and the cuts in the
    JAX package's order of draws, so both packages give the same batches for
    the same seed;
  * the next batch's feature files are prefetched while the current batch
    is assembled (features.FeatureStore.prefetch);
  * with `pin_memory` the feature grids are assembled straight into pinned
    host memory, which a copy to the card reads without blocking.

`device_prefetch` moves upcoming batches to the device on a background
thread while the current step runs.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from bist_tpu_torch.data.avsd import AVSDData, Example, cut_answer
from bist_tpu_torch.data.batching import Batch, BatchMeta, bucket_len, make_batch
from bist_tpu_torch.data.features import FeatureStore

GROUP_CHUNK = 16      # batches per length-sorted chunk of the training shuffle
PREFETCH_DEPTH = 2    # batches device_prefetch prepares ahead of the step


class AVSDLoader:
    def __init__(self, data: AVSDData,
                 visual_stores: Sequence[FeatureStore] = (),
                 audio_stores: Sequence[FeatureStore] = (),
                 batch_size: int = 32, shuffle: bool = True,
                 cut_a: bool = False, seed: int = 1,
                 len_buckets: Sequence[int] = (16, 32, 64, 128, 256),
                 time_buckets: Sequence[int] = (16, 32, 48, 64),
                 pad_batch_multiple: int = 1, pin_memory: bool = False):
        self.data = data
        self.visual_stores = list(visual_stores)
        self.audio_stores = list(audio_stores)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.cut_a = cut_a
        self.rng = np.random.default_rng(seed)
        self.len_buckets = tuple(len_buckets)
        self.time_buckets = tuple(time_buckets)
        self.pad_batch_multiple = max(1, pad_batch_multiple)
        self.pin_memory = pin_memory

    def __len__(self) -> int:
        n = len(self.data.examples)
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        n = len(self.data.examples)
        idx = np.arange(n)
        if not self.shuffle:
            return idx
        # length-grouped shuffle: shuffle → stable-sort by history length in
        # chunks of (GROUP_CHUNK · batch_size) → batch → shuffle batch order.
        self.rng.shuffle(idx)
        chunk = GROUP_CHUNK * self.batch_size
        out = []
        lens = np.array([len(self.data.examples[i].history) for i in idx])
        for s in range(0, n, chunk):
            out.append(idx[s:s + chunk][np.argsort(lens[s:s + chunk], kind="stable")])
        idx = np.concatenate(out)
        batches = [idx[s:s + self.batch_size] for s in range(0, n, self.batch_size)]
        self.rng.shuffle(batches)
        return np.concatenate(batches)

    def __iter__(self) -> Iterator[Tuple[Batch, BatchMeta]]:
        order = self._epoch_order()
        bs = self.batch_size
        for s in range(0, len(order), bs):
            # the next batch's files load on the stores' pools while this
            # batch is assembled
            nxt = [self.data.examples[i].vid for i in order[s + bs:s + 2 * bs]]
            for store in self.visual_stores + self.audio_stores:
                store.prefetch(nxt)
            yield self._assemble([self.data.examples[i] for i in order[s:s + bs]])

    def _assemble(self, exs: List[Example]) -> Tuple[Batch, BatchMeta]:
        ans_in, ans_out = [], []
        for e in exs:
            ai, ao = (cut_answer(e.answer_in, e.answer_out, self.rng)
                      if self.cut_a else (e.answer_in, e.answer_out))
            ans_in.append(ai)
            ans_out.append(ao)
        vids = [e.vid for e in exs]
        m = self.pad_batch_multiple
        n_rows = (len(exs) + m - 1) // m * m

        def _features(store):
            t_pad = bucket_len(store.max_t(vids), self.time_buckets)
            shape = (n_rows, t_pad) + tuple(store.shape_of(vids[0])[1:])
            arr = (torch.empty(shape, dtype=torch.float32, pin_memory=True).numpy()
                   if self.pin_memory else np.empty(shape, np.float32))
            store.get_batch(vids, t_pad, out=arr[:len(exs)])
            arr[len(exs):] = 0.0
            return arr

        batch = make_batch(
            [e.history for e in exs], [e.question for e in exs], ans_in, ans_out,
            captions=[e.caption for e in exs] if exs[0].caption is not None
            else None,
            len_buckets=self.len_buckets, pad_batch_to=n_rows)
        batch = batch._replace(
            fts=_features(self.visual_stores[0]) if self.visual_stores else None,
            audio_fts=_features(self.audio_stores[0]) if self.audio_stores
            else None)
        meta = BatchMeta(vids=vids, qa_ids=[e.qa_id for e in exs],
                         real_count=len(exs))
        return batch, meta


def device_prefetch(iterator, prepare=None):
    """Background-thread prefetch: runs `prepare(batch)` (e.g. int8
    quantisation and the move to the device) for upcoming batches while the
    current step runs.  Yields (prepared_batch, meta); a loader error is
    raised in the consumer.  The producer stops when the consumer leaves
    early (an error, KeyboardInterrupt), so no thread or batch leaks."""
    import queue as _queue
    import threading

    q: "_queue.Queue" = _queue.Queue(maxsize=PREFETCH_DEPTH)
    err = []
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def producer():
        try:
            for batch, meta in iterator:
                if prepare is not None:
                    batch = prepare(batch)
                if not _put((batch, meta)):
                    return
        except BaseException as e:  # surface loader errors in the consumer
            err.append(e)
        finally:
            _put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            yield item
    finally:
        stop.set()
        while True:                      # unblock a producer stuck in _put
            try:
                q.get_nowait()
            except _queue.Empty:
                break
        t.join()
    if err:
        raise err[0]
