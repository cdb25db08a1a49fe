"""Per-video .npy feature store with host-side prefetch (after
`bist_tpu.data.features`).

Reference behaviour (data/data_handler.py:111-133, 168-176;
data/dataset.py:146-151): path template "<FeaType>/<ImageID>.npy" under a base
dir, 'rgb'-type features subsampled [::skip], 3-D+ features reshaped to
(T, S, D) = (shape[0], -1, shape[-1]), features whose type names 'vggish' are
audio.  As in `bist_tpu`: a batch is assembled by the native C++ thread pool
(`native.loader`, numpy where it cannot be built), T comes from the files'
headers, and a thread pool of `workers` prefetches the next batch's files
into a bounded LRU cache while the current batch is assembled and stepped.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bist_tpu_torch.native.loader import assemble_feature_batch, probe_npy_shape


def load_npy_tsd(filepath: str) -> np.ndarray:
    """np.load + (T, S, D) canonicalisation (reference dataset.py:146-151)."""
    feature = np.load(filepath)
    if feature.ndim == 2:
        return feature
    return feature.reshape((feature.shape[0], -1, feature.shape[-1]))


class FeatureStore:
    """Features of one type: vid → file, assembled into batches by the
    native loader, single files loaded on demand, cached and prefetched by a
    pool of `workers` threads (none for 0)."""

    def __init__(self, fea_type: str, fea_path_template: str,
                 skip: int = 1, cache_items: int = 512, workers: int = 4):
        self.fea_type = fea_type
        self.template = fea_path_template.replace("<FeaType>", fea_type)
        self.skip = skip
        self.eager = "rgb" in fea_type          # data_handler.py:122-125
        self.is_audio = "vggish" in fea_type    # dataset.py:175-179
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._shape_cache: Dict[str, tuple] = {}
        self._cache_items = cache_items
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=workers) if workers > 0 else None
        self._paths: Dict[str, str] = {}

    def register(self, vids: Sequence[str]) -> None:
        for vid in vids:
            self._paths[vid] = self.template.replace("<ImageID>", vid)

    def path(self, vid: str) -> str:
        return self._paths.get(vid) or self.template.replace("<ImageID>", vid)

    def _load(self, vid: str) -> np.ndarray:
        arr = load_npy_tsd(self.path(vid))
        if self.eager and self.skip > 1:
            arr = arr[:: self.skip]
        return np.asarray(arr, dtype=np.float32)

    def get(self, vid: str) -> np.ndarray:
        with self._lock:
            if vid in self._cache:
                self._cache.move_to_end(vid)
                return self._cache[vid]
        arr = self._load(vid)
        with self._lock:
            self._cache[vid] = arr
            self._cache.move_to_end(vid)
            while len(self._cache) > self._cache_items:
                self._cache.popitem(last=False)
        return arr

    def prefetch(self, vids: Sequence[str]) -> None:
        """Load the files of `vids` into the cache on the pool's threads (a
        no-op without workers); a later read finds them there or in the
        page cache (and a file that fails to load fails there)."""
        if self._pool is None:
            return
        for vid in vids:
            with self._lock:
                if vid in self._cache:
                    continue
            self._pool.submit(self.get, vid)

    def shape_of(self, vid: str) -> tuple:
        """(T, S, D) or (T, D) from the file's .npy header (no payload read),
        cached; canonicalised as load_npy_tsd does."""
        s = self._shape_cache.get(vid)
        if s is None:
            raw = probe_npy_shape(self.path(vid))
            s = (raw[0], int(np.prod(raw[1:-1])), raw[-1]) if len(raw) > 2 else raw
            self._shape_cache[vid] = s
        return s

    def get_batch(self, vids: Sequence[str], t_pad: int,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        """A zero-padded (B, t_pad, *tail) float32 batch, by the native
        assembler (the files' payloads straight into the batch), or for
        subsampled eager features through `get`; written into `out` (a
        C-ordered float32 array of that shape) when it is given."""
        tail = self.shape_of(vids[0])[1:]
        if self.eager and self.skip > 1:
            if out is None:
                out = np.empty((len(vids), t_pad) + tuple(tail), np.float32)
            out[...] = 0.0
            for i, f in enumerate(self.get(v) for v in vids):
                k = min(f.shape[0], t_pad)
                out[i, :k] = f.reshape(f.shape[0], *tail)[:k]
            return out
        return assemble_feature_batch([self.path(v) for v in vids], t_pad, tuple(tail),
                                      out=out)

    def max_t(self, vids: Sequence[str]) -> int:
        return max(self.shape_of(v)[0] for v in vids)

    def dim(self) -> int:
        """Trailing feature dim, from the first registered file's header
        (reference feature_shape, data_handler.py:168-176)."""
        return int(self.shape_of(next(iter(self._paths)))[-1])


def build_stores(fea_types: Optional[Sequence[str]], fea_path_template: str,
                 vids: Sequence[str], skip: int = 1, workers: int = 4,
                 ) -> Tuple[List[FeatureStore], List[FeatureStore]]:
    """(visual_stores, audio_stores); fea_types None / ['none'] yields no
    stores (text-only, data_handler.py:112-114).  `workers` sizes each
    store's prefetch pool (the CLIs' --num-workers, at least 1; the native
    assembler has its own C++ thread pool)."""
    visual: List[FeatureStore] = []
    audio: List[FeatureStore] = []
    if not fea_types or fea_types[0] == "none":
        return visual, audio
    for ftype in fea_types:
        if ftype == "none":
            continue
        store = FeatureStore(ftype, fea_path_template, skip=skip,
                             workers=max(workers, 1))
        store.register(vids)
        (audio if store.is_audio else visual).append(store)
    return visual, audio


def feature_shape(stores: Sequence[FeatureStore]) -> List[int]:
    return [s.dim() for s in stores]
