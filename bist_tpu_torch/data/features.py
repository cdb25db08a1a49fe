"""Per-video .npy feature store, read path (after `bist_tpu.data.features`).

Reference behaviour (data/data_handler.py:111-133, 168-176;
data/dataset.py:146-151): path template "<FeaType>/<ImageID>.npy" under a base
dir, 'rgb'-type features subsampled [::skip], 3-D+ features reshaped to
(T, S, D) = (shape[0], -1, shape[-1]), features whose type names 'vggish' are
audio.  Files are read when a batch asks for them, with a bounded LRU cache.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def load_npy_tsd(filepath: str) -> np.ndarray:
    """np.load + (T, S, D) canonicalisation (reference dataset.py:146-151)."""
    feature = np.load(filepath)
    if feature.ndim == 2:
        return feature
    return feature.reshape((feature.shape[0], -1, feature.shape[-1]))


class FeatureStore:
    """Features of one type: vid → file, loaded on demand and cached."""

    def __init__(self, fea_type: str, fea_path_template: str,
                 skip: int = 1, cache_items: int = 512):
        self.fea_type = fea_type
        self.template = fea_path_template.replace("<FeaType>", fea_type)
        self.skip = skip
        self.eager = "rgb" in fea_type          # data_handler.py:122-125
        self.is_audio = "vggish" in fea_type    # dataset.py:175-179
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._cache_items = cache_items
        self._paths: Dict[str, str] = {}

    def register(self, vids: Sequence[str]) -> None:
        for vid in vids:
            self._paths[vid] = self.template.replace("<ImageID>", vid)

    def path(self, vid: str) -> str:
        return self._paths.get(vid) or self.template.replace("<ImageID>", vid)

    def get(self, vid: str) -> np.ndarray:
        if vid in self._cache:
            self._cache.move_to_end(vid)
            return self._cache[vid]
        arr = load_npy_tsd(self.path(vid))
        if self.eager and self.skip > 1:
            arr = arr[:: self.skip]
        arr = np.asarray(arr, dtype=np.float32)
        self._cache[vid] = arr
        while len(self._cache) > self._cache_items:
            self._cache.popitem(last=False)
        return arr

    def get_batch(self, vids: Sequence[str], t_pad: int) -> np.ndarray:
        """A zero-padded (B, t_pad, *tail) float32 batch."""
        fts = [self.get(v) for v in vids]
        tail = fts[0].shape[1:]
        out = np.zeros((len(vids), t_pad) + tuple(tail), np.float32)
        for i, f in enumerate(fts):
            k = min(f.shape[0], t_pad)
            out[i, :k] = f[:k]
        return out

    def max_t(self, vids: Sequence[str]) -> int:
        return max(self.get(v).shape[0] for v in vids)

    def dim(self) -> int:
        """Trailing feature dim, from the first registered file's header
        (reference feature_shape, data_handler.py:168-176)."""
        vid = next(iter(self._paths))
        return int(np.load(self.path(vid), mmap_mode="r").shape[-1])


def build_stores(fea_types: Optional[Sequence[str]], fea_path_template: str,
                 vids: Sequence[str], skip: int = 1,
                 ) -> Tuple[List[FeatureStore], List[FeatureStore]]:
    """(visual_stores, audio_stores); fea_types None / ['none'] yields no
    stores (text-only, data_handler.py:112-114)."""
    visual: List[FeatureStore] = []
    audio: List[FeatureStore] = []
    if not fea_types or fea_types[0] == "none":
        return visual, audio
    for ftype in fea_types:
        if ftype == "none":
            continue
        store = FeatureStore(ftype, fea_path_template, skip=skip)
        store.register(vids)
        (audio if store.is_audio else visual).append(store)
    return visual, audio


def feature_shape(stores: Sequence[FeatureStore]) -> List[int]:
    return [s.dim() for s in stores]
