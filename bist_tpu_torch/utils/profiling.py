"""Step-time and throughput accounting (after `bist_tpu.utils.profiling`'s
`StepTimer`).

On a CUDA device a step's time is read from CUDA events recorded around it,
so it counts the device work the step queued, not only the host's enqueue;
the events are read once, in `summary()`, so the loop never waits on them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


class StepTimer:
    """Step-time/throughput accounting with warmup discard.

    >>> timer = StepTimer(warmup=2, device=torch.device("cuda"))
    >>> for batch in loader:
    ...     with timer.step(items=batch_size):
    ...         run(batch)
    >>> timer.summary()   # {'steps': n, 'mean_s': ..., 'p50_s': ..., 'items_per_s': ...}
    """

    def __init__(self, warmup: int = 1, device: Optional[torch.device] = None):
        self.warmup = warmup
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._times: List[float] = []
        self._events: List[tuple] = []
        self._items: List[int] = []
        self._n_seen = 0

    @contextlib.contextmanager
    def step(self, items: int = 1):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
        else:
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self._n_seen += 1
        if self._n_seen > self.warmup:
            if self.cuda:
                self._events.append((start, end))
            else:
                self._times.append(dt)
            self._items.append(items)

    def summary(self) -> Dict[str, float]:
        times = self._times
        if self.cuda and self._events:
            self._events[-1][1].synchronize()
            times = [s.elapsed_time(e) / 1e3 for s, e in self._events]
        if not times:
            return {"steps": 0, "mean_s": 0.0, "p50_s": 0.0, "items_per_s": 0.0}
        total_t = sum(times)
        return {
            "steps": len(times),
            "mean_s": total_t / len(times),
            "p50_s": sorted(times)[len(times) // 2],
            "items_per_s": sum(self._items) / total_t if total_t > 0 else 0.0,
        }
