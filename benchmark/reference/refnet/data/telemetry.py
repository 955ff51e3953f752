"""Capacity-drop counters: a visible count for every truncation.

The port's copy of the JAX package's ``data/telemetry.py``. The batch is
padded to fixed capacities; inputs beyond a cap are subsampled, folded or
dropped, which is harmless when the caps are sized right and corrupts
training silently when they are not. Every truncation site adds to a named
counter here. Thread-safe (loader workers add concurrently). Counters:

  points_dropped        collate: scene points beyond cfg.max_points subsampled
  gts_dropped           collate: GT boxes beyond cfg.max_gts truncated
  superpoints_folded    collate: points whose superpoint id >= max_superpoints,
                        folded into slot S - 1
  instances_dropped     collate: instance-mask points whose id >= max_gts
  voxels_dropped        collate's pack: valid points whose level-0 voxel
                        overflowed the level's capacity
  coarse_voxels_dropped collate's pack: level >= 1 voxels whose parent
                        overflowed the next level's capacity
"""
from __future__ import annotations

import threading
from collections import defaultdict


class DropCounters:
    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict = defaultdict(int)

    def add(self, name: str, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self._counts[name] += int(n)

    def snapshot(self, reset: bool = False) -> dict:
        """The nonzero counters; with `reset`, cleared after the read (one
        log interval's drops)."""
        with self._lock:
            out = {k: v for k, v in self._counts.items() if v}
            if reset:
                self._counts.clear()
        return out

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def format(self, counts: dict | None = None) -> str:
        c = self.snapshot() if counts is None else counts
        return " ".join(f"{k}={v}" for k, v in sorted(c.items()))


# Process-global instance: loader threads and the training loop share it.
DROPS = DropCounters()
