"""Profiling and observability helpers, the port of the JAX package's
``train/profiling.py``:

  * ``StepTimer``: EMA step time and ETA (copied as it is);
  * ``trace(logdir)``: ``torch.profiler`` over the block (CPU, and CUDA when
    a card is present), written as a Chrome trace into `logdir`;
  * ``annotate(name)``: a named range in that trace
    (``torch.profiler.record_function``);
  * ``device_memory_stats()``: ``torch.cuda.memory_stats`` per card, ``{}``
    without one;
  * ``log_memory_stats(prefix)``: allocated and reserved bytes per card. It
    takes the place of the JAX ``log_compile_stats``, whose only output is a
    count of live arrays: eager PyTorch has no jit cache to report.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("unidet3d_tpu_torch")


class StepTimer:
    def __init__(self, ema: float = 0.98):
        self.ema = ema
        self._avg = None
        self._last = None

    def tick(self) -> float | None:
        """Call once per step; returns smoothed step time (s) or None."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return None
        dt = now - self._last
        self._last = now
        self._avg = dt if self._avg is None else (
            self.ema * self._avg + (1 - self.ema) * dt
        )
        return self._avg

    def eta(self, steps_left: int) -> float | None:
        return None if self._avg is None else self._avg * steps_left


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block: ``with trace('traces/'): step()`` writes
    ``logdir/trace-<pid>-<ns>.json`` (open it in Perfetto or
    chrome://tracing) and yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def annotate(name: str):
    """A named range on the profiler's host timeline (and its kernels')."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict:
    """{"cuda:i": torch.cuda.memory_stats(i)} for every card; {} without."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}


def log_memory_stats(prefix: str = "") -> None:
    """Logs each card's allocated and reserved bytes (current and peak)."""
    for name, st in device_memory_stats().items():
        log.info("%s%s memory: allocated %d (peak %d), reserved %d (peak %d) bytes",
                 prefix, name, st.get("allocated_bytes.all.current", 0),
                 st.get("allocated_bytes.all.peak", 0),
                 st.get("reserved_bytes.all.current", 0),
                 st.get("reserved_bytes.all.peak", 0))
