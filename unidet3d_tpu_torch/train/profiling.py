"""Spans and memory statistics, the port's observability helpers:

  * ``span(name, key=None)``: a named stretch of host time at a layer
    boundary of the program (``SPAN_NAMES``). On exit it adds its count and
    seconds to ``SPANS``, the process-wide totals, and exposes its own
    ``seconds``. While a profiler runs it is also a
    ``torch.profiler.record_function`` range, so that the profiler's trace
    holds it on the same clock as the kernels;
  * ``SPANS``: cumulative counts and seconds per span name, never reset: a
    consumer subtracts an earlier ``snapshot()`` (``since``);
  * ``device_memory_stats()``: ``torch.cuda.memory_stats`` per card, ``{}``
    without one;
  * ``log_memory_stats(prefix)``: allocated and reserved bytes per card. It
    takes the place of the JAX ``log_compile_stats``, whose only output is a
    count of live arrays: eager PyTorch has no jit cache to report.
"""
from __future__ import annotations

import logging
import threading
import time

import torch

log = logging.getLogger("unidet3d_tpu_torch")

# Every span the program opens, by layer. Children lie inside their parent:
# eval.decoder (OneFormer3D's decoder) inside eval.forward, post.* inside
# eval.post, step.* inside step.
SPAN_NAMES = (
    # data/loader.py::_build, on the loaders' worker threads
    "loader.pipeline", "loader.collate", "loader.pack", "loader.stage",
    # train/loop.py::evaluate (and models/postprocess.py, models/
    # instance_postprocess.py, models/oneformer3d.py), on its thread
    "eval.open", "eval.wait", "eval.forward", "eval.decoder", "eval.post", "post.trim",
    "post.nms", "post.masks", "eval.fetch", "eval.metric", "eval.compute",
    # parallel/train_step.py::make_train_step
    "step", "step.forward", "step.loss", "step.backward", "step.optimizer",
    # train/loop.py::train
    "train.wait", "train.checkpoint",
)
_KNOWN = frozenset(SPAN_NAMES)


class SpanTotals:
    """Thread-safe cumulative {name: [count, seconds]}."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: dict = {}

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._totals.setdefault(name, [0, 0.0])
            t[0] += 1
            t[1] += seconds

    def snapshot(self) -> dict:
        """{name: (count, seconds)} of every span closed so far."""
        with self._lock:
            return {k: (c, s) for k, (c, s) in self._totals.items()}

    def since(self, before: dict, after: dict | None = None) -> dict:
        """{name: seconds} of the spans closed after the snapshot `before`
        (and up to the snapshot `after`, else up to now)."""
        out = {}
        for name, (count, seconds) in (self.snapshot() if after is None else after).items():
            c0, s0 = before.get(name, (0, 0.0))
            if count > c0:
                out[name] = seconds - s0
        return out


# Process-global instance: loader threads, the loops and the step share it.
SPANS = SpanTotals()


class span:
    """``with span("eval.post", key=g) as s: ...``; ``s.seconds`` after the
    block. `key` (a group index, a step number) becomes the profiler range's
    args. With no profiler running the cost is two clock reads and one
    locked add."""

    __slots__ = ("name", "key", "seconds", "_t0", "_range")

    def __init__(self, name: str, key=None):
        if name not in _KNOWN:
            raise ValueError(f"unknown span {name!r}; SPAN_NAMES lists {SPAN_NAMES}")
        self.name = name
        self.key = key
        self.seconds = None
        self._range = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(
                self.name, None if self.key is None else str(self.key))
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        SPANS.add(self.name, self.seconds)
        return False


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
