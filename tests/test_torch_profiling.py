"""The port's spans and memory helpers (``unidet3d_tpu_torch/train/profiling.py``):
``span`` nests, returns its seconds and adds them to ``SPANS`` from many
threads at once without losing one; an unknown name raises; a
``record_function`` range opens only while a profiler runs, and then the
span is a user annotation of the trace, inside its parent; the memory
helpers are empty without a card. The spans' places in the loader, the eval
loop, the step and ``train`` are tested beside those
(``test_torch_loader.py``, ``test_torch_eval_loop.py``,
``test_torch_train_loop.py``)."""
import logging
import os
import sys
import threading

import pytest
import torch

from unidet3d_tpu_torch.train import profiling
from unidet3d_tpu_torch.train.profiling import SPAN_NAMES, SpanTotals, span


@pytest.fixture
def totals(monkeypatch):
    """A fresh SPANS for the test: the process-wide one is never reset."""
    fresh = SpanTotals()
    monkeypatch.setattr(profiling, "SPANS", fresh)
    return fresh


class RangeSpy:
    """Stands in for torch.profiler.record_function and records its calls."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, name, args=None):
        self.calls.append((name, args))
        return self.real(name, args)


def test_span_names_are_the_layer_boundaries():
    assert SPAN_NAMES == (
        "loader.pipeline", "loader.collate", "loader.pack", "loader.stage",
        "eval.open", "eval.wait", "eval.forward", "eval.decoder", "eval.post", "post.trim",
        "post.nms", "post.masks", "eval.fetch", "eval.metric", "eval.compute",
        "step", "step.forward", "step.loss", "step.backward", "step.optimizer",
        "train.wait", "train.checkpoint")


def test_span_nests_and_returns_its_seconds(totals):
    before = totals.snapshot()
    with span("step", 3) as outer:
        assert outer.seconds is None
        with span("step.forward") as inner:
            torch.ones(256).sum()
        with span("step.loss") as other:
            pass
    assert 0 <= inner.seconds and 0 <= other.seconds
    assert outer.seconds >= inner.seconds + other.seconds
    assert totals.snapshot() == {"step": (1, outer.seconds), "step.forward": (1, inner.seconds),
                                 "step.loss": (1, other.seconds)}
    assert totals.since(before) == {"step": outer.seconds, "step.forward": inner.seconds,
                                    "step.loss": other.seconds}
    mark = totals.snapshot()
    with span("step.loss") as again:
        pass
    assert totals.since(mark) == {"step.loss": pytest.approx(again.seconds, abs=1e-12)}
    assert totals.snapshot()["step.loss"][0] == 2


def test_spans_add_up_from_many_threads(totals):
    """More threads than cores, a short switch interval: a lost update would
    show in the counts."""
    n_threads, n_spans = (os.cpu_count() or 4) + 4, 300
    seconds = [[] for _ in range(n_threads)]
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait(timeout=60)
        for k in range(n_spans):
            with span("loader.collate" if k % 2 else "loader.pack") as s:
                pass
            seconds[i].append(s.seconds)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = totals.snapshot()
    half = n_threads * n_spans // 2
    assert snap["loader.collate"][0] == snap["loader.pack"][0] == half
    got = snap["loader.collate"][1] + snap["loader.pack"][1]
    assert got == pytest.approx(sum(map(sum, seconds)), rel=1e-9)


@pytest.mark.parametrize("name", ["eval", "step.fwd", "Step"])
def test_unknown_span_name_raises(name, totals):
    with pytest.raises(ValueError, match="unknown span"):
        span(name)
    assert totals.snapshot() == {}


def test_no_range_opens_without_a_profiler(monkeypatch, totals):
    spy = RangeSpy(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    assert not torch.autograd._profiler_enabled()
    with span("eval.post", 4):
        with span("post.nms"):
            pass
    assert spy.calls == []
    assert totals.snapshot()["post.nms"][0] == 1


def test_span_is_a_user_annotation_under_the_profiler(monkeypatch, totals):
    spy = RangeSpy(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("eval.post", 7):
            with span("post.trim"):
                (torch.ones(64) * 2).sum()
    assert spy.calls == [("eval.post", "7"), ("post.trim", None)]
    events = {e.name: e for e in prof.events() if e.name in SPAN_NAMES}
    assert set(events) == {"eval.post", "post.trim"}
    parent, child = events["eval.post"], events["post.trim"]
    assert parent.is_user_annotation and child.is_user_annotation
    assert parent.time_range.start <= child.time_range.start
    assert child.time_range.end <= parent.time_range.end
    assert child.cpu_parent is parent
    assert {c.name for c in child.cpu_children} >= {"aten::mul", "aten::sum"}
    assert [totals.snapshot()[k][0] for k in ("eval.post", "post.trim")] == [1, 1]


def test_memory_stats_without_a_card(caplog):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert profiling.device_memory_stats() == {}
    with caplog.at_level(logging.INFO, logger="unidet3d_tpu_torch"):
        profiling.log_memory_stats("x ")
    assert caplog.messages == []
