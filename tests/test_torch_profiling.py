"""The port's profiling helpers (``unidet3d_tpu_torch/train/profiling.py``):
``StepTimer`` equal to the JAX one on the same clock readings, ``trace``
writing a Chrome trace with the ``annotate`` range on the CPU, and the memory
helpers empty without a card."""
import json
import logging
import os

import pytest
import torch

from unidet3d_tpu.train import profiling as jax_profiling
from unidet3d_tpu_torch.train import profiling


def readings(monkeypatch, clock):
    values = iter(clock)
    monkeypatch.setattr("time.perf_counter", lambda: next(values))


@pytest.mark.parametrize("ema", [0.98, 0.5])
def test_step_timer_equals_jax_on_one_clock(monkeypatch, ema):
    clock = [10.0, 10.5, 10.75, 12.0, 12.1, 15.0]
    out = {}
    for name, mod in (("mine", profiling), ("ref", jax_profiling)):
        readings(monkeypatch, clock)
        timer = mod.StepTimer(ema=ema)
        assert timer.eta(5) is None
        out[name] = [(timer.tick(), timer.eta(7)) for _ in clock]
    assert out["mine"] == out["ref"]
    assert out["mine"][0] == (None, None) and out["mine"][1][0] == 0.5


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path, caplog):
    logdir = str(tmp_path / "trace")
    with caplog.at_level(logging.INFO, logger="unidet3d_tpu_torch"):
        with profiling.trace(logdir):
            with profiling.annotate("train_step"):
                (torch.ones(64) * 2).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "train_step" for e in events)
    assert any("profiler trace written" in m for m in caplog.messages)


def test_memory_stats_without_a_card(caplog):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert profiling.device_memory_stats() == {}
    with caplog.at_level(logging.INFO, logger="unidet3d_tpu_torch"):
        profiling.log_memory_stats("x ")
    assert caplog.messages == []
