"""``harness/spans.py``: the join of the program's spans with the device's
idle gaps on synthetic intervals, the readings of its METRICS, the join
over a CPU profiler's events, and a tiny traced eval cell on the CPU with
the spans in its line."""
import math

import pytest
import torch

from benchmark.harness import spans
from benchmark.tests import tiny


def table(span_list, gaps):
    return spans.join(span_list, gaps)


def test_a_gap_in_a_child_counts_for_the_child_and_its_parent():
    got = table([(0, 100, "step", 5.0), (10, 40, "step.forward", 2.0),
                 (40, 90, "step.backward", 0.0)], [(20, 30), (95, 99)])
    assert got["step.forward"]["idle_s"] == pytest.approx(10e-6)
    assert got["step.backward"]["idle_s"] == 0
    assert got["step"]["idle_s"] == pytest.approx(14e-6)
    assert got["step"]["count"] == 1 and got["step"]["host_s"] == pytest.approx(100e-6)
    assert got["step"]["device_s"] == pytest.approx(5e-6)


def test_a_gap_outside_every_span_counts_nowhere():
    got = table([(0, 10, "eval.wait", 0.0), (30, 40, "eval.wait", 0.0),
                 (12, 28, "eval.forward", 0.0)], [(9, 13), (41, 60)])  # middles 11, 50.5
    assert got["eval.wait"]["idle_s"] == 0 and got["eval.forward"]["idle_s"] == 0
    assert got["eval.wait"]["count"] == 2 and got["eval.wait"]["host_s"] == pytest.approx(20e-6)


def test_disjoint_siblings_add_up_to_no_more_than_the_idle():
    gaps = [(1, 3), (5, 9), (14, 16), (18, 30), (33, 34)]
    got = table([(0, 10, "step.forward", 0.0), (10, 20, "step.loss", 0.0),
                 (20, 32, "step.backward", 0.0)], gaps)
    siblings = sum(got[k]["idle_s"] for k in ("step.forward", "step.loss", "step.backward"))
    total = sum(b - a for a, b in gaps) / 1e6
    assert siblings <= total
    assert siblings == pytest.approx((2 + 4 + 2 + 12) / 1e6)  # (33, 34) lies outside


def test_spans_of_one_name_that_overlap_count_a_gap_once():
    got = table([(0, 50, "eval.wait", 0.0), (20, 80, "eval.wait", 0.0)], [(30, 40)])
    assert got["eval.wait"]["idle_s"] == pytest.approx(10e-6)
    assert got["eval.wait"]["count"] == 2


def test_idle_gaps_include_the_edges_of_the_slice():
    assert spans.idle_gaps([(10, 20), (15, 30), (40, 45)], 0, 50) == [
        (0, 10), (30, 40), (45, 50)]
    assert spans.idle_gaps([(0, 20)], 0, 20) == []
    assert spans.idle_gaps([], 0, 50) == []  # no device activity: nothing to read


def record(busy_s=6.0, window_s=10.0, **named):
    return {"trace": {"busy_s": busy_s, "window_s": window_s, "spans": named}}


@pytest.mark.parametrize("name", sorted(spans.METRICS))
def test_each_reading_needs_a_trace_and_its_span(name):
    span, kind = spans.METRICS[name]
    assert spans.reading({}, span, kind) is None
    assert spans.reading({"trace": None}, span, kind) is None
    assert spans.reading({"trace": {"busy_s": 1.0, "window_s": 2.0}}, span, kind) is None
    assert spans.reading(record(), span, kind) is None
    other = "eval.fetch"
    assert spans.reading(record(**{other: dict(count=3, host_s=1.0, idle_s=0.5,
                                                device_s=0.2)}), span, kind) is None
    entry = dict(count=4, host_s=3.0, idle_s=1.5, device_s=0.2)
    assert spans.reading(record(busy_s=0.0, **{span: entry}), span, kind) is None
    want = 15.0 if kind == "idle" else 50.0  # 1.5 s of 10 s; 0.2 s over 4
    assert spans.reading(record(**{span: entry}), span, kind) == pytest.approx(want)


def test_metrics_name_the_programs_spans():
    names = spans.span_names()
    assert {span for span, _ in spans.METRICS.values()} <= set(names)
    assert {kind for _, kind in spans.METRICS.values()} == {"idle", "device_ms"}
    assert len(spans.METRICS) == 10


def test_join_over_a_cpu_profile():
    from unidet3d_tpu_torch.train.profiling import span

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for g in range(3):
            with span("eval.post", g):
                with span("post.nms"):
                    (torch.ones(64) * 2).sum()
    got = spans.from_events(prof.events(), spans.span_names())
    assert set(got) == {"eval.post", "post.nms"}
    assert got["eval.post"]["count"] == 3 and got["post.nms"]["count"] == 3
    assert got["eval.post"]["host_s"] >= got["post.nms"]["host_s"] > 0
    assert got["eval.post"]["idle_s"] == 0 and got["eval.post"]["device_s"] == 0
    assert spans.from_events(prof.events(), ()) == {}  # a program without spans


def test_a_traced_tiny_eval_run_carries_its_spans(tmp_path):
    torch.set_num_threads(2)
    wl = tiny.workload("scannet-eval")
    ctx = tiny.context(wl, 5, str(tmp_path), trace=True, seconds=0.5)
    line = spans.traced_line(ctx)
    assert line["correct"]
    got = line["spans"]
    groups = got["eval.forward"]["count"]
    assert groups >= 1
    for name in ("eval.wait", "eval.post", "eval.fetch", "eval.metric"):
        assert got[name]["count"] == groups, name
    assert got["eval.compute"]["count"] == 1 and got["eval.open"]["count"] == 2
    assert "loader.pipeline" not in got  # worker threads: not on the traced thread
    # The CPU has no device intervals: nothing is read.
    assert sorted(line["span_metrics"]) == sorted(k for k in spans.METRICS if k.endswith(".eval"))
    assert all(v is None for v in line["span_metrics"].values())


def test_span_cost_is_small():
    cost = spans.span_cost(2000)
    assert math.isfinite(cost["off_us"]) and math.isfinite(cost["on_us"])
    assert cost["off_us"] < 100 and cost["device"] == "cpu"
