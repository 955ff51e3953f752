"""The program's spans (``unidet3d_tpu_torch/train/profiling.py``) joined
with the device's idle time in a traced slice.

The program opens each span as a ``torch.profiler.record_function`` range
while a profiler runs, so the trace holds it as a host user annotation on
the kernels' clock. For every span name of the program (``SPAN_NAMES``;
none on a program without spans) found among the host events, the join
gives:

  * ``count`` and ``host_s``, the sum of the spans' durations;
  * ``idle_s``: the seconds of the device's idle gaps whose middle lies
    inside one of that name's spans. A child's gap counts for its parent
    too. The gaps are the stretches of the traced slice that no device
    interval covers (the union of device intervals, as ``trace.py`` takes
    it), including the stretch before the first device interval and after
    the last, which the idle share counts as well;
  * ``device_s``: the spans' ``device_time_total``, the device time of the
    kernels launched by operations nested in them on their own thread (not
    meaningful for ``step.backward``, whose kernels the autograd engine's
    thread launches).

``METRICS`` names the per-layer readings over that table, and ``reading``
computes one from a traced run's record whose trace summary carries the
table under ``spans``. The benchmark's own ``Trace.summary()`` does not add
that key; this module's command runs a cell traced with a summary that
does:

    OPENBLAS_NUM_THREADS=1 python3 -m benchmark.harness.spans \
        --workload scannet-eval --seed 7 --seconds 45
    python3 -m benchmark.harness.spans --cost

(``run.py`` pins numpy's OpenBLAS to one thread before numpy loads; a
module run cannot, so the command pins it.) The first prints the cell's
``--trace 1`` result line with ``spans`` (the table) and ``span_metrics``
(each reading of ``METRICS``) added; the second the cost of one span in
microseconds with no profiler running and under the profiler.
"""
from __future__ import annotations

import argparse
import bisect
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from . import registry, runner
from .trace import Trace

# metric name: (span name, "idle" for 100 x idle_s / the slice's seconds,
# "device_ms" for 1000 x device_s / count)
METRICS = {
    "idle_in_eval_open.eval": ("eval.open", "idle"),
    "idle_in_eval_wait.eval": ("eval.wait", "idle"),
    "idle_in_eval_metric.eval": ("eval.metric", "idle"),
    "idle_in_eval_compute.eval": ("eval.compute", "idle"),
    "device_ms_eval_post.eval": ("eval.post", "device_ms"),
    "idle_in_step_forward.staged": ("step.forward", "idle"),
    "idle_in_step_loss.staged": ("step.loss", "idle"),
    "idle_in_step_backward.staged": ("step.backward", "idle"),
    "idle_in_step_optimizer.staged": ("step.optimizer", "idle"),
    "device_ms_step_loss.staged": ("step.loss", "device_ms"),
}


def span_names() -> tuple:
    """The program's span names; () for a program that has none."""
    from unidet3d_tpu_torch.train import profiling

    return tuple(getattr(profiling, "SPAN_NAMES", ()))


def idle_gaps(device: list, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no (start, end) of `device` covers;
    none without device intervals."""
    if not device:
        return []
    gaps, cur = [], lo
    for start, end in sorted(device):
        if start > cur:
            gaps.append((cur, start))
        cur = max(cur, end)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def join(spans: list, gaps: list) -> dict:
    """{name: {"count", "host_s", "idle_s", "device_s"}} of `spans`, a list
    of (start, end, name, device time), over `gaps`, a list of (start, end);
    times in microseconds, the table's in seconds."""
    by_name: dict = {}
    for start, end, name, dev in spans:
        by_name.setdefault(name, []).append((start, end, dev))
    out = {}
    for name, items in by_name.items():
        union = []  # the name's intervals merged: a gap's middle counts once
        for start, end, _ in sorted(items):
            if union and start <= union[-1][1]:
                union[-1][1] = max(union[-1][1], end)
            else:
                union.append([start, end])
        starts = [u[0] for u in union]
        idle_us = 0.0
        for a, b in gaps:
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and mid <= union[i][1]:
                idle_us += b - a
        out[name] = {"count": len(items), "host_s": sum(e - s for s, e, _ in items) / 1e6,
                     "idle_s": idle_us / 1e6, "device_s": sum(d for _, _, d in items) / 1e6}
    return out


def from_events(events, names) -> dict:
    """The join over a profiler's events (``prof.events()``): spans are the
    host events named in `names`, the slice runs from the first event's
    start to the last one's end."""
    names = set(names)
    if not names:
        return {}
    dev_type = torch.autograd.DeviceType.CUDA
    device, spans = [], []
    lo, hi = float("inf"), float("-inf")
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        lo, hi = min(lo, start), max(hi, end)
        if e.device_type == dev_type:
            if not e.is_user_annotation:
                device.append((start, end))
        elif e.name in names:
            spans.append((start, end, e.name, e.device_time_total))
    return join(spans, idle_gaps(device, lo, hi))


def reading(record: dict, span: str, kind: str):
    """One reading of METRICS from a traced run's record; None without a
    trace, without device time, or without the span."""
    tr = record.get("trace")
    if not tr or tr.get("busy_s", 0) <= 0 or tr.get("window_s", 0) <= 0:
        return None
    s = tr.get("spans", {}).get(span)
    if not s or not s["count"]:
        return None
    if kind == "idle":
        return 100.0 * s["idle_s"] / tr["window_s"]
    return 1e3 * s["device_s"] / s["count"]


class SpanTrace(Trace):
    """The benchmark's traced slice, its summary with ``spans`` added."""

    def summary(self) -> dict:
        out = super().summary()
        out["spans"] = from_events(self.prof.events(), span_names())
        return out


def traced_line(ctx: runner.Context) -> dict:
    """The cell's ``--trace 1`` result line, with ``spans`` and
    ``span_metrics``: the cell's driver runs with SpanTrace in place of
    Trace."""
    mod = importlib.import_module(f"benchmark.drivers.{ctx.workload['driver']}")
    mod.Trace = SpanTrace
    try:
        res = runner.end_to_end(ctx.workload["name"], mod.run(ctx))
    finally:
        mod.Trace = Trace
    line = runner.result_line(res, True, runner.read_per_layer(ctx.workload["name"], res),
                              ctx.device)
    line["spans"] = (res.trace or {}).get("spans", {})
    suffix = "." + ("eval" if ctx.workload["driver"] == "eval" else "staged")
    line["span_metrics"] = {name: reading(res.record, *how) for name, how in METRICS.items()
                            if name.endswith(suffix)}
    return line


def span_cost(n: int = 200_000) -> dict:
    """Microseconds per span: with no profiler running (less an empty
    loop's), and under a profiler of the benchmark's activities."""
    from unidet3d_tpu_torch.train.profiling import span

    def per_span(count, body) -> float:
        t = time.perf_counter()
        body(count)
        return (time.perf_counter() - t) / count * 1e6

    def spans(count):
        for k in range(count):
            with span("step.loss", k):
                pass

    def empty(count):
        for _ in range(count):
            pass

    out = {"off_us": per_span(n, spans) - per_span(n, empty)}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out["on_us"] = per_span(n // 10, spans) - per_span(n // 10, empty)
    out["device"] = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    if args.cost:
        print(json.dumps(span_cost()), flush=True)
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        ap.error("--workload, --seed and --seconds, or --cost")
    if not torch.cuda.is_available():
        print("spans: no CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    wl = registry.workload(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    scratch = tempfile.mkdtemp(prefix="unidet3d_spans_")
    try:
        ctx = runner.Context(workload=wl, config=registry.config(wl["config"]), seed=args.seed,
                             seconds=args.seconds, trace=True, device=device,
                             t_start=t_start, scratch=scratch)
        line = traced_line(ctx)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    runner.setup_environment(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    sys.exit(main())
