"""Validation as a user runs it: ``train/loop.py::evaluate`` over
validation sets on disk, in passes back to back.

Set-up writes the cell's validation scenes under TMPDIR (each info file
cycles over a few distinct scene files), makes the model from the seed and
runs a warm-up pass over one group of each distinct file (every group
shape of the timed passes; ``data.write_warm_info``). The window runs whole
passes until its seconds are up. Scene drains are timed through a subclass
of ``IndoorMetric`` handed in as ``evaluate``'s ``metric``:
``eval_scenes_per_s`` is the scenes drained in the window over its
seconds; ``eval_group_ms_p90`` the 90th percentile of the loop's time per
group over every group of the window, a group's time running from the
previous group's drain (or the pass's start) to its own, so that the
loader's start counts.

``correct``: the first window pass keeps, for a sample of its groups drawn
from the seed (each dataset's first, largest group among them), the
forward's last-layer outputs and the batch's points, and every scene's
detections and the pass's mAP. The reference (``harness/eval_oracle.py``)
judges them after the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import sys
import time

import numpy as np
import torch

from ..harness import data, eval_oracle, training
from ..harness.runner import Context, Result
from ..harness.trace import Trace
from ..harness.weights import init_from_seed_

FORWARD_LAUNCHES = (37, 0, 0, 6, 0, 0)  # K1 and K3 per forward


class LoopRecords(logging.Handler):
    """Collects ``evaluate``'s per-dataset ``eval_stats`` log records (after
    ``chip_smoke.py::LoopRecords``)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.eval = []

    def emit(self, record):
        if hasattr(record, "eval_stats"):
            self.eval.append(record.eval_stats)


@contextlib.contextmanager
def loop_records():
    logger = logging.getLogger("unidet3d_tpu_torch")
    handler, level = LoopRecords(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield handler
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def timed_metric_class():
    from unidet3d_tpu_torch.train.metric import IndoorMetric

    class TimedMetric(IndoorMetric):
        """IndoorMetric that times each scene's drain and, with `keep`,
        keeps each scene's detection arrays."""

        def __init__(self, cfg, classes, keep: bool):
            super().__init__(cfg, classes)
            self.drains, self.keep, self.kept = [], keep, []

        def process(self, dataset_idx, boxes, labels, scores, valid, gt_boxes, gt_labels):
            super().process(dataset_idx, boxes, labels, scores, valid, gt_boxes, gt_labels)
            self.drains.append(time.perf_counter())
            if self.keep:
                self.kept.append((dataset_idx, *(np.array(x) for x in (boxes, labels, scores,
                                                                      valid))))

    return TimedMetric


class ForwardHook:
    """On the model: counts forwards; in the checked pass keeps the sampled
    groups' last-layer outputs and inputs; in the traced slice keeps each
    forward's shapes for the counts."""

    def __init__(self, sampled: set):
        self.sampled = sampled  # forward indices within the checked pass
        self.forwards = 0
        self.pass_start = None  # forward count at the checked pass's start
        self.kept = {}
        self.tracing = False
        self.shapes = []

    def __call__(self, module, args, output):
        batch, pack = args[0], args[1]
        out, aux = output
        if self.pass_start is not None:
            f = self.forwards - self.pass_start
            if f in self.sampled:
                self.kept[f] = dict(
                    points=batch.points.detach().clone(), valid=batch.valid.clone(),
                    sp_ids=batch.sp_ids.clone(), logits=out.cls_logits[-1].detach().clone(),
                    boxes=out.boxes[-1].detach().clone(), query_valid=aux.query_valid.clone())
        if self.tracing:
            self.shapes.append(dict(
                capacity=[int(n.shape[0]) for n in pack.neighbors], n_valid=list(pack.n_valid),
                pairs=[(n[:k] < n.shape[0]).sum() for n, k in zip(pack.neighbors, pack.n_valid)],
                queries=aux.query_valid.sum(1), slots=int(aux.query_valid.shape[1])))
        self.forwards += 1


def experiment(ctx: Context, exp, cfg, roots: dict, ann: str = data.VAL_ANN):
    specs = tuple(dataclasses.replace(s, data_root=roots[s.name], ann_train=None, ann_val=ann)
                  for s in exp.datasets if s.name in roots)
    specs = tuple({s.name: s for s in specs}.values())  # S3DIS lists one spec per area
    return dataclasses.replace(exp, model=cfg, datasets=specs,
                               eval_batch_size=int(ctx.workload["group"]))


def run(ctx: Context) -> Result:
    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES
    from unidet3d_tpu_torch.models.detector import UniDet3D
    from unidet3d_tpu_torch.train.loop import evaluate

    wl = ctx.workload
    exp, cfg = training.model_config(ctx)
    entries = eval_oracle.entries_of(wl)
    roots = data.write(ctx.scratch, wl["raw_points"], wl["files"], ctx.seed, data.VAL_ANN,
                       entries)
    data.write_warm_info(roots, entries, int(wl["group"]))
    warm_exp = experiment(ctx, exp, cfg, roots, data.WARM_ANN)
    exp = experiment(ctx, exp, cfg, roots)
    order = [s.name for s in exp.datasets]
    groups = {n: -(-len(entries[n]) // exp.eval_batch_size) for n in order}
    sampled = eval_oracle.sample_groups(ctx.seed, order, groups, int(wl["checked_groups"]))
    hook = ForwardHook(set(sampled))
    model = init_from_seed_(UniDet3D(cfg, build_class_table(DATASETS_CLASSES), device=ctx.device),
                            ctx.seed)
    handle = model.register_forward_hook(hook)
    TimedMetric = timed_metric_class()

    def one_pass(keep: bool, over=exp):
        """(start, metric, mAP dict)."""
        metric = TimedMetric(cfg, exp.datasets_classes, keep)
        t = time.perf_counter()
        res = evaluate(over, model, device=ctx.device, logger=lambda *a: None, metric=metric)
        return t, metric, res

    with loop_records() as rec:
        one_pass(False, warm_exp)  # warm-up: every group shape of a pass
        training.gpu_ready(ctx.device)
        setup_s = training.now() - ctx.t_start
        stats_from = len(rec.eval)
        launches0 = training.read_launches()
        forwards0 = hook.forwards
        tracer = Trace(ctx.device) if ctx.trace else None
        # The window: whole passes back to back until its seconds are up (a
        # pass opens with each dataset's loader start, seconds without a
        # drain, so a window cut inside one would count its scenes in steps).
        hook.pass_start = hook.forwards
        if tracer is not None:
            hook.tracing = True
            tracer.start()
        t0 = training.now()
        passes = [one_pass(True)]
        hook.pass_start = None
        hook.tracing = False
        if tracer is not None:
            tracer.stop()
        while training.now() - t0 < ctx.seconds:
            passes.append(one_pass(False))
        training.gpu_ready(ctx.device)
        window_s = training.now() - t0
        stats = rec.eval[stats_from:]
    handle.remove()
    n_forwards = hook.forwards - forwards0
    launch_err = training.launch_mismatch(launches0, training.read_launches(), n_forwards,
                                          FORWARD_LAUNCHES, ctx.device)
    drops = training.drops_total()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    trace = tracer.summary() if tracer is not None else None

    group_s, n_scenes = [], 0
    for t_pass, metric, _ in passes:
        ends = eval_oracle.group_ends(metric.drains, [len(entries[n]) for n in order],
                                      exp.eval_batch_size)
        group_s += list(np.diff([t_pass] + ends))
        n_scenes += len(metric.drains)
    q = np.percentile(group_s, [50, 90, 100]) * 1e3
    print(f"eval: {len(passes)} passes, {len(group_s)} groups, {n_scenes} scenes in "
          f"{window_s:.2f} s; group ms p50 {q[0]:.1f} p90 {q[1]:.1f} max {q[2]:.1f}",
          file=sys.stderr)
    _, first_metric, first_res = passes[0]
    checked = eval_oracle.Checked(kept=hook.kept, sampled=sampled, detections=first_metric.kept,
                                  results=first_res)
    shapes = eval_oracle.traced_shapes(hook.shapes)
    del model, hook, passes, first_metric
    training.free_device()
    t_ref = training.now()
    found = eval_oracle.judge(ctx, cfg, exp, roots, entries, checked)
    training.log_reference(t_ref)
    print(f"reference chain (not compared): chain_score_gap {found['chain_score_gap']!r} "
          f"chain_kept_gap {found['chain_kept_gap']!r}", file=sys.stderr)
    limits = wl["limits"]
    checks = [(k, found[k], limits[k]) for k in eval_oracle.NUMBERS]
    checks += [("drops", drops, 0), ("launch_mismatch", launch_err, 0)]
    waits = [w for st in stats for w in st["wait_s"]]
    record = dict(trace=trace, window_s=window_s, eval_waits_s=waits, traced_shapes=shapes,
                  train=False, dims=training.model_dims(cfg))
    return Result(
        end_to_end={"eval_scenes_per_s": (n_scenes / window_s, "scenes/s"),
                    "eval_group_ms_p90": (float(q[1]), "ms"), "setup_s": (setup_s, "s")},
        record=record, checks=checks, attempted=n_scenes, failed=0,
        memory_peak_bytes=peak, trace=trace)
