"""Instance-segmentation validation with its groups staged on the card: the
cell ``oneformer3d-scannet-staged-eval`` (OneFormer3D, ``configs/
oneformer3d_scannet.json``).

    python3 benchmark/run.py --workload oneformer3d-scannet-staged-eval --seed 7 --seconds 45 --trace 1

Set-up writes the cell's validation scenes under TMPDIR (``files`` scenes of
``raw_points`` points, ScanNet's raw nyu40 semantic and instance ids,
superpoints of 64 points, up to 64 instances), builds its groups of
``group`` once through the program's own ``EvalLoader`` (the test pipeline,
``collate``, the native rulebook builder, the staging on the card, the
size-sorted groups and their capacity buckets), makes the model from the
seed and runs one warm-up pass (every group shape). The window then cycles
over the staged groups in a closed loop, in whole passes: for each group
the per-group function ``evaluate`` calls, ``train/loop.py::eval_group``
(the forward, the post-processing, and the drain of the previous group
into the metric, one group late), then the last drain and
``metric.compute()`` under the span "eval.compute", as ``evaluate`` ends a
dataset. The loader, which sets the pace of ``scannet-eval`` (PERF.md),
is bypassed. ``eval_scenes_per_s``: the scenes of the window's whole passes
over its seconds.

``correct``: the first window pass keeps, for a sample of its groups drawn
from the seed (the first, largest group among them), the forward's last
prediction set, its per-layer attention bitmasks and its inputs, and for
every group the instances and semantic map; the reference judges them
after the window (``harness/instseg_oracle.py``), with ``band`` the
workload's logit band of ``mask_flips``, and also holds the program's
metric to the reference's on instances planted from the scenes' ground
truth (``planted_ap_gap``: the model's own match nothing with random
weights). Also compared: this run's drops in collate (0) and the kernels'
launches per forward (K1 37, K3 6, M1 6, no other).

With ``--trace 1`` the first window pass runs under the profiler; the
record holds each traced forward's levels, valid superpoints and open
pairs per layer (``harness/instseg_counts.py``), the same forwards as the
conv and attention roofline readers read UniDet3D's (``traced_shapes``:
the backbone's levels, and the self-attention's rows, the 20 semantic
queries and the superpoints), and each group's seconds of the span
"post.masks".

Adding this cell edited no file of the harness: the workload names this
driver, and its per-layer metrics have readers of their own
(``metrics/mask_attn_roofline.py``, ``instseg_forward_mfu.py``,
``instseg_post_ms.py``; ``device_idle.instseg``, ``conv_roofline.instseg``
and ``attn_roofline.instseg`` are the existing families').
The correctness control: ``python3 -m benchmark.harness.instseg_control``.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

from ..harness import counts, data, eval_oracle, instseg_oracle, training
from ..harness.instseg_counts import M1_KERNELS, InstsegShape, mask_attn_bound_s
from ..harness.runner import Context, Result
from ..harness.trace import Trace, device_seconds
from ..harness.weights import init_from_seed_

FORWARD_LAUNCHES = (37, 0, 0, 6, 0, 0)  # K1 and K3 per forward; M1 6 (M1_LAUNCHES)
M1_LAUNCHES = 6


class ForwardHook:
    """On the model: counts forwards; in the checked pass keeps the sampled
    groups' last prediction set, bitmasks and inputs; in the traced pass
    each forward's shape."""

    def __init__(self, sampled: set):
        self.sampled = sampled
        self.group = None  # the index of the group being run, set by the loop
        self.checking = False
        self.tracing = False
        self.forwards = 0
        self.kept = {}
        self.shapes = []

    def __call__(self, module, args, output):
        batch, pack = args[0], args[1]
        out, aux = output
        if self.checking and self.group in self.sampled:
            self.kept[self.group] = dict(
                points=batch.points.clone(), valid=batch.valid.clone(),
                cls=out.cls_logits[-1].clone(), masks=out.masks.clone(),
                bits=[b.clone() for b in aux.attn_bits], sp_valid=aux.sp_valid.clone(),
                sp_counts=aux.sp_counts.clone())
        if self.tracing:
            self.shapes.append(dict(
                capacity=[int(n.shape[0]) for n in pack.neighbors], n_valid=list(pack.n_valid),
                pairs=[(n[:k] < n.shape[0]).sum() for n, k in zip(pack.neighbors, pack.n_valid)],
                superpoints=aux.sp_valid.sum(1), open_pairs=aux.open_pairs,
                slots=aux.sp_valid.shape[1]))
        self.forwards += 1


def traced_shapes(shapes: list) -> list:
    """The traced forwards' InstsegShape, read back from the card."""
    return [InstsegShape(
        tuple(counts.LevelShape(c, int(n), int(p))
              for c, n, p in zip(s["capacity"], s["n_valid"], s["pairs"])),
        tuple(int(x) for x in s["superpoints"].tolist()),
        tuple(int(x) for x in s["open_pairs"].tolist())) for s in shapes]


def family_shapes(shapes: list, n_sem: int) -> list:
    """The traced forwards as the conv and attention roofline readers
    (``readers.roofline``) read UniDet3D's: [(counts.BatchShape, slots)],
    the self-attention's valid rows per scene (the semantic queries and the
    valid superpoints) and its padded rows (K3's L)."""
    return [(counts.BatchShape(sh.levels, tuple(n_sem + n for n in sh.superpoints)),
             n_sem + int(s["slots"])) for sh, s in zip(traced_shapes(shapes), shapes)]


def predictions_of(pred) -> dict:
    """A group's instances and semantic map, copied on the device."""
    p = pred.predictions
    return dict(keep=p.keep.clone(), labels=p.labels.clone(), scores=p.scores.clone(),
                queries=p.queries.clone(), masks=p.masks.clone(), semantic=p.semantic.clone())


def stage_groups(ctx: Context, exp, cfg, root: str) -> list:
    """The cell's groups built once by the program's EvalLoader and staged on
    the card: [EvalGroup]."""
    from unidet3d_tpu_torch.core.experiment import DatasetSpec
    from unidet3d_tpu_torch.data.loader import EvalLoader
    from unidet3d_tpu_torch.train import loop

    exp = dataclasses.replace(exp, model=cfg, datasets=(DatasetSpec(
        name="scannet", data_root=root, ann_val=data.VAL_ANN),),
        eval_batch_size=int(ctx.workload["group"]))
    (ds,) = loop.build_datasets(exp, "val")
    loader = EvalLoader(ds, cfg, exp.eval_batch_size, device=ctx.device)
    return [loop.EvalGroup(samples, batch, pack, cfg_b, ds.dataset_idx, g, loader.group_indices(g))
            for g, (samples, batch, _, pack, _, cfg_b) in enumerate(loader)]


def m1_launches() -> int:
    from unidet3d_tpu_torch.ops.mask_attention import mask_attention_cuda

    return mask_attention_cuda.launches


def run(ctx: Context) -> Result:
    from unidet3d_tpu_torch.models.oneformer3d import OneFormer3D
    from unidet3d_tpu_torch.train import loop
    from unidet3d_tpu_torch.train.instance_metric import InstanceSegMetric
    from unidet3d_tpu_torch.train.profiling import SPANS, span

    wl = ctx.workload
    drops0 = training.drops_total()  # this run's drops only, set-up's included
    exp, cfg = training.model_config(ctx)
    roots = data.write(ctx.scratch, wl["raw_points"], wl["files"], ctx.seed, data.VAL_ANN)
    groups = stage_groups(ctx, exp, cfg, roots["scannet"])
    sampled = eval_oracle.sample_groups(ctx.seed, ["scannet"], {"scannet": len(groups)},
                                        int(wl["checked_groups"]))
    hook = ForwardHook(set(sampled))
    model = init_from_seed_(OneFormer3D(cfg, device=ctx.device), ctx.seed)
    handle = model.register_forward_hook(hook)
    scenes_per_pass = sum(len(g.scene_ids) for g in groups)
    predictions, post_s = {}, []

    def one_pass(keep: bool = False, timed: bool = False) -> dict:
        metric, pending = InstanceSegMetric(), None
        for group in groups:
            hook.group = group.index
            mark = SPANS.snapshot()
            pending = loop.eval_group(model, metric, group, pending)
            if timed:
                post_s.append(SPANS.since(mark).get("post.masks", 0.0))
            if keep:
                predictions[group.index] = predictions_of(pending[0])
        loop.drain(metric, pending)
        with span("eval.compute"):
            return metric.compute(logger=None)

    one_pass()  # warm-up: every group shape of a pass
    training.gpu_ready(ctx.device)
    setup_s = training.now() - ctx.t_start
    launches0, m1_0, forwards0 = training.read_launches(), m1_launches(), hook.forwards
    tracer = Trace(ctx.device) if ctx.trace else None
    hook.checking = True
    if tracer is not None:
        hook.tracing = True
        tracer.start()
    t0 = training.now()
    results = one_pass(keep=True, timed=tracer is not None)
    n_passes = 1
    hook.checking = hook.tracing = False
    if tracer is not None:
        tracer.stop()
    while training.now() - t0 < ctx.seconds:
        one_pass()
        n_passes += 1
    training.gpu_ready(ctx.device)
    window_s = training.now() - t0
    handle.remove()
    n_forwards = hook.forwards - forwards0
    launch_err = training.launch_mismatch(launches0, training.read_launches(), n_forwards,
                                          FORWARD_LAUNCHES, ctx.device)
    launch_err += abs(m1_launches() - m1_0 - (
        n_forwards * M1_LAUNCHES if ctx.device.type == "cuda" else 0))
    drops = training.drops_total() - drops0
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    trace = tracer.summary() if tracer is not None else None
    shapes = traced_shapes(hook.shapes)
    families = family_shapes(hook.shapes, cfg.num_semantic_queries)
    n_scenes = n_passes * scenes_per_pass
    print(f"eval_staged: {n_passes} passes of {len(groups)} groups, {n_scenes} scenes in "
          f"{window_s:.2f} s", file=sys.stderr)
    if trace is not None and shapes:
        m1_s = device_seconds(trace["kernel_s"], M1_KERNELS)
        bound_s = sum(mask_attn_bound_s(sh, cfg.d_model, cfg.num_heads, cfg.num_semantic_queries)
                      for sh in shapes)
        print(f"traced pass (not compared): M1 {1e3 * m1_s / len(shapes):.4f} ms a group "
              f"(bound {1e3 * bound_s / len(shapes):.4f}); open pairs a layer, per group: "
              f"{[list(sh.open_pairs) for sh in shapes]}", file=sys.stderr)

    checked = instseg_oracle.Checked(kept=hook.kept, sampled=sampled, predictions=predictions,
                                     results=results)
    del model, hook
    training.free_device()
    t_ref = training.now()
    found = instseg_oracle.judge(ctx, cfg, groups, roots["scannet"], data.VAL_ANN, checked,
                                 float(wl["band"]))
    training.log_reference(t_ref)
    print(f"flip_margin (not compared): {found['flip_margin']!r}", file=sys.stderr)
    limits = wl["limits"]
    checks = [(k, found[k], limits[k]) for k in instseg_oracle.NUMBERS]
    checks += [("drops", drops, 0), ("launch_mismatch", launch_err, 0)]
    record = dict(trace=trace, window_s=window_s, instseg_shapes=shapes, post_masks_s=post_s,
                  traced_shapes=families,
                  train=False, dims=dict(planes=tuple(cfg.num_planes), d_model=cfg.d_model,
                                         num_heads=cfg.num_heads, hidden=cfg.hidden_dim,
                                         num_layers=cfg.num_layers,
                                         n_sem=cfg.num_semantic_queries,
                                         n_classes=cfg.num_instance_classes))
    return Result(
        end_to_end={"eval_scenes_per_s": (n_scenes / window_s, "scenes/s"),
                    "setup_s": (setup_s, "s")},
        record=record, checks=checks, attempted=n_scenes, failed=0,
        memory_peak_bytes=peak, trace=trace)
