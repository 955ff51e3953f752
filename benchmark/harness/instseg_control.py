"""The readings that the limits of ``correct`` in the OneFormer3D cell are
set from, beside the program's own (which every run prints), on the chip at
the cell's own size:

    python3 -m benchmark.harness.instseg_control --workload oneformer3d-scannet-staged-eval --seeds 1 2 3

For each seed, one JSON line, over the scenes of the groups that a run with
that seed checks: `control`, the reference at e4m3's three mantissa bits
(the configuration computes in bf16) in the program's place, running free,
against the fp32 reference teacher-forced with the control's own per-layer
masks: fwd_logits_gap, fwd_mask_gap, mask_flips, read as the run reads the
program's (``instseg_oracle.forward_readings``, with the flip_margin that
sets the band); `no_mask`, a planted fault:
the fp32 reference with its cross-attention left unmasked, read the same
way (the masks it ran with against its own logits' signs); `no_floor`, a
planted fault of the metric: the program's ScanNet evaluation without its
100-point floor (``instance_metric.MIN_REGION`` 0), read by
``planted_ap_gap`` over the cell's groups as the program's EvalLoader
builds them. Each reading goes through the run's own verdict
(``runner.correct_of``) with the cell's limits, and its line gives
`correct`, which has to be false."""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from . import control, data, eval_oracle, instseg_oracle, registry, runner, training


def group_slots(cfg, scenes: list) -> int:
    """The superpoint slots of a group as the program's EvalLoader pads it."""
    from unidet3d_tpu_torch.data.loader import superpoint_buckets

    need = max(int(s["sp_pts_mask"].max()) + 1 for s in scenes)
    return next((r for r in superpoint_buckets(cfg) if need <= r), cfg.max_superpoints)


def readings(ctx) -> dict:
    from ..reference.refnet import precision

    wl = ctx.workload
    _, cfg = training.model_config(ctx)
    band, group = float(wl["band"]), int(wl["group"])
    root = data.write(ctx.scratch, wl["raw_points"], wl["files"], ctx.seed,
                      data.VAL_ANN)["scannet"]
    n = int(wl["files"]["scannet"])
    order = eval_oracle.scene_order(root, data.VAL_ANN, n, data.reference_data())
    n_groups = -(-n // group)
    sampled = eval_oracle.sample_groups(ctx.seed, ["scannet"], {"scannet": n_groups},
                                        int(wl["checked_groups"]))
    model = instseg_oracle.reference_model(cfg, ctx.seed, ctx.device)
    found = {k: dict(fwd_logits_gap=0.0, fwd_mask_gap=0.0, mask_flips=0, flip_margin=0.0)
             for k in ("control", "no_mask")}
    for g in sampled:
        scenes = [instseg_oracle.reference_scene(root, data.VAL_ANN, int(k))
                  for k in order[g * group:(g + 1) * group]]
        s = group_slots(cfg, scenes)
        for sample in scenes:
            precision.MANTISSA_BITS = control.BITS
            try:
                low = instseg_oracle.reference_forward(model, sample, cfg, s, ctx.device)
            finally:
                precision.MANTISSA_BITS = None
            opened = [torch.ones_like(m) for m in low["used"]]
            fault = instseg_oracle.reference_forward(model, sample, cfg, s, ctx.device, opened)
            for name, prog in (("control", low), ("no_mask", fault)):
                res = instseg_oracle.reference_forward(model, sample, cfg, s, ctx.device,
                                                       prog["used"])
                read = instseg_oracle.forward_readings(prog["cls"][-1], prog["masks"][-1],
                                                       prog["used"], res, band)
                found[name]["mask_flips"] += read["mask_flips"]
                for key in ("fwd_logits_gap", "fwd_mask_gap", "flip_margin"):
                    found[name][key] = max(found[name][key], read[key])
            del low, fault
    del model
    found["no_floor"] = dict(planted_ap_gap=no_floor_gap(ctx, root))
    return found


def no_floor_gap(ctx, root: str) -> float:
    """planted_ap_gap of the cell's groups with the program's metric
    stripped of its 100-point floor."""
    from unidet3d_tpu_torch.train import instance_metric

    from ..drivers.eval_staged import stage_groups

    exp, cfg = training.model_config(ctx)
    groups = stage_groups(ctx, exp, cfg, root)
    floor = instance_metric.MIN_REGION
    instance_metric.MIN_REGION = 0
    try:
        return instseg_oracle.planted_ap_gap(groups, root, data.VAL_ANN, ctx.seed, ctx.device)
    finally:
        instance_metric.MIN_REGION = floor


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("instseg_control: no CUDA card", file=sys.stderr)
        return 2
    wl = registry.workload(args.workload)
    for seed in args.seeds:
        scratch = tempfile.mkdtemp(prefix="unidet3d_control_")
        t0 = time.perf_counter()
        try:
            ctx = runner.Context(workload=wl, config=registry.config(wl["config"]), seed=seed,
                                 seconds=0, trace=False, device=torch.device("cuda"),
                                 t_start=t0, scratch=scratch)
            read = {k: control.verdict(wl["limits"], r) for k, r in readings(ctx).items()}
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **read}), flush=True)
    return 0


if __name__ == "__main__":
    runner.setup_environment(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    sys.exit(main())
