"""The readings that the limits of ``correct`` are set from, beside the
program's own (which every run prints): the correctness control and the
planted faults, on the chip at a cell's own size.

    python3 -m benchmark.harness.control --workload joint-train-staged --seeds 11 12 13

For each seed, one JSON line. Training cells: `control`, the reference
rounding to three mantissa bits (e4m3's; the configuration computes in
bf16) where the program rounds, in the program's place, against the fp32
reference; `half_batch`, the fp32 reference with each batch's second half
left out (the loss the mean over the rest), against the whole reference;
each with the cell's numbers (loss_gap, fwd_logits_gap, fwd_boxes_gap,
grad_gap, change_gap, query_mismatch). A state left unchanged reads
change_gap 1 by construction and needs no run. Eval cells: `control` with
fwd_logits_gap and fwd_boxes_gap. Each reading goes through the run's own
verdict (``runner.correct_of``) with the cell's limits, and its line gives
`correct`, which has to be false."""
from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from . import registry, runner, training

BITS = 3  # e4m3's mantissa


def training_readings(ctx) -> dict:
    from ..reference.refnet import precision

    mod = importlib.import_module(f"benchmark.drivers.{ctx.workload['driver']}")
    _, cfg = training.model_config(ctx)
    roots = mod.write_scenes(ctx)
    batches = mod.reference_batches(ctx, roots, cfg)
    ref = training.reference_steps(ctx, cfg, batches)
    precision.MANTISSA_BITS = BITS
    try:
        low = training.reference_steps(ctx, cfg, batches)
    finally:
        precision.MANTISSA_BITS = None
    del batches
    training.free_device()
    half = training.reference_steps(ctx, cfg, mod.reference_batches(ctx, roots, cfg, half=True))
    return {"control": training.compare(low, ref), "half_batch": training.compare(half, ref)}


def eval_readings(ctx) -> dict:
    from ..drivers import eval as driver
    from . import data, eval_oracle

    exp, cfg = training.model_config(ctx)
    entries = eval_oracle.entries_of(ctx.workload)
    roots = data.write(ctx.scratch, ctx.workload["raw_points"], ctx.workload["files"], ctx.seed,
                       data.VAL_ANN, entries)
    exp = driver.experiment(ctx, exp, cfg, roots)
    order = [s.name for s in exp.datasets]
    groups = {n: -(-len(entries[n]) // exp.eval_batch_size) for n in order}
    sampled = eval_oracle.sample_groups(ctx.seed, order, groups,
                                        int(ctx.workload["checked_groups"]))
    return {"control": eval_oracle.control_gaps(ctx, cfg, exp, roots, entries, sampled, BITS)}


def verdict(limits: dict, reading: dict) -> dict:
    """The reading with `correct`: the run's verdict over each of its numbers
    that the cell holds to a limit."""
    checks = [(k, v, limits[k]) for k, v in reading.items() if k in limits]
    return dict(reading, correct=runner.correct_of(checks))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    wl = registry.workload(args.workload)
    for seed in args.seeds:
        scratch = tempfile.mkdtemp(prefix="unidet3d_control_")
        t0 = time.perf_counter()
        try:
            ctx = runner.Context(workload=wl, config=registry.config(wl["config"]), seed=seed,
                                 seconds=0, trace=False, device=torch.device("cuda"),
                                 t_start=t0, scratch=scratch)
            read = eval_readings(ctx) if wl["driver"] == "eval" else training_readings(ctx)
            read = {k: verdict(wl["limits"], r) for k, r in read.items()}
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **read}), flush=True)
    return 0


if __name__ == "__main__":
    runner.setup_environment(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    sys.exit(main())
