"""Training on batches already on the card (the step sets the pace).

Set-up writes the cell's scenes under TMPDIR, builds its K batches through
the program's train pipelines (augmentation on), ``collate`` and the native
rulebook builder, stages them on the card, makes the model and optimizer
from the seed, and runs steps 1..K (the first three are the checked ones).
The window cycles ``make_train_step`` over the K batches in a closed loop;
``staged_train_scenes_per_s`` is the scenes of every step completed in the
window over the window's seconds. Then the reference rebuilds batches 1-3
and follows the first three steps.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import data, training
from ..harness.runner import Context, Result
from ..harness.trace import Trace

TRACED_FROM, TRACED_STEPS = 2, 4  # window steps 3..6 under the profiler


def run(ctx: Context) -> Result:
    wl = ctx.workload
    mix, n_batches = wl["batch"], int(wl["batches"])
    _, cfg = training.model_config(ctx)
    pkg = data.program_data()
    roots = write_scenes(ctx)
    datasets = {k: data.train_dataset(pkg, k, roots[k]) for k in mix}
    hosts = data.in_threads(data.staged_batch, [
        (pkg, datasets, data.batch_picks(mix, k), training.batch_rng(ctx.seed, k), cfg)
        for k in range(n_batches)])
    shapes = [training.batch_shape(b, pack, cfg) for b, _, pack in hosts]
    batches = [data.on_device(pkg, h, ctx.device) for h in hosts]
    checked_hosts = [hosts[k % n_batches] for k in range(training.CHECKED_STEPS)]
    del hosts
    program = training.Program(ctx, cfg)
    launches0 = training.read_launches()
    for k in range(max(n_batches, training.CHECKED_STEPS)):
        metrics = program(*batches[k % n_batches])
        if program.n_steps <= training.CHECKED_STEPS:
            program.checked(metrics)
    training.gpu_ready(ctx.device)
    setup_s = training.now() - ctx.t_start

    tracer = Trace(ctx.device) if ctx.trace else None
    traced, slots = [], training.query_slots(cfg)
    t0 = training.now()
    i = 0
    while training.now() - t0 < ctx.seconds:
        if tracer is not None and i == TRACED_FROM:
            tracer.start()
        program(*batches[program.n_steps % n_batches])
        if tracer is not None and TRACED_FROM <= i < TRACED_FROM + TRACED_STEPS:
            traced.append((shapes[(program.n_steps - 1) % n_batches], slots))
            if i == TRACED_FROM + TRACED_STEPS - 1:
                tracer.stop()
        i += 1
    if tracer is not None:
        tracer.stop()  # a window too short for the whole traced slice
    training.gpu_ready(ctx.device)
    window_s = training.now() - t0
    n_steps = program.n_steps
    launch_err = training.launch_mismatch(launches0, training.read_launches(), n_steps,
                                          training.STEP_LAUNCHES, ctx.device)
    drops = training.drops_total()
    scenes_per_step = sum(mix.values())
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    trace = tracer.summary() if tracer is not None and tracer.prof is not None else None

    kept = program.kept()
    del program, batches, metrics
    training.free_device()
    t_ref = training.now()
    ref_hosts = reference_hosts(ctx, roots, cfg)
    host_err = sum(training.tree_mismatch(h, r) for h, r in zip(checked_hosts, ref_hosts))
    ref_pkg = data.reference_data()
    ref = training.reference_steps(ctx, cfg, [data.on_device(ref_pkg, h, ctx.device)
                                              for h in ref_hosts])
    del checked_hosts, ref_hosts
    found = dict(training.compare(kept, ref), input_mismatch=host_err)
    checks = training.checks(found, wl["limits"], drops, launch_err)
    window_steps = n_steps - max(n_batches, training.CHECKED_STEPS)
    record = dict(trace=trace, traced_shapes=traced, train=True,
                  dims=training.model_dims(cfg), window_s=window_s, steps=window_steps)
    training.log_reference(t_ref)
    return Result(
        end_to_end={"staged_train_scenes_per_s": (window_steps * scenes_per_step / window_s,
                                                  "scenes/s"),
                    "setup_s": (setup_s, "s")},
        record=record, checks=checks, attempted=window_steps,
        failed=int(not np.isfinite(kept["losses"]).all()), memory_peak_bytes=peak,
        trace=trace)



def write_scenes(ctx: Context) -> dict:
    wl = ctx.workload
    return data.write(ctx.scratch, wl["raw_points"],
                      {k: n * int(wl["batches"]) for k, n in wl["batch"].items()}, ctx.seed,
                      data.TRAIN_ANN)


def reference_batches(ctx: Context, roots: dict, cfg, half: bool = False) -> list:
    """reference_hosts on the device."""
    pkg = data.reference_data()
    return [data.on_device(pkg, h, ctx.device) for h in reference_hosts(ctx, roots, cfg, half)]


def reference_hosts(ctx: Context, roots: dict, cfg, half: bool = False) -> list:
    """Batches 1-3 of the window's cycle built again by the reference, host
    arrays (`half`: the first half of each batch's scenes only)."""
    wl = ctx.workload
    mix, n_batches = wl["batch"], int(wl["batches"])
    pkg, rcfg = data.reference_data(), training.ref_config(cfg)
    sets = {k: data.train_dataset(pkg, k, roots[k]) for k in mix}
    return data.in_threads(data.staged_batch, [
        (pkg, sets, data.batch_picks(mix, k % n_batches), training.batch_rng(ctx.seed, k % n_batches),
         rcfg, half) for k in range(training.CHECKED_STEPS)])
