"""Training as a user runs it: ``TrainLoader`` feeds ``make_train_step``
from scenes on disk (the loader sets the pace).

Set-up writes the cell's scenes under TMPDIR in the reference's info
format, starts a ``TrainLoader`` (its default workers, the configuration's
batch, shuffled, the train pipelines with augmentation) over the
configuration's datasets, makes the model and optimizer from the seed and
runs the first three steps (the checked ones, which are also the warm
steps). The window then takes batches from the loader and steps until its
seconds are up; ``train_scenes_per_s`` counts the scenes of every step
completed in the window, loader waits included. The reference builds
loader batches 0-2 again (the loader's per-batch RandomState, its scene
draws, pipelines and collate) and follows the first three steps.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..harness import data, training
from ..harness.runner import Context, Result
from ..harness.trace import Trace

TRACED_FROM, TRACED_STEPS = 2, 4  # window steps 3..6 under the profiler
WORKER_PARTS = ("pipeline", "collate", "pack", "stage")


def experiment(ctx: Context, exp, cfg, roots: dict):
    """The configuration's experiment over the scenes written for this run."""
    specs = tuple(dataclasses.replace(s, data_root=roots[s.name], ann_train=data.TRAIN_ANN,
                                      ann_val=None)
                  for s in exp.datasets if s.name in roots)
    return dataclasses.replace(exp, model=cfg, datasets=specs, seed=ctx.seed % 2**31)


def run(ctx: Context) -> Result:
    from unidet3d_tpu_torch.data.loader import TrainLoader
    from unidet3d_tpu_torch.train.loop import build_datasets

    wl = ctx.workload
    exp, cfg = training.model_config(ctx)
    pkg = data.program_data()
    roots = write_scenes(ctx)
    exp = experiment(ctx, exp, cfg, roots)
    loader = TrainLoader(pkg.ConcatDataset(build_datasets(exp, "train")), cfg,
                         exp.batch_size, seed=ctx.seed, device=ctx.device)
    try:
        program = training.Program(ctx, cfg)
        launches0 = training.read_launches()
        hosts, staged_err = [], 0
        for _ in range(training.CHECKED_STEPS):
            tb = next(loader)
            program.checked(program(tb.batch, tb.gt, tb.pack, tb.host[0].dataset_ids))
            # The staged copy the step read, against the loader's host arrays.
            staged_err += training.tree_mismatch((tb.batch, tb.gt, tb.pack), tb.host)
            hosts.append(tb.host)
        del tb
        training.gpu_ready(ctx.device)
        setup_s = training.now() - ctx.t_start

        tracer = Trace(ctx.device) if ctx.trace else None
        waits, traced_from = [], None
        times_at_start = len(loader.times)
        t0 = training.now()
        i = 0
        while training.now() - t0 < ctx.seconds:
            if tracer is not None and i == TRACED_FROM:
                tracer.start()
                traced_from = len(waits)
            t = training.now()
            tb = next(loader)
            waits.append(training.now() - t)
            program(tb.batch, tb.gt, tb.pack, tb.host[0].dataset_ids)
            if tracer is not None and i == TRACED_FROM + TRACED_STEPS - 1:
                tracer.stop()
            i += 1
        if tracer is not None:
            tracer.stop()
        training.gpu_ready(ctx.device)
        window_s = training.now() - t0
        worker = list(loader.times)[times_at_start:]
    finally:
        loader.close()
    n_steps = program.n_steps
    launch_err = training.launch_mismatch(launches0, training.read_launches(), n_steps,
                                          training.STEP_LAUNCHES, ctx.device)
    drops = training.drops_total()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    trace = tracer.summary() if tracer is not None and tracer.prof is not None else None

    kept = program.kept()
    del program, loader, tb
    training.free_device()
    t_ref = training.now()
    ref_hosts = reference_hosts(ctx, roots, cfg)
    host_err = sum(training.tree_mismatch(h, r) for h, r in zip(hosts, ref_hosts))
    print(f"input: {staged_err} staged elements differ from the loader's host arrays, "
          f"{host_err} host elements from the reference's batches", file=sys.stderr)
    pkg = data.reference_data()
    ref = training.reference_steps(ctx, cfg, [data.on_device(pkg, h, ctx.device)
                                              for h in ref_hosts])
    del hosts, ref_hosts
    found = dict(training.compare(kept, ref), input_mismatch=staged_err + host_err)
    checks = training.checks(found, wl["limits"], drops, launch_err)
    window_steps = n_steps - training.CHECKED_STEPS
    record = dict(trace=trace, window_s=window_s, steps=window_steps, loader_waits_s=waits,
                  traced_waits_s=waits[traced_from:traced_from + TRACED_STEPS]
                  if traced_from is not None else [],
                  worker_batch_s=[sum(getattr(t, p) for p in WORKER_PARTS) for t in worker])
    training.log_reference(t_ref)
    if worker and waits:
        print(f"loader: {window_steps} steps in {window_s:.2f} s, mean wait "
              f"{1e3 * sum(waits) / len(waits):.1f} ms, worker s per batch median "
              f"{sorted(record['worker_batch_s'])[len(worker) // 2]:.3f}", file=sys.stderr)
    return Result(
        end_to_end={"train_scenes_per_s": (window_steps * exp.batch_size / window_s, "scenes/s"),
                    "setup_s": (setup_s, "s")},
        record=record, checks=checks, attempted=window_steps,
        failed=int(not np.isfinite(kept["losses"]).all()), memory_peak_bytes=peak,
        trace=trace)


def write_scenes(ctx: Context) -> dict:
    wl = ctx.workload
    return data.write(ctx.scratch, wl["raw_points"], wl["scenes"], ctx.seed, data.TRAIN_ANN)


def reference_batches(ctx: Context, roots: dict, cfg, half: bool = False) -> list:
    """reference_hosts on the device."""
    pkg = data.reference_data()
    return [data.on_device(pkg, h, ctx.device) for h in reference_hosts(ctx, roots, cfg, half)]


def reference_hosts(ctx: Context, roots: dict, cfg, half: bool = False) -> list:
    """Loader batches 0..2 built again by the reference, host arrays:
    TrainLoader's per-batch RandomState, scene draws (``_samples``),
    pipelines, collate and the numpy rulebook builder (`half`: the first
    half of each batch's scenes only)."""
    exp = experiment(ctx, training.model_config(ctx)[0], cfg, roots)
    pkg, rcfg = data.reference_data(), training.ref_config(cfg)
    sets = [pkg.IndoorDataset(s.data_root, s.ann_train, data.dataset_index(s.name),
                              pipeline=pkg.train_pipeline(s.name, augment=s.augment),
                              partition=s.partition,
                              label_mapping=s.label_mapping or pkg.mappings.get(s.name))
            for s in exp.datasets]
    concat = pkg.ConcatDataset(sets)

    def build(n):
        rng = training.batch_rng(ctx.seed, n)
        idxs = rng.randint(len(concat), size=exp.batch_size)
        samples = [concat.get(int(i), rng) for i in idxs]
        if half:
            samples = samples[: len(samples) // 2]
        batch, gt, _ = pkg.collate(samples, rcfg, rng=rng, build_rulebooks=False)
        return batch, gt, pkg.build_packs(batch.vox_src, batch.valid, rcfg)

    return data.in_threads(build, [(n,) for n in range(training.CHECKED_STEPS)])
