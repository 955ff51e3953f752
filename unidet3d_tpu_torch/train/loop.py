"""Model and dataset construction, the training loop and the evaluation loop.

The port of the JAX package's ``train/loop.py`` (``build_model``,
``build_datasets``, ``train``, ``evaluate``), in one process on one card
or in one process per card under ``torch.distributed``:
  * ``train``: epochs over the mixed-dataset ``TrainLoader``, a log line per
    interval (loss, its EMA, lr, s/step, scenes/s, ETA) with a warning when
    collate dropped inputs, checkpoints with keep-last-k and resume, and
    validation on the epochs of ``_val_epochs`` (every 16, then every epoch
    of the last 16). Losses stay on the card between log lines: one read per
    interval, and one per epoch for its mean. In a process group each rank
    trains on its share of the global batch (``parallel/distributed.py``);
    rank 0 logs and writes the checkpoints;
  * ``evaluate``: per-dataset validation over the eval loader's
    size-sorted, capacity-bucketed groups, the forward and post-processing
    on the card, and indoor mAP on the host. In a process group each rank
    evaluates a strided shard of every dataset and the metric gathers; no
    collective runs per group, since the buckets depend on each rank's
    scenes (the JAX loop evaluates on a process-local mesh for this reason).
Every interval, epoch, checkpoint, resume, ``load_from`` and validation line
carries its numbers as the log record's ``train_stats`` attribute (a dict
with "kind"), and ``evaluate`` its per-dataset numbers as ``eval_stats``.
"""
from __future__ import annotations

import collections
import copy
import itertools
import logging
import os
import statistics
import time

import numpy as np
import torch

from ..core.class_table import build_class_table
from ..core.config import ModelConfig
from ..core.experiment import ExperimentConfig, resolve_steps_per_epoch
from ..data.dataset_specs import DEFAULT_LABEL_MAPPINGS
from ..data.datasets import ConcatDataset, IndoorDataset
from ..data.loader import EvalLoader, TrainLoader
from ..data.pipelines import test_pipeline, train_pipeline
from ..data.telemetry import DROPS
from ..device import resolve_device
from ..models.detector import UniDet3D
from ..models.postprocess import predict_batch
from ..parallel.distributed import broadcast_module, is_primary, local_batch_size, rank_world
from ..parallel.train_step import make_train_step
from ..viz.show_results import show_online, show_result
from ..weights import seeded_init_
from .checkpoint import CheckpointManager, merge_by_prefix, restore_params
from .metric import IndoorMetric
from .optim import make_optimizer
from .profiling import log_memory_stats

log = logging.getLogger("unidet3d_tpu_torch")


def build_model(exp: ExperimentConfig, device="cuda"):
    """(UniDet3D on `device`, its class table); the weights are zeros until
    they are loaded or ``weights.seeded_init_`` fills them."""
    table = build_class_table(exp.datasets_classes)
    return UniDet3D(exp.model, table, device=device), table


def build_datasets(exp: ExperimentConfig, split: str):
    """One IndoorDataset per configured dataset that has an info file for
    `split` ("train": the train pipeline, random scene draws; otherwise the
    test pipeline in scene order)."""
    out = []
    for spec in exp.datasets:
        ann = spec.ann_train if split == "train" else spec.ann_val
        if ann is None:
            continue
        didx = exp.model.datasets.index(spec.name)
        pipe = (
            train_pipeline(spec.name, augment=spec.augment)
            if split == "train"
            else test_pipeline(spec.name)
        )
        mapping = spec.label_mapping
        if mapping is None:
            mapping = DEFAULT_LABEL_MAPPINGS.get(spec.name)
        out.append(
            IndoorDataset(
                spec.data_root,
                ann,
                didx,
                pipeline=pipe,
                test_mode=split != "train",
                partition=spec.partition if split == "train" else 1.0,
                label_mapping=mapping,
                seed=exp.seed + didx,
            )
        )
    return out


def _val_epochs(exp: ExperimentConfig) -> set:
    """The epochs (from 1) after which train() validates: every
    val_interval_epochs, and each of the last val_last_epochs."""
    every = set(range(exp.val_interval_epochs, exp.epochs + 1, exp.val_interval_epochs))
    every |= set(range(max(1, exp.epochs - exp.val_last_epochs + 1), exp.epochs + 1))
    return every


def _stats(kind: str, **numbers) -> dict:
    return {"train_stats": dict(kind=kind, **numbers)}


def log_primary(*args, **kw) -> None:
    """log.info on rank 0 only (every rank when there is no group)."""
    if is_primary():
        log.info(*args, **kw)


def train(exp: ExperimentConfig, resume: str | None = None, device="cuda"):
    """Trains `exp` on `device` ("cuda" unless the caller asks for "cpu"),
    writing checkpoints under ``exp.work_dir/checkpoints``; returns the model
    and its ClippedAdamW.

    The weights start from ``seeded_init_(model, exp.seed)``; with
    ``exp.load_from`` every tensor under ``exp.load_prefix`` comes from that
    state dict (``merge_by_prefix``, raising when none matches); `resume`
    ("auto": the latest step, or a step number) then restores weights and
    optimizer strictly and training goes on from epoch step //
    steps_per_epoch + 1. As in the JAX loop, the query / dropout generator
    starts at seed + 1 and the loader at its batch 1 in every run, resumed or
    not (the JAX loop draws batch 0 to initialise its state).

    In a process group (``parallel/distributed.py``, launched by torchrun)
    every rank runs this loop on its card: exp.batch_size is the global
    batch, each rank's loader draws its batch_size / world scenes from seed
    + 7919 * rank (the JAX loop's fold), rank 0's weights are broadcast once
    they are initialised, loaded or restored, the step averages over the
    group, rank 0 writes the checkpoints and the log lines, and every rank
    validates its shard of each dataset (``evaluate`` gathers the metric)."""
    device = resolve_device(device)
    rank, world = rank_world()
    launched = int(os.environ.get("WORLD_SIZE", "1"))
    if launched > 1 and world == 1:
        raise RuntimeError(
            f"WORLD_SIZE={launched} but no process group: call "
            "parallel.distributed.maybe_initialize() before train() (tools/train.py does)")
    local_bs = local_batch_size(exp.batch_size)
    os.makedirs(exp.work_dir, exist_ok=True)
    model, _ = build_model(exp, device)
    log.info("device=%s%s, rank %d of %d", device,
             f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "",
             rank, world)
    train_sets = build_datasets(exp, "train")
    if not train_sets:
        raise ValueError("no training datasets configured")
    concat = ConcatDataset(train_sets)
    exp = resolve_steps_per_epoch(exp, len(concat))
    log.info("steps_per_epoch=%d (dataset %d scenes, bs %d, %d per rank)",
             exp.steps_per_epoch, len(concat), exp.batch_size, local_bs)
    seeded_init_(model, exp.seed)
    optimizer = make_optimizer(
        model.parameters(), base_lr=exp.lr, weight_decay=exp.weight_decay,
        total_steps=exp.total_steps, power=exp.lr_power, clip_norm=exp.clip_norm)
    if exp.load_from:
        model.load_state_dict(merge_by_prefix(
            model.state_dict(), restore_params(exp.load_from), exp.load_prefix))
        log.info("initialized %s from %s", exp.load_prefix, exp.load_from,
                 extra=_stats("load_from", prefix=exp.load_prefix, path=exp.load_from))
    mngr = CheckpointManager(os.path.join(exp.work_dir, "checkpoints"), exp.ckpt_max_keep)
    step = 0
    if resume:
        restored = mngr.restore(model, optimizer, None if resume == "auto" else int(resume))
        if restored is not None:
            step = restored
            log.info("resumed from step %d", step, extra=_stats("resume", step=step))
    broadcast_module(model)
    start_epoch = step // exp.steps_per_epoch
    if start_epoch >= exp.epochs:
        return model, optimizer

    step_fn = make_train_step(model, exp.model, optimizer)
    val_epochs = _val_epochs(exp)
    generator = torch.Generator(device=device).manual_seed(exp.seed + 1)
    DROPS.reset()
    loader = TrainLoader(concat, exp.model, local_bs, seed=exp.seed + 7919 * rank,
                         device=device, start=1)
    ema = None  # loss EMA for the interval lines
    try:
        for epoch in range(start_epoch + 1, exp.epochs + 1):
            t0 = t_int = time.time()
            losses = []
            for it in range(1, exp.steps_per_epoch + 1):
                tb = next(loader)
                metrics = step_fn(tb.batch, tb.gt, tb.pack, generator,
                                  host_dataset_ids=tb.host[0].dataset_ids)
                losses.append(metrics["loss"])
                step += 1
                if rank == 0 and (it % exp.log_interval == 0 or it == exp.steps_per_epoch):
                    # The one read from the card per interval.
                    loss = float(losses[-1])
                    ema = loss if ema is None else 0.9 * ema + 0.1 * loss
                    now = time.time()
                    steps = it - (it - 1) // exp.log_interval * exp.log_interval
                    spstep = (now - t_int) / steps
                    t_int = now
                    eta = int(max(exp.total_steps - step, 0) * spstep)
                    lr = optimizer.schedule(optimizer.count - 1)
                    log.info(
                        "epoch %d iter %d/%d loss %.4f (ema %.4f) lr %.3e "
                        "%.2f s/step %.2f scenes/s eta %d:%02d:%02d",
                        epoch, it, exp.steps_per_epoch, loss, ema, lr, spstep,
                        exp.batch_size / spstep, eta // 3600, eta % 3600 // 60, eta % 60,
                        extra=_stats("interval", epoch=epoch, it=it, step=step, loss=loss,
                                     ema=ema, lr=lr, steps=steps, seconds=spstep * steps))
                    drops = DROPS.snapshot(reset=True)
                    if drops:
                        log.warning(
                            "capacity drops this interval: %s — inputs exceeded "
                            "static caps (see data/telemetry.py; raise the "
                            "relevant ModelConfig capacity if unexpected)",
                            DROPS.format(drops), extra=_stats("drops", step=step, **drops))
            mean_loss = torch.stack(losses).mean().item()
            dt = time.time() - t0
            log_primary("epoch %d/%d loss %.4f (%.1f s, %.2f scenes/s)", epoch, exp.epochs,
                        mean_loss, dt, exp.steps_per_epoch * exp.batch_size / dt,
                        extra=_stats("epoch", epoch=epoch, step=step, loss=mean_loss,
                                     seconds=dt))
            log_memory_stats(f"epoch {epoch} ")
            if epoch % exp.ckpt_interval_epochs == 0:
                t = time.perf_counter()
                path = mngr.save(step, model, optimizer)
                dt = time.perf_counter() - t
                size = os.path.getsize(path)
                log_primary("checkpoint step %d: %d bytes in %.3f s -> %s", step, size, dt,
                            path, extra=_stats("checkpoint", step=step, bytes=size, seconds=dt))
            if epoch in val_epochs:
                t = time.perf_counter()
                results = evaluate(exp, model, device=device)
                dt = time.perf_counter() - t
                for name, res in results.items():
                    log_primary("[val %s] mAP@0.25 %.4f mAP@0.50 %.4f", name,
                                res.get("mAP_0.25", 0), res.get("mAP_0.50", 0))
                log_primary("validation after epoch %d: %.2f s", epoch, dt,
                            extra=_stats("val", epoch=epoch, step=step, seconds=dt,
                                         results=results))
    finally:
        loader.close()
        mngr.close()
    return model, optimizer


def at_capacities(model: UniDet3D, cfg_b: ModelConfig) -> UniDet3D:
    """The model at an eval bucket's capacities: a shallow copy whose config
    is cfg_b and which shares every parameter and buffer with `model` (the
    weights do not depend on the capacities)."""
    if cfg_b == model.cfg:
        return model
    model_b = copy.copy(model)
    model_b.cfg = cfg_b
    return model_b


def evaluate(exp: ExperimentConfig, model: UniDet3D, device="cuda", logger=None,
             num_threads: int | None = None, metric: IndoorMetric | None = None,
             show: bool = False, show_dir: str | None = None):
    """Per-dataset validation: returns IndoorMetric.compute()'s
    {dataset name: {"mAP_0.25", "mAP_0.50", ...}}.

    `model` is the port's detector on `device` ("cuda" unless the caller asks
    for "cpu"); it runs in eval mode under no_grad. For each dataset one
    EvalLoader builds and stages the groups; each group runs the forward and
    predict_batch at its bucket's config, and is drained (its detections
    copied to the host and fed to the metric) one group late, after the next
    group was dispatched, so that the host's metric work overlaps the card.
    In a torch.distributed run every process evaluates a strided shard of
    each dataset and the metric gathers before compute(). Each dataset's
    scenes/s, groups per bucket, seconds the loop waited for each group and
    the workers' seconds per group are logged (the record's `eval_stats`).
    `metric` is the IndoorMetric to fill (a new one by default); the scenes
    it holds stay readable after the call.

    With `show_dir`, each scene's points, ground-truth boxes and kept
    predictions are written as .obj files (``viz/show_results.py::
    show_result``) under <show_dir>/<dataset>_scene<k>/, k being the scene's
    index in its info file, so that the processes of a distributed run write
    disjoint names. With `show`, each scene opens in the open3d viewer;
    without open3d this warns once and evaluation goes on."""
    device = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"model on {param.device}, evaluate asked for {device}")
    cfg = exp.model
    if metric is None:
        metric = IndoorMetric(cfg, exp.datasets_classes)
    rank, world = rank_world()
    eval_bs = exp.eval_batch_size or 4

    def drain(pending):
        """The host half of one group: detections to numpy, into the metric
        and the visualisers."""
        nonlocal show
        det, samples, scene_ids, didx = pending
        boxes, labels, scores, valid = (x.cpu().numpy() for x in det)
        for i, k in enumerate(scene_ids):
            gt_boxes = samples[i]["gt_bboxes_3d"]
            if gt_boxes.shape[1] == 6:
                gt_boxes = np.concatenate(
                    [gt_boxes, np.zeros((len(gt_boxes), 1), np.float32)], 1)
            metric.process(didx, boxes[i], labels[i], scores[i], valid[i], gt_boxes,
                           samples[i]["gt_labels_3d"])
            if not (show or show_dir):
                continue
            pred = boxes[i][valid[i].astype(bool)]
            points = np.asarray(samples[i]["points"], np.float32)
            if show_dir:
                show_result(show_dir, f"{cfg.datasets[didx]}_scene{k:05d}", points,
                            gt_boxes, pred)
            if show:
                try:
                    show_online(points, pred)
                except ImportError as e:
                    log.warning("show disabled: %s", e)
                    show = False

    was_training = model.training
    model.eval()
    pending = None
    n_scenes = 0
    t_all = time.time()
    try:
        for ds in build_datasets(exp, "val"):
            didx = ds.dataset_idx
            loader = EvalLoader(ds, cfg, eval_bs, shard_idx=rank, shard_count=world,
                                num_threads=num_threads, device=device)
            buckets = collections.Counter()
            waits = []
            n_ds = 0
            t0 = time.time()
            groups = iter(loader)
            for g in itertools.count():
                t_wait = time.perf_counter()
                try:
                    samples, batch, _, pack, n_real, cfg_b = next(groups)
                except StopIteration:
                    break
                waits.append(time.perf_counter() - t_wait)
                with torch.no_grad():
                    out, aux = at_capacities(model, cfg_b)(batch, pack)
                    det = predict_batch(cfg_b, didx, out.cls_logits[-1], out.boxes[-1],
                                        aux.query_valid, batch.points, batch.valid,
                                        batch.sp_ids)
                if pending is not None:
                    drain(pending)
                pending = (det, samples, loader.group_indices(g), didx)
                buckets[(cfg_b.max_points, cfg_b.max_superpoints)] += 1
                n_ds += n_real
            if pending is not None:
                drain(pending)
                pending = None
            dt = max(time.time() - t0, 1e-9)
            n_scenes += n_ds
            times = list(loader.times)
            stats = dict(
                dataset=cfg.datasets[didx], scenes=n_ds, groups=sum(buckets.values()),
                seconds=dt, buckets=dict(buckets), wait_s=waits,
                worker_s={part: statistics.median(getattr(t, part) for t in times)
                          for part in ("pipeline", "collate", "pack", "stage")}
                if times else {},
            )
            log.info("eval %s: %d scenes, %d groups in %.2f s (%.2f scenes/s); "
                     "groups per (max_points, max_superpoints) bucket %s",
                     stats["dataset"], n_ds, stats["groups"], dt, n_ds / dt,
                     stats["buckets"], extra={"eval_stats": stats})
    finally:
        model.train(was_training)
    dt = max(time.time() - t_all, 1e-9)
    log.info("eval: %d scenes in %.1f s (%.2f scenes/s)", n_scenes, dt, n_scenes / dt)
    metric.gather_across_processes()
    return metric.compute(logger=logger if logger is not None else print)
