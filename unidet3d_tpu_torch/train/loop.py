"""Model and dataset construction, and the evaluation loop.

The port of the JAX package's ``train/loop.py`` (``build_model``,
``build_datasets``, ``evaluate``): per-dataset validation over the eval
loader's size-sorted, capacity-bucketed groups, the forward and
post-processing on the card, and indoor mAP on the host. The training loop
(``train``) comes with checkpoints.
"""
from __future__ import annotations

import collections
import copy
import logging
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.class_table import build_class_table
from ..core.config import ModelConfig
from ..core.experiment import ExperimentConfig
from ..data.dataset_specs import DEFAULT_LABEL_MAPPINGS
from ..data.datasets import IndoorDataset
from ..data.loader import EvalLoader
from ..data.pipelines import test_pipeline, train_pipeline
from ..device import resolve_device
from ..models.detector import UniDet3D
from ..models.postprocess import predict_batch
from .metric import IndoorMetric

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
             num_threads: int | None = None, metric: IndoorMetric | None = None):
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
    the workers' seconds per group are logged (the record's `eval_stats`). `metric` is the IndoorMetric to fill (a new
    one by default); the scenes it holds stay readable after the call."""
    device = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"model on {param.device}, evaluate asked for {device}")
    cfg = exp.model
    if metric is None:
        metric = IndoorMetric(cfg, exp.datasets_classes)
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_available() and dist.is_initialized() else (0, 1))
    eval_bs = exp.eval_batch_size or 4

    def drain(pending):
        """The host half of one group: detections to numpy, into the metric."""
        det, samples, n_real, didx = pending
        det = [x.cpu().numpy() for x in det]
        for i in range(n_real):
            gt_boxes = samples[i]["gt_bboxes_3d"]
            if gt_boxes.shape[1] == 6:
                gt_boxes = np.concatenate(
                    [gt_boxes, np.zeros((len(gt_boxes), 1), np.float32)], 1)
            metric.process(didx, *(x[i] for x in det), gt_boxes,
                           samples[i]["gt_labels_3d"])

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
            while True:
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
                pending = (det, samples, n_real, didx)
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
