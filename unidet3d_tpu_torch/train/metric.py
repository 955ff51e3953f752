"""Per-dataset detection metric accumulator.

The port of the JAX package's ``train/metric.py``: detections and ground
truth are routed to their dataset by its index, kept on the host, and
evaluated per dataset with ``indoor_eval`` at IoU thresholds 0.25 / 0.50
(rotated overlaps for the datasets with ``cfg.angles``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch.distributed as dist

from ..core.config import ModelConfig
from .indoor_eval import indoor_eval
from .profiling import span


class IndoorMetric:
    def __init__(self, cfg: ModelConfig, datasets_classes, iou_thrs=(0.25, 0.5)):
        self.cfg = cfg
        self.datasets_classes = datasets_classes
        self.iou_thrs = tuple(iou_thrs)
        self._gt = {i: [] for i in range(cfg.num_datasets)}
        self._dt = {i: [] for i in range(cfg.num_datasets)}

    def process(
        self,
        dataset_idx: int,
        det_boxes: np.ndarray,  # (K, 7)
        det_labels: np.ndarray,
        det_scores: np.ndarray,
        det_valid: np.ndarray,
        gt_boxes: np.ndarray,  # (M, 7)
        gt_labels: np.ndarray,
    ):
        """Adds one scene: its valid detections and its ground truth."""
        v = np.asarray(det_valid, bool)
        self._dt[dataset_idx].append({
            "boxes": np.asarray(det_boxes)[v].reshape(-1, 7),
            "labels": np.asarray(det_labels)[v],
            "scores": np.asarray(det_scores)[v],
        })
        self._gt[dataset_idx].append({
            "gt_boxes": np.asarray(gt_boxes).reshape(-1, 7),
            "gt_labels": np.asarray(gt_labels),
        })

    def process_group(self, pred, group, viewer=None):
        """Adds an eval group's scenes: `pred` its (boxes, labels, scores,
        valid) detections on the device (``predict_batch``), `group` the
        loop's EvalGroup. The copy to the host is the span "eval.fetch",
        the rest "eval.metric"; a true `viewer` (``loop.Viewer``) gets each
        scene's points, ground truth and kept boxes."""
        g, didx = group.index, group.dataset_idx
        with span("eval.fetch", g):
            boxes, labels, scores, valid = (x.cpu().numpy() for x in pred)
        with span("eval.metric", g):
            for i, k in enumerate(group.scene_ids):
                sample = group.samples[i]
                gt_boxes = sample["gt_bboxes_3d"]
                if gt_boxes.shape[1] == 6:
                    gt_boxes = np.concatenate(
                        [gt_boxes, np.zeros((len(gt_boxes), 1), np.float32)], 1)
                self.process(didx, boxes[i], labels[i], scores[i], valid[i], gt_boxes,
                             sample["gt_labels_3d"])
                if viewer:
                    viewer.scene(group.cfg, didx, k, sample, gt_boxes,
                                 boxes[i][valid[i].astype(bool)])

    def gather_across_processes(self):
        """Every process contributes its scenes; afterwards each holds the
        union, ordered by rank, so that compute() gives the same everywhere.
        A no-op unless a torch.distributed process group is initialised.
        The scenes are numpy arrays on the host: ``all_gather_object``
        pickles them through CPU tensors under gloo, and through the current
        card under NCCL (``parallel.distributed.maybe_initialize`` selects
        the rank's card first)."""
        if not (dist.is_available() and dist.is_initialized()):
            return
        payload = [None] * dist.get_world_size()
        dist.all_gather_object(payload, (self._gt, self._dt))
        gt = {i: [] for i in self._gt}
        dt = {i: [] for i in self._dt}
        for proc_gt, proc_dt in payload:
            for i in gt:
                gt[i].extend(proc_gt[i])
                dt[i].extend(proc_dt[i])
        self._gt, self._dt = gt, dt

    def compute(self, logger=print) -> Dict[str, Dict[str, float]]:
        """{dataset name: indoor_eval's results} for every dataset that has
        scenes."""
        results = {}
        for d in range(self.cfg.num_datasets):
            if not self._dt[d]:
                continue
            name = self.cfg.datasets[d]
            if logger is not None:
                logger(f"==== {name} ====")
            results[name] = indoor_eval(
                self._gt[d],
                self._dt[d],
                self.iou_thrs,
                list(self.datasets_classes[d]),
                with_yaw=self.cfg.angles[d],
                logger=logger,
            )
        return results
