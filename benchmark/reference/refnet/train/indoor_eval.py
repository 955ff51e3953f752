"""Indoor detection mAP / mAR (host-side numpy).

The port of the JAX package's ``train/indoor_eval.py``, itself the
reference's ``indoor_eval.py``: VOC-style AP with greedy per-scene IoU
matching, the area under the PR curve, several IoU thresholds, and an ASCII
table. Box overlaps: axis-aligned IoU for 6-dof boxes, rotated 3D IoU
(``ops/rotated_iou.py`` on CPU tensors) for 7-dof ones.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.rotated_iou import rotated_iou_3d


def _aa_iou(pred: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """(N, 6+) x (M, 6+) gravity-center boxes -> (N, M) axis-aligned IoU."""
    p1 = pred[:, None, :3] - pred[:, None, 3:6] / 2
    p2 = pred[:, None, :3] + pred[:, None, 3:6] / 2
    g1 = gts[None, :, :3] - gts[None, :, 3:6] / 2
    g2 = gts[None, :, :3] + gts[None, :, 3:6] / 2
    lt = np.maximum(p1, g1)
    rb = np.minimum(p2, g2)
    wh = np.clip(rb - lt, 0, None)
    inter = wh.prod(-1)
    v1 = np.clip(pred[:, None, 3:6], 0, None).prod(-1)
    v2 = np.clip(gts[None, :, 3:6], 0, None).prod(-1)
    return inter / np.maximum(v1 + v2 - inter, 1e-8)


def _rotated_iou(pred: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """(N, 7) x (M, 7) -> (N, M) rotated 3D IoU, in float32 on the CPU."""
    p = torch.as_tensor(np.asarray(pred, np.float32))
    g = torch.as_tensor(np.asarray(gts, np.float32))
    return rotated_iou_3d(p[:, None, :], g[None, :, :]).numpy()


def box_overlaps(pred: np.ndarray, gts: np.ndarray, with_yaw: bool):
    if pred.size == 0 or gts.size == 0:
        return np.zeros((len(pred), len(gts)), np.float32)
    if with_yaw:
        return _rotated_iou(pred[:, :7], gts[:, :7])
    return _aa_iou(pred, gts)


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """Area-mode AP: the area under the PR curve made monotone."""
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det_cls(
    pred: Dict[int, list], gt: Dict[int, np.ndarray], iou_thrs, with_yaw
):
    """Per-class PR over all scenes.

    pred: scene_id -> list of (box (7,), score); gt: scene_id -> (M, 7).
    Returns per-threshold (recall_curve, precision_curve, ap).
    """
    class_recs = {}
    npos = 0
    for scene, boxes in gt.items():
        class_recs[scene] = {
            "bbox": boxes,
            "det": [np.zeros(len(boxes), bool) for _ in iou_thrs],
        }
        npos += len(boxes)

    scene_ids, confidences, ious = [], [], []
    for scene, dets in pred.items():
        if not dets:
            continue
        boxes = np.stack([d[0] for d in dets])
        gtb = class_recs.get(scene, {"bbox": np.zeros((0, 7))})["bbox"]
        iou = box_overlaps(boxes, gtb, with_yaw) if len(gtb) else None
        for i, (box, score) in enumerate(dets):
            scene_ids.append(scene)
            confidences.append(score)
            ious.append(iou[i] if iou is not None else np.zeros(0))

    order = np.argsort(-np.asarray(confidences)) if confidences else []
    nd = len(order)
    tp = [np.zeros(nd) for _ in iou_thrs]
    fp = [np.zeros(nd) for _ in iou_thrs]
    for d, oi in enumerate(order):
        scene = scene_ids[oi]
        rec = class_recs.get(scene)
        cur = ious[oi]
        jmax, iou_max = -1, -np.inf
        for j in range(len(cur)):
            if cur[j] > iou_max:
                iou_max = cur[j]
                jmax = j
        for ti, thr in enumerate(iou_thrs):
            if iou_max > thr and rec is not None:
                if not rec["det"][ti][jmax]:
                    tp[ti][d] = 1.0
                    rec["det"][ti][jmax] = True
                else:
                    fp[ti][d] = 1.0
            else:
                fp[ti][d] = 1.0

    out = []
    for ti in range(len(iou_thrs)):
        cfp = np.cumsum(fp[ti])
        ctp = np.cumsum(tp[ti])
        recall = ctp / max(float(npos), 1e-8)
        precision = ctp / np.maximum(ctp + cfp, np.finfo(np.float64).eps)
        out.append((recall, precision, average_precision(recall, precision)))
    return out


def indoor_eval(
    gt_annos: List[dict],
    dt_annos: List[dict],
    iou_thrs: Sequence[float],
    classes: Sequence[str],
    with_yaw: bool = False,
    logger=print,
) -> Dict[str, float]:
    """Per-class AP and recall at each IoU threshold, their means, and the
    table (printed through `logger` unless it is None).

    gt_annos[i]: {'gt_boxes': (M, 7) np, 'gt_labels': (M,) np}.
    dt_annos[i]: {'boxes': (N, 7), 'labels': (N,), 'scores': (N,)}.
    """
    pred = {}  # class -> scene -> [(box, score)]
    gt = {}  # class -> scene -> (M, 7)
    for scene, (g, d) in enumerate(zip(gt_annos, dt_annos)):
        for i in range(len(d["labels"])):
            c = int(d["labels"][i])
            pred.setdefault(c, {}).setdefault(scene, []).append(
                (d["boxes"][i], float(d["scores"][i]))
            )
            gt.setdefault(c, {}).setdefault(scene, [])
        for i in range(len(g["gt_labels"])):
            c = int(g["gt_labels"][i])
            gt.setdefault(c, {}).setdefault(scene, [])
        for c in gt:
            if scene not in gt[c]:
                gt[c][scene] = []
    # Convert gt lists to arrays.
    gt_arr = {}
    for c, scenes in gt.items():
        gt_arr[c] = {}
        for scene in scenes:
            gb = gt_annos[scene]
            mask = np.asarray(gb["gt_labels"]) == c
            gt_arr[c][scene] = np.asarray(gb["gt_boxes"]).reshape(-1, 7)[mask]

    ret = {}
    table_rows = []
    aps = {t: [] for t in iou_thrs}
    ars = {t: [] for t in iou_thrs}
    for c in sorted(gt_arr.keys()):
        name = classes[c] if c < len(classes) else str(c)
        if c in pred:
            res = eval_det_cls(pred[c], gt_arr[c], iou_thrs, with_yaw)
        else:
            res = [(np.zeros(1), np.zeros(1), 0.0) for _ in iou_thrs]
        row = [name]
        for ti, t in enumerate(iou_thrs):
            recall, precision, ap = res[ti]
            rec_last = float(recall[-1]) if len(recall) else 0.0
            ret[f"{name}_AP_{t:.2f}"] = ap
            ret[f"{name}_rec_{t:.2f}"] = rec_last
            aps[t].append(ap)
            ars[t].append(rec_last)
            row += [f"{ap:.4f}", f"{rec_last:.4f}"]
        table_rows.append(row)

    header = ["classes"]
    for t in iou_thrs:
        header += [f"AP_{t:.2f}", f"AR_{t:.2f}"]
    overall = ["Overall"]
    for t in iou_thrs:
        ret[f"mAP_{t:.2f}"] = float(np.nanmean(aps[t])) if aps[t] else 0.0
        ret[f"mAR_{t:.2f}"] = float(np.nanmean(ars[t])) if ars[t] else 0.0
        overall += [f"{ret[f'mAP_{t:.2f}']:.4f}", f"{ret[f'mAR_{t:.2f}']:.4f}"]
    table_rows.append(overall)

    if logger is not None:
        widths = [
            max(len(str(r[i])) for r in [header] + table_rows)
            for i in range(len(header))
        ]
        lines = [
            " | ".join(str(v).ljust(w) for v, w in zip(row, widths))
            for row in [header] + table_rows
        ]
        sep = "-+-".join("-" * w for w in widths)
        logger("\n".join([lines[0], sep] + lines[1:]))
    return ret
