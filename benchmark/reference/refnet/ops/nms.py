"""Class-wise greedy 3D NMS.

The port of the JAX package's ``ops/nms.py``: a pairwise IoU matrix
(axis-aligned, ``pairwise_iou_aa``, or rotated, ``pairwise_iou_rotated``,
ARKitScenes), then greedy suppression over score-sorted boxes restricted to
same-class pairs (``greedy_nms``).
"""
from __future__ import annotations

import torch

from ..core.boxes import axis_aligned_overlaps_3d, boxes_to_corner_format
from .rotated_iou import rotated_iou_3d


def pairwise_iou_aa(boxes: torch.Tensor) -> torch.Tensor:
    """(N, >=6) center-size boxes -> (N, N) axis-aligned IoU (yaw ignored)."""
    corners = boxes_to_corner_format(boxes[:, :6])
    return axis_aligned_overlaps_3d(corners, corners)


def pairwise_iou_rotated(boxes: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """(N, 7) boxes -> (N, N) rotated 3D IoU, `chunk` rows at a time to bound
    the clip's temporaries."""
    return torch.cat(
        [rotated_iou_3d(boxes[r0:r0 + chunk, None, :], boxes[None, :, :])
         for r0 in range(0, boxes.shape[0], chunk)]
    )


def greedy_nms(
    iou: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    iou_thr: float,
) -> torch.Tensor:
    """Greedy class-wise NMS. Returns the keep mask (N,) on iou's device.

    Boxes are taken in descending score order; a box is suppressed if a kept,
    higher-scoring box of the same class overlaps it above iou_thr. The
    suppression edges are computed on the device; the sequential walk over
    the (at most topk_insts = 1000) boxes runs on the host over one (N, N)
    bool copy, because one device launch per step would cost more than the
    copy."""
    order = torch.argsort(-torch.where(valid, scores, -1.0), stable=True)
    iou_s = iou[order][:, order]
    labels_s = labels[order]
    sup = (iou_s > iou_thr) & (labels_s[:, None] == labels_s[None, :])
    sup_np = sup.cpu().numpy()
    keep = valid[order].cpu().numpy().copy()
    for i in range(len(keep)):
        if keep[i]:
            keep[i + 1:] &= ~sup_np[i, i + 1:]
    keep_s = torch.from_numpy(keep).to(iou.device)
    out = torch.zeros_like(keep_s)
    out[order] = keep_s
    return out
