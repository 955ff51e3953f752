"""Axis-aligned DIoU loss, the port of the JAX package's
``losses/iou_losses.py::axis_aligned_diou_loss``.

Elementwise over any leading dims, unreduced, differentiable. The rotated
DIoU (``rotated_diou_3d_loss``, ARKitScenes) is not ported yet: ROADMAP.md
Queue 1, item 3.
"""
from __future__ import annotations

import torch

from ..core.boxes import axis_aligned_overlaps_3d

_EPS = 1e-8


def axis_aligned_diou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """DIoU loss (1 - IoU + r^2 / c^2) of corner-format boxes (..., 6)."""
    iou_loss = 1.0 - axis_aligned_overlaps_3d(pred, target, aligned=True)
    pc = (pred[..., :3] + pred[..., 3:]) / 2
    tc = (target[..., :3] + target[..., 3:]) / 2
    r2 = ((pc - tc) ** 2).sum(-1)
    mins = torch.minimum(pred[..., :3], target[..., :3])
    maxs = torch.maximum(pred[..., 3:], target[..., 3:])
    c2 = ((maxs - mins) ** 2).sum(-1)
    return iou_loss + r2 / c2.clamp(min=_EPS)
