"""Axis-aligned and rotated (D)IoU losses, the port of the JAX package's
``losses/iou_losses.py``.

Elementwise over any leading dims, unreduced, differentiable: the criterion
uses them one-to-one on matched pairs and pairwise as matching costs.
"""
from __future__ import annotations

import torch

from ..core.boxes import axis_aligned_overlaps_3d
from ..ops.rotated_iou import diff_diou_rotated_3d, rotated_iou_3d

_EPS = 1e-8


def axis_aligned_iou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - IoU of corner-format boxes (..., 6) = (x1, y1, z1, x2, y2, z2)."""
    return 1.0 - axis_aligned_overlaps_3d(pred, target, aligned=True)


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


def rotated_iou_3d_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - rotated IoU of (..., 7) boxes (x, y, z, w, l, h, alpha)."""
    return 1.0 - rotated_iou_3d(pred, target)


def rotated_diou_3d_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - rotated DIoU of (..., 7) boxes (x, y, z, w, l, h, alpha)."""
    return 1.0 - diff_diou_rotated_3d(pred, target)


def make_bbox_loss(mode: str, rotated: bool):
    """The loss of a reference registry entry: mode 'iou' | 'diou'; `rotated`
    selects the 7-dof branch."""
    if rotated:
        return rotated_diou_3d_loss if mode == "diou" else rotated_iou_3d_loss
    return axis_aligned_diou_loss if mode == "diou" else axis_aligned_iou_loss
