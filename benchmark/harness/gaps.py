"""Gaps between the program's outputs and the reference's."""
from __future__ import annotations

import math

import torch


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in norm."""
    a, b = a.float(), b.float().to(a.device)
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def box_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """rel_gap of (..., 7) boxes whose yaw is defined modulo pi (a box turned
    by pi is the same box; a rotated scene's yaw near +-pi/2 rounds to either
    end)."""
    a, b = a.float(), b.float().to(a.device)
    d = a - b
    d[..., 6] = torch.remainder(d[..., 6] + math.pi / 2, math.pi) - math.pi / 2
    return float(d.norm() / b.norm().clamp_min(1e-30))


def forward_gaps(logits, boxes, ref_logits, ref_boxes, valid) -> tuple:
    """(logits gap, boxes gap) of one scene's last-layer outputs over its
    valid queries; class slots the scene's dataset lacks (-inf) are left
    out."""
    a, b = logits[valid], ref_logits[valid]
    finite = b > -1e8
    return rel_gap(a[finite], b[finite]), box_gap(boxes[valid], ref_boxes[valid])
