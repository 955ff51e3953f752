"""Differentiable intersection, IoU and DIoU of rotated boxes.

The port of the JAX package's ``ops/rotated_iou.py``, which ARKitScenes'
loss, matcher costs, NMS and mAP overlaps share. Elementwise over any
leading dims, fixed shapes, differentiable through the gathered vertex
coordinates.

Per pair of rotated BEV rectangles:
  1. 24 candidate vertices of the intersection polygon: the 16 edge-edge
     crossings, the 4 corners of box 1 inside box 2 and the 4 of box 2
     inside box 1;
  2. the valid candidates sorted by angle around their centroid (a stable
     sort on keys without gradient; invalid candidates last);
  3. the shoelace formula over the valid prefix, closed cyclically.
"""
from __future__ import annotations

import torch

from ..core.boxes import box_corners_bev

_EPS = 1e-8


def _points_in_rotated_box(points: torch.Tensor, boxes5: torch.Tensor) -> torch.Tensor:
    """points (..., K, 2) inside boxes5 (..., 5), boundary included (+1e-6)
    -> (..., K) bool."""
    rel = points - boxes5[..., None, :2]
    c = torch.cos(boxes5[..., 4])[..., None]
    s = torch.sin(boxes5[..., 4])[..., None]
    # Into the box frame (the inverse rotation).
    local_x = rel[..., 0] * c + rel[..., 1] * s
    local_y = -rel[..., 0] * s + rel[..., 1] * c
    tol = 1e-6
    inside_x = local_x.abs() <= boxes5[..., None, 2] / 2 + tol
    inside_y = local_y.abs() <= boxes5[..., None, 3] / 2 + tol
    return inside_x & inside_y


def _edge_intersections(c1: torch.Tensor, c2: torch.Tensor):
    """The 16 crossings of the edges of two quads (..., 4, 2) (edge i runs
    from corner i to corner i + 1) -> points (..., 16, 2), valid (..., 16)."""
    p1 = c1[..., :, None, :]
    p2 = torch.roll(c1, -1, dims=-2)[..., :, None, :]
    q1 = c2[..., None, :, :]
    q2 = torch.roll(c2, -1, dims=-2)[..., None, :, :]
    d1 = p2 - p1  # (..., 4, 4, 2): edge i of box 1 x edge j of box 2
    d2 = q2 - q1
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    dq = q1 - p1
    t_num = dq[..., 0] * d2[..., 1] - dq[..., 1] * d2[..., 0]
    u_num = dq[..., 0] * d1[..., 1] - dq[..., 1] * d1[..., 0]
    parallel = denom.abs() < _EPS
    safe = torch.where(parallel, 1.0, denom)
    t = t_num / safe
    u = u_num / safe
    valid = ~parallel & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    pts = p1 + t[..., None] * d1
    lead = pts.shape[:-3]
    return pts.reshape(*lead, 16, 2), valid.reshape(*lead, 16)


def rotated_intersection_area_2d(boxes5_a: torch.Tensor,
                                 boxes5_b: torch.Tensor) -> torch.Tensor:
    """Intersection areas (...,) of rotated rectangles (..., 5) = (x, y, w,
    h, alpha), elementwise over broadcast leading dims."""
    boxes5_a, boxes5_b = torch.broadcast_tensors(boxes5_a, boxes5_b)
    c1 = box_corners_bev(boxes5_a)  # (..., 4, 2)
    c2 = box_corners_bev(boxes5_b)
    inter_pts, inter_valid = _edge_intersections(c1, c2)
    in12 = _points_in_rotated_box(c1, boxes5_b)  # (..., 4)
    in21 = _points_in_rotated_box(c2, boxes5_a)
    vertices = torch.cat([inter_pts, c1, c2], dim=-2)  # (..., 24, 2)
    valid = torch.cat([inter_valid, in12, in21], dim=-1)  # (..., 24)

    num_valid = valid.sum(-1)  # (...,)
    validf = valid[..., None].to(vertices.dtype)
    center = (vertices * validf).sum(-2) / num_valid[..., None].clamp(min=1).to(
        vertices.dtype)
    rel = (vertices - center[..., None, :]) * validf
    # Sort keys only, cut from the graph: atan2 at the zeroed invalid
    # candidates would give NaN gradients. The sort is stable (as jnp.argsort),
    # so that the first of two equal candidates carries the gradient.
    rel_sg = rel.detach()
    angles = torch.atan2(rel_sg[..., 1], rel_sg[..., 0])
    angles = torch.where(valid, angles, float("inf"))  # invalid -> tail
    order = torch.argsort(angles, dim=-1, stable=True)
    rel_sorted = torch.gather(rel, -2, order[..., None].expand(rel.shape))

    # Cyclic next index within the valid prefix [0, k).
    idx = torch.arange(24, device=rel.device)
    k = num_valid[..., None]
    nxt = torch.where(idx + 1 >= k, 0, idx + 1)
    rel_next = torch.gather(rel_sorted, -2, nxt[..., None].expand(rel.shape))
    cross = rel_sorted[..., 0] * rel_next[..., 1] - rel_sorted[..., 1] * rel_next[..., 0]
    cross = torch.where(idx < k, cross, 0.0)
    area = 0.5 * cross.sum(-1).abs()
    # Fewer than 3 vertices: no polygon.
    return torch.where(num_valid >= 3, area, 0.0)


def _bev(box3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) (x, y, z, w, h, l, alpha) -> (..., 5) (x, y, w, h, alpha), by
    slices: indexing with a list would copy an index tensor to the device."""
    return torch.cat([box3d[..., 0:2], box3d[..., 3:5], box3d[..., 6:7]], dim=-1)


def _intersection_and_union_3d(box3d1, box3d2, b1, b2):
    intersection = rotated_intersection_area_2d(b1, b2)
    zmax1 = box3d1[..., 2] + box3d1[..., 5] * 0.5
    zmin1 = box3d1[..., 2] - box3d1[..., 5] * 0.5
    zmax2 = box3d2[..., 2] + box3d2[..., 5] * 0.5
    zmin2 = box3d2[..., 2] - box3d2[..., 5] * 0.5
    z_overlap = (torch.minimum(zmax1, zmax2) - torch.maximum(zmin1, zmin2)).clamp(min=0.0)
    intersection_3d = intersection * z_overlap
    volume1 = box3d1[..., 3] * box3d1[..., 4] * box3d1[..., 5]
    volume2 = box3d2[..., 3] * box3d2[..., 4] * box3d2[..., 5]
    union_3d = volume1 + volume2 - intersection_3d
    return intersection_3d, union_3d, (zmin1, zmax1, zmin2, zmax2)


def diff_diou_rotated_3d(box3d1: torch.Tensor, box3d2: torch.Tensor) -> torch.Tensor:
    """Differentiable DIoU (...,) of rotated 3D boxes (..., 7) = (x, y, z,
    w, h, l, alpha), gravity centers: IoU - center distance^2 / diagonal^2."""
    b1, b2 = _bev(box3d1), _bev(box3d2)
    intersection_3d, union_3d, (zmin1, zmax1, zmin2, zmax2) = (
        _intersection_and_union_3d(box3d1, box3d2, b1, b2))

    c1 = box_corners_bev(b1)
    c2 = box_corners_bev(b2)
    x_max = torch.maximum(c1[..., 0].amax(-1), c2[..., 0].amax(-1))
    x_min = torch.minimum(c1[..., 0].amin(-1), c2[..., 0].amin(-1))
    y_max = torch.maximum(c1[..., 1].amax(-1), c2[..., 1].amax(-1))
    y_min = torch.minimum(c1[..., 1].amin(-1), c2[..., 1].amin(-1))
    z_max = torch.maximum(zmax1, zmax2)
    z_min = torch.minimum(zmin1, zmin2)

    # b1[..., :3] of the 5-dim BEV box is (x, y, w), not (x, y, z): the JAX
    # package reproduces the reference's (mmcv's) rotated DIoU loss exactly
    # there, for checkpoint-level training parity, and so does the port.
    r2 = ((b1[..., :3] - b2[..., :3]) ** 2).sum(-1)
    c2_diag = (x_min - x_max) ** 2 + (y_min - y_max) ** 2 + (z_min - z_max) ** 2
    return intersection_3d / union_3d.clamp(min=_EPS) - r2 / c2_diag.clamp(min=_EPS)


def rotated_iou_3d(box3d1: torch.Tensor, box3d2: torch.Tensor) -> torch.Tensor:
    """Rotated 3D IoU (...,) of boxes (..., 7), elementwise (eval overlaps,
    NMS)."""
    intersection_3d, union_3d, _ = _intersection_and_union_3d(
        box3d1, box3d2, _bev(box3d1), _bev(box3d2))
    return intersection_3d / union_3d.clamp(min=_EPS)
