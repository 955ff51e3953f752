"""3D box geometry needed by post-processing.

Box convention: ``(cx, cy, cz, dx, dy, dz[, yaw])`` with the gravity center
and yaw around +z, as in the JAX package's ``core/boxes.py``.
"""
from __future__ import annotations

import torch

EPS = 1e-6


def boxes_to_corner_format(boxes: torch.Tensor) -> torch.Tensor:
    """Center-size -> (x1, y1, z1, x2, y2, z2). Identity for 7-dof boxes."""
    if boxes.shape[-1] != 6:
        return boxes
    half = boxes[..., 3:6] / 2
    return torch.cat([boxes[..., :3] - half, boxes[..., :3] + half], dim=-1)


def rotate_points_z(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate points (..., 3) around +z by `angles` (broadcastable to (...)),
    row-vector convention ``p @ R`` with R = [[c, s, 0], [-s, c, 0], [0, 0, 1]]."""
    c = torch.cos(angles)
    s = torch.sin(angles)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return torch.stack(
        [x * c - y * s, x * s + y * c, z.expand_as(x * c)], dim=-1
    )


def get_face_distances(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Distances from points (..., 3) to the six faces of boxes (..., 7).

    Returns (..., 6): (dx_min, dx_max, dy_min, dy_max, dz_min, dz_max); all
    six positive <=> point inside box."""
    shift = rotate_points_z(points - boxes[..., :3], -boxes[..., 6])
    half = boxes[..., 3:6] / 2
    d_min = shift + half
    d_max = half - shift
    return torch.stack(
        [
            d_min[..., 0], d_max[..., 0],
            d_min[..., 1], d_max[..., 1],
            d_min[..., 2], d_max[..., 2],
        ],
        dim=-1,
    )


def axis_aligned_overlaps_3d(
    boxes1: torch.Tensor, boxes2: torch.Tensor
) -> torch.Tensor:
    """Pairwise IoU (N, M) of corner-format boxes (N, 6) and (M, 6)."""
    lt = torch.maximum(boxes1[:, None, :3], boxes2[None, :, :3])
    rb = torch.minimum(boxes1[:, None, 3:], boxes2[None, :, 3:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1] * wh[..., 2]
    vol1 = torch.prod(boxes1[:, 3:] - boxes1[:, :3], dim=-1)
    vol2 = torch.prod(boxes2[:, 3:] - boxes2[:, :3], dim=-1)
    union = vol1[:, None] + vol2[None, :] - overlap
    return overlap / union.clamp(min=EPS)
