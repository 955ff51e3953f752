"""3D box geometry needed by post-processing and the training loss.

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
    boxes1: torch.Tensor, boxes2: torch.Tensor, aligned: bool = False
) -> torch.Tensor:
    """IoU of corner-format boxes (x1, y1, z1, x2, y2, z2): pairwise (N, M)
    of (N, 6) and (M, 6), or with `aligned` elementwise (...,) of two
    (..., 6) stacks."""
    if not aligned:
        boxes1, boxes2 = boxes1[:, None, :], boxes2[None, :, :]
    lt = torch.maximum(boxes1[..., :3], boxes2[..., :3])
    rb = torch.minimum(boxes1[..., 3:], boxes2[..., 3:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1] * wh[..., 2]
    vol1 = torch.prod(boxes1[..., 3:] - boxes1[..., :3], dim=-1)
    vol2 = torch.prod(boxes2[..., 3:] - boxes2[..., :3], dim=-1)
    union = vol1 + vol2 - overlap
    return overlap / union.clamp(min=EPS)


def rotation_matrix_z(angles: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations around +z, row-vector convention ``p @ R`` with
    R = [[c, s, 0], [-s, c, 0], [0, 0, 1]] (``rotate_points_z``'s)."""
    c = torch.cos(angles)
    s = torch.sin(angles)
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, s, zeros], dim=-1),
            torch.stack([-s, c, zeros], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )


def box_corners_bev(boxes5: torch.Tensor) -> torch.Tensor:
    """BEV corners (..., 4, 2) of rotated 2D boxes (..., 5) = (x, y, w, h,
    alpha), counter-clockwise from (w, -h) / 2 in the box frame."""
    x, y, w, h, alpha = boxes5.unbind(-1)
    tx = torch.stack([w, w, -w, -w], dim=-1) * 0.5
    ty = torch.stack([-h, h, h, -h], dim=-1) * 0.5
    c = torch.cos(alpha)[..., None]
    s = torch.sin(alpha)[..., None]
    cx = tx * c - ty * s + x[..., None]
    cy = tx * s + ty * c + y[..., None]
    return torch.stack([cx, cy], dim=-1)


# The eight corners of a box in units of its half size.
_CORNER_SIGNS = (
    (-1, -1, -1), (-1, -1, 1), (-1, 1, -1), (-1, 1, 1),
    (1, -1, -1), (1, -1, 1), (1, 1, -1), (1, 1, 1),
)


def boxes7_corners(boxes: torch.Tensor) -> torch.Tensor:
    """Eight 3D corners (..., 8, 3) of gravity-center boxes (..., 7)."""
    signs = torch.tensor(_CORNER_SIGNS, dtype=boxes.dtype, device=boxes.device)
    local = signs * (boxes[..., None, 3:6] / 2)
    world = local @ rotation_matrix_z(boxes[..., 6])
    return world + boxes[..., None, :3]
