"""ARKitScenes offline preparation utilities.

The port's own copy of the JAX package's ``tools/arkitscenes_utils.py``, the
counterpart of the reference's data/arkitscenes/*: RGB-D frames are
back-projected and accumulated into a point cloud on a 5 cm grid
(data_prepare_offline.py:16-44), and the 3D-OD annotations (center + scale +
rotation matrix) become 7-dof gravity-center boxes (utils/box_utils.py,
taxonomy). numpy only — no open3d dependency.
"""
from __future__ import annotations

import numpy as np


def unproject_depth(
    depth: np.ndarray,  # (H, W) metres
    intrinsics: np.ndarray,  # (3, 3)
    pose: np.ndarray,  # (4, 4) camera-to-world
    rgb: np.ndarray | None = None,  # (H, W, 3)
    max_depth: float = 10.0,
):
    """Back-project one RGB-D frame to world-frame points (N, 3|6)."""
    h, w = depth.shape
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    z = depth.reshape(-1)
    ok = (z > 0) & (z < max_depth)
    u = u.reshape(-1)[ok]
    v = v.reshape(-1)[ok]
    z = z[ok]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    cam = np.stack([x, y, z, np.ones_like(z)], 1)
    world = (cam @ pose.T)[:, :3].astype(np.float32)
    if rgb is not None:
        cols = rgb.reshape(-1, 3)[ok].astype(np.float32)
        return np.concatenate([world, cols], 1)
    return world


def voxel_downsample(points: np.ndarray, grid: float = 0.05) -> np.ndarray:
    """Average points per `grid` cell (ref accumulation at 0.05 m,
    data_prepare_offline.py:16-44)."""
    coords = np.floor(points[:, :3] / grid).astype(np.int64)
    coords -= coords.min(0)
    key = (
        coords[:, 0] * (coords[:, 1].max() + 1) + coords[:, 1]
    ) * (coords[:, 2].max() + 1) + coords[:, 2]
    order = np.argsort(key)
    ks = key[order]
    new = np.ones(len(ks), bool)
    new[1:] = ks[1:] != ks[:-1]
    seg = np.cumsum(new) - 1
    sums = np.zeros((seg[-1] + 1, points.shape[1]), np.float64)
    np.add.at(sums, seg, points[order])
    counts = np.bincount(seg).astype(np.float64)
    return (sums / counts[:, None]).astype(np.float32)


def accumulate_frames(frames, grid: float = 0.05) -> np.ndarray:
    """frames: iterable of (depth, intrinsics, pose[, rgb]) tuples."""
    clouds = []
    for frame in frames:
        clouds.append(unproject_depth(*frame))
    return voxel_downsample(np.concatenate(clouds, 0), grid)


def annotation_to_box7(center, scale, rotation) -> np.ndarray:
    """ARKitScenes 3DOD annotation -> (7,) gravity-center box.

    rotation: (3, 3) matrix or (9,) flat; yaw extracted from the matrix
    (ref utils/box_utils.py corner math collapsed to the yaw-only case the
    detector consumes)."""
    rot = np.asarray(rotation, np.float64).reshape(3, 3)
    yaw = np.arctan2(rot[1, 0], rot[0, 0])
    return np.concatenate(
        [np.asarray(center, np.float32), np.asarray(scale, np.float32),
         np.asarray([yaw], np.float32)]
    )


def boxes_from_annotation_json(data: dict) -> tuple[np.ndarray, list]:
    """Parse an ARKitScenes 3DOD annotation dict -> (boxes (G, 7), labels)."""
    boxes, labels = [], []
    for obj in data.get("data", []):
        seg = obj["segments"]["obbAligned"]
        boxes.append(
            annotation_to_box7(
                seg["centroid"], seg["axesLengths"], seg["normalizedAxes"]
            )
        )
        labels.append(obj.get("label"))
    if boxes:
        return np.stack(boxes), labels
    return np.zeros((0, 7), np.float32), []
