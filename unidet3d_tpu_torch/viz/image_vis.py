"""Project 3D points and boxes into images (numpy).

The port's own copy of the JAX package's ``viz/image_vis.py`` (the
reference's ``project_pts_on_img``, ``draw_depth_bbox3d_on_img``,
``draw_camera_bbox3d_on_img``) without cv2: lines are rasterised by
sampling along them, so the images can be saved by any writer. No train or
eval path uses it.
"""
from __future__ import annotations

import numpy as np

from .show_results import EDGES, box_corners


def project_points(points: np.ndarray, proj_mat: np.ndarray) -> np.ndarray:
    """(N, 3) world points x (4, 4) projection -> (N, 3) [u, v, depth]."""
    ones = np.ones((len(points), 1), points.dtype)
    hom = np.concatenate([points[:, :3], ones], axis=1)
    cam = hom @ proj_mat.T
    depth = cam[:, 2:3]
    uv = cam[:, :2] / np.maximum(np.abs(depth), 1e-6) * np.sign(depth)
    return np.concatenate([uv, depth], axis=1)


def _draw_line(img, p0, p1, color):
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xs = np.linspace(p0[0], p1[0], n + 1).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n + 1).round().astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color
    return img


def draw_points_on_img(points: np.ndarray, img: np.ndarray, proj_mat: np.ndarray,
                       color=(0, 255, 0)):
    """Splat the points in front of the camera into the image."""
    uvd = project_points(points, proj_mat)
    ok = uvd[:, 2] > 0
    u = uvd[ok, 0].round().astype(int)
    v = uvd[ok, 1].round().astype(int)
    h, w = img.shape[:2]
    m = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    img[v[m], u[m]] = color
    return img


def draw_depth_bbox3d_on_img(boxes: np.ndarray, img: np.ndarray, calib: np.ndarray,
                             extrinsic: np.ndarray | None = None, color=(0, 255, 0)):
    """Boxes in the depth / world frame: an optional depth -> camera
    extrinsic composes with the (3, 3) or (4, 4) intrinsics."""
    proj = np.asarray(calib, np.float64)
    if proj.shape == (3, 3):
        p = np.eye(4)
        p[:3, :3] = proj
        proj = p
    if extrinsic is not None:
        proj = proj @ np.asarray(extrinsic, np.float64)
    return draw_bbox3d_on_img(boxes, img, proj, color=color)


def draw_lidar_bbox3d_on_img(boxes: np.ndarray, img: np.ndarray, lidar2img: np.ndarray,
                             color=(0, 255, 0)):
    """Boxes in the lidar frame: one (4, 4) lidar -> image matrix."""
    return draw_bbox3d_on_img(boxes, img, lidar2img, color=color)


def draw_camera_bbox3d_on_img(boxes: np.ndarray, img: np.ndarray, cam2img: np.ndarray,
                              color=(0, 255, 0)):
    """Boxes already in camera coordinates, projected by the (3, 3) or
    (4, 4) intrinsics."""
    return draw_depth_bbox3d_on_img(boxes, img, cam2img, None, color=color)


def draw_bbox3d_on_img(boxes: np.ndarray, img: np.ndarray, proj_mat: np.ndarray,
                       color=(0, 255, 255)):
    """Draw (M, 6|7) gravity-center boxes as projected wireframes; a box
    with a corner behind the camera is skipped."""
    for cs in box_corners(boxes):
        uvd = project_points(cs, proj_mat)
        if (uvd[:, 2] <= 0).any():
            continue
        for a, b in EDGES:
            img = _draw_line(img, uvd[a, :2], uvd[b, :2], color)
    return img
