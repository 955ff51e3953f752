"""Qualitative result export: colored point clouds and box wireframes as
``.obj`` files.

The port's own copy of the JAX package's ``viz/show_results.py`` (the
reference's ``show_result_v2``, ``_write_obj`` and
``_write_oriented_bbox_v2``): ground-truth boxes drawn green, predictions
red, points with their RGB colors. numpy text files, viewable in any mesh
viewer. Box corners come from ``core/boxes.py::boxes7_corners`` on a CPU
tensor.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.boxes import boxes7_corners

# Wireframe edges over the 8 corners of boxes7_corners (corner bit order: x
# sign major, then y, then z).
EDGES = (
    (0, 1), (0, 2), (1, 3), (2, 3),
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
)


def box_corners(boxes) -> np.ndarray:
    """(M, 8, 3) float32 corners of (M, 6|7) gravity-center boxes (yaw 0
    when absent)."""
    boxes = np.asarray(boxes, np.float32)
    if boxes.shape[-1] == 6:
        boxes = np.concatenate([boxes, np.zeros_like(boxes[:, :1])], axis=-1)
    return boxes7_corners(torch.from_numpy(boxes)).numpy()


def write_obj(points: np.ndarray, path: str):
    """Write (N, 3) points, or (N, >= 6) with rgb in [0, 255] or [0, 1] (a
    point whose largest color exceeds 1 is scaled by 1 / 255). The numbers
    are written as the JAX package's per-point loop writes them (the repr of
    each value as a Python float), from whole arrays at a time."""
    points = np.asarray(points)
    if points.shape[1] >= 6:
        rgb = points[:, 3:6]
        rgb = np.where(rgb.max(1, keepdims=True) > 1.0, rgb / 255.0, rgb)
        rows = np.concatenate([points[:, :3], rgb], 1).tolist()
        line = "v %r %r %r %r %r %r\n"
    else:
        rows = points[:, :3].tolist()
        line = "v %r %r %r\n"
    with open(path, "w") as f:
        f.writelines(line % tuple(r) for r in rows)


def write_boxes_obj(boxes: np.ndarray, path: str, color=(1.0, 0.0, 0.0)):
    """Write (M, 6|7) gravity-center boxes as wireframes (lines)."""
    with open(path, "w") as f:
        for ci, cs in enumerate(box_corners(boxes)):
            for p in cs:
                f.write(f"v {p[0]} {p[1]} {p[2]} {color[0]} {color[1]} {color[2]}\n")
            base = ci * 8 + 1
            for a, b in EDGES:
                f.write(f"l {base + a} {base + b}\n")


def show_seg_result(
    out_dir: str,
    name: str,
    points: np.ndarray,  # (N, 3|6)
    gt_seg: np.ndarray | None,
    pred_seg: np.ndarray | None,
    palette: np.ndarray,  # (num_classes, 3) in [0, 255]
    ignore_index: int | None = None,
):
    """Semantic-segmentation variant (the reference's show_seg_result):
    points recolored by the label palette, gt / pred written as .obj files;
    points labelled `ignore_index` in gt_seg are left out."""
    points = np.asarray(points)
    if gt_seg is not None and ignore_index is not None:
        keep = gt_seg != ignore_index
        points = points[keep]
        if pred_seg is not None:
            pred_seg = pred_seg[keep]
        gt_seg = gt_seg[keep]

    result_dir = os.path.join(out_dir, name)
    os.makedirs(result_dir, exist_ok=True)
    palette = np.asarray(palette, np.float32)
    if len(points):
        write_obj(points, os.path.join(result_dir, f"{name}_points.obj"))
    for seg, tag in ((gt_seg, "gt"), (pred_seg, "pred")):
        if seg is None:
            continue
        colored = np.concatenate([points[:, :3], palette[seg]], axis=1)
        write_obj(colored, os.path.join(result_dir, f"{name}_{tag}.obj"))
    return result_dir


def show_multi_modality_result(
    img: np.ndarray,  # (H, W, 3) uint8
    gt_bboxes: np.ndarray | None,  # (M, 6|7) depth-frame boxes
    pred_bboxes: np.ndarray | None,
    proj_mat: np.ndarray,  # (4, 4) depth -> image projection
    out_dir: str,
    name: str,
    gt_color=(61, 102, 255),
    pred_color=(241, 101, 72),
):
    """Project 3D boxes onto an image and save it as PNGs (the reference's
    show_multi_modality_result, with image_vis's rasteriser in place of
    cv2)."""
    from PIL import Image

    from .image_vis import draw_bbox3d_on_img

    result_dir = os.path.join(out_dir, name)
    os.makedirs(result_dir, exist_ok=True)
    for boxes, color, tag in ((gt_bboxes, gt_color, "gt"), (pred_bboxes, pred_color, "pred")):
        if boxes is not None and len(boxes):
            shown = draw_bbox3d_on_img(boxes, img.copy(), proj_mat, color=color)
            Image.fromarray(shown.astype(np.uint8)).save(
                os.path.join(result_dir, f"{name}_{tag}.png"))
    Image.fromarray(np.asarray(img, np.uint8)).save(
        os.path.join(result_dir, f"{name}_img.png"))
    return result_dir


def show_online(points: np.ndarray, boxes: np.ndarray | None = None):
    """Interactive viewer (the reference's open3d path). open3d is not a
    dependency of the port: without it this raises ImportError pointing at
    show_result()'s .obj exports."""
    try:
        import open3d as o3d
    except ImportError as e:
        raise ImportError(
            "open3d is not installed; use show_result()'s .obj exports "
            "with any mesh viewer instead"
        ) from e
    geoms = []
    pc = o3d.geometry.PointCloud()
    pc.points = o3d.utility.Vector3dVector(np.asarray(points[:, :3]))
    if points.shape[1] >= 6:
        cols = np.asarray(points[:, 3:6], np.float64)
        if cols.max() > 1.0:
            cols = cols / 255.0
        pc.colors = o3d.utility.Vector3dVector(cols)
    geoms.append(pc)
    if boxes is not None:
        for cs in box_corners(boxes):
            ls = o3d.geometry.LineSet(
                points=o3d.utility.Vector3dVector(cs),
                lines=o3d.utility.Vector2iVector(np.asarray(EDGES)),
            )
            ls.paint_uniform_color([1.0, 0.0, 0.0])
            geoms.append(ls)
    o3d.visualization.draw_geometries(geoms)


def show_result(
    out_dir: str,
    name: str,
    points: np.ndarray | None = None,
    gt_bboxes: np.ndarray | None = None,
    pred_bboxes: np.ndarray | None = None,
):
    """Write <out_dir>/<name>/<name>_points.obj, _gt.obj and _pred.obj (each
    when its input is non-empty); returns the scene's directory."""
    result_dir = os.path.join(out_dir, name)
    os.makedirs(result_dir, exist_ok=True)
    if points is not None and len(points):
        write_obj(points, os.path.join(result_dir, f"{name}_points.obj"))
    if gt_bboxes is not None and len(gt_bboxes):
        write_boxes_obj(gt_bboxes, os.path.join(result_dir, f"{name}_gt.obj"),
                        color=(0.0, 1.0, 0.0))
    if pred_bboxes is not None and len(pred_bboxes):
        write_boxes_obj(pred_bboxes, os.path.join(result_dir, f"{name}_pred.obj"),
                        color=(1.0, 0.0, 0.0))
    return result_dir
