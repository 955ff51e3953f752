"""Batch collation: pipeline sample dicts -> padded arrays, padded ground
truth and host-built rulebooks, and the move to the device.

The port of the JAX package's ``data/batcher.py::collate``: the same padding,
subsampling, features and ground-truth fields, and the GridPack with its
(V, 27) neighbor tables built by the numpy builder. Every row dropped at a
capacity is counted in ``data/telemetry.py::DROPS``, at the JAX collate's
sites. Augmentations (``elastic_coords``) are not ported yet.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core.config import ModelConfig
from ..device import resolve_device
from ..models.detector import GTBatch, PointBatch
from ..ops.gridpack import GridPack, build_gridpack_numpy, quantize_points
from .telemetry import DROPS


def collate(
    samples: List[dict],
    cfg: ModelConfig,
    rng: np.random.RandomState | None = None,
) -> Tuple[PointBatch, GTBatch, GridPack]:
    """Returns (PointBatch, GTBatch, GridPack) of numpy arrays for a group of
    scenes.

    Each sample holds "points" (N, 6) [xyz, rgb], "dataset_idx" and
    optionally "sp_pts_mask" (N,) superpoint ids and the ground truth:
    "gt_bboxes_3d" (n, 6 or 7), "gt_labels_3d" (n,), "gt_sp_masks"
    (n, n_superpoints) bool, "pts_instance_mask" (N,) instance ids. Scenes
    with more than cfg.max_points points are subsampled uniformly at random;
    superpoint ids beyond cfg.max_superpoints are folded into the last slot;
    GTs beyond cfg.max_gts are dropped; voxels beyond a level's capacity are
    dropped by the pack builder. DROPS counts each."""
    rng = rng or np.random.RandomState(0)
    b = len(samples)
    p, s, g = cfg.max_points, cfg.max_superpoints, cfg.max_gts

    points = np.zeros((b, p, 3), np.float32)
    vox_src = np.zeros((b, p, 3), np.float32)
    features = np.zeros((b, p, 6), np.float32)
    valid = np.zeros((b, p), bool)
    sp_ids = np.zeros((b, p), np.int32)
    ds_ids = np.zeros((b,), np.int32)

    labels = np.zeros((b, g), np.int32)
    boxes = np.zeros((b, g, 7), np.float32)
    gt_valid = np.zeros((b, g), bool)
    sp_masks = np.zeros((b, g, s), bool)
    inst_ids = np.full((b, p), -1, np.int32)

    for i, sm in enumerate(samples):
        pts = sm["points"]
        n = min(len(pts), p)
        if len(pts) > p:
            sel = np.sort(rng.choice(len(pts), p, replace=False))
            DROPS.add("points_dropped", len(pts) - p)
        else:
            sel = np.arange(n)
        points[i, :n] = pts[sel, :3]
        valid[i, :n] = True
        ds_ids[i] = sm["dataset_idx"]

        # Voxel features: [normalized colors, xyz - mean].
        mean = pts[sel, :3].mean(0) if n else np.zeros(3)
        features[i, :n, :3] = pts[sel, 3:6]
        features[i, :n, 3:] = pts[sel, :3] - mean
        vox_src[i, :n] = pts[sel, :3] / cfg.voxel_size

        sp = sm.get("sp_pts_mask")
        if sp is not None:
            spc = sp[sel]
            DROPS.add("superpoints_folded", int((spc >= s).sum()))
            sp_ids[i, :n] = np.minimum(spc, s - 1).astype(np.int32)

        gb = sm.get("gt_bboxes_3d", np.zeros((0, 6), np.float32))
        gl = sm.get("gt_labels_3d", np.zeros((0,), np.int64))
        DROPS.add("gts_dropped", len(gb) - g)
        ng = min(len(gb), g)
        if ng:
            boxes[i, :ng, : gb.shape[1]] = gb[:ng]
            labels[i, :ng] = gl[:ng]
            gt_valid[i, :ng] = True
        gsm = sm.get("gt_sp_masks")
        if gsm is not None and gsm.size:
            cols = min(gsm.shape[1], s)
            sp_masks[i, :ng, :cols] = gsm[:ng, :cols]
        pim = sm.get("pts_instance_mask")
        if pim is not None:
            im = pim[sel].astype(np.int32)
            DROPS.add("instances_dropped", int((im >= g).sum()))
            inst_ids[i, :n] = np.where(im >= g, -1, im)  # overflowed GTs dropped

    batch = PointBatch(
        points=points,
        vox_src=vox_src,
        features=features,
        valid=valid,
        sp_ids=sp_ids,
        dataset_ids=ds_ids,
    )
    gt = GTBatch(
        labels=labels, boxes=boxes, valid=gt_valid, sp_masks=sp_masks,
        inst_ids=inst_ids,
    )
    caps = cfg.level_capacities(b)
    pack, _ = build_gridpack_numpy(
        quantize_points(vox_src, valid), valid.reshape(-1), caps
    )
    # Valid points whose level-0 voxel was dropped, and valid voxels whose
    # parent overflowed the next level.
    DROPS.add("voxels_dropped",
              int((pack.point_inverse[valid.reshape(-1)] >= caps[0]).sum()))
    for lvl, par in enumerate(pack.parent):
        DROPS.add("coarse_voxels_dropped",
                  int((par[pack.valid[lvl]] >= caps[lvl + 1]).sum()))
    return batch, gt, pack


def to_device(
    batch: PointBatch, pack: GridPack, device="cuda"
) -> Tuple[PointBatch, GridPack]:
    """Copy a collated (batch, pack) to `device` ("cuda" unless the caller
    asks for "cpu"). pack.n_valid stays host ints."""
    device = resolve_device(device)

    def put(x):
        return _put(x, device)

    def put_all(xs):
        return tuple(put(x) for x in xs)

    return (
        PointBatch(*(put(x) for x in batch)),
        GridPack(
            valid=put_all(pack.valid),
            neighbors=put_all(pack.neighbors),
            parent=put_all(pack.parent),
            offset_code=put_all(pack.offset_code),
            point_inverse=put(pack.point_inverse),
            n_valid=tuple(pack.n_valid),
        ),
    )


def gt_to_device(gt: GTBatch, device="cuda") -> GTBatch:
    """Copy a collated GTBatch to `device` ("cuda" unless the caller asks for
    "cpu")."""
    device = resolve_device(device)
    return GTBatch(*(_put(x, device) for x in gt))


def _put(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)
