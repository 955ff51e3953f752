"""Batch collation: pipeline sample dicts -> padded arrays, padded ground
truth and host-built rulebooks, and the move to the device.

The port of the JAX package's ``data/batcher.py::collate``: the same padding,
subsampling, features (voxel coordinates from ``elastic_coords`` when the
pipeline's elastic distortion made them) and ground-truth fields, and the
GridPack with its (V, 27) neighbor tables, built by the native builder
(``ops/gridpack.py::build_gridpack_host``) unless the caller names another
(``build_gridpack_numpy``, the reference). Every row dropped at a capacity is
counted in ``data/telemetry.py::DROPS``, at the JAX collate's sites.

``to_device`` / ``gt_to_device`` copy synchronously from pageable memory;
``data/loader.py``'s loaders stage their batches instead (pinned buffers, a
side stream, an event the consumer waits on).
"""
from __future__ import annotations

from typing import Callable, List, Tuple

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
    build_rulebooks: bool = True,
    builder: Callable = build_gridpack_numpy,
) -> Tuple[PointBatch, GTBatch, GridPack]:
    """Returns (PointBatch, GTBatch, GridPack) of numpy arrays for a group of
    scenes; the GridPack is None when build_rulebooks is False (the caller
    then runs ``build_packs`` itself).

    Each sample holds "points" (N, 6) [xyz, rgb], "dataset_idx" and
    optionally "sp_pts_mask" (N,) superpoint ids and the ground truth:
    "gt_bboxes_3d" (n, 6 or 7), "gt_labels_3d" (n,), "gt_sp_masks"
    (n, n_superpoints) bool, "pts_instance_mask" (N,) instance ids, and
    "elastic_coords" (N, 3), the voxel-unit coordinates of the elastic
    distortion (otherwise points / voxel_size). Scenes
    with more than cfg.max_points points are subsampled uniformly at random;
    superpoint ids beyond cfg.max_superpoints are folded into the last slot;
    GTs beyond cfg.max_gts are dropped; voxels beyond a level's capacity are
    dropped by the pack builder. DROPS counts each. `builder(bxyz, valid,
    caps)` builds the rulebooks (``build_packs``); subsampling draws from
    `rng`, as the JAX collate does."""
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
        if "elastic_coords" in sm:
            vox_src[i, :n] = sm["elastic_coords"][sel]
        else:
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
    pack = build_packs(vox_src, valid, cfg, builder) if build_rulebooks else None
    return batch, gt, pack


def build_packs(vox_src: np.ndarray, valid: np.ndarray, cfg: ModelConfig,
                builder: Callable = build_gridpack_numpy) -> GridPack:
    """The GridPack of a collated (B, P, 3) vox_src / (B, P) valid, built by
    `builder(bxyz, valid, caps)` at cfg's level capacities, with the
    voxels it dropped counted in DROPS."""
    caps = cfg.level_capacities(vox_src.shape[0])
    pack, _ = builder(quantize_points(vox_src, valid), valid.reshape(-1), caps)
    # Valid points whose level-0 voxel was dropped, and valid voxels whose
    # parent overflowed the next level.
    DROPS.add("voxels_dropped",
              int((pack.point_inverse[valid.reshape(-1)] >= caps[0]).sum()))
    for lvl, par in enumerate(pack.parent):
        DROPS.add("coarse_voxels_dropped",
                  int((par[pack.valid[lvl]] >= caps[lvl + 1]).sum()))
    return pack


def map_arrays(fn, tree):
    """`tree` (a PointBatch, GTBatch or GridPack) with `fn` applied to each of
    its arrays; a GridPack's n_valid stays host ints."""
    if isinstance(tree, GridPack):
        return GridPack(
            valid=tuple(map(fn, tree.valid)),
            neighbors=tuple(map(fn, tree.neighbors)),
            parent=tuple(map(fn, tree.parent)),
            offset_code=tuple(map(fn, tree.offset_code)),
            point_inverse=fn(tree.point_inverse),
            n_valid=tuple(tree.n_valid),
        )
    return type(tree)(*map(fn, tree))


def to_device(
    batch: PointBatch, pack: GridPack, device="cuda"
) -> Tuple[PointBatch, GridPack]:
    """Copy a collated (batch, pack) to `device` ("cuda" unless the caller
    asks for "cpu"), synchronously. pack.n_valid stays host ints."""
    device = resolve_device(device)

    def put(x):
        return _put(x, device)

    return map_arrays(put, batch), map_arrays(put, pack)


def gt_to_device(gt: GTBatch, device="cuda") -> GTBatch:
    """Copy a collated GTBatch to `device` ("cuda" unless the caller asks for
    "cpu")."""
    device = resolve_device(device)
    return map_arrays(lambda x: _put(x, device), gt)


def _put(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)
