"""Eval batch collation: pipeline sample dicts -> padded arrays + host-built
rulebooks, and the move to the device.

The port of the eval fields of the JAX package's ``data/batcher.py::collate``:
the same padding, subsampling and features, and the GridPack with its
(V, 27) neighbor tables built by the numpy builder. Ground truth is not
collated (training and mAP come in later slices).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core.config import ModelConfig
from ..device import resolve_device
from ..models.detector import PointBatch
from ..ops.gridpack import GridPack, build_gridpack_numpy, quantize_points


def collate(
    samples: List[dict],
    cfg: ModelConfig,
    rng: np.random.RandomState | None = None,
) -> Tuple[PointBatch, GridPack]:
    """Returns (PointBatch, GridPack) of numpy arrays for a group of scenes.

    Each sample holds "points" (N, 6) [xyz, rgb], "dataset_idx" and
    optionally "sp_pts_mask" (N,) superpoint ids. Scenes with more than
    cfg.max_points points are subsampled uniformly at random; superpoint ids
    beyond cfg.max_superpoints are folded into the last slot."""
    rng = rng or np.random.RandomState(0)
    b = len(samples)
    p, s = cfg.max_points, cfg.max_superpoints

    points = np.zeros((b, p, 3), np.float32)
    vox_src = np.zeros((b, p, 3), np.float32)
    features = np.zeros((b, p, 6), np.float32)
    valid = np.zeros((b, p), bool)
    sp_ids = np.zeros((b, p), np.int32)
    ds_ids = np.zeros((b,), np.int32)

    for i, sm in enumerate(samples):
        pts = sm["points"]
        n = min(len(pts), p)
        if len(pts) > p:
            sel = np.sort(rng.choice(len(pts), p, replace=False))
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
            sp_ids[i, :n] = np.minimum(sp[sel], s - 1).astype(np.int32)

    batch = PointBatch(
        points=points,
        vox_src=vox_src,
        features=features,
        valid=valid,
        sp_ids=sp_ids,
        dataset_ids=ds_ids,
    )
    pack, _ = build_gridpack_numpy(
        quantize_points(vox_src, valid),
        valid.reshape(-1),
        cfg.level_capacities(b),
    )
    return batch, pack


def to_device(
    batch: PointBatch, pack: GridPack, device="cuda"
) -> Tuple[PointBatch, GridPack]:
    """Copy a collated (batch, pack) to `device` ("cuda" unless the caller
    asks for "cpu"). pack.n_valid stays host ints."""
    device = resolve_device(device)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

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
