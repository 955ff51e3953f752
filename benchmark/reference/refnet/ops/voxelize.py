"""Voxelization on the device: quantized points -> a sorted, deduplicated,
fixed-capacity voxel set, its per-voxel feature means and the point ->
voxel map.

The port of the JAX package's ``ops/voxelize.py``, in PyTorch tensor ops
(a stable sort, a cumulative sum, scatters), as JAX builds it from XLA ops.
Voxels are sorted by their (batch, x, y, z) key (``ops/keys.py``); a voxel's
coords come from its first point in input order (the sort is stable, as
JAX's ``lexsort``); groups at or beyond `capacity` are dropped and their
points get the sentinel `capacity`. Nothing is read back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .keys import INVALID_KEY, MAX_COORD, pack_keys
from .segment import segment_count, segment_sum


class VoxelGrid(NamedTuple):
    """A fixed-capacity sorted voxel set.

    coords: (V, 4) int32 (batch, x, y, z); zeros past n_voxels.
    key: (V,) int64 sorted keys (INVALID_KEY past n_voxels), the JAX
        package's (key1, key2) pair in one key.
    valid: (V,) bool, row < n_voxels.
    n_voxels: () int64 device scalar, the number of real voxels (<= V).
    inverse: (N,) int32 input row -> voxel row; V (the sentinel) for an
        invalid or dropped input.
    counts: (V,) float32 input rows per voxel.
    """

    coords: torch.Tensor
    key: torch.Tensor
    valid: torch.Tensor
    n_voxels: torch.Tensor
    inverse: torch.Tensor
    counts: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.key.shape[0]


def voxelize(bxyz: torch.Tensor, valid: torch.Tensor, capacity: int,
             features: torch.Tensor | None = None):
    """Deduplicate integer voxel coordinates and, given `features`, average
    them per voxel.

    Args:
        bxyz: (N, 4) int (batch, x, y, z), coords clipped to [0, MAX_COORD]
            here.
        valid: (N,) bool.
        capacity: the voxel capacity V.
        features: optional (N, F) float features.

    Returns:
        (VoxelGrid, (V, F) voxel feature means or None).
    """
    n = bxyz.shape[0]
    dev = bxyz.device
    bxyz = torch.cat([bxyz[:, :1], bxyz[:, 1:].clamp(0, MAX_COORD)], -1).int()
    keys_s, order = torch.sort(pack_keys(bxyz, valid), stable=True)
    valid_s = valid[order]
    new_group = torch.ones(n, dtype=torch.bool, device=dev)
    new_group[1:] = keys_s[1:] != keys_s[:-1]
    # Invalid rows share INVALID_KEY: at most one trailing group.
    seg = new_group.long().cumsum(0) - 1
    n_voxels = (new_group & valid_s).sum().clamp(max=capacity)
    seg_ok = valid_s & (seg < capacity)
    seg_c = torch.where(seg_ok, seg, capacity)

    inverse = torch.empty(n, dtype=torch.int32, device=dev)
    inverse[order] = seg_c.int()
    # The first row of each kept group writes its voxel's key and coords;
    # every other row writes into the dropped row `capacity`.
    row = torch.where(new_group & seg_ok, seg_c, capacity)
    key = torch.full((capacity + 1,), INVALID_KEY, dtype=torch.int64, device=dev)
    key[row] = keys_s
    coords = torch.zeros((capacity + 1, 4), dtype=torch.int32, device=dev)
    coords[row] = bxyz[order]
    counts = segment_count(seg_c, capacity)
    grid = VoxelGrid(
        coords=coords[:capacity],
        key=key[:capacity],
        valid=torch.arange(capacity, device=dev) < n_voxels,
        n_voxels=n_voxels,
        inverse=inverse,
        counts=counts,
    )
    if features is None:
        return grid, None
    total = segment_sum(torch.where(valid_s[:, None], features[order], 0.0), seg_c, capacity)
    return grid, total / counts[:, None].clamp(min=1.0)


def gather_voxel_to_points(voxel_feats: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """Per-voxel features gathered back to the points; sentinel rows -> 0."""
    from .sparse_conv import gather_rows  # sparse_conv imports this module

    return gather_rows(voxel_feats, inverse)
