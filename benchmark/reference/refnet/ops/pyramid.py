"""Grid pyramid: every level's rulebooks of the sparse U-Net, built on the
device from the level-0 voxel grid.

The port of the JAX package's ``ops/pyramid.py``: each transition (l, l+1)
shares one DownsampleMap between its strided and inverse convs, and each
level one neighbor table between its submanifold convs.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

from .sparse_conv import build_downsample_map, build_subm_neighbors
from .voxelize import VoxelGrid


class GridPyramid(NamedTuple):
    grids: tuple  # VoxelGrid per level
    neighbors: tuple  # (V_l, 27) int32 per level
    ds: tuple  # DownsampleMap per transition (levels - 1)


def build_pyramid(grid0: VoxelGrid, capacities: Sequence[int]) -> GridPyramid:
    """capacities[l] is level l's voxel capacity; capacities[0] must be
    grid0's."""
    if capacities[0] != grid0.capacity:
        raise ValueError(f"capacities[0] {capacities[0]} != grid0's {grid0.capacity}")
    grids = [grid0]
    ds = []
    for cap in capacities[1:]:
        m = build_downsample_map(grids[-1], cap)
        ds.append(m)
        grids.append(m.grid)
    return GridPyramid(grids=tuple(grids),
                       neighbors=tuple(build_subm_neighbors(g) for g in grids),
                       ds=tuple(ds))
