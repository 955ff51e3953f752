"""GridPack: the sparse-conv rulebooks for one batch.

The port's copy of the numpy builder in the JAX package's ``ops/gridpack.py``
(same semantics, bit for bit), the reference of the native builder
(``native/rulebook.cc``) that ``build_gridpack_host`` runs in the loaders:
the production path. ``build_gridpack_device`` is the fallback that the
detector runs when it is handed no pack (``UniDet3D.forward(batch, None)``):
the same tables built on the device with PyTorch tensor ops.

For each U-Net level l:
  * valid[l]: (V_l,) voxel validity; valid voxels are a prefix of the rows
  * neighbors[l]: (V_l, 27) submanifold-conv neighbor table (sentinel V_l)
  * n_valid[l]: the number of valid voxels, a host int, so that the conv
    kernel launches over the valid rows without reading anything back from
    the device
and for each level transition l -> l+1:
  * parent[l]: (V_l,) fine-voxel -> coarse-voxel row (sentinel V_{l+1})
  * offset_code[l]: (V_l,) 3-bit kernel offset of the strided/inverse conv
plus point_inverse: (N,) point -> level-0 voxel (sentinel V_0).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .pyramid import build_pyramid
from .voxelize import voxelize


class GridPack(NamedTuple):
    valid: tuple  # per level: (V_l,) bool
    neighbors: tuple  # per level: (V_l, 27) int32
    parent: tuple  # per transition: (V_l,) int32
    offset_code: tuple  # per transition: (V_l,) int32
    point_inverse: object  # (N,) int32
    n_valid: tuple  # per level: host int, valid rows are [0, n_valid)

    @property
    def num_levels(self) -> int:
        return len(self.valid)

    def capacity(self, level: int) -> int:
        return self.valid[level].shape[0]


def build_gridpack_device(bxyz, point_valid, capacities: Sequence[int]):
    """GridPack construction on the device (the JAX package's
    ``build_gridpack_device``): a stable sort, cumulative sums, scatters and
    binary searches over int64 keys, no kernel of its own.

    Args:
        bxyz: (N, 4) int tensor (batch, x, y, z) of quantized coords.
        point_valid: (N,) bool tensor.
        capacities: the voxel capacity of each level.

    Returns:
        (GridPack of tensors on bxyz's device, the level-0 VoxelGrid, whose
        counts average features). The tables equal build_gridpack_numpy's on
        every row. Every level's n_valid is read to the host in one
        ``.tolist()`` at the end, the builder's only wait for the device: the
        conv kernels size their grids from it.
    """
    grid0, _ = voxelize(bxyz, point_valid, capacities[0])
    pyr = build_pyramid(grid0, list(capacities))
    n_valid = torch.stack([g.n_voxels for g in pyr.grids]).tolist()
    return GridPack(
        valid=tuple(g.valid for g in pyr.grids),
        neighbors=pyr.neighbors,
        parent=tuple(d.parent for d in pyr.ds),
        offset_code=tuple(d.offset_code for d in pyr.ds),
        point_inverse=grid0.inverse,
        n_valid=tuple(n_valid),
    ), grid0


_SUBM_OFFSETS = np.array(
    [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
    ],
    dtype=np.int64,
)


def _pack64(bxyz: np.ndarray) -> np.ndarray:
    b, x, y, z = (bxyz[:, i].astype(np.int64) for i in range(4))
    return (b << 36) | (x << 24) | (y << 12) | z


def build_gridpack_numpy(
    bxyz: np.ndarray, point_valid: np.ndarray, capacities: Sequence[int]
):
    """Voxelize (N, 4) int (batch, x, y, z) points and build every level's
    rulebooks. Voxels are sorted by (batch, x, y, z); overflow beyond a
    level's capacity is dropped.

    Returns (GridPack of numpy arrays, counts0 (V_0,) float32 point counts).
    """
    n = bxyz.shape[0]
    coords = bxyz.astype(np.int64).copy()
    coords[:, 1:] = np.clip(coords[:, 1:], 0, 4095)

    valids, neighbors, parents, offsets, n_valid = [], [], [], [], []

    # Level 0: dedup points -> voxels (sorted by packed key = (b, x, y, z)).
    keys = _pack64(coords)
    keys_v = np.where(point_valid, keys, np.iinfo(np.int64).max)
    order = np.argsort(keys_v, kind="stable")
    ks = keys_v[order]
    new_group = np.empty(n, bool)
    new_group[0] = True
    new_group[1:] = ks[1:] != ks[:-1]
    seg = np.cumsum(new_group) - 1
    valid_s = point_valid[order]
    n_vox = int(new_group[valid_s].sum())

    cap0 = capacities[0]
    n_vox = min(n_vox, cap0)
    seg_ok = valid_s & (seg < cap0)
    seg_c = np.where(seg_ok, seg, cap0)
    point_inverse = np.empty(n, np.int32)
    point_inverse[order] = seg_c.astype(np.int32)

    lvl_keys = np.full(cap0, np.iinfo(np.int64).max, np.int64)
    first = new_group & seg_ok
    lvl_keys[seg_c[first]] = ks[first]
    counts0 = np.bincount(
        seg_c[seg_c < cap0], minlength=cap0
    ).astype(np.float32)

    cur_keys = lvl_keys
    cur_n = n_vox
    for li, cap in enumerate(capacities):
        valids.append(np.arange(cap) < cur_n)
        n_valid.append(int(cur_n))
        kk = cur_keys[:cur_n]
        kb = kk >> 36
        kx = (kk >> 24) & 4095
        ky = (kk >> 12) & 4095
        kz = kk & 4095
        # Submanifold neighbors for all 27 offsets at once: the level keys are
        # sorted, so one vectorised np.searchsorted resolves everything.
        d = _SUBM_OFFSETS  # (27, 3)
        qx = kx[:, None] + d[None, :, 0]
        qy = ky[:, None] + d[None, :, 1]
        qz = kz[:, None] + d[None, :, 2]
        ok = (
            (qx >= 0) & (qx <= 4095)
            & (qy >= 0) & (qy <= 4095)
            & (qz >= 0) & (qz <= 4095)
        )
        qk = (
            (kb[:, None] << 36)
            | (np.clip(qx, 0, None) << 24)
            | (np.clip(qy, 0, None) << 12)
            | np.clip(qz, 0, None)
        )
        pos = np.searchsorted(kk, qk)
        posc = np.minimum(pos, max(cur_n - 1, 0))
        found = ok & (pos < cur_n) & (
            kk[posc] == qk if cur_n else np.zeros_like(ok)
        )
        nbr = np.full((cap, 27), cap, np.int32)
        nbr[:cur_n] = np.where(found, posc, cap).astype(np.int32)
        neighbors.append(nbr)

        if li == len(capacities) - 1:
            break
        # Downsample transition (unique over halved coords, sorted order).
        ncap = capacities[li + 1]
        pk = (kb << 36) | ((kx >> 1) << 24) | ((ky >> 1) << 12) | (kz >> 1)
        uniq, inv = np.unique(pk, return_inverse=True)
        nn = min(len(uniq), ncap)
        par = np.full(cap, ncap, np.int32)
        par[:cur_n] = np.where(inv < ncap, inv, ncap).astype(np.int32)
        off = np.zeros(cap, np.int32)
        off[:cur_n] = ((kx & 1) * 4 + (ky & 1) * 2 + (kz & 1)).astype(np.int32)
        parents.append(par)
        offsets.append(off)
        nk = np.full(ncap, np.iinfo(np.int64).max, np.int64)
        nk[:nn] = uniq[:nn]
        cur_keys = nk
        cur_n = nn

    pack = GridPack(
        valid=tuple(valids),
        neighbors=tuple(neighbors),
        parent=tuple(parents),
        offset_code=tuple(offsets),
        point_inverse=point_inverse,
        n_valid=tuple(n_valid),
    )
    return pack, counts0


def quantize_points(vox_src: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per-scene min-shift over valid points, floor, batch-prefixed int32
    coords.

    Args:
        vox_src: (B, P, 3) float32 voxel-unit coords.
        valid: (B, P) bool.

    Returns:
        (B*P, 4) int32 (batch, x, y, z).
    """
    b, p, _ = vox_src.shape
    vs = np.where(valid[..., None], vox_src, 1e9).astype(np.float32)
    pmin = vs.min(axis=1, keepdims=True)
    pmin = np.where(pmin >= 1e9, 0.0, pmin)
    icoords = np.floor(vox_src - pmin).astype(np.int32)
    bidx = np.repeat(np.arange(b, dtype=np.int32)[:, None], p, axis=1)
    return np.concatenate(
        [bidx.reshape(-1, 1), icoords.reshape(-1, 3)], axis=1
    )


def quantize_points_device(vox_src: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """quantize_points on the device, the same float32 arithmetic: (B, P, 3)
    vox_src and (B, P) valid -> (B*P, 4) int32 (batch, x, y, z)."""
    b, p, _ = vox_src.shape
    vs = torch.where(valid[..., None], vox_src, 1e9)
    pmin = vs.amin(dim=1, keepdim=True)
    pmin = torch.where(pmin >= 1e9, 0.0, pmin)
    icoords = torch.floor(vox_src - pmin).int().reshape(-1, 3)
    scene = torch.arange(b, dtype=torch.int32, device=vox_src.device).repeat_interleave(p)
    return torch.cat([scene[:, None], icoords], -1)
